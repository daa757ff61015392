"""FPFH descriptors as batched histogram tensor ops.

Replaces `pcl::FPFHEstimation` (SURVEY.md section 2.1, "Descriptors").
Two batched stages, no per-point loops:

  1. SPFH for every point: Darboux-frame angles (alpha, phi, theta) between
     each point's normal and its k neighbors', 11 hard bins per angle ->
     [N, 33], one segment-sum scatter for the cloud.
  2. FPFH_i = SPFH_i + mean_j (1 / dist_ij) * SPFH_j over i's neighbors,
     then L2 normalization; gathered at the keypoint indices.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from saccot.features.neighbors import knn, neighbor_validity

FPFH_DIM = 33
_BINS = 11


def _angle_bins(x: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    return jnp.clip(((x - lo) / (hi - lo) * _BINS).astype(jnp.int32), 0, _BINS - 1)


def _angle_bins_soft(x: jnp.ndarray, lo: float, hi: float):
    """Linear-interpolated (clamped) bin split: ((lo_i, w_lo), (hi_i, w_hi)).

    The soft counterpart of _angle_bins: noise that moves
    an angle across a bin edge shifts weight continuously instead of
    flipping a whole count."""
    c = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0) * _BINS - 0.5
    f0 = jnp.floor(c)
    f = c - f0
    lo_i = jnp.clip(f0.astype(jnp.int32), 0, _BINS - 1)
    hi_i = jnp.clip(f0.astype(jnp.int32) + 1, 0, _BINS - 1)
    return (lo_i, 1.0 - f), (hi_i, f)


def spfh(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    idx: jnp.ndarray,
    valid: jnp.ndarray,
    dist: jnp.ndarray,
    soft: bool = False,
) -> jnp.ndarray:
    """Simplified point feature histograms [N, 33]."""
    N, k = idx.shape
    p = points[:, None, :]  # [N,1,3]
    q = points[idx]         # [N,k,3]
    np_ = normals[:, None, :]
    nq = normals[idx]

    diff = q - p
    d = jnp.maximum(dist, 1e-12)[..., None]
    u = jnp.broadcast_to(np_, diff.shape)  # [N,k,3]
    pq = diff / d
    v = jnp.cross(pq, u)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    w = jnp.cross(u, v)

    alpha = jnp.sum(v * nq, axis=-1)             # [-1, 1]
    phi = jnp.sum(u * pq, axis=-1)               # [-1, 1]
    theta = jnp.arctan2(jnp.sum(w * nq, axis=-1), jnp.sum(u * nq, axis=-1))  # [-pi, pi]

    wgt = valid.astype(jnp.float32)
    rows = jnp.arange(N, dtype=jnp.int32)[:, None] * FPFH_DIM
    if soft:
        segs, vals_l = [], []
        for x, lo_v, hi_v, off in [
            (alpha, -1.0, 1.0, 0),
            (phi, -1.0, 1.0, _BINS),
            (theta, -float(jnp.pi), float(jnp.pi), 2 * _BINS),
        ]:
            for b_i, b_w in _angle_bins_soft(x, lo_v, hi_v):
                segs.append((rows + b_i + off).reshape(-1))
                vals_l.append((wgt * b_w).reshape(-1))
        seg = jnp.concatenate(segs)
        vals = jnp.concatenate(vals_l)
    else:
        b_alpha = _angle_bins(alpha, -1.0, 1.0)
        b_phi = _angle_bins(phi, -1.0, 1.0) + _BINS
        b_theta = _angle_bins(theta, -jnp.pi, jnp.pi) + 2 * _BINS
        seg = jnp.concatenate(
            [(rows + b_alpha).reshape(-1), (rows + b_phi).reshape(-1), (rows + b_theta).reshape(-1)]
        )
        vals = jnp.concatenate([wgt.reshape(-1)] * 3)
    hist = jax.ops.segment_sum(vals, seg, num_segments=N * FPFH_DIM).reshape(N, FPFH_DIM)
    # Normalize each point's histogram by its neighbor count (x3 angle blocks).
    cnt = jnp.maximum(jnp.sum(wgt, axis=-1, keepdims=True), 1.0)
    return hist / cnt


def fpfh_descriptors(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    kp_idx: jnp.ndarray,
    radius: float,
    k: int = 32,
    mask: Optional[jnp.ndarray] = None,
    approx: bool = False,
    soft: bool = False,
) -> jnp.ndarray:
    """FPFH descriptors [M, 33] at keypoint indices `kp_idx`.

    soft=True linearly interpolates each angle across its two nearest bins
    (see _angle_bins_soft) instead of hard binning."""
    d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask,
                 exclude_self=True, approx=approx)
    valid = neighbor_validity(d, radius=radius)
    s = spfh(points, normals, idx, valid, d, soft=soft)  # [N, 33]

    # Weighted neighbor pooling: FPFH_i = SPFH_i + mean_j SPFH_j / dist_ij.
    wgt = valid.astype(jnp.float32) / jnp.maximum(d, 1e-9)
    wgt = jnp.where(valid, wgt, 0.0)
    pooled = jnp.einsum(
        "nk,nkf->nf", wgt, s[idx], precision=jax.lax.Precision.HIGHEST
    ) / jnp.maximum(jnp.sum(wgt, axis=-1, keepdims=True), 1e-9)
    f = s + pooled
    f = f[kp_idx]
    return f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-9)
