"""SHOT descriptors as batched histogram tensor ops.

Replaces `pcl::SHOTEstimation` (SURVEY.md section 2.1, "Descriptors") with a
fully batched formulation: per keypoint, a weighted-covariance local
reference frame (LRF) with sign disambiguation, then a 32-volume spatial
grid (8 azimuth x 2 elevation x 2 radial) x 11 cosine-of-normal-angle bins
= 352-D histogram, accumulated with one segment-sum scatter for the whole
keypoint set. Hard binning instead of PCL's quadrilinear soft binning — the
contract is matching/recall parity (SURVEY.md section 2.3), not PCL
bit-parity.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from saccot.features.neighbors import knn, neighbor_validity

SHOT_DIM = 352  # 8 * 2 * 2 spatial volumes x 11 cosine bins


def local_reference_frames(
    points: jnp.ndarray,
    kp_idx: jnp.ndarray,
    nbr_idx: jnp.ndarray,
    nbr_valid: jnp.ndarray,
    nbr_dist: jnp.ndarray,
    radius: float,
) -> jnp.ndarray:
    """Disambiguated LRFs [M, 3, 3]; rows are the x, y, z axes.

    Weighted covariance with weights (radius - d), eigenvectors as axes
    (largest eigenvalue -> x, smallest -> z), each of x/z sign-flipped
    toward the majority of neighbors, y = z cross x.
    """
    kp = points[kp_idx]  # [M, 3]
    nb = points[nbr_idx]  # [M, k, 3]
    rel = nb - kp[:, None, :]
    w = jnp.maximum(radius - nbr_dist, 0.0) * nbr_valid.astype(points.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    cov = jnp.einsum(
        "mk,mki,mkj->mij", w, rel, rel, precision=jax.lax.Precision.HIGHEST
    ) / wsum[..., None]
    # Closed-form extreme eigenvectors (features/eig3.py) instead of an
    # iterative batched eigh; only the smallest/largest axes are consumed
    # (y is recomputed as z cross x).
    from saccot.features.eig3 import extreme_eigvecs3_sym

    z, x = extreme_eigvecs3_sym(cov)

    def disambiguate(axis):
        proj = jnp.einsum("mki,mi->mk", rel, axis)
        vote = jnp.sum(jnp.where(nbr_valid, jnp.sign(proj), 0.0), axis=-1)
        s = jnp.where(vote < 0, -1.0, 1.0)
        return axis * s[:, None]

    x = disambiguate(x)
    z = disambiguate(z)
    y = jnp.cross(z, x)
    return jnp.stack([x, y, z], axis=-2)  # [M, 3(axes), 3(coords)]


def _soft_axis(c, nbins: int, wrap: bool):
    """Linear-interpolation split of continuous bin coordinate c in
    [0, nbins): returns ((lo_idx, w_lo), (hi_idx, w_hi)). Bin centers sit
    at i + 0.5; `wrap` wraps the neighbor bin (azimuth), else it clamps
    (mass merges into the edge bin, preserving the total)."""
    cc = c - 0.5
    lo = jnp.floor(cc)
    f = cc - lo
    lo_i = lo.astype(jnp.int32)
    hi_i = lo_i + 1
    if wrap:
        lo_i = jnp.mod(lo_i, nbins)
        hi_i = jnp.mod(hi_i, nbins)
    else:
        lo_i = jnp.clip(lo_i, 0, nbins - 1)
        hi_i = jnp.clip(hi_i, 0, nbins - 1)
    return (lo_i, 1.0 - f), (hi_i, f)


def shot_descriptors(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    kp_idx: jnp.ndarray,
    radius: float,
    k: int = 64,
    mask: Optional[jnp.ndarray] = None,
    approx: bool = False,
    soft: bool = False,
) -> jnp.ndarray:
    """SHOT descriptors [M, 352] for keypoints `kp_idx` of a cloud.

    Invalid keypoints (padded idx) simply produce whatever histogram their
    slot-0 gather gives — callers carry the keypoint validity mask.

    soft=True enables quadrilinear interpolation (azimuth wrapped,
    elevation/radial/cosine clamped) — each neighbor spreads its weight
    over 2^4 = 16 bins, PCL-style; this is what keeps the descriptor
    stable when noise moves points across bin boundaries. The A/B on the
    structured-scene generator (scripts/exp_shot_soft.py, r5) measures
    where hard binning's matching recall collapses vs soft.
    """
    kp = points[kp_idx]  # [M, 3]
    d, idx = knn(kp, points, k=k, ref_mask=mask, exclude_self=False,
                 approx=approx)
    valid = neighbor_validity(d, radius=radius)
    # Exclude the keypoint itself (distance ~0 would pollute azimuth).
    valid &= d > 1e-9

    lrf = local_reference_frames(points, kp_idx, idx, valid, d, radius)  # [M,3,3]
    nb = points[idx] - kp[:, None, :]  # [M, k, 3]
    local = jnp.einsum("mai,mki->mka", lrf, nb)  # [M, k, 3] coords in LRF(x,y,z)

    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    azimuth = jnp.arctan2(ly, lx)  # [-pi, pi]
    az_c = (azimuth + jnp.pi) / (2 * jnp.pi) * 8  # [0, 8)
    cos_t = jnp.einsum("mki,mi->mk", normals[idx], lrf[:, 2, :])  # vs LRF z
    cos_c = jnp.clip((cos_t + 1.0) * 0.5, 0.0, 1.0) * 11  # [0, 11]
    M = kp.shape[0]
    row = jnp.arange(M, dtype=jnp.int32)[:, None] * SHOT_DIM  # [M, 1]

    if not soft:
        az_bin = jnp.clip(az_c.astype(jnp.int32), 0, 7)
        el_bin = (lz >= 0).astype(jnp.int32)
        rad_bin = (d >= radius * 0.5).astype(jnp.int32)
        cos_bin = jnp.clip(cos_c.astype(jnp.int32), 0, 10)
        bins = ((az_bin * 2 + el_bin) * 2 + rad_bin) * 11 + cos_bin
        seg = (row + bins).reshape(-1)
        w = valid.astype(jnp.float32).reshape(-1)
        hist = jax.ops.segment_sum(
            w, seg, num_segments=M * SHOT_DIM).reshape(M, SHOT_DIM)
        return hist / jnp.maximum(
            jnp.linalg.norm(hist, axis=-1, keepdims=True), 1e-9)

    # Quadrilinear: continuous coordinates per axis. Elevation uses
    # sin(elevation) = lz / d (d > 0 for all valid neighbors); radial uses
    # d / radius — both mapped to [0, nbins).
    dn = jnp.maximum(d, 1e-9)
    el_c = jnp.clip((lz / dn + 1.0) * 0.5, 0.0, 1.0) * 2  # [0, 2]
    rad_c = jnp.clip(d / radius, 0.0, 1.0) * 2            # [0, 2]
    az_s = _soft_axis(az_c, 8, wrap=True)
    el_s = _soft_axis(el_c, 2, wrap=False)
    rad_s = _soft_axis(rad_c, 2, wrap=False)
    cos_s = _soft_axis(jnp.minimum(cos_c, 11.0 - 1e-4), 11, wrap=False)

    w0 = valid.astype(jnp.float32)
    segs, ws = [], []
    for az_i, az_w in az_s:
        for el_i, el_w in el_s:
            for rad_i, rad_w in rad_s:
                for cos_i, cos_w in cos_s:
                    bins = ((az_i * 2 + el_i) * 2 + rad_i) * 11 + cos_i
                    segs.append((row + bins).reshape(-1))
                    ws.append((w0 * az_w * el_w * rad_w * cos_w).reshape(-1))
    seg = jnp.concatenate(segs)
    w = jnp.concatenate(ws)
    hist = jax.ops.segment_sum(
        w, seg, num_segments=M * SHOT_DIM).reshape(M, SHOT_DIM)
    return hist / jnp.maximum(
        jnp.linalg.norm(hist, axis=-1, keepdims=True), 1e-9)
