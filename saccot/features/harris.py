"""Harris-3D keypoint detection, fixed-budget (the reference's alternate
detector: SURVEY.md section 2.1 lists "ISS (and/or Harris-3D)").

The 3-D Harris response follows the PCL formulation: for each point, the
covariance C of the *normals* over its neighborhood (the structure tensor
of the surface orientation field); response = det(C) - k * trace(C)^2.
High response marks corner-like regions where normals turn in every
direction. Same static-shape contract as ISS: NMS + top-k saliency into a
`max_keypoints` budget with a validity mask.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from saccot.features.iss import Keypoints
from saccot.features.neighbors import knn, neighbor_validity


def harris_keypoints(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    radius: float,
    nms_radius: float,
    max_keypoints: int,
    k: int = 32,
    harris_k: float = 0.04,
    min_neighbors: int = 5,
    mask: Optional[jnp.ndarray] = None,
) -> Keypoints:
    """Detect up to `max_keypoints` Harris-3D keypoints."""
    N = points.shape[0]
    d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask)
    valid = neighbor_validity(d, radius=radius)

    nb_normals = normals[idx]  # [N, k, 3]
    w = valid.astype(points.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu = jnp.sum(w[..., None] * nb_normals, axis=-2) / wsum
    c = nb_normals - mu[:, None, :]
    C = jnp.einsum(
        "nk,nki,nkj->nij", w, c, c, precision=jax.lax.Precision.HIGHEST
    ) / wsum[..., None]

    # The normal field lives on the unit sphere, so its scatter is
    # effectively rank-2 (det3 ~ 0 always); the corner measure is the 2-D
    # Harris response on the two dominant eigenvalues: normals turning in
    # two independent directions = corner, in one = edge, in none = plane.
    from saccot.features.eig3 import eigvals3_sym

    evals = eigvals3_sym(C)  # ascending (closed form; see features/eig3.py)
    l1, l2 = evals[..., 2], evals[..., 1]
    response = l1 * l2 - harris_k * (l1 + l2) ** 2

    keep = (jnp.sum(valid, axis=-1) >= min_neighbors) & (response > 0)
    if mask is not None:
        keep &= mask.astype(bool)

    # NMS identical in structure to ISS.
    d_nms, idx_nms = knn(points, points, k=k, query_mask=mask, ref_mask=mask, exclude_self=True)
    in_nms = neighbor_validity(d_nms, radius=nms_radius)
    nbr_resp = jnp.where(in_nms, response[idx_nms], -jnp.inf)
    keep &= response >= jnp.max(nbr_resp, axis=-1)

    score = jnp.where(keep, response, -1.0)
    top_s, top_i = lax.top_k(score, min(max_keypoints, N))
    if top_s.shape[0] < max_keypoints:
        pad = max_keypoints - top_s.shape[0]
        top_i = jnp.concatenate([top_i, jnp.zeros((pad,), top_i.dtype)])
        top_s = jnp.concatenate([top_s, jnp.full((pad,), -1.0, top_s.dtype)])
    return Keypoints(
        idx=top_i.astype(jnp.int32),
        xyz=points[top_i],
        saliency=top_s.astype(jnp.float32),
        valid=top_s > 0,
    )
