"""Surface-normal estimation: batched neighborhood PCA.

Replaces `pcl::NormalEstimation` (SURVEY.md section 2.1, "Preprocess"): each
point's normal is the least-significant eigenvector of its k-neighborhood
covariance. The whole cloud is one batched [N, 3, 3] `eigh` — no per-point
loop, no tree. Orientation is disambiguated toward a viewpoint (sensor
origin by default), matching the usual convention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from saccot.features.neighbors import knn, neighbor_validity


def neighborhood_covariance(
    points: jnp.ndarray,
    idx: jnp.ndarray,
    valid: jnp.ndarray,
    weights: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted covariance of gathered neighborhoods.

    points [N, 3]; idx [M, k]; valid [M, k] -> (cov [M, 3, 3], centroid [M, 3]).
    """
    nb = points[idx]  # [M, k, 3]
    w = valid.astype(points.dtype)
    if weights is not None:
        w = w * weights
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu = jnp.sum(w[..., None] * nb, axis=-2) / wsum  # [M, 3]
    c = nb - mu[:, None, :]
    cov = jnp.einsum(
        "mk,mki,mkj->mij", w, c, c, precision=jax.lax.Precision.HIGHEST
    ) / wsum[..., None]
    return cov, mu


def estimate_normals(
    points: jnp.ndarray,
    k: int = 16,
    mask: Optional[jnp.ndarray] = None,
    viewpoint: Optional[jnp.ndarray] = None,
    neighbors: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> jnp.ndarray:
    """Per-point unit normals [N, 3] from k-NN PCA, viewpoint-oriented.

    `neighbors`: optional precomputed self-kNN (dists [N, >=k], idx) —
    the pipeline computes one shared kNN for normals + ISS instead of
    three full N^2 passes;
    ascending-sorted columns slice exactly to any smaller k.
    """
    if neighbors is None:
        d, idx = knn(points, points, k=k, query_mask=mask, ref_mask=mask,
                     exclude_self=False)
    else:
        d, idx = neighbors[0][:, :k], neighbors[1][:, :k]
    valid = neighbor_validity(d)
    cov, _ = neighborhood_covariance(points, idx, valid)
    # Closed-form smallest eigenvector (features/eig3.py) instead of an
    # iterative batched eigh.
    from saccot.features.eig3 import smallest_eigvec3_sym

    n = smallest_eigvec3_sym(cov)  # [N, 3]
    vp = jnp.zeros((3,), points.dtype) if viewpoint is None else viewpoint
    to_vp = vp[None, :] - points
    sign = jnp.where(jnp.sum(n * to_vp, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    n = n * sign
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
