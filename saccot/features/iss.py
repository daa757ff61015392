"""ISS (Intrinsic Shape Signatures) keypoint detection, fixed-budget.

Replaces `pcl::ISSKeypoint3D` (SURVEY.md section 2.1, "Keypoint detection").
Per point: eigenvalues l1 >= l2 >= l3 of the distance-weighted neighborhood
scatter matrix; a point is salient iff l2/l1 < gamma21 and l3/l2 < gamma32;
saliency value is l3; non-maximum suppression keeps points whose l3 is the
max over their NMS neighborhood. All stages are batched tensor ops; the
data-dependent "how many keypoints" becomes a fixed `max_keypoints` budget
selected by `top_k` saliency with a validity mask — the same static-shape
contract used everywhere in this framework.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from saccot.features.neighbors import knn, neighbor_validity
from saccot.features.normals import neighborhood_covariance


class Keypoints(NamedTuple):
    idx: jnp.ndarray       # [max_keypoints] int32 indices into the cloud
    xyz: jnp.ndarray       # [max_keypoints, 3]
    saliency: jnp.ndarray  # [max_keypoints] float32 (l3)
    valid: jnp.ndarray     # [max_keypoints] bool


def iss_keypoints(
    points: jnp.ndarray,
    salient_radius: float,
    nms_radius: float,
    max_keypoints: int,
    gamma21: float = 0.975,
    gamma32: float = 0.975,
    k: int = 32,
    min_neighbors: int = 5,
    mask: Optional[jnp.ndarray] = None,
    neighbors: Optional[tuple] = None,
) -> Keypoints:
    """Detect up to `max_keypoints` ISS keypoints.

    `k` caps the neighborhood gather (neighbors beyond `salient_radius` are
    masked); radii follow the paper's mesh-resolution-multiples convention.
    `neighbors`: optional precomputed self-kNN (dists [N, >=k], idx,
    including self) shared with the normal stage — saliency and NMS both
    consume the SAME neighbor set (the NMS pass masks the self slot instead
    of running a second full N^2 kNN; r4: two of the three full kNN passes
    per scan removed).
    """
    N = points.shape[0]
    # NMS gets one extra neighbor column when the shared set has it: its
    # self slot is masked below, so k+1 columns keep the effective non-self
    # neighborhood at k — matching the semantics of a dedicated
    # exclude_self kNN (k columns would leave NMS with only k-1 non-self
    # comparisons).
    k_nms = min(k + 1, N)
    if neighbors is None:
        d_nms, idx_nms = knn(points, points, k=k_nms, query_mask=mask,
                             ref_mask=mask, exclude_self=False)
        d, idx = d_nms[:, :k], idx_nms[:, :k]
    else:
        k_nms = min(k_nms, neighbors[0].shape[1])
        d_nms, idx_nms = neighbors[0][:, :k_nms], neighbors[1][:, :k_nms]
        d, idx = neighbors[0][:, :k], neighbors[1][:, :k]
    valid = neighbor_validity(d, radius=salient_radius)

    # ISS weights: 1 / local density — approximated as inverse neighbor
    # count of each neighbor; the standard simplification w=1 also works and
    # is what we use (recall parity, not PCL bit-parity, is the bar).
    cov, _ = neighborhood_covariance(points, idx, valid)
    from saccot.features.eig3 import eigvals3_sym

    evals = eigvals3_sym(cov)  # ascending: [l3, l2, l1]; closed form
    # (features/eig3.py) instead of iterative batched eigvalsh.
    l3, l2, l1 = evals[..., 0], evals[..., 1], evals[..., 2]

    n_ok = jnp.sum(valid, axis=-1) >= min_neighbors
    eps = 1e-12
    salient = (
        (l2 / jnp.maximum(l1, eps) < gamma21)
        & (l3 / jnp.maximum(l2, eps) < gamma32)
        & (l3 > eps)
        & n_ok
    )
    if mask is not None:
        salient &= mask.astype(bool)

    # NMS: keep i iff l3_i >= l3_j for all non-self neighbors j within
    # nms_radius (the self slot — distance 0, same index — is masked out
    # of the shared neighbor set).
    rows = jnp.arange(N, dtype=idx_nms.dtype)[:, None]
    in_nms = neighbor_validity(d_nms, radius=nms_radius) & (idx_nms != rows)
    nbr_sal = jnp.where(in_nms, l3[idx_nms], -jnp.inf)  # [N, k_nms]
    is_max = l3 >= jnp.max(nbr_sal, axis=-1)
    keep = salient & is_max

    score = jnp.where(keep, l3, -1.0)
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
