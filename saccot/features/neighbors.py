"""k-nearest-neighbor search as blocked matmuls.

Replaces the reference's PCL kd-trees (SURVEY.md section 2.1: keypoints,
descriptors, and matching all sit on `pcl::KdTreeFLANN`). Trees are
pointer-chasing structures with data-dependent control flow — the jitted
equivalent is a blocked brute-force distance GEMM with `lax.top_k` per row
block. At the N this pipeline runs (up to ~64k points after voxel
downsampling) the N^2 distance work is dense tensor math, and the
row-blocked scan keeps peak memory at O(block * N).

All outputs are fixed-shape [*, k] with invalid slots marked by +inf
distance (and index 0) — the padding convention consumed by the feature
modules.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

BIG = 1e30


def knn(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    k: int,
    query_mask: Optional[jnp.ndarray] = None,
    ref_mask: Optional[jnp.ndarray] = None,
    exclude_self: bool = False,
    block_rows: int = 1024,
    approx: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest refs for each query point.

    Args:
      query: [M, 3]; ref: [N, 3].
      k: neighbor count (static).
      query_mask/ref_mask: optional validity masks for padded rows.
      exclude_self: drop the i==j pair (for self-kNN where query is ref).
      block_rows: query rows per scan step.
      approx: use `lax.approx_max_k` for the per-row selection (recall
        target ~99% where the backend approximates; exact elsewhere).
        Right for *neighborhood sampling*
        consumers (normals/saliency/descriptor supports, which are
        radius-masked statistical aggregates); keep exact selection for
        anything that needs the true k-NN set.

    Returns:
      (dists [M, k], idx [M, k]): Euclidean distances ascending; padded /
      missing neighbors have dist >= BIG (1e30) and idx 0.
    """
    M = query.shape[0]
    N = ref.shape[0]
    k = min(k, N)
    nb = -(-M // block_rows)
    Mpad = nb * block_rows

    qp = jnp.pad(query, ((0, Mpad - M), (0, 0)))
    qm = jnp.ones((M,), jnp.float32) if query_mask is None else query_mask.astype(jnp.float32)
    qm = jnp.pad(qm, (0, Mpad - M))
    rm = jnp.ones((N,), bool) if ref_mask is None else ref_mask.astype(bool)

    r2 = jnp.sum(ref * ref, axis=-1)

    def body(_, blk):
        qb, mb, start = blk  # [bs,3], [bs], scalar
        q2 = jnp.sum(qb * qb, axis=-1)
        g = jnp.einsum("ik,jk->ij", qb, ref, precision=lax.Precision.HIGHEST)
        d2 = jnp.maximum(q2[:, None] + r2[None, :] - 2.0 * g, 0.0)  # [bs, N]
        d2 = jnp.where(rm[None, :], d2, BIG)
        if exclude_self:
            rows = start + jnp.arange(qb.shape[0])
            cols = jnp.arange(N)
            d2 = jnp.where(rows[:, None] == cols[None, :], BIG, d2)
        d2 = jnp.where(mb[:, None] > 0, d2, BIG)
        if k == 1:
            # Nearest-neighbor-only (mesh resolution): a plain min/argmin
            # beats the general top_k lowering; argmin's lowest-index
            # tie-break matches top_k's exactly.
            neg = -jnp.min(d2, axis=1, keepdims=True)
            idx = jnp.argmin(d2, axis=1, keepdims=True)
        elif approx:
            neg, idx = lax.approx_max_k(-d2, k)
        else:
            neg, idx = lax.top_k(-d2, k)
        return None, (jnp.sqrt(jnp.maximum(-neg, 0.0)), idx.astype(jnp.int32))

    starts = jnp.arange(nb) * block_rows
    _, (d, i) = lax.scan(
        body, None,
        (qp.reshape(nb, block_rows, 3), qm.reshape(nb, block_rows), starts),
    )
    d = d.reshape(Mpad, k)[:M]
    i = i.reshape(Mpad, k)[:M]
    # Normalize padding: anything at/above BIG distance points at index 0.
    invalid = d >= jnp.sqrt(BIG) - 1.0
    return jnp.where(invalid, BIG, d), jnp.where(invalid, 0, i)


def neighbor_validity(dists: jnp.ndarray, radius: Optional[float] = None) -> jnp.ndarray:
    """Boolean mask of usable neighbor slots ([..., k])."""
    ok = dists < jnp.sqrt(BIG) - 1.0
    if radius is not None:
        ok &= dists < radius
    return ok
