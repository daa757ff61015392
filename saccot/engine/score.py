"""Hypothesis scoring: vectorized inlier counting over K hypotheses x N points.

Replaces the reference's per-hypothesis CPU loop (`countInliers`,
SURVEY.md section 2.1) with a batched transform-residual-reduce: the
[K, N, 3] residual tensor is computed blockwise over the hypothesis axis so
peak memory stays bounded at `block_k * N * 3` regardless of K. XLA fuses
each block's transform-residual-count into one reduction on every backend.
Every f32 contraction here is pinned to Precision.HIGHEST: on a GPU an
unpinned f32 matmul may run in TF32 and move the inlier decision.

Scoring modes (params.scoring):
  "count":    number of i with ||R p_i + t - q_i|| < tau        (reference behavior)
  "weighted": sum_i max(0, 1 - d_i / tau)   (soft MSAC-style, same argmax
              landscape for clean data, more stable near the threshold)
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def score_hypotheses(
    R: jnp.ndarray,
    t: jnp.ndarray,
    P: jnp.ndarray,
    Q: jnp.ndarray,
    tau: float,
    mask: Optional[jnp.ndarray] = None,
    mode: str = "count",
    block_k: int = 256,
    axis_name: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Score K rigid hypotheses against N correspondences.

    Args:
      R: [K, 3, 3], t: [K, 3] hypothesis transforms.
      P, Q: [N, 3] correspondence points.
      tau: inlier distance threshold.
      mask: optional [N] validity mask (padding).
      mode: "count" or "weighted".
      block_k: hypothesis-axis block size (memory bound, not semantics).
      axis_name: if set, P/Q are this device's shard of the correspondence
        axis; per-hypothesis partial sums are psum-reduced across the mesh
        axis (the SP scoring path, SURVEY.md section 2.2).

    Returns:
      (scores [K] float32, counts [K] int32). For mode="count",
      scores == counts as float.
    """
    K = R.shape[0]
    m = None if mask is None else mask.astype(P.dtype)

    nblocks = -(-K // block_k)
    Kpad = nblocks * block_k
    if Kpad != K:
        R = jnp.concatenate([R, jnp.tile(jnp.eye(3, dtype=R.dtype)[None], (Kpad - K, 1, 1))])
        t = jnp.concatenate([t, jnp.zeros((Kpad - K, 3), t.dtype)])
    Rb = R.reshape(nblocks, block_k, 3, 3)
    tb = t.reshape(nblocks, block_k, 3)

    def body(carry, rt):
        Rk, tk = rt
        # [bk, N, 3] = P @ Rk^T + tk - Q, residual norms reduced over N.
        x = (
            jnp.einsum("kij,nj->kni", Rk, P, precision=jax.lax.Precision.HIGHEST)
            + tk[:, None, :]
            - Q[None, :, :]
        )
        d2 = jnp.sum(x * x, axis=-1)  # [bk, N]
        inl = (d2 < tau * tau).astype(P.dtype)
        wgt = jnp.maximum(0.0, 1.0 - jnp.sqrt(jnp.maximum(d2, 0.0)) / tau)
        if m is not None:
            inl = inl * m[None, :]
            wgt = wgt * m[None, :]
        return carry, (jnp.sum(inl, axis=-1), jnp.sum(wgt, axis=-1))

    _, (counts, weights) = lax.scan(body, None, (Rb, tb))
    counts = counts.reshape(Kpad)[:K]
    weights = weights.reshape(Kpad)[:K]
    if axis_name is not None:
        counts = lax.psum(counts, axis_name)
        weights = lax.psum(weights, axis_name)
    scores = weights if mode == "weighted" else counts
    return scores.astype(jnp.float32), counts.astype(jnp.int32)


def inlier_mask(
    R: jnp.ndarray,
    t: jnp.ndarray,
    P: jnp.ndarray,
    Q: jnp.ndarray,
    tau: float,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Boolean inlier mask of a single hypothesis. R [3,3], t [3] -> [N]."""
    x = jnp.matmul(P, R.T, precision=jax.lax.Precision.HIGHEST)
    d = jnp.linalg.norm(x + t - Q, axis=-1)
    inl = d < tau
    if mask is not None:
        inl = inl & mask.astype(bool)
    return inl
