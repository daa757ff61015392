"""The SAC-COT estimator — jitted end-to-end per-pair registration.

This is the API centerpiece (SURVEY.md section 2.3): the jitted
equivalent of the reference's `sac_cot(correspondences, params) -> T,
inliers` entry point (SURVEY.md section 1.2, L4). One trace compiles the
whole estimator — blockwise compatibility degrees, triangle
ranking/sampling, batched 3-point SVD, hypothesis scoring, argmax, and a
branchless inlier re-fit — into a single XLA program with static shapes
throughout. The dense N x N compatibility matrix is never materialized (see
engine/compat.py). Every stage is plain XLA except the O(N^2) degree
stage, which runs a Triton kernel when the program is compiled for a CUDA
GPU and the XLA blockwise loop everywhere else (`_degrees`).

Two execution modes share this code path:

- single-device / vmapped batch: `corr_axis=None`; P, Q are the full [N, 3]
  correspondence arrays.
- correspondence-axis sharded (SP, SURVEY.md section 2.2): called inside
  `shard_map` with `corr_axis` naming the mesh axis; P, Q are each device's
  [N/d, 3] shard. One [N, 3] point all-gather feeds the (replicated) pool
  stage; degree rows, hypothesis scoring, and refinement stay sharded with
  psum reductions. Interconnect traffic is O(N), never O(N^2).

Correspondences are taken as input (points plus a validity mask for
padding), exactly like the reference's estimator layer: upstream
keypoint/descriptor/matching stages live in `saccot.features` /
`saccot.match`, and external correspondences (e.g. FCGF-style learned
features for the 3DMatch config) plug in directly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from saccot.engine import compat as compat_mod
from saccot.engine import score as score_mod
from saccot.engine import triangles as tri_mod
from saccot.engine.svd3 import umeyama, transform_from_rt
from saccot.utils.params import SacCotParams


class RegistrationResult(NamedTuple):
    R: jnp.ndarray            # [3, 3]
    t: jnp.ndarray            # [3]
    T: jnp.ndarray            # [4, 4]
    inliers: jnp.ndarray      # [N] bool (the local shard under corr_axis)
    num_inliers: jnp.ndarray  # int32 scalar (global under corr_axis)
    best_score: jnp.ndarray   # float32 scalar (pre-refinement hypothesis score)
    num_valid_triangles: jnp.ndarray  # int32 scalar: valid entries in the pool
    success: jnp.ndarray      # bool scalar: at least one valid triangle existed


def _degrees(P, Q, P_full, Q_full, params, row_offset, m, m_full):
    """Weighted degrees of the local rows against all columns.

    The compilation platform picks the implementation: the Triton kernel
    (kernels/compat.py) on CUDA, the XLA blockwise loop elsewhere. Both
    have the same contract.
    """
    from saccot.kernels.compat import degrees_triton

    def kernel(P, Q, P_full, Q_full, row_offset, m, m_full):
        return degrees_triton(
            P, Q, P_full, Q_full, params, row_offset=row_offset,
            mask_rows=m, mask_cols=m_full,
        )

    def plain(P, Q, P_full, Q_full, row_offset, m, m_full):
        return compat_mod.degrees(
            P, Q, P_full, Q_full, params, row_offset=row_offset,
            mask_rows=m, mask_cols=m_full,
            block_rows=min(params.degree_block_rows, P.shape[0]),
        )

    return lax.platform_dependent(
        P, Q, P_full, Q_full, jnp.asarray(row_offset, jnp.int32), m, m_full,
        cuda=kernel, default=plain,
    )


def _register_pair(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    params: SacCotParams,
    corr_axis: Optional[str] = None,
    hyp_axis: Optional[str] = None,
) -> RegistrationResult:
    P = P.astype(jnp.float32)
    Q = Q.astype(jnp.float32)
    N_local = P.shape[0]
    m = jnp.ones((N_local,), jnp.float32) if mask is None else mask.astype(jnp.float32)

    if corr_axis is not None:
        # One tiny all-gather of raw points; everything quadratic stays sharded.
        P_full = lax.all_gather(P, corr_axis, tiled=True)
        Q_full = lax.all_gather(Q, corr_axis, tiled=True)
        m_full = lax.all_gather(m, corr_axis, tiled=True)
        row_offset = lax.axis_index(corr_axis) * N_local
    else:
        P_full, Q_full, m_full = P, Q, m
        row_offset = 0

    with jax.named_scope("saccot_degrees"):
        if corr_axis is not None and params.ring_compat:
            from saccot.dist.ring import degrees_ring
            deg_local = degrees_ring(P, Q, params, corr_axis, mask_loc=m)
        else:
            deg_local = _degrees(
                P, Q, P_full, Q_full, params, row_offset, m, m_full,
            )
        deg_full = (
            lax.all_gather(deg_local, corr_axis, tiled=True)
            if corr_axis is not None
            else deg_local
        )

    with jax.named_scope("saccot_triangles"):
        pool = tri_mod.triangle_pool_from_points(
            P_full, Q_full, deg_full, params, mask=m_full,
            anchor_axis=corr_axis,
        )

    if hyp_axis is not None:
        # TP (SURVEY.md section 2.2): shard the K hypotheses over a mesh
        # axis — each device solves and scores its K/d slice of the
        # (replicated) triangle pool; the best hypothesis is reduced
        # globally below, and the refine tail stays replicated.
        d_h = lax.axis_size(hyp_axis)
        K = pool.scores.shape[0]
        if K % d_h:
            raise ValueError(
                f"max_hypotheses={K} must be divisible by the hyp axis size {d_h}"
            )
        k_loc = K // d_h
        k0 = lax.axis_index(hyp_axis) * k_loc
        triples = lax.dynamic_slice_in_dim(pool.triples, k0, k_loc, axis=0)
        hyp_valid = lax.dynamic_slice_in_dim(pool.valid, k0, k_loc, axis=0)
    else:
        triples, hyp_valid = pool.triples, pool.valid

    with jax.named_scope("saccot_svd3"):
        R, t = umeyama(P_full[triples], Q_full[triples])  # [K, 3, 3] gathers

    with jax.named_scope("saccot_score"):
        scores, counts = score_mod.score_hypotheses(
            R, t, P, Q, params.inlier_tau, mask=m, mode=params.scoring,
            block_k=params.score_block_k, axis_name=corr_axis,
        )
        scores = jnp.where(hyp_valid, scores, -1.0)
        best = jnp.argmax(scores)
        best_score = scores[best]
        Rb, tb = R[best], t[best]
        if hyp_axis is not None:
            # Global best across hypothesis shards: gather each shard's
            # champion (tiny: d_h scalars + transforms) and argmax. Shards
            # are gathered in axis order, so the combined argmax keeps the
            # single-device first-maximum tie-break exactly.
            g_scores = lax.all_gather(best_score, hyp_axis)  # [d_h]
            g_R = lax.all_gather(Rb, hyp_axis)               # [d_h, 3, 3]
            g_t = lax.all_gather(tb, hyp_axis)               # [d_h, 3]
            g_best = jnp.argmax(g_scores)
            best_score = g_scores[g_best]
            Rb, tb = g_R[g_best], g_t[g_best]

    with jax.named_scope("saccot_refine"):
        inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)
        for _ in range(params.refine_iters):
            w = inl.astype(jnp.float32) * m
            n = jnp.sum(w)
            if corr_axis is not None:
                n = lax.psum(n, corr_axis)
            Rf, tf = umeyama(P, Q, w=w, axis_name=corr_axis)
            # Branchless guard: keep the previous fit when <3 inliers.
            keep = n >= 3.0
            Rb = jnp.where(keep, Rf, Rb)
            tb = jnp.where(keep, tf, tb)
            inl = score_mod.inlier_mask(Rb, tb, P, Q, params.inlier_tau, mask=m)

    success = jnp.any(pool.valid)
    eye = jnp.eye(3, dtype=jnp.float32)
    Rb = jnp.where(success, Rb, eye)
    tb = jnp.where(success, tb, jnp.zeros((3,), jnp.float32))
    inl = inl & success
    n_inl = jnp.sum(inl).astype(jnp.int32)
    if corr_axis is not None:
        n_inl = lax.psum(n_inl, corr_axis)
    return RegistrationResult(
        R=Rb,
        t=tb,
        T=transform_from_rt(Rb, tb),
        inliers=inl,
        num_inliers=n_inl,
        best_score=best_score,
        num_valid_triangles=jnp.sum(pool.valid).astype(jnp.int32),
        success=success,
    )


@functools.partial(jax.jit, static_argnames=("params",))
def register_pair(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
) -> RegistrationResult:
    """Register one correspondence set: (P, Q, mask) -> best rigid transform.

    Args:
      P, Q: [N, 3] matched source/target keypoints (row i of P corresponds
        to row i of Q).
      params: static estimator configuration.
      mask: optional [N] validity mask for padded correspondences.
    """
    return _register_pair(P, Q, mask, params)


def register_pair_sp(
    P_shard: jnp.ndarray,
    Q_shard: jnp.ndarray,
    params: SacCotParams,
    corr_axis: str,
    mask_shard: Optional[jnp.ndarray] = None,
    hyp_axis: Optional[str] = None,
) -> RegistrationResult:
    """Correspondence-axis-sharded estimator body, for use inside shard_map.

    Each device passes its [N/d, 3] shard; the returned `inliers` is the
    local shard (stitch with out_specs P(corr_axis)); scalar fields are
    replicated/global. Pass `hyp_axis` to additionally shard the hypothesis
    pool over a second mesh axis (the TP analog, SURVEY.md section 2.2).
    """
    return _register_pair(
        P_shard, Q_shard, mask_shard, params, corr_axis=corr_axis,
        hyp_axis=hyp_axis,
    )


def register_pair_tp(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    hyp_axis: str,
    mask: Optional[jnp.ndarray] = None,
) -> RegistrationResult:
    """Hypothesis-axis (TP) sharded estimator body, for use inside shard_map.

    Points are replicated on every device; the K-hypothesis pool is sliced
    K/d per device, solve+scoring run on the slice, and the global best is
    argmax-reduced via a tiny all_gather (SURVEY.md section 2.2, TP row).
    All returned fields are replicated.
    """
    return _register_pair(P, Q, mask, params, hyp_axis=hyp_axis)


@functools.partial(jax.jit, static_argnames=("params",))
def register_batch(
    P: jnp.ndarray,
    Q: jnp.ndarray,
    params: SacCotParams,
    mask: Optional[jnp.ndarray] = None,
) -> RegistrationResult:
    """vmap of `register_pair` over a leading batch axis of scan pairs.

    P, Q: [B, N, 3]; mask: optional [B, N]. This is the unit the data-parallel
    sweep shards over devices (SURVEY.md section 2.2, DP row). Jitted at the
    API boundary: the eager op-by-op vmap dispatch is pathologically slow on
    every backend, and one trace per (shape, params) is the semantics every
    caller wants anyway.
    """
    if mask is None:
        return jax.vmap(lambda p, q: _register_pair(p, q, None, params))(P, Q)
    return jax.vmap(lambda p, q, mk: _register_pair(p, q, mk, params))(P, Q, mask)
