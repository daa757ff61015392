"""Batched ICP refinement: dense-cloud polish of a SAC-COT initial transform.

The reference pipeline (SURVEY.md section 1.2) stops at the coarse estimator;
users of PCL-based registration stacks conventionally follow it with
`pcl::IterativeClosestPoint` on the full clouds. This module is the
jitted equivalent: a fixed-iteration ICP whose inner correspondence search
is a blockwise brute-force nearest neighbor — the O(N*M) distance field as
one matmul (Gram trick) instead of a pointer-chasing kd-tree, batched over
scan pairs for free.

Variants:
  - point-to-point: weighted Horn alignment of matched pairs per iteration
    (engine/svd3.umeyama), re-fit from the original source cloud each step
    so rotation error never accumulates.
  - point-to-plane: Gauss-Newton on r_i = n_i . (T p_i - q_i) with the
    standard [p' x n, n] Jacobian, one branchless 6x6 solve per iteration,
    SE(3) update on the manifold (slam/se3.exp_se3). Needs target normals
    (features/normals.py estimates them if the sensor provides none).

Robustness: correspondences beyond `max_corr_dist` get weight 0, and an
optional trimmed-ICP fraction keeps only the closest `trim_frac` of matches
(top_k on negated distances — static shapes, no sorting of the full cloud).
All control flow is `lax.scan` over a fixed iteration budget; convergence
shows up as the RMSE trace flattening, never as data-dependent early exit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from saccot.engine.svd3 import transform_from_rt, umeyama
from saccot.slam import se3


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Static ICP configuration (hashable; folds into the jitted program)."""

    max_iters: int = 20
    # Matches farther than this get weight 0 (metric units; <=0 disables).
    max_corr_dist: float = 0.1
    # Trimmed ICP: keep only the closest trim_frac of matched points each
    # iteration (1.0 = classic ICP). Robust to partial overlap.
    trim_frac: float = 1.0
    # "point" (point-to-point, Horn) or "plane" (point-to-plane, GN).
    variant: str = "point"
    # Levenberg damping on the 6x6 point-to-plane normal equations.
    plane_damping: float = 1e-6
    # Source-block size for the blockwise NN search (memory knob only).
    nn_block_rows: int = 512

    def __post_init__(self):
        if not (0.0 < self.trim_frac <= 1.0):
            raise ValueError("trim_frac must be in (0, 1]")
        if self.variant not in ("point", "plane"):
            raise ValueError(f"unknown ICP variant: {self.variant!r}")
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")


class IcpResult(NamedTuple):
    T: jnp.ndarray            # [4, 4] refined transform (tgt <- src)
    R: jnp.ndarray            # [3, 3]
    t: jnp.ndarray            # [3]
    rmse: jnp.ndarray         # float32: weighted inlier RMSE evaluated at T
    rmse_trace: jnp.ndarray   # [max_iters] RMSE after each update; [-1] == rmse
    num_matched: jnp.ndarray  # int32: weight-positive matches under final T


def nearest_neighbors(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    mask_tgt: Optional[jnp.ndarray] = None,
    block_rows: int = 512,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brute-force NN of each src point in tgt, blockwise over src rows.

    src: [N, 3], tgt: [M, 3] -> (idx [N] int32, dist [N] float32). The
    [block, M] distance tile comes from one matmul (Gram trick); peak
    memory is O(block * M) however large N grows. Masked-out target points
    (padding) are never selected.
    """
    N = src.shape[0]
    M = tgt.shape[0]
    t2 = jnp.sum(tgt * tgt, axis=-1)  # [M]
    if mask_tgt is not None:
        # +inf distance for padded targets; keeps argmin off them.
        t2 = jnp.where(mask_tgt.astype(bool), t2, jnp.inf)

    bs = min(block_rows, N)
    nb = -(-N // bs)
    pad = nb * bs - N
    srcp = jnp.pad(src, ((0, pad), (0, 0)))

    def body(_, sb):  # sb: [bs, 3]
        s2 = jnp.sum(sb * sb, axis=-1)  # [bs]
        g = jnp.einsum("ik,jk->ij", sb, tgt, precision=lax.Precision.HIGHEST)
        d2 = s2[:, None] + t2[None, :] - 2.0 * g  # [bs, M]
        idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        dmin = jnp.take_along_axis(d2, idx[:, None], axis=-1)[:, 0]
        return None, (idx, jnp.sqrt(jnp.maximum(dmin, 0.0)))

    _, (idx, dist) = lax.scan(body, None, srcp.reshape(nb, bs, 3))
    return idx.reshape(-1)[:N], dist.reshape(-1)[:N]


def _match_weights(
    dist: jnp.ndarray,
    mask_src: Optional[jnp.ndarray],
    params: IcpParams,
) -> jnp.ndarray:
    """Per-match weights: source mask x distance gate x trim gate."""
    w = jnp.ones_like(dist)
    if mask_src is not None:
        w = w * mask_src.astype(dist.dtype)
    if params.max_corr_dist > 0:
        w = w * (dist < params.max_corr_dist).astype(dist.dtype)
    if params.trim_frac < 1.0:
        n_keep = max(3, int(round(params.trim_frac * dist.shape[0])))
        # Distance of the n_keep-th closest *eligible* match; ineligible
        # matches are pushed to +inf so they never define the cut.
        gated = jnp.where(w > 0, dist, jnp.inf)
        thresh = -lax.top_k(-gated, n_keep)[0][-1]
        w = w * (gated <= thresh).astype(dist.dtype)
    return w


def icp(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    params: IcpParams,
    T_init: Optional[jnp.ndarray] = None,
    mask_src: Optional[jnp.ndarray] = None,
    mask_tgt: Optional[jnp.ndarray] = None,
    tgt_normals: Optional[jnp.ndarray] = None,
) -> IcpResult:
    """Refine a rigid transform on full clouds. src [N,3], tgt [M,3].

    For variant="plane", `tgt_normals` [M, 3] (unit) is required.
    Jit-safe and vmap-safe; see `icp_batch` for the batched driver.
    """
    src = src.astype(jnp.float32)
    tgt = tgt.astype(jnp.float32)
    if T_init is None:
        T_init = jnp.eye(4, dtype=jnp.float32)
    T_init = T_init.astype(jnp.float32)
    if params.variant == "plane" and tgt_normals is None:
        raise ValueError("point-to-plane ICP requires tgt_normals")

    def step(T, _):
        R, t = T[:3, :3], T[:3, 3]
        # current transformed source (f32 pinned: TF32 would move points)
        x = jnp.matmul(src, R.T, precision=lax.Precision.HIGHEST) + t
        idx, dist = nearest_neighbors(
            x, tgt, mask_tgt=mask_tgt, block_rows=params.nn_block_rows
        )
        q = tgt[idx]
        w = _match_weights(dist, mask_src, params)
        wsum = jnp.maximum(jnp.sum(w), 1e-9)
        rmse = jnp.sqrt(jnp.sum(w * dist * dist) / wsum)

        if params.variant == "point":
            # Re-fit from the ORIGINAL source points against the current
            # matches: the solve is closed-form, so each iteration returns
            # the global optimum for its correspondence set.
            Rn, tn = umeyama(src, q, w=w)
            T_new = transform_from_rt(Rn, tn)
        else:
            n = tgt_normals[idx]  # [N, 3]
            r = jnp.sum(n * (x - q), axis=-1)  # signed plane residual
            # Twist order matches se3.exp_se3: xi = (v, w), so the Jacobian
            # columns are [dr/dv, dr/dw] = [n, x' x n].
            J = jnp.concatenate([n, jnp.cross(x, n)], axis=-1)  # [N, 6]
            A = jnp.einsum("ni,nj->ij", w[:, None] * J, J,
                           precision=lax.Precision.HIGHEST)
            b = -jnp.einsum("ni,n->i", J, w * r, precision=lax.Precision.HIGHEST)
            A = A + params.plane_damping * jnp.eye(6, dtype=A.dtype)
            xi = jnp.linalg.solve(A, b)
            # Guard: a degenerate normal field can still blow up the solve;
            # keep the previous T on non-finite updates (branchless).
            ok = jnp.all(jnp.isfinite(xi))
            xi = jnp.where(ok, xi, jnp.zeros_like(xi))
            T_new = jnp.matmul(se3.exp_se3(xi), T, precision=lax.Precision.HIGHEST)
        # <3 effective matches: the problem is unconstrained — hold T.
        keep = jnp.sum(w) >= 3.0
        T_new = jnp.where(keep, T_new, T)
        n_matched = jnp.sum(w > 0).astype(jnp.int32)
        return T_new, (T, rmse, n_matched)

    # rmse inside `step` evaluates the transform *entering* the step, so one
    # extra evaluation-only iteration (whose update is discarded) makes the
    # reported rmse/num_matched describe T_final itself, not the
    # second-to-last iterate. Ts[i] is the transform after i updates.
    _, (Ts, rmse_trace, matched_trace) = lax.scan(
        step, T_init, None, length=params.max_iters + 1
    )
    T_final = Ts[params.max_iters]
    return IcpResult(
        T=T_final,
        R=T_final[:3, :3],
        t=T_final[:3, 3],
        rmse=rmse_trace[params.max_iters],
        rmse_trace=rmse_trace[1:],
        num_matched=matched_trace[params.max_iters],
    )


def icp_batch(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    params: IcpParams,
    T_init: Optional[jnp.ndarray] = None,
    mask_src: Optional[jnp.ndarray] = None,
    mask_tgt: Optional[jnp.ndarray] = None,
    tgt_normals: Optional[jnp.ndarray] = None,
) -> IcpResult:
    """vmap of `icp` over a leading batch of scan pairs ([B, N, 3] etc.).

    The batch axis is the same unit the DP sweep shards over devices, so a
    sweep can refine every registered pair in one compiled program.
    """
    B = src.shape[0]
    if T_init is None:
        T_init = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    if mask_src is None:
        mask_src = jnp.ones(src.shape[:2], jnp.float32)
    if mask_tgt is None:
        mask_tgt = jnp.ones(tgt.shape[:2], jnp.float32)
    if params.variant == "plane":
        fn = lambda s, t, Ti, ms, mt, nn: icp(
            s, t, params, T_init=Ti, mask_src=ms, mask_tgt=mt, tgt_normals=nn
        )
        return jax.vmap(fn)(src, tgt, T_init, mask_src, mask_tgt, tgt_normals)
    fn = lambda s, t, Ti, ms, mt: icp(
        s, t, params, T_init=Ti, mask_src=ms, mask_tgt=mt
    )
    return jax.vmap(fn)(src, tgt, T_init, mask_src, mask_tgt)
