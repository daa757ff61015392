"""Sharded bundle adjustment: Schur-complement Gauss-Newton, matrix-free PCG.

The distributed-BA capability from the north star (SURVEY.md sections 2.2,
3.5): joint refinement of scan poses T_i and map landmarks l_k from
point-to-point observations, scaled by sharding the *landmark* axis across
the device mesh. Each device eliminates its own landmark blocks locally
(3x3 inverses — trivially parallel) and the reduced camera system
S = H_pp - W H_ll^{-1} W^T is solved by matrix-free preconditioned
conjugate gradients: S is never materialized — each CG matvec streams
through the local observation slots (O(L*G) work) and one `psum` of a
[M, 6] vector reduces it globally. Per GN iteration the interconnect traffic is
therefore one [M, 6, 6] block-diagonal reduction (the block-Jacobi
preconditioner) plus one [M, 6] vector per CG step — *independent of both
the landmark count and of M^2*, which is what lets M grow to hundreds or
thousands of poses where the previous dense [6M, 6M] solve (O(M^3) flops,
O(M^2) memory and comm) stopped scaling.

Layout: observations are grouped by landmark with a fixed per-landmark
budget G (padded, weight 0) — the static-shape convention; a landmark's
whole group lives on one device, which is what makes local elimination
exact. Multi-view tracks (G >= 3 distinct poses observing one physical
point) are what distinguishes this from a re-weighted pairwise solve; the
track association lives in slam/frontend.correspondences_to_ba.

Residual (world-frame point-to-point):
    r = R_i z + t_i - l_k          for observation (pose i, landmark k, z)
Jacobians (right perturbation T <- T exp(v, w)):
    d r / d v = R_i,   d r / d w = -R_i [z]_x,   d r / d l = -I

All block contractions run at Precision.HIGHEST: at a reduced default f32
dot precision (TF32 on a GPU) the normal equations lose enough digits that
Gauss-Newton steps stop decreasing the cost (the LM guard then silently
rejects every iteration).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from saccot.slam import se3

# f32-accurate contractions for the tiny (3/6-dim) normal-equation blocks;
# see module docstring.
_es = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)


class BAProblem(NamedTuple):
    poses: jnp.ndarray      # [M, 4, 4]
    landmarks: jnp.ndarray  # [L, 3] (the local shard under sharding)
    obs_pose: jnp.ndarray   # [L, G] int32 pose index per observation slot
    obs_z: jnp.ndarray      # [L, G, 3] observed point in scan frame
    obs_w: jnp.ndarray      # [L, G] weights; 0 marks padding


class BAResult(NamedTuple):
    poses: jnp.ndarray
    landmarks: jnp.ndarray
    initial_cost: jnp.ndarray  # global under sharding
    final_cost: jnp.ndarray
    lam: jnp.ndarray = 0.0     # final LM damping (checkpoint for resume)


def _residuals(poses, landmarks, prob: BAProblem):
    """r [L, G, 3] and rotations gathered per slot."""
    R = poses[prob.obs_pose][..., :3, :3]  # [L, G, 3, 3]
    t = poses[prob.obs_pose][..., :3, 3]   # [L, G, 3]
    world = _es("lgij,lgj->lgi", R, prob.obs_z) + t
    r = world - landmarks[:, None, :]
    return r, R


def ba_cost(poses, landmarks, prob: BAProblem, axis_name=None,
            robust_delta: Optional[float] = None):
    """Total (optionally Huber-robustified) weighted squared residual.

    With robust_delta set, per-observation cost is rho(|r|) = |r|^2 below
    delta and 2*delta*|r| - delta^2 above — the loss whose IRLS weight is
    min(1, delta/|r|) (see bundle_adjust). Track association at high
    outlier rates inevitably admits some contaminated tracks; the linear
    tail stops them from steering the solve.
    """
    r, _ = _residuals(poses, landmarks, prob)
    d2 = jnp.sum(r * r, axis=-1)
    if robust_delta is not None:
        d = jnp.sqrt(jnp.maximum(d2, 1e-24))
        rho = jnp.where(
            d <= robust_delta, d2,
            2.0 * robust_delta * d - robust_delta * robust_delta,
        )
    else:
        rho = d2
    c = jnp.sum(prob.obs_w * rho)
    if axis_name is not None:
        c = lax.psum(c, axis_name)
    return c


def _gn_system(poses, landmarks, prob: BAProblem, num_poses: int,
               lm_damping: float, robust_delta: Optional[float] = None):
    """One device's contribution to the reduced camera system, block form.

    Returns (Hpp [M, 6, 6] block-diagonal pose Hessian, b_red [M, 6] reduced
    gradient, Fdiag [M, 6, 6] same-slot Schur fill-in for the block-Jacobi
    preconditioner, Hll_inv [L, 3, 3], bl [L, 3], W [L, G, 6, 3]) — the last
    three are kept for the matrix-free matvec and back-substitution. Nothing
    [M, M]-shaped is ever built.
    """
    M = num_poses
    r, R = _residuals(poses, landmarks, prob)  # [L,G,3], [L,G,3,3]
    w = prob.obs_w  # [L, G]
    if robust_delta is not None:
        # Huber IRLS: observations past delta get weight delta/|r| — fixed
        # within the iteration, so the exact landmark elimination below
        # stays valid.
        d = jnp.sqrt(jnp.maximum(jnp.sum(r * r, axis=-1), 1e-24))
        w = w * jnp.minimum(1.0, robust_delta / d)

    # Pose Jacobian A = [R | -R [z]x]  -> [L, G, 3, 6]
    zhat = se3.hat(prob.obs_z)  # [L, G, 3, 3]
    A = jnp.concatenate([R, -_es("lgij,lgjk->lgik", R, zhat)], axis=-1)
    # Landmark Jacobian B = -I (constant).

    wA = w[..., None, None] * A
    # H_pp diagonal blocks: sum_o A^T w A  keyed by pose. [L*G] scatter.
    AtA = _es("lgai,lgaj->lgij", A, wA)  # [L, G, 6, 6]
    Atr = _es("lgai,lga->lgi", A, w[..., None] * r)  # [L, G, 6]
    pose_ids = prob.obs_pose.reshape(-1)
    Hpp = jax.ops.segment_sum(AtA.reshape(-1, 6, 6), pose_ids, num_segments=M)
    bp = jax.ops.segment_sum(Atr.reshape(-1, 6), pose_ids, num_segments=M)

    # Landmark blocks: H_ll = (sum_g w) I + damping; b_l = -sum_g w r.
    wsum = jnp.sum(w, axis=-1)  # [L]
    Hll_inv = jnp.eye(3)[None] / (wsum + lm_damping)[:, None, None]  # [L,3,3]
    bl = -jnp.sum(w[..., None] * r, axis=1)  # [L, 3]

    # Coupling blocks W_{k,g} = A^T w B = -A^T w  -> [L, G, 6, 3]
    W = -jnp.swapaxes(wA, -1, -2)  # [L, G, 6, 3]

    WH = _es("lgab,lbc->lgac", W, Hll_inv)  # [L, G, 6, 3]
    # Same-slot fill-in W_g Hll^{-1} W_g^T, scattered by pose: the dominant
    # (g == g') part of the Schur fill's diagonal blocks — the block-Jacobi
    # preconditioner. (Cross-slot g != g' terms hitting the same pose exist
    # only when a track is observed twice from one scan; omitting them from
    # the *preconditioner* costs a few CG iterations at most, never
    # correctness — the matvec itself is exact.)
    Dslot = _es("lgac,lgdc->lgad", WH, W)  # [L, G, 6, 6]
    Fdiag = jax.ops.segment_sum(Dslot.reshape(-1, 6, 6), pose_ids, num_segments=M)

    # Reduced gradient b_red = bp - sum_k W Hll^{-1} b_l.
    bfill = _es("lgac,lc->lga", WH, bl)  # [L, G, 6]
    bfill = jax.ops.segment_sum(bfill.reshape(-1, 6), pose_ids, num_segments=M)
    return Hpp, bp - bfill, Fdiag, Hll_inv, bl, W


def _schur_matvec(x, Hpp, Hll_inv, W, obs_pose, lam, free, axis_name):
    """y = S x with S = Hpp - W Hll^{-1} W^T + lam*I, gauge-projected.

    x, y: [M, 6] replicated. `free` [M, 1] is 0 on the pinned pose; on
    pinned coordinates the operator acts as the identity so CG leaves them
    untouched. The local fill-in streams through the observation slots and
    one psum produces the global product — no [M, M] structure anywhere.
    """
    M = Hpp.shape[0]
    xm = x * free
    y = _es("mab,mb->ma", Hpp, xm)
    xs = xm[obs_pose]                                  # [L, G, 6]
    u = _es("lgac,lga->lc", W, xs)                     # W^T x
    v = _es("lab,lb->la", Hll_inv, u)
    c = _es("lgac,lc->lga", W, v)                      # W Hll^{-1} W^T x
    y = y - jax.ops.segment_sum(c.reshape(-1, 6), obs_pose.reshape(-1),
                                num_segments=M)
    if axis_name is not None:
        y = lax.psum(y, axis_name)
    return (y + lam * xm) * free + (1.0 - free) * x


@functools.partial(
    jax.jit, static_argnames=("iters", "axis_name", "cg_iters")
)
def bundle_adjust(
    prob: BAProblem,
    iters: int = 5,
    damping: float = 1e-6,
    lm_damping: float = 1e-6,
    axis_name: Optional[str] = None,
    cg_iters: int = 64,
    cg_tol: float = 1e-6,
    lam0: Optional[jnp.ndarray] = None,
    robust_delta: Optional[float] = None,
) -> BAResult:
    """Fixed-iteration Schur GN + matrix-free PCG; landmark-sharded when
    axis_name is set.

    Damping is Levenberg-Marquardt-adaptive (a rejected step raises it 10x,
    an accepted step relaxes it toward `damping`); pass `lam0` (and reuse
    the returned `lam`) to resume mid-solve from a checkpoint with the
    damping schedule intact — see utils/checkpoint.save_slam_state and
    frontend.run_sequence's chunked-BA resume path.
    """
    M = prob.poses.shape[0]
    initial_cost = ba_cost(prob.poses, prob.landmarks, prob, axis_name,
                           robust_delta)
    free = (jnp.arange(M) >= 1).astype(prob.poses.dtype)[:, None]  # [M, 1]
    eye6 = jnp.eye(6, dtype=prob.poses.dtype)

    def gn_step(state, _):
        poses, landmarks, cost, lam = state  # cost of current iterate, carried
        Hpp, b_red, Fdiag, Hll_inv, bl, W = _gn_system(
            poses, landmarks, prob, M, lm_damping, robust_delta
        )
        Sdiag = Hpp - Fdiag
        if axis_name is not None:
            b_red = lax.psum(b_red, axis_name)
            Sdiag = lax.psum(Sdiag, axis_name)
        # Block-Jacobi preconditioner from the (global) diagonal blocks,
        # identity on the pinned pose.
        Sdiag = Sdiag + lam * eye6[None]
        Sdiag = jnp.where(free[:, :, None] > 0, Sdiag, eye6[None])
        Pinv = jnp.linalg.inv(Sdiag)  # [M, 6, 6]

        b_g = -b_red * free

        def matvec(x):
            return _schur_matvec(x, Hpp, Hll_inv, W, prob.obs_pose, lam,
                                 free, axis_name)

        def precond(x):
            return _es("mab,mb->ma", Pinv, x * free) + (1.0 - free) * x

        dx, _ = jax.scipy.sparse.linalg.cg(
            matvec, b_g, tol=cg_tol, maxiter=cg_iters, M=precond
        )
        dx = dx * free  # exact gauge: pinned pose never moves

        # Back-substitute landmarks: dl = -Hll^{-1} (bl + Hlp dx) with
        # Hlp dx = sum_g W_g^T dx_{pose(g)}.
        dx_slots = dx[prob.obs_pose]  # [L, G, 6]
        Wtdx = _es("lgac,lga->lc", W, dx_slots)  # [L, 3]
        dl = -_es("lab,lb->la", Hll_inv, bl + Wtdx)

        new_poses = se3.compose(poses, se3.exp_se3(dx))
        new_landmarks = landmarks + dl
        # Monotonicity guard (cost is global under sharding, so the accept
        # decision is identical on every device). LM schedule: rejected
        # steps retry 10x more damped instead of deadlocking.
        new_cost = ba_cost(new_poses, new_landmarks, prob, axis_name,
                           robust_delta)
        better = new_cost <= cost
        poses = jnp.where(better, new_poses, poses)
        landmarks = jnp.where(better, new_landmarks, landmarks)
        cost = jnp.where(better, new_cost, cost)
        lam = jnp.where(better, jnp.maximum(lam * 0.3, damping), lam * 10.0)
        return (poses, landmarks, cost, lam), None

    lam_init = jnp.asarray(damping if lam0 is None else lam0,
                           prob.poses.dtype)
    (poses, landmarks, final_cost, lam), _ = lax.scan(
        gn_step, (prob.poses, prob.landmarks, initial_cost, lam_init),
        None, length=iters,
    )
    return BAResult(
        poses=poses,
        landmarks=landmarks,
        initial_cost=initial_cost,
        final_cost=final_cost,
        lam=lam,
    )
