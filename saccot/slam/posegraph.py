"""Pose-graph optimization: on-manifold Gauss-Newton over SE(3).

New capability beyond the reference (SURVEY.md section 1.3, T6): multi-scan
consistency from pairwise SAC-COT edges. Nodes are scan poses T_i (world <-
scan), edges carry relative measurements Z_ij ~= T_i^{-1} T_j with 6x6
information matrices derived from the estimator's inlier statistics.

Residual (right-perturbation convention):
    r_ij = log( Z_ij^{-1} * T_i^{-1} * T_j )  in R^6,  T <- T * exp(dx)

Per-edge Jacobians come from forward-mode autodiff through the exp/log maps
(vmapped, evaluated at dx = 0) — exact, branchless, and free of hand-derived
adjoint bookkeeping. The normal system is assembled as dense [M*6, M*6] via
one segment-sum scatter (fine to a few thousand poses; the sharded
large-scale path lives in slam/ba.py where the Schur trick applies), gauge
is fixed by pinning pose 0, and a fixed GN iteration count keeps the whole
solve inside one jit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax as _lax

# f32-accurate contractions: a reduced-precision f32 einsum (TF32 on a
# GPU, 10-bit mantissa) is too coarse for normal-equation /
# information-matrix algebra (see slam/se3.py).
_es = functools.partial(jnp.einsum, precision=_lax.Precision.HIGHEST)

from saccot.slam import se3


class PoseGraph(NamedTuple):
    poses: jnp.ndarray    # [M, 4, 4] initial pose estimates (world <- scan)
    edge_i: jnp.ndarray   # [E] int32 source node
    edge_j: jnp.ndarray   # [E] int32 target node
    meas: jnp.ndarray     # [E, 4, 4] measured Z_ij ~= T_i^{-1} T_j
    weight: jnp.ndarray   # [E] scalar edge weights (info = weight * I6)
    info: Optional[jnp.ndarray] = None  # optional [E, 6, 6] full information


def edge_residual(T_i, T_j, Z_ij):
    """r = log(Z^{-1} T_i^{-1} T_j) in R^6."""
    return se3.log_se3(se3.compose(se3.inv(Z_ij), se3.compose(se3.inv(T_i), T_j)))


def _edge_residual_perturbed(xi_i, xi_j, T_i, T_j, Z_ij):
    Ti = se3.compose(T_i, se3.exp_se3(xi_i))
    Tj = se3.compose(T_j, se3.exp_se3(xi_j))
    return edge_residual(Ti, Tj, Z_ij)


def _edge_jacobians(T_i, T_j, Z_ij):
    """(r [6], J_i [6,6], J_j [6,6]) at xi = 0, per edge (vmapped)."""
    zero = jnp.zeros((6,), T_i.dtype)
    r = _edge_residual_perturbed(zero, zero, T_i, T_j, Z_ij)
    J_i = jax.jacfwd(_edge_residual_perturbed, argnums=0)(zero, zero, T_i, T_j, Z_ij)
    J_j = jax.jacfwd(_edge_residual_perturbed, argnums=1)(zero, zero, T_i, T_j, Z_ij)
    return r, J_i, J_j


def _edge_sq_error(r, graph: PoseGraph):
    """Per-edge weighted squared error s_e = r^T L r (or w |r|^2)."""
    if graph.info is not None:
        return _es("ea,eab,eb->e", r, graph.info, r)
    return graph.weight * jnp.sum(r * r, axis=-1)


def robust_weight(s, robust: Optional[str], delta: float):
    """IRLS weight omega(s) for weighted squared error s.

    "huber": omega = min(1, delta/sqrt(s)) — quadratic near zero, linear
      tails; delta is in units of the *whitened* residual (sqrt of the
      weighted squared error).
    "dcs": dynamic covariance scaling, omega = min(1, 2*delta^2/(delta^2+s))
      — redescending: a confidently-wrong edge (huge s) is driven to ~small
      influence rather than merely linearized.
    "tls": truncated least squares / switchable gate, omega = 1{s <= delta^2}
      — the hard-redescending loss. An edge whose whitened residual exceeds
      delta contributes *zero* gradient, so a confidently-wrong loop closure
      (high inlier weight, wrong transform) is cut entirely the moment the
      odometry-chain init exposes it; this is the loss that survives the
      planted-false-loop test. With chi^2_6-whitened residuals (info
      matrices from edge_information), delta ~ 4.1 is the 99% gate.
    """
    if robust is None or robust == "none":
        return jnp.ones_like(s)
    s = jnp.maximum(s, 1e-12)
    if robust == "huber":
        return jnp.minimum(1.0, delta / jnp.sqrt(s))
    if robust == "dcs":
        phi = delta * delta
        return jnp.minimum(1.0, 2.0 * phi / (phi + s))
    if robust == "tls":
        return (s <= delta * delta).astype(s.dtype)
    raise ValueError(f"unknown robust loss {robust!r}")


def robust_cost(s, robust: Optional[str], delta: float):
    """rho(s): the robust cost whose IRLS weight is `robust_weight`."""
    if robust is None or robust == "none":
        return s
    s = jnp.maximum(s, 0.0)
    if robust == "huber":
        rt = jnp.sqrt(jnp.maximum(s, 1e-12))
        return jnp.where(rt <= delta, s, 2.0 * delta * rt - delta * delta)
    if robust == "dcs":
        phi = delta * delta
        # smooth, monotone, saturating at phi — the guard only needs
        # monotonicity w.r.t. each edge's error.
        return phi * s / (phi + s)
    if robust == "tls":
        return jnp.minimum(s, delta * delta)
    raise ValueError(f"unknown robust loss {robust!r}")


def _assemble_normal_system(
    poses, graph: PoseGraph, robust: Optional[str] = None, delta: float = 1.0
):
    """Dense H [6M, 6M], b [6M] from all edges (one scatter)."""
    M = poses.shape[0]
    Ti = poses[graph.edge_i]
    Tj = poses[graph.edge_j]
    r, J_i, J_j = jax.vmap(_edge_jacobians)(Ti, Tj, graph.meas)  # [E,6],[E,6,6]x2

    omega = robust_weight(_edge_sq_error(r, graph), robust, delta)  # [E]

    if graph.info is not None:
        L = graph.info * omega[:, None, None]  # [E, 6, 6]
        LJ_i = _es("eab,ebc->eac", L, J_i)
        LJ_j = _es("eab,ebc->eac", L, J_j)
        Lr = _es("eab,eb->ea", L, r)
    else:
        w = (graph.weight * omega)[:, None, None]
        LJ_i, LJ_j = w * J_i, w * J_j
        Lr = (graph.weight * omega)[:, None] * r

    # Block contributions: H[ii] += Ji^T L Ji, H[ij] += Ji^T L Jj, etc.
    Hii = _es("eba,ebc->eac", J_i, LJ_i)
    Hij = _es("eba,ebc->eac", J_i, LJ_j)
    Hji = jnp.swapaxes(Hij, -1, -2)
    Hjj = _es("eba,ebc->eac", J_j, LJ_j)
    bi = _es("eba,eb->ea", J_i, Lr)
    bj = _es("eba,eb->ea", J_j, Lr)

    # Scatter blocks into the dense system via linear segment ids.
    ei, ej = graph.edge_i, graph.edge_j
    blk = jnp.concatenate([Hii, Hij, Hji, Hjj], axis=0)  # [4E, 6, 6]
    rows = jnp.concatenate([ei, ei, ej, ej])
    cols = jnp.concatenate([ei, ej, ei, ej])
    seg = rows * M + cols
    Hblocks = jax.ops.segment_sum(blk, seg, num_segments=M * M)  # [M*M, 6, 6]
    H = (
        Hblocks.reshape(M, M, 6, 6)
        .transpose(0, 2, 1, 3)
        .reshape(M * 6, M * 6)
    )
    bvec = jax.ops.segment_sum(
        jnp.concatenate([bi, bj], axis=0),
        jnp.concatenate([ei, ej]),
        num_segments=M,
    ).reshape(M * 6)
    return H, bvec


def _edge_blocks(poses, graph: PoseGraph, robust: Optional[str], delta: float,
                 axis_name: Optional[str] = None):
    """Per-edge GN blocks for the matrix-free path.

    Returns (J_i, J_j, LJ_i, LJ_j, b [M, 6], Pdiag [M, 6, 6]) with L the
    (robust-reweighted) information folded into LJ = L J. Nothing
    [M, M]-shaped is ever built: b and the block-diagonal preconditioner
    Pdiag come from two segment-sums over the 2E edge endpoints.

    With `axis_name`, `graph` holds this device's EDGE shard (poses
    replicated) and b/Pdiag are psum-reduced — the distributed-PGO layout:
    per-device work is O(E/d), per-GN-step comm is one [M, 6] + one
    [M, 6, 6] reduction here plus one [M, 6] psum per CG step in
    `_pgo_matvec`.
    """
    M = poses.shape[0]
    Ti = poses[graph.edge_i]
    Tj = poses[graph.edge_j]
    r, J_i, J_j = jax.vmap(_edge_jacobians)(Ti, Tj, graph.meas)

    omega = robust_weight(_edge_sq_error(r, graph), robust, delta)  # [E]
    if graph.info is not None:
        L = graph.info * omega[:, None, None]
        LJ_i = _es("eab,ebc->eac", L, J_i)
        LJ_j = _es("eab,ebc->eac", L, J_j)
        Lr = _es("eab,eb->ea", L, r)
    else:
        w = (graph.weight * omega)[:, None, None]
        LJ_i, LJ_j = w * J_i, w * J_j
        Lr = (graph.weight * omega)[:, None] * r

    seg = jnp.concatenate([graph.edge_i, graph.edge_j])
    b = jax.ops.segment_sum(
        jnp.concatenate(
            [_es("eba,eb->ea", J_i, Lr), _es("eba,eb->ea", J_j, Lr)], axis=0
        ),
        seg, num_segments=M,
    )  # [M, 6]
    Pdiag = jax.ops.segment_sum(
        jnp.concatenate(
            [_es("eba,ebc->eac", J_i, LJ_i), _es("eba,ebc->eac", J_j, LJ_j)],
            axis=0,
        ),
        seg, num_segments=M,
    )  # [M, 6, 6]
    if axis_name is not None:
        b = _lax.psum(b, axis_name)
        Pdiag = _lax.psum(Pdiag, axis_name)
    return J_i, J_j, LJ_i, LJ_j, b, Pdiag


def _pgo_matvec(x, J_i, J_j, LJ_i, LJ_j, graph, lam, free, M,
                axis_name: Optional[str] = None):
    """y = (H + lam I) x, gauge-projected: one edge stream + one
    segment-sum — O(E) work, O(M) memory per CG step (the pose-graph
    analog of slam/ba._schur_matvec). On pinned
    coordinates the operator is the identity so CG leaves them fixed.
    Under `axis_name`, the edge blocks are this device's shard and the
    [M, 6] product is psum-reduced — the only per-CG-step communication."""
    xm = x * free                                            # [M, 6]
    u = _es("eab,eb->ea", LJ_i, xm[graph.edge_i]) + _es(
        "eab,eb->ea", LJ_j, xm[graph.edge_j])                # [E, 6] = L J x
    y = jax.ops.segment_sum(
        jnp.concatenate(
            [_es("eba,eb->ea", J_i, u), _es("eba,eb->ea", J_j, u)], axis=0
        ),
        jnp.concatenate([graph.edge_i, graph.edge_j]),
        num_segments=M,
    )
    if axis_name is not None:
        y = _lax.psum(y, axis_name)
    return (y + lam * xm) * free + (1.0 - free) * x


class PGOResult(NamedTuple):
    poses: jnp.ndarray          # [M, 4, 4] optimized
    final_cost: jnp.ndarray     # scalar: sum of weighted squared residuals
    initial_cost: jnp.ndarray


def edge_errors(poses, graph: PoseGraph) -> jnp.ndarray:
    """Per-edge weighted squared error s_e = r^T L r (or w |r|^2), [E].

    The quantity `robust_weight`/`robust_cost` gate on — exposed so callers
    can scale a TLS gate to the solved graph's actual residual distribution
    (a fixed gate in whitened units is meaningless when edges are weight-
    whitened with mixed meter/radian residuals; see cli/sequence._close_loops).
    """
    r = jax.vmap(edge_residual)(poses[graph.edge_i], poses[graph.edge_j], graph.meas)
    return _edge_sq_error(r, graph)


def graph_cost(
    poses, graph: PoseGraph, robust: Optional[str] = None, delta: float = 1.0,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    r = jax.vmap(edge_residual)(poses[graph.edge_i], poses[graph.edge_j], graph.meas)
    c = jnp.sum(robust_cost(_edge_sq_error(r, graph), robust, delta))
    if axis_name is not None:
        c = _lax.psum(c, axis_name)
    return c


# Above this pose count optimize_pose_graph defaults to the matrix-free
# PCG solver: the dense [6M, 6M] assembly + LU is O(M^2) memory / O(M^3)
# flops per GN step and stops scaling around a few hundred poses; the
# edge-streamed CG is O(E) per step. Below it the
# dense direct solve is both exact and faster (no CG iterations).
DENSE_PGO_MAX_POSES = 64


@functools.partial(
    jax.jit,
    static_argnames=("iters", "robust", "solver", "cg_iters", "axis_name"),
)
def optimize_pose_graph(
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-6,
    robust: Optional[str] = None,
    delta: float = 1.0,
    solver: Optional[str] = None,
    cg_iters: int = 96,
    cg_tol: float = 1e-8,
    axis_name: Optional[str] = None,
) -> PGOResult:
    """Gauss-Newton with pose-0 gauge fix, fixed iteration count, one jit.

    robust: None (plain least squares), "huber", or "dcs" — iteratively
    reweighted (IRLS) inside each GN step, with the step-acceptance guard
    evaluated on the matching robust cost so outlier edges cannot drag the
    trajectory. For a *confidently-wrong* loop closure (huge weight, wrong
    transform) use "dcs": it is redescending, driving such an edge's
    influence to ~zero; Huber's linear tail only tempers it.

    solver: "dense" (assemble [6M, 6M], direct solve), "pcg" (matrix-free
    edge-streamed CG with block-Jacobi preconditioner — cost linear in E,
    memory linear in M; the KITTI-scale path), or None = auto by
    DENSE_PGO_MAX_POSES. Both run the identical LM accept/reject loop;
    parity is tested to ~1e-4 ATE on mid-size graphs.

    axis_name (pcg only): DISTRIBUTED pose graph — call inside shard_map
    with `graph` holding this device's EDGE shard (poses and the pin
    replicated). Per-device work is O(E/d); communication is one [M, 6] +
    one [M, 6, 6] psum per GN step plus one [M, 6] psum per CG step —
    the pose-graph counterpart of the landmark-sharded BA (slam/ba.py).
    The cost/accept decision psums, so every device follows the identical
    LM schedule. Sharded parity is tested on the faked 8-device mesh.

    Damping is Levenberg-Marquardt-adaptive: a rejected step multiplies the
    damping by 10 and retries smaller next iteration (instead of deadlocking
    on the same rejected full GN step), an accepted step relaxes it.
    """
    M = graph.poses.shape[0]
    if solver is None:
        solver = "dense" if M <= DENSE_PGO_MAX_POSES else "pcg"
    if axis_name is not None and solver != "pcg":
        raise ValueError("edge-sharded PGO requires solver='pcg'")
    initial_cost = graph_cost(graph.poses, graph, robust, delta, axis_name)
    eye6 = jnp.eye(6, dtype=graph.poses.dtype)

    def solve_dense(poses, lam):
        H, b = _assemble_normal_system(poses, graph, robust, delta)
        # Gauge: pin pose 0 by masking its rows/cols and unit diagonal.
        free = (jnp.arange(M * 6) >= 6).astype(poses.dtype)
        H = H * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        b = b * free
        H = H + lam * jnp.eye(M * 6, dtype=poses.dtype)
        return jnp.linalg.solve(H, -b).reshape(M, 6)

    def solve_pcg(poses, lam):
        J_i, J_j, LJ_i, LJ_j, b, Pdiag = _edge_blocks(
            poses, graph, robust, delta, axis_name)
        free = (jnp.arange(M) >= 1).astype(poses.dtype)[:, None]  # [M, 1]
        Pdiag = Pdiag + lam * eye6[None]
        Pdiag = jnp.where(free[:, :, None] > 0, Pdiag, eye6[None])
        Pinv = jnp.linalg.inv(Pdiag)

        def matvec(x):
            return _pgo_matvec(x, J_i, J_j, LJ_i, LJ_j, graph, lam, free, M,
                               axis_name)

        def precond(x):
            return _es("mab,mb->ma", Pinv, x * free) + (1.0 - free) * x

        dx, _ = jax.scipy.sparse.linalg.cg(
            matvec, -b * free, tol=cg_tol, maxiter=cg_iters, M=precond
        )
        return dx * free

    def gn_step(state, _):
        poses, cost, lam = state  # cost of current iterate, carried
        dx = solve_dense(poses, lam) if solver == "dense" else solve_pcg(
            poses, lam)
        new_poses = se3.compose(poses, se3.exp_se3(dx))
        # LM accept/reject (branchless select; global cost under sharding,
        # so every device takes the same branch).
        new_cost = graph_cost(new_poses, graph, robust, delta, axis_name)
        better = new_cost <= cost
        poses = jnp.where(better, new_poses, poses)
        cost = jnp.where(better, new_cost, cost)
        lam = jnp.where(better, jnp.maximum(lam * 0.3, damping), lam * 10.0)
        return (poses, cost, lam), None

    lam0 = jnp.asarray(damping, graph.poses.dtype)
    (poses, final_cost, _), _ = jax.lax.scan(
        gn_step, (graph.poses, initial_cost, lam0), None, length=iters
    )
    return PGOResult(
        poses=poses,
        final_cost=final_cost,
        initial_cost=initial_cost,
    )


def odometry_chain_init(meas_odo: jnp.ndarray) -> jnp.ndarray:
    """Initialize poses by chaining consecutive measurements Z_{i,i+1}.

    meas_odo: [M-1, 4, 4] -> poses [M, 4, 4] with pose 0 = identity.
    (Host-side helper — runs a tiny scan.)
    """
    def step(T, Z):
        Tn = se3.compose(T, Z)
        return Tn, Tn

    T0 = jnp.eye(4, dtype=meas_odo.dtype)
    _, rest = jax.lax.scan(step, T0, meas_odo)
    return jnp.concatenate([T0[None], rest], axis=0)
