"""SLAM front end: pairwise SAC-COT edges -> pose graph -> optional BA.

The full config-5 flow (SURVEY.md section 3.5):

  1. batch-register every sequence edge (odometry + loop closures) with the
     SAC-COT estimator — one vmapped/sharded sweep, the same unit the DP
     mesh axis shards;
  2. convert per-edge transforms to pose-graph measurements with weights
     from inlier counts; chain odometry for the initial guess;
  3. Gauss-Newton pose-graph optimization;
  4. optionally promote the per-edge inlier correspondences to landmark
     observations and run Schur-complement bundle adjustment for the final
     trajectory + map.

Frame conventions: `register_pair(P_i, Q_j)` returns M with q ~= M p (p in
scan i's frame, q in scan j's). With poses T_i: world <- scan, a shared
point satisfies p_j = T_j^{-1} T_i p_i, so the pose-graph measurement
Z_ij = T_i^{-1} T_j = M^{-1}.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax as _lax

# f32-accurate contractions: a reduced-precision f32 einsum (TF32 on a
# GPU, 10-bit mantissa) is too coarse for normal-equation /
# information-matrix algebra (see slam/se3.py).
_es = functools.partial(jnp.einsum, precision=_lax.Precision.HIGHEST)

from saccot.engine.sac_cot import RegistrationResult, register_batch
from saccot.slam import se3
from saccot.slam.ba import BAProblem, bundle_adjust, BAResult, ba_cost
from saccot.slam.posegraph import (
    PoseGraph, PGOResult, odometry_chain_init, optimize_pose_graph,
)
from saccot.utils.params import SacCotParams


class SequenceResult(NamedTuple):
    poses: jnp.ndarray               # [M, 4, 4] final trajectory
    pose_graph_result: PGOResult
    registration: RegistrationResult  # batched per-edge results
    ba_result: Optional[BAResult]
    num_failed_edges: int            # edges below min_inliers / unsuccessful
    ba_stats: Optional[Dict] = None  # track-association stats (truncation etc.)


def edge_information(
    reg: RegistrationResult,     # batched over E
    edge_P: jnp.ndarray,         # [E, N, 3] source points (frame i)
    edge_Q: jnp.ndarray,         # [E, N, 3] target points (frame j)
    sigma_floor: float = 1e-3,
) -> jnp.ndarray:
    """[E, 6, 6] information matrices from the estimator's inlier statistics.

    First-order propagation of the registration's Gauss-Newton information:
    each inlier residual r_n = R p_n + t - q_n has Jacobian
    J_n = R [I | -hat(p_n)] w.r.t. a right perturbation of the estimated
    transform, so (R drops out under J^T J)

        H = (1/sigma^2) sum_n w_n [[I,        -hat(p_n)     ],
                                   [hat(p_n), |p_n|^2 I - p_n p_n^T]]

    with sigma^2 the *per-coordinate* residual variance — the weighted mean
    of |r|^2 divided by 3, since J^T J / sigma^2 whitens each of the three
    residual components — floored at sigma_floor^2 so near-perfect fits
    don't produce unbounded confidence. (Using the full 3-component mean
    would understate the information 3x and break the chi^2_6 delta
    calibration documented in posegraph.robust_weight.)
    The closed form needs only three inlier moments (sum w, sum w p,
    sum w p p^T) — no per-point 6x6 products are materialized. Edges with
    <3 inliers get a tiny isotropic information so the graph keeps static
    shapes without letting failed edges constrain anything.
    """
    P = edge_P.astype(jnp.float32)
    Q = edge_Q.astype(jnp.float32)
    w = reg.inliers.astype(jnp.float32)  # [E, N]

    # Residuals under the estimated transforms (for sigma^2).
    x = _es("eij,enj->eni", reg.R, P) + reg.t[:, None, :] - Q
    d2 = jnp.sum(x * x, axis=-1)                       # [E, N]
    S0 = jnp.sum(w, axis=-1)                           # [E]
    sigma2 = jnp.sum(w * d2, axis=-1) / (3.0 * jnp.maximum(S0, 1.0))
    sigma2 = jnp.maximum(sigma2, sigma_floor**2)       # [E]

    S1 = _es("en,eni->ei", w, P)                # [E, 3]
    S2 = _es("en,eni,enj->eij", w, P, P)        # [E, 3, 3]
    eye3 = jnp.eye(3, dtype=P.dtype)

    def hat(v):
        zeros = jnp.zeros_like(v[..., 0])
        return jnp.stack([
            jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
        ], axis=-2)

    tl = S0[:, None, None] * eye3                      # [E, 3, 3]
    tr = -hat(S1)
    br = jnp.trace(S2, axis1=-2, axis2=-1)[:, None, None] * eye3 - S2
    H = jnp.concatenate([
        jnp.concatenate([tl, tr], axis=-1),
        jnp.concatenate([-tr, br], axis=-1),
    ], axis=-2) / sigma2[:, None, None]                # [E, 6, 6]

    ok = (reg.success & (S0 >= 3.0))[:, None, None]
    tiny = 1e-6 * jnp.broadcast_to(jnp.eye(6, dtype=P.dtype), H.shape)
    return jnp.where(ok, H, tiny)


def registrations_to_graph(
    n_scans: int,
    edges: jnp.ndarray,          # [E, 2] (i, j)
    reg: RegistrationResult,     # batched over E
    min_inliers: int = 5,
    edge_P: Optional[jnp.ndarray] = None,
    edge_Q: Optional[jnp.ndarray] = None,
) -> PoseGraph:
    """Build a PoseGraph from batched edge registrations.

    With `edge_P`/`edge_Q` given, full [E, 6, 6] information matrices are
    derived from the estimator's inlier statistics (`edge_information`);
    otherwise edge weight = inlier count (a crude but effective information
    proxy). Failed edges (few inliers / no triangles) get weight ~0 so they
    don't corrupt the solve but keep static shapes.

    Caveat surfaced via SequenceResult.num_failed_edges: a *failed odometry*
    edge leaves every later pose initialized at the break point (its
    identity measurement is still chained) and, absent a loop closure
    spanning the gap, only damping constrains those poses — callers must
    treat a nonzero failed-edge count on the odometry chain as a broken
    trajectory segment, exactly as the reference's serial pipeline would
    produce an unregistered pair.
    """
    Z = se3.inv(reg.T)  # measurement T_i^{-1} T_j (see module docstring)
    ok = reg.success & (reg.num_inliers >= min_inliers)
    w = jnp.where(ok, reg.num_inliers.astype(jnp.float32), 1e-6)

    info = None
    if edge_P is not None and edge_Q is not None:
        info = edge_information(reg, jnp.asarray(edge_P), jnp.asarray(edge_Q))
        # The estimator's H whitens a right perturbation of T_est, but the
        # graph residual r = log(Z^{-1} T_i^{-1} T_j) is a perturbation of
        # Z = inv(T_est); transport: H_r = Ad(Z)^T H Ad(Z) (see
        # se3.adjoint — Monte-Carlo-verified in tests/test_slam.py).
        # Without this, edges with large translations feed a mis-rotated
        # information to the chi^2_6-calibrated robust gates.
        Ad = se3.adjoint(Z)
        info = _es("eba,ebc,ecd->ead", Ad, info, Ad)
        info = jnp.where(
            ok[:, None, None], info,
            1e-6 * jnp.broadcast_to(jnp.eye(6, dtype=info.dtype), info.shape),
        )

    # Initial guess: chain the odometry edges (assumed to be the first
    # n_scans-1 edges, in order — the sequence harness guarantees this).
    odo = Z[: n_scans - 1]
    poses0 = odometry_chain_init(odo)
    return PoseGraph(
        poses=poses0,
        edge_i=edges[:, 0].astype(jnp.int32),
        edge_j=edges[:, 1].astype(jnp.int32),
        meas=Z,
        weight=w,
        info=info,
    )


def correspondences_to_ba(
    poses: jnp.ndarray,            # [M, 4, 4] pose-graph output
    edges: np.ndarray,             # [E, 2]
    edge_P: np.ndarray,            # [E, N, 3] points in frame i
    edge_Q: np.ndarray,            # [E, N, 3] points in frame j
    inliers: np.ndarray,           # [E, N] bool from registration
    max_landmarks: int = 2048,
    obs_per_landmark: int = 8,
    merge_cell: float = 0.02,
    min_track_obs: int = 2,
    mode: str = "tracks",
) -> Tuple[BAProblem, Dict]:
    """Associate inlier correspondences into multi-view landmark tracks.

    The step that makes BA *bundle adjustment* rather than a re-weighted
    pairwise solve: every inlier correspondence contributes two
    observations of one physical point (in scan i at P, in scan j at Q);
    observations of the same point made by *different edges* — a point
    co-visible from 3+ scans appears in several pairwise registrations —
    are merged into one landmark track by voxel-hashing their world-frame
    estimates under the pose-graph poses (cell size `merge_cell`, in scene
    units; ~2-3x the inlier noise merges same-point observations while
    keeping distinct surface points apart; boundary-split tracks simply
    become two smaller, still-consistent tracks).

    Fully vectorized host-side NumPy (no Python loop over E x N). Tracks
    are ranked by observation count so truncation to `max_landmarks` drops
    the *least*-constrained tracks, not whichever edges came last; within a
    track, slots prefer observations from distinct poses (that is what
    couples 3+ poses through one landmark). All drops are surfaced in the
    returned stats dict.

    Returns (BAProblem, stats) with stats keys: n_obs, n_tracks_raw,
    n_tracks_kept, n_tracks_dropped, n_obs_truncated, multiview_tracks
    (tracks observing >= 3 distinct poses), max_track_obs.

    mode="pairwise" keeps each correspondence as its own 2-observation
    landmark (no cross-edge association) — the degenerate baseline that
    reduces BA to a re-weighted pairwise solve; kept for A/B comparison
    (tests/test_slam.py shows tracks beat it on co-visible sequences).
    """
    poses_np = np.asarray(poses, np.float64)
    edges = np.asarray(edges)
    E, N = inliers.shape
    G = obs_per_landmark
    L = max_landmarks

    # World-frame estimate of every observation under the current poses.
    Ri = poses_np[edges[:, 0], :3, :3]  # [E, 3, 3]
    ti = poses_np[edges[:, 0], :3, 3]
    Rj = poses_np[edges[:, 1], :3, :3]
    tj = poses_np[edges[:, 1], :3, 3]
    wP = np.einsum("eab,enb->ena", Ri, np.asarray(edge_P, np.float64)) + ti[:, None]
    wQ = np.einsum("eab,enb->ena", Rj, np.asarray(edge_Q, np.float64)) + tj[:, None]

    valid = np.asarray(inliers, bool).reshape(-1)
    pose_id = np.concatenate([
        np.repeat(edges[:, 0], N), np.repeat(edges[:, 1], N)
    ])[np.concatenate([valid, valid])]
    z_loc = np.concatenate([
        np.asarray(edge_P, np.float32).reshape(-1, 3)[valid],
        np.asarray(edge_Q, np.float32).reshape(-1, 3)[valid],
    ])
    w_pt = np.concatenate([
        wP.reshape(-1, 3)[valid], wQ.reshape(-1, 3)[valid]
    ])
    n_obs = w_pt.shape[0]

    prob_out = functools.partial(
        _pack_ba_problem, poses=poses, L=L, G=G
    )
    if n_obs == 0:
        return prob_out(None, None, None, None), dict(
            n_obs=0, n_tracks_raw=0, n_tracks_kept=0, n_tracks_dropped=0,
            n_obs_truncated=0, multiview_tracks=0, max_track_obs=0,
        )

    if mode == "pairwise":
        # Each correspondence = its own landmark: both halves of the
        # concatenated observation list index the same correspondence, so
        # the "track key" is simply the correspondence's flat index.
        key = np.concatenate([np.arange(valid.size)] * 2)[
            np.concatenate([valid, valid])
        ]
    else:
        # Voxel hash -> track ids. 21 bits per axis around a 2^20 offset
        # covers +-1e6 cells per dimension.
        q = np.floor(w_pt / merge_cell).astype(np.int64) + (1 << 20)
        key = q[:, 0] | (q[:, 1] << 21) | (q[:, 2] << 42)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)

    # Keep the best-constrained tracks: count desc, >= min_track_obs.
    order = np.argsort(-counts, kind="stable")
    keep = order[counts[order] >= min_track_obs][:L]
    n_kept = len(keep)
    rank = np.full(len(uniq), -1, np.int64)
    rank[keep] = np.arange(n_kept)
    tr = rank[inv]  # per-observation track slot, -1 = dropped track

    sel = np.nonzero(tr >= 0)[0]
    # Prefer distinct poses within a track: stable-sort observations by
    # (track, first-observation-of-this-pose? 0 : 1), then take the first G
    # per track — multi-view coverage survives truncation.
    by_tp = sel[np.lexsort((pose_id[sel], tr[sel]))]
    first = np.ones(len(by_tp), bool)
    first[1:] = (tr[by_tp][1:] != tr[by_tp][:-1]) | (
        pose_id[by_tp][1:] != pose_id[by_tp][:-1]
    )
    so = by_tp[np.lexsort(((~first).astype(np.int8), tr[by_tp]))]
    t_sorted = tr[so]
    group_sizes = np.bincount(t_sorted, minlength=n_kept)
    starts = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    slot = np.arange(len(so)) - starts[t_sorted]
    take = slot < G

    obs_pose = np.zeros((L, G), np.int32)
    obs_z = np.zeros((L, G, 3), np.float32)
    obs_w = np.zeros((L, G), np.float32)
    ti_, si_ = t_sorted[take], slot[take]
    obs_pose[ti_, si_] = pose_id[so[take]]
    obs_z[ti_, si_] = z_loc[so[take]]
    obs_w[ti_, si_] = 1.0

    # Landmark init: mean world-frame estimate over the kept observations.
    landmarks = np.zeros((L, 3), np.float32)
    acc = np.zeros((L, 3), np.float64)
    np.add.at(acc, ti_, w_pt[so[take]])
    cnt = np.bincount(ti_, minlength=L).astype(np.float64)
    landmarks[:n_kept] = (
        acc[:n_kept] / np.maximum(cnt[:n_kept], 1.0)[:, None]
    ).astype(np.float32)

    # Distinct poses per kept track (for the multiview stat): `first` marks
    # the first observation of each (track, pose) run in by_tp order.
    distinct = np.bincount(tr[by_tp[first]], minlength=n_kept)
    stats = dict(
        n_obs=int(n_obs),
        n_tracks_raw=int((counts >= min_track_obs).sum()),
        n_tracks_kept=int(n_kept),
        n_tracks_dropped=int((counts >= min_track_obs).sum() - n_kept),
        n_obs_truncated=int((~take).sum()),
        multiview_tracks=int((distinct >= 3).sum()),
        max_track_obs=int(counts.max()) if len(counts) else 0,
    )
    return prob_out(landmarks, obs_pose, obs_z, obs_w), stats


def _pack_ba_problem(landmarks, obs_pose, obs_z, obs_w, *, poses, L, G):
    if landmarks is None:
        landmarks = np.zeros((L, 3), np.float32)
        obs_pose = np.zeros((L, G), np.int32)
        obs_z = np.zeros((L, G, 3), np.float32)
        obs_w = np.zeros((L, G), np.float32)
    return BAProblem(
        poses=jnp.asarray(np.asarray(poses, np.float32)),
        landmarks=jnp.asarray(landmarks),
        obs_pose=jnp.asarray(obs_pose),
        obs_z=jnp.asarray(obs_z),
        obs_w=jnp.asarray(obs_w),
    )


def propose_loop_candidates(
    poses: np.ndarray,
    min_gap: int = 3,
    radius: float = 1.0,
    max_candidates: int = 32,
) -> np.ndarray:
    """Loop-closure candidates by trajectory proximity (host-side).

    After odometry chaining, scans whose estimated positions fall within
    `radius` of each other but are at least `min_gap` apart in time are
    candidate loop closures (SURVEY.md section 3.5, "odometry + loop
    candidates") — the registration engine then confirms or rejects each by
    actually registering the pair. Returns [C, 2] (i, j) with i < j, closest
    first, capped at max_candidates.
    """
    t = np.asarray(poses, np.float64)[:, :3, 3]  # [M, 3]
    d = np.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    M = t.shape[0]
    ii, jj = np.triu_indices(M, k=min_gap)
    sel = d[ii, jj] < radius
    ii, jj = ii[sel], jj[sel]
    order = np.argsort(d[ii, jj], kind="stable")[:max_candidates]
    return np.stack([ii[order], jj[order]], axis=1).astype(np.int64)


def run_sequence(
    n_scans: int,
    edges: np.ndarray,
    edge_P: np.ndarray,
    edge_Q: np.ndarray,
    params: SacCotParams,
    pgo_iters: int = 10,
    run_ba: bool = True,
    ba_iters: int = 5,
    max_landmarks: int = 2048,
    use_info: bool = True,
    robust: Optional[str] = "huber",
    robust_delta: float = 3.0,
    obs_per_landmark: int = 8,
    merge_cell: Optional[float] = None,
    ckpt_path: Optional[str] = None,
    ba_ckpt_every: int = 0,
    log=None,
) -> SequenceResult:
    """Full sequence SLAM on one device (the sharded variant lives in
    dist/sweep.py + slam/dryrun.py composition).

    use_info derives [E, 6, 6] information matrices from the inlier
    statistics (edge_information); robust selects the pose-graph loss
    ("huber"/"dcs"/None) with threshold `robust_delta` on the whitened
    residual. BA runs on multi-view landmark tracks (voxel-merge cell
    `merge_cell`, default 3x the estimator's inlier threshold) with up to
    `obs_per_landmark` observations each.

    Checkpoint/resume: with `ckpt_path`, BA runs in chunks of
    `ba_ckpt_every` iterations (0 = one chunk), saving (poses, landmarks,
    gn_iter, lam) after each; a rerun with the same arguments restores the
    iterate AND the LM damping state and continues where the interrupted
    run stopped — the resumed trajectory matches the uninterrupted one.
    """
    reg = register_batch(jnp.asarray(edge_P), jnp.asarray(edge_Q), params)
    graph = registrations_to_graph(
        n_scans, jnp.asarray(edges), reg,
        edge_P=jnp.asarray(edge_P) if use_info else None,
        edge_Q=jnp.asarray(edge_Q) if use_info else None,
    )
    pgo = optimize_pose_graph(graph, iters=pgo_iters, robust=robust,
                              delta=robust_delta)
    n_failed = int(
        np.sum(~(np.asarray(reg.success) & (np.asarray(reg.num_inliers) >= 5)))
    )

    ba_res = None
    ba_stats = None
    poses = pgo.poses
    if run_ba:
        if merge_cell is None:
            merge_cell = 3.0 * float(params.inlier_tau)
        # Data-scaled Huber gate: 2x the median initial track residual.
        # Landmarks start at their track means, so the initial |r|
        # distribution measures intra-track spread directly — true tracks
        # sit at the noise scale, association errors above it. A fixed gate
        # at the estimator's inlier_tau measured 1.7x worse ATE on the
        # 16-scan driver config (tau is an *inlier* radius, far above the
        # noise), and no gate 2.3x worse.
        ba_robust = None  # set after the problem exists, below
        prob, ba_stats = correspondences_to_ba(
            pgo.poses, edges, edge_P, edge_Q, np.asarray(reg.inliers),
            max_landmarks=max_landmarks, obs_per_landmark=obs_per_landmark,
            merge_cell=merge_cell,
        )
        from saccot.slam.ba import _residuals as _ba_residuals

        r0, _ = _ba_residuals(prob.poses, prob.landmarks, prob)
        d0 = np.sqrt(np.sum(np.asarray(r0, np.float64) ** 2, axis=-1))
        real = np.asarray(prob.obs_w) > 0
        if real.any():
            ba_robust = max(2.0 * float(np.median(d0[real])), 1e-9)
        ba_stats["huber_delta"] = ba_robust
        if log is not None:
            log.log(dict(event="ba_tracks", **ba_stats))

        done, lam = 0, None
        if ckpt_path:
            from saccot.utils.checkpoint import restore_slam_state

            st = restore_slam_state(ckpt_path)
            if st is not None and int(st.get("gn_iter", 0)) > 0:
                done = min(int(st["gn_iter"]), ba_iters)
                prob = prob._replace(
                    poses=jnp.asarray(np.asarray(st["poses"], np.float32)),
                    landmarks=jnp.asarray(
                        np.asarray(st["landmarks"], np.float32)),
                )
                if "lam" in st:
                    lam = jnp.asarray(float(np.asarray(st["lam"])),
                                      jnp.float32)
        while done < ba_iters:
            chunk = (ba_iters - done if ba_ckpt_every <= 0
                     else min(ba_ckpt_every, ba_iters - done))
            ba_res = bundle_adjust(prob, iters=chunk, lam0=lam,
                                   robust_delta=ba_robust)
            prob = prob._replace(poses=ba_res.poses,
                                 landmarks=ba_res.landmarks)
            lam = ba_res.lam
            done += chunk
            if ckpt_path:
                from saccot.utils.checkpoint import save_slam_state

                save_slam_state(ckpt_path, ba_res.poses, ba_res.landmarks,
                                gn_iter=done, lam=float(np.asarray(lam)))
        if ba_res is None:
            # Resume found a checkpoint whose gn_iter already equals
            # ba_iters: BA finished in a prior run and the while loop never
            # entered. Synthesize the result from the restored state so
            # callers can always read ba_result when run_ba is true.
            c = ba_cost(prob.poses, prob.landmarks, prob,
                        robust_delta=ba_robust)
            ba_res = BAResult(
                poses=prob.poses, landmarks=prob.landmarks,
                initial_cost=c, final_cost=c,
                lam=jnp.asarray(0.0 if lam is None else lam, jnp.float32),
            )
        poses = prob.poses
    return SequenceResult(
        poses=poses,
        pose_graph_result=pgo,
        registration=reg,
        ba_result=ba_res,
        num_failed_edges=n_failed,
        ba_stats=ba_stats,
    )
