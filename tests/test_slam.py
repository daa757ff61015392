"""SLAM layer tests: SE(3) maps, pose-graph GN convergence, Schur BA, and
the landmark-sharded distributed BA (SURVEY.md section 4.4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from saccot.slam import se3
from saccot.slam.posegraph import (
    PoseGraph, optimize_pose_graph, odometry_chain_init, graph_cost,
)
from saccot.slam.ba import BAProblem, bundle_adjust, ba_cost
from saccot.utils import se3np


def rand_pose(rng, angle=0.8, trans=1.0):
    return se3np.random_transform(rng, max_angle_rad=angle, max_trans=trans).astype(np.float32)


# ---------------------------------------------------------------- SE(3) maps
def test_exp_log_roundtrip(rng):
    xi = rng.normal(scale=0.7, size=(64, 6)).astype(np.float32)
    T = se3.exp_se3(jnp.asarray(xi))
    back = np.asarray(se3.log_se3(T))
    np.testing.assert_allclose(back, xi, atol=2e-4)


def test_exp_matches_numpy(rng):
    xi = rng.normal(scale=0.5, size=(16, 6))
    T_j = np.asarray(se3.exp_se3(jnp.asarray(xi.astype(np.float32))))
    T_n = se3np.exp_se3(xi)
    np.testing.assert_allclose(T_j, T_n, atol=1e-5)


def test_log_near_pi():
    axis = np.array([1.0, 2.0, -0.5])
    axis /= np.linalg.norm(axis)
    for ang in [np.pi - 1e-2, np.pi - 1e-4]:
        R = se3np.exp_so3(axis * ang).astype(np.float32)
        w = np.asarray(se3.log_so3(jnp.asarray(R)))
        R2 = se3np.exp_so3(w.astype(np.float64))
        # f32 conditioning of log near pi is ~1e-3; that's the contract.
        np.testing.assert_allclose(R2, R, atol=5e-3)


def test_small_angle_stability():
    xi = jnp.asarray(np.full((4, 6), 1e-9, np.float32))
    T = se3.exp_se3(xi)
    assert bool(jnp.isfinite(T).all())
    np.testing.assert_allclose(np.asarray(T[0]), np.eye(4), atol=1e-6)


# ------------------------------------------------------------- pose graph GN
def _make_pg_problem(seed=0, M=12, loop=True, noise=0.03, loop_noise=0.002):
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(M - 1):
        gt.append((gt[-1] @ rand_pose(rng, angle=0.4, trans=0.5)).astype(np.float32))
    gt = np.stack(gt)

    edges_i, edges_j, meas = [], [], []
    def add_edge(i, j, sigma):
        Z = np.linalg.inv(gt[i]) @ gt[j]
        pert = se3np.exp_se3(rng.normal(scale=sigma, size=6))
        edges_i.append(i); edges_j.append(j)
        meas.append((Z @ pert).astype(np.float32))

    # Noisy odometry chain + precise loop closures: the classic setting
    # where optimization visibly pulls drift back.
    for i in range(M - 1):
        add_edge(i, i + 1, noise)
    if loop:
        add_edge(M - 1, 0, loop_noise)
        add_edge(0, M // 2, loop_noise)
        add_edge(M // 4, 3 * M // 4, loop_noise)

    meas = np.stack(meas)
    init = np.asarray(odometry_chain_init(jnp.asarray(meas[: M - 1])))
    graph = PoseGraph(
        poses=jnp.asarray(init),
        edge_i=jnp.asarray(edges_i, dtype=jnp.int32),
        edge_j=jnp.asarray(edges_j, dtype=jnp.int32),
        meas=jnp.asarray(meas),
        weight=jnp.ones((len(edges_i),), jnp.float32),
    )
    return graph, gt


def ate_rmse(poses, gt):
    # Align first pose (gauge) then RMSE over translations.
    rel = np.linalg.inv(poses[0]) @ poses
    rel_gt = np.linalg.inv(gt[0]) @ gt
    d = rel[:, :3, 3] - rel_gt[:, :3, 3]
    return float(np.sqrt((d ** 2).sum(-1).mean()))


def test_pose_graph_converges_to_gt():
    graph, gt = _make_pg_problem(seed=1, M=12)
    res = optimize_pose_graph(graph, iters=10)
    assert float(res.final_cost) <= float(res.initial_cost)
    poses = np.asarray(res.poses, np.float64)
    ate_opt = ate_rmse(poses, gt)
    ate_init = ate_rmse(np.asarray(graph.poses, np.float64), gt)
    # Loop closures must visibly pull odometry drift back toward GT.
    assert ate_opt < 0.1, (ate_opt, ate_init)
    assert ate_opt < 0.6 * ate_init, (ate_opt, ate_init)


def test_pose_graph_perfect_measurements_zero_cost():
    graph, gt = _make_pg_problem(seed=2, M=8, noise=0.0, loop_noise=0.0)
    res = optimize_pose_graph(graph, iters=5)
    assert float(res.final_cost) < 1e-8


# ------------------------------------------------------------------------ BA
def _make_ba_problem(seed=0, M=6, L=64, G=4, noise=0.01, init_noise=0.05):
    rng = np.random.default_rng(seed)
    gt_poses = [np.eye(4, dtype=np.float32)]
    for _ in range(M - 1):
        gt_poses.append((gt_poses[-1] @ rand_pose(rng, angle=0.3, trans=0.4)).astype(np.float32))
    gt_poses = np.stack(gt_poses)
    gt_lm = rng.uniform(-2, 2, size=(L, 3)).astype(np.float32)

    obs_pose = rng.integers(0, M, size=(L, G)).astype(np.int32)
    # z = T_i^{-1} * l + noise (observation in scan frame)
    Tinv = np.linalg.inv(gt_poses)[obs_pose]  # [L, G, 4, 4]
    z = np.einsum("lgij,lj->lgi", Tinv[..., :3, :3], gt_lm) + Tinv[..., :3, 3]
    z = (z + rng.normal(scale=noise, size=z.shape)).astype(np.float32)
    w = np.ones((L, G), np.float32)
    w[:, -1] = (rng.uniform(size=L) > 0.3)  # some padding slots

    # Noisy initialization
    pert = np.stack([se3np.exp_se3(rng.normal(scale=init_noise, size=6)) for _ in range(M)])
    init_poses = (gt_poses @ pert).astype(np.float32)
    init_poses[0] = np.eye(4, dtype=np.float32)  # gauge
    init_lm = (gt_lm + rng.normal(scale=init_noise, size=gt_lm.shape)).astype(np.float32)

    prob = BAProblem(
        poses=jnp.asarray(init_poses),
        landmarks=jnp.asarray(init_lm),
        obs_pose=jnp.asarray(obs_pose),
        obs_z=jnp.asarray(z),
        obs_w=jnp.asarray(w),
    )
    return prob, gt_poses, gt_lm


def test_ba_reduces_cost_and_recovers_poses():
    prob, gt_poses, gt_lm = _make_ba_problem(seed=3)
    res = bundle_adjust(prob, iters=8)
    assert float(res.final_cost) < float(res.initial_cost) * 0.05
    poses = np.asarray(res.poses, np.float64)
    assert ate_rmse(poses, gt_poses) < 0.05


def test_ba_perfect_obs_zero_cost():
    prob, _, _ = _make_ba_problem(seed=4, noise=0.0, init_noise=0.02)
    res = bundle_adjust(prob, iters=8)
    assert float(res.final_cost) < 1e-6


def test_ba_sharded_matches_single_device(eight_devices):
    from saccot.dist.mesh import make_mesh

    prob, gt_poses, _ = _make_ba_problem(seed=5, L=64, M=6)
    ref = bundle_adjust(prob, iters=6)

    mesh = make_mesh(pairs=1, corr=8)

    def local(landmarks, obs_pose, obs_z, obs_w):
        local_prob = BAProblem(
            poses=prob.poses, landmarks=landmarks,
            obs_pose=obs_pose, obs_z=obs_z, obs_w=obs_w,
        )
        return bundle_adjust(local_prob, iters=6, axis_name="corr")

    from saccot.slam.ba import BAResult

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("corr"), P("corr"), P("corr"), P("corr")),
        out_specs=BAResult(
            poses=P(), landmarks=P("corr"), initial_cost=P(), final_cost=P(),
            lam=P(),
        ),
        check_vma=False,
    )
    res = jax.jit(fn)(prob.landmarks, prob.obs_pose, prob.obs_z, prob.obs_w)
    np.testing.assert_allclose(
        np.asarray(res.poses), np.asarray(ref.poses), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(res.landmarks), np.asarray(ref.landmarks), atol=2e-4
    )
    assert abs(float(res.final_cost) - float(ref.final_cost)) < 1e-3


# ------------------------------------------------------- sequence front end
def test_sequence_slam_end_to_end():
    from saccot.io.synthetic import slam_sequence
    from saccot.slam.frontend import run_sequence
    from saccot.evaluation.metrics import ate
    from saccot.utils.params import SacCotParams

    seq = slam_sequence(seed=11, n_scans=6, n_corr=192, outlier_ratio=0.4,
                        noise=0.003, loop_every=3)
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.08, inlier_tau=0.03,
        num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
    )
    res = run_sequence(
        n_scans=6, edges=seq["edges"], edge_P=seq["edge_P"], edge_Q=seq["edge_Q"],
        params=params, pgo_iters=8, run_ba=True, ba_iters=4, max_landmarks=512,
    )
    # All edges registered
    assert bool(np.asarray(res.registration.success).all())
    err = ate(np.asarray(res.poses, np.float64), seq["poses_gt"])
    err_odo = ate(np.asarray(res.pose_graph_result.poses, np.float64), seq["poses_gt"])
    assert err["rmse"] < 0.05, (err, err_odo)


# ------------------------------------------------- landmark track association
def test_track_association_merges_covisible_points():
    """correspondences_to_ba (tracks mode): a point co-visible from several
    scans, appearing in multiple pairwise registrations, must collapse into
    ONE landmark with observations from >= 3 distinct poses."""
    from saccot.slam.frontend import correspondences_to_ba

    rng = np.random.default_rng(0)
    M = 4
    gt = [np.eye(4)]
    for _ in range(M - 1):
        gt.append(gt[-1] @ se3np.random_transform(rng, 0.3, 0.4))
    gt = np.stack(gt)
    pts_w = rng.uniform(-1, 1, size=(32, 3))  # shared world points

    edges = np.array([(0, 1), (1, 2), (2, 3), (0, 3)], np.int32)
    eP, eQ = [], []
    for (i, j) in edges:
        eP.append(se3np.apply_T(np.linalg.inv(gt[i]), pts_w).astype(np.float32))
        eQ.append(se3np.apply_T(np.linalg.inv(gt[j]), pts_w).astype(np.float32))
    inl = np.ones((4, 32), bool)

    prob, stats = correspondences_to_ba(
        jnp.asarray(gt.astype(np.float32)), edges, np.stack(eP), np.stack(eQ),
        inl, max_landmarks=64, obs_per_landmark=8, merge_cell=0.05,
    )
    # 32 physical points, each observed 8 times (2 ends x 4 edges) from all
    # 4 poses -> exactly 32 tracks, every one multiview.
    assert stats["n_tracks_kept"] == 32, stats
    assert stats["multiview_tracks"] == 32, stats
    assert stats["max_track_obs"] == 8, stats
    # Distinct-pose preference: with G=8 every obs fits; each track must
    # reference all 4 poses.
    w = np.asarray(prob.obs_w[:32])
    op = np.asarray(prob.obs_pose[:32])
    for k in range(32):
        assert set(op[k][w[k] > 0]) == {0, 1, 2, 3}


def test_track_ba_beats_pairwise():
    """On a sequence with heavy cross-edge co-visibility, multi-view track
    BA must yield lower ATE than the pairwise (G=2, no association)
    degenerate mode."""
    from saccot.io.synthetic import slam_sequence
    from saccot.slam.frontend import (
        correspondences_to_ba, registrations_to_graph,
    )
    from saccot.engine.sac_cot import register_batch
    from saccot.slam.ba import bundle_adjust
    from saccot.slam.posegraph import optimize_pose_graph
    from saccot.utils.params import SacCotParams

    seq = slam_sequence(seed=5, n_scans=12, n_corr=256, outlier_ratio=0.4,
                        noise=0.004, loop_every=3, n_world=700)
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=96, neighbors_per_anchor=10, max_hypotheses=256,
    )
    reg = register_batch(jnp.asarray(seq["edge_P"]), jnp.asarray(seq["edge_Q"]), params)
    graph = registrations_to_graph(12, jnp.asarray(seq["edges"]), reg,
                                   edge_P=seq["edge_P"], edge_Q=seq["edge_Q"])
    pgo = optimize_pose_graph(graph, iters=8, robust="huber", delta=3.0)
    inl = np.asarray(reg.inliers)

    ates = {}
    for mode in ("tracks", "pairwise"):
        prob, stats = correspondences_to_ba(
            pgo.poses, seq["edges"], seq["edge_P"], seq["edge_Q"], inl,
            max_landmarks=2048, obs_per_landmark=8, merge_cell=0.09, mode=mode,
        )
        res = bundle_adjust(prob, iters=8)
        ates[mode] = ate_rmse(np.asarray(res.poses, np.float64), seq["poses_gt"])
        if mode == "tracks":
            assert stats["multiview_tracks"] > 100, stats
        else:
            assert stats["multiview_tracks"] == 0, stats
    ate_pgo = ate_rmse(np.asarray(pgo.poses, np.float64), seq["poses_gt"])
    # Tracks must measurably beat both the pairwise mode and the PGO input.
    assert ates["tracks"] < 0.9 * ates["pairwise"], (ates, ate_pgo)
    assert ates["tracks"] < ate_pgo, (ates, ate_pgo)


def test_slam_resume_matches_uninterrupted(tmp_path):
    """Interrupting BA mid-solve and resuming from the checkpoint must
    reproduce the uninterrupted run's final trajectory and cost."""
    from saccot.io.synthetic import slam_sequence
    from saccot.slam.frontend import run_sequence
    from saccot.utils.params import SacCotParams

    seq = slam_sequence(seed=9, n_scans=6, n_corr=192, outlier_ratio=0.4,
                        noise=0.004, loop_every=3, n_world=700)
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
    )
    kw = dict(n_scans=6, edges=seq["edges"], edge_P=seq["edge_P"],
              edge_Q=seq["edge_Q"], params=params, pgo_iters=6,
              max_landmarks=512)

    ref = run_sequence(ba_iters=6, **kw)  # uninterrupted, no checkpoint

    ck = str(tmp_path / "slam_ck")
    # "Interrupted" run: stops after 3 of 6 BA iterations, checkpointing.
    part = run_sequence(ba_iters=3, ckpt_path=ck, ba_ckpt_every=3, **kw)
    # Resumed run restores (poses, landmarks, gn_iter, lam) and finishes.
    res = run_sequence(ba_iters=6, ckpt_path=ck, ba_ckpt_every=3, **kw)

    np.testing.assert_allclose(
        np.asarray(res.poses), np.asarray(ref.poses), atol=1e-5
    )
    assert abs(float(res.ba_result.final_cost) - float(ref.ba_result.final_cost)) \
        <= 1e-4 * max(1.0, abs(float(ref.ba_result.final_cost)))
    # The partial run really did stop early.
    assert float(part.ba_result.final_cost) >= float(ref.ba_result.final_cost)


# -------------------------------------------------- robust loss + information
def _plant_false_loop(graph, i, j, rng, weight=200.0):
    """Append a confidently-wrong loop closure (random transform, huge
    weight — the self-similar-structure failure mode)."""
    Z_bad = rand_pose(rng, angle=1.2, trans=1.5)
    return PoseGraph(
        poses=graph.poses,
        edge_i=jnp.concatenate([graph.edge_i, jnp.asarray([i], jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.asarray([j], jnp.int32)]),
        meas=jnp.concatenate([graph.meas, jnp.asarray(Z_bad)[None]]),
        weight=jnp.concatenate([graph.weight, jnp.asarray([weight], jnp.float32)]),
    )


def test_false_loop_closure_robust_tls():
    """One planted false loop closure (high weight, wrong transform) must
    leave the robust solve's ATE within 2x of the clean run. TLS (the hard-redescending switchable gate) is the loss that
    achieves it: from the odometry init the wrong edge's whitened residual
    blows past the gate and contributes zero gradient thereafter."""
    rng = np.random.default_rng(7)
    graph, gt = _make_pg_problem(seed=3, M=12)
    res_clean = optimize_pose_graph(graph, iters=20, robust="tls", delta=1.0)
    ate_clean = ate_rmse(np.asarray(res_clean.poses, np.float64), gt)

    bad = _plant_false_loop(graph, 2, 9, rng, weight=200.0)
    res_bad = optimize_pose_graph(bad, iters=20, robust="tls", delta=1.0)
    ate_bad = ate_rmse(np.asarray(res_bad.poses, np.float64), gt)
    assert ate_bad < max(2.0 * ate_clean, 0.02), (ate_bad, ate_clean)

    # The non-robust solve on the same graph must be visibly corrupted —
    # otherwise this test would not be exercising the robustifier.
    res_plain = optimize_pose_graph(bad, iters=20)
    ate_plain = ate_rmse(np.asarray(res_plain.poses, np.float64), gt)
    assert ate_plain > 2.0 * ate_bad, (ate_plain, ate_bad)

    # DCS (soft-redescending) visibly tempers the corruption even where its
    # IRLS basin doesn't fully reject the edge; Huber at least never makes
    # it worse than the plain solve.
    res_dcs = optimize_pose_graph(bad, iters=20, robust="dcs", delta=1.0)
    ate_dcs = ate_rmse(np.asarray(res_dcs.poses, np.float64), gt)
    assert ate_dcs < 0.5 * ate_plain, (ate_dcs, ate_plain)
    res_hub = optimize_pose_graph(bad, iters=20, robust="huber", delta=1.0)
    ate_hub = ate_rmse(np.asarray(res_hub.poses, np.float64), gt)
    assert ate_hub <= ate_plain + 1e-6, (ate_hub, ate_plain)


def test_edge_information_from_inlier_statistics():
    """edge_information: SPD, scales with inlier count, shrinks with noise
    (slam/frontend.py)."""
    from saccot.engine.sac_cot import register_batch
    from saccot.io.synthetic import correspondence_problem
    from saccot.slam.frontend import edge_information
    from saccot.utils.params import SacCotParams

    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=48, neighbors_per_anchor=10, max_hypotheses=256,
    )
    probs = [
        correspondence_problem(seed=60, n=128, outlier_ratio=0.3, noise=0.002),
        correspondence_problem(seed=61, n=128, outlier_ratio=0.3, noise=0.008),
        correspondence_problem(seed=62, n=128, outlier_ratio=0.8, noise=0.002),
    ]
    P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
    reg = register_batch(P_all, Q_all, params)
    info = np.asarray(edge_information(reg, P_all, Q_all), np.float64)

    assert info.shape == (3, 6, 6)
    for e in range(3):
        np.testing.assert_allclose(info[e], info[e].T, atol=1e-3)
        ev = np.linalg.eigvalsh(info[e])
        assert ev.min() > 0, (e, ev)
    # More noise at the same inlier rate -> strictly less information.
    assert np.trace(info[1]) < 0.25 * np.trace(info[0])
    # Fewer inliers -> less information.
    assert np.trace(info[2]) < np.trace(info[0])


def test_info_graph_converges():
    """Full-information pose graph (registrations_to_graph with points)
    still converges and beats odometry."""
    from saccot.io.synthetic import slam_sequence
    from saccot.engine.sac_cot import register_batch
    from saccot.slam.frontend import registrations_to_graph
    from saccot.utils.params import SacCotParams

    seq = slam_sequence(seed=13, n_scans=6, n_corr=192, outlier_ratio=0.4,
                        noise=0.003, loop_every=3)
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.08, inlier_tau=0.03,
        num_anchors=64, neighbors_per_anchor=10, max_hypotheses=256,
    )
    reg = register_batch(jnp.asarray(seq["edge_P"]), jnp.asarray(seq["edge_Q"]), params)
    graph = registrations_to_graph(
        6, jnp.asarray(seq["edges"]), reg,
        edge_P=seq["edge_P"], edge_Q=seq["edge_Q"],
    )
    assert graph.info is not None and graph.info.shape[-2:] == (6, 6)
    res = optimize_pose_graph(graph, iters=8, robust="huber", delta=3.0)
    ate_opt = ate_rmse(np.asarray(res.poses, np.float64), seq["poses_gt"])
    ate_init = ate_rmse(np.asarray(graph.poses, np.float64), seq["poses_gt"])
    assert ate_opt <= ate_init + 1e-6
    assert ate_opt < 0.05


def test_propose_loop_candidates():
    from saccot.slam.frontend import propose_loop_candidates

    # Square loop returning near the origin.
    M = 9
    ang = np.linspace(0, 2 * np.pi, M)
    poses = np.tile(np.eye(4), (M, 1, 1))
    poses[:, 0, 3] = np.cos(ang) * 2.0
    poses[:, 1, 3] = np.sin(ang) * 2.0  # pose 8 == pose 0 position
    cand = propose_loop_candidates(poses, min_gap=3, radius=0.5)
    assert len(cand) >= 1
    assert [0, M - 1] in cand.tolist()
    assert all(j - i >= 3 for i, j in cand)


def test_ba_scales_to_hundreds_of_poses():
    """The matrix-free PCG path must handle M in the hundreds — the regime
    the dense [6M, 6M] solve could not reach. No
    [M, M] structure exists anywhere; this exercises M=128, L=4096."""
    prob, gt_poses, _ = _make_ba_problem(seed=8, M=128, L=4096, G=4,
                                         noise=0.005, init_noise=0.03)
    res = bundle_adjust(prob, iters=6, cg_iters=96)
    assert float(res.final_cost) < float(res.initial_cost) * 0.2, (
        float(res.initial_cost), float(res.final_cost))
    poses = np.asarray(res.poses, np.float64)
    assert ate_rmse(poses, gt_poses) < 0.05


def test_adjoint_transport_of_information():
    """se3.adjoint + the H -> Ad(Z)^T H Ad(Z) transport in
    registrations_to_graph: Monte-Carlo over right
    perturbations of T_est, the empirical covariance of the graph residual
    r = log(Z^{-1} Z_true) must match (Ad(Z)^T H Ad(Z))^{-1}."""
    rng = np.random.default_rng(7)
    T = rand_pose(rng, angle=0.9, trans=2.5)  # large translation on purpose
    # A well-conditioned but anisotropic information for T's perturbation.
    Aq = rng.normal(size=(6, 6))
    H = Aq @ Aq.T + 6.0 * np.eye(6)
    cov = np.linalg.inv(H)
    Lc = np.linalg.cholesky(cov)
    n = 20000
    # Scale down so log's linearization error is negligible vs the spread.
    scale = 0.02
    delta = (rng.normal(size=(n, 6)) @ Lc.T) * scale  # cov = scale^2 * H^-1

    T_est = se3.compose(jnp.asarray(T)[None], se3.exp_se3(jnp.asarray(
        delta.astype(np.float32))))
    Z = se3.inv(T_est)                      # measured Z per sample
    Z_true = se3.inv(jnp.asarray(T))[None]
    r = se3.log_se3(se3.compose(se3.inv(Z), Z_true))  # residual at GT poses
    r = np.asarray(r, np.float64)
    emp_cov = (r.T @ r) / n / scale**2       # undo the scale

    Ad = np.asarray(se3.adjoint(se3.inv(jnp.asarray(T))), np.float64)
    H_r = Ad.T @ H @ Ad
    pred_cov = np.linalg.inv(H_r)
    # Relative Frobenius agreement (MC error ~ 1/sqrt(n) ~ 1%).
    err = np.linalg.norm(emp_cov - pred_cov) / np.linalg.norm(pred_cov)
    assert err < 0.05, err
    # And the *unconjugated* H would be wrong for this large-translation
    # edge — guard that the transport actually matters.
    err_raw = np.linalg.norm(emp_cov - cov) / np.linalg.norm(cov)
    assert err_raw > 0.5, err_raw


def test_pgo_pcg_matches_dense():
    """Matrix-free PCG pose graph == dense direct solve:
    same LM loop, same trajectory to ~CG tolerance, on a mid-size graph
    with full information matrices and a robust loss."""
    graph, gt = _make_pg_problem(seed=3, M=40)
    dense = optimize_pose_graph(graph, iters=10, robust="huber", delta=3.0,
                                solver="dense")
    pcg = optimize_pose_graph(graph, iters=10, robust="huber", delta=3.0,
                              solver="pcg", cg_iters=128)
    ate_d = ate_rmse(np.asarray(dense.poses, np.float64), gt)
    ate_p = ate_rmse(np.asarray(pcg.poses, np.float64), gt)
    assert abs(ate_d - ate_p) < 2e-3, (ate_d, ate_p)
    assert float(pcg.final_cost) <= float(pcg.initial_cost)
    np.testing.assert_allclose(
        np.asarray(pcg.poses), np.asarray(dense.poses), atol=5e-3)


def test_pgo_pcg_scales_to_hundreds_of_poses():
    """The auto-selected PCG path handles M in the hundreds where the
    dense [6M, 6M] assembly stopped scaling — M=256 with loop closures,
    convergence to GT within noise."""
    graph, gt = _make_pg_problem(seed=9, M=256, noise=0.02)
    res = optimize_pose_graph(graph, iters=12)  # auto -> pcg at M=256
    assert float(res.final_cost) < float(res.initial_cost)
    ate_opt = ate_rmse(np.asarray(res.poses, np.float64), gt)
    ate_init = ate_rmse(np.asarray(graph.poses, np.float64), gt)
    assert ate_opt < 0.5 * ate_init, (ate_opt, ate_init)
    assert ate_opt < 0.2, ate_opt


def test_pgo_edge_sharded_matches_single_device(eight_devices):
    """Distributed PGO (r5): edge axis sharded over the 8-device mesh via
    shard_map, poses replicated, one [M, 6] psum per CG step — must match
    the single-device PCG solve near-bitwise (identical LM schedule)."""
    from jax import shard_map
    from jax.sharding import Mesh

    graph, gt = _make_pg_problem(seed=21, M=40)
    E = int(graph.edge_i.shape[0])
    d = 8
    Ep = -(-E // d) * d
    pad = Ep - E

    def padE(x, value=0.0):
        w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.asarray(np.pad(np.asarray(x), w, constant_values=value))

    # Zero-weight identity padding edges contribute nothing to cost or
    # normal equations.
    gpad = PoseGraph(
        poses=graph.poses,
        edge_i=padE(graph.edge_i), edge_j=padE(graph.edge_j),
        meas=jnp.concatenate(
            [graph.meas,
             jnp.tile(jnp.eye(4, dtype=graph.meas.dtype), (pad, 1, 1))]),
        weight=padE(graph.weight),
        info=None,
    )
    ref = optimize_pose_graph(gpad, iters=8, robust="huber", delta=3.0,
                              solver="pcg", cg_iters=128)

    mesh = Mesh(np.array(jax.devices()[:d]), ("e",))

    def body(ei, ej, meas, w):
        g = PoseGraph(poses=gpad.poses, edge_i=ei, edge_j=ej, meas=meas,
                      weight=w, info=None)
        return optimize_pose_graph(
            g, iters=8, robust="huber", delta=3.0, solver="pcg",
            cg_iters=128, axis_name="e").poses

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P("e"), P("e"), P("e"), P("e")),
        out_specs=P(),
        check_vma=False,
    )
    poses_sh = sharded(gpad.edge_i, gpad.edge_j, gpad.meas, gpad.weight)
    np.testing.assert_allclose(
        np.asarray(poses_sh), np.asarray(ref.poses), atol=1e-5)
    ate_sh = ate_rmse(np.asarray(poses_sh, np.float64), gt)
    assert ate_sh < 0.1, ate_sh
