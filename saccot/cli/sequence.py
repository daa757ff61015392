"""Register a directory of scans as an odometry sequence — real-file mode.

The reference's KITTI workflow loops consecutive LiDAR scans through the
registration pipeline (SURVEY.md section 3.2); this runner does that on
real files: a native prefetch pool (native/prefetch.cpp) parses scans ahead
of the device while the jitted pipeline registers the previous pair, scan
features are computed once and reused for both pairs they appear in
(features/pipeline.py `extract_scan_features`), and estimated relative
transforms are chained into a trajectory (ATE against KITTI-format ground
truth when given).
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from saccot.evaluation.metrics import ate, registration_error
from saccot.features.pipeline import (
    PipelineConfig, extract_scan_features, register_scan_features,
)
from saccot.io import native
from saccot.io.loaders import load_cloud, load_kitti_poses, pad_cloud
from saccot.utils.params import SacCotParams


def _find_scans(path: str, fmt: str) -> List[str]:
    if os.path.isdir(path):
        ext = {"kitti": "bin", "ply": "ply"}[fmt]
        paths = sorted(glob.glob(os.path.join(path, f"*.{ext}")))
    else:  # comma-separated explicit list
        paths = [p for p in path.split(",") if p]
    if len(paths) < 2:
        raise ValueError(f"need at least 2 scans, found {len(paths)} at {path!r}")
    return paths


def _scan_iter(paths: List[str], fmt: str, max_pts: int):
    """Native prefetching iterator when available, serial loads otherwise."""
    if fmt in ("kitti", "ply"):
        reader = native.prefetch_reader(paths, fmt, max_pts=max_pts)
        if reader is not None:
            return reader
    return (load_cloud(p)[:max_pts] for p in paths)


def default_sequence_config(metric_scale: float = 0.25) -> PipelineConfig:
    """Scene-scale defaults: thresholds in multiples of `metric_scale` (m)."""
    return PipelineConfig(
        voxel_mult=1.0,
        max_cloud_points=8192,
        iss_salient_mult=4.0, iss_nms_mult=3.0,
        descriptor="fpfh", descriptor_radius_mult=8.0, descriptor_k=48,
        max_keypoints=1024, max_correspondences=1024,
        compat_mult=3.0, min_sep_mult=6.0, inlier_mult=3.0,
        estimator=SacCotParams(
            num_anchors=192, neighbors_per_anchor=12, max_hypotheses=1024,
        ),
        metric_scale=metric_scale,
    )


def run_sequence_files(
    path: str,
    fmt: str = "kitti",
    poses_path: Optional[str] = None,
    cfg: Optional[PipelineConfig] = None,
    max_pts: int = 200_000,
    bucket: int = 65536,
    stride: int = 1,
    log=None,
    loops: bool = False,
    loop_radius: Optional[float] = None,
    loop_min_gap: int = 3,
    max_loops: int = 16,
    loop_min_inliers: int = 10,
    loop_gate: float = 1.0,
    pgo_iters: int = 12,
) -> Dict:
    """Odometry over a scan directory: consecutive registration + chaining.

    Returns aggregate metrics (per-pair records to `log` as JSONL). Poses
    follow target = T * source with source = scan i+stride, target = scan i,
    so chaining pose_{i+1} = pose_i @ T_i accumulates world-from-scan poses.

    With `loops=True` the full config-5 flow runs (SURVEY.md section 3.5):
    loop-closure candidates are proposed from the chained trajectory's
    self-proximity (slam/frontend.propose_loop_candidates), each candidate
    is confirmed or rejected by actually registering the pair from its
    cached per-scan features, and the odometry chain + confirmed loops are
    optimized as a robust pose graph (TLS gate `loop_gate` cuts any
    confidently-wrong closure). Adds `loop_closures` / `ate_rmse_optimized`
    to the metrics.
    """
    if cfg is None:
        cfg = default_sequence_config()
    paths = _find_scans(path, fmt)
    if stride > 1:
        paths = paths[::stride]

    gt_poses = load_kitti_poses(poses_path) if poses_path else None
    if gt_poses is not None and stride != 1:
        gt_poses = gt_poses[::stride]

    poses = [np.eye(4)]
    prev_feat = None
    times, rot_errs, trans_errs = [], [], []
    n_inliers = []
    feats = []       # per-scan features (kept only when loops=True)
    rel_meas = []    # odometry measurements Z_{i,i+1}
    corr = []        # per-edge (P, Q, inlier-mask, success) for info matrices
    t_start = time.time()
    scans = _scan_iter(paths, fmt, max_pts)
    try:
        for i, pts in enumerate(scans):
            if pts is None:
                raise IOError(f"unreadable scan: {paths[i]}")
            padded, mask = pad_cloud(pts.astype(np.float32), bucket)
            feat = extract_scan_features(
                jnp.asarray(padded), cfg, mask=jnp.asarray(mask)
            )
            if loops:
                feats.append(feat)
            if prev_feat is not None:
                t0 = time.time()
                res = register_scan_features(feat, prev_feat, cfg)
                T = np.asarray(res.registration.T, np.float64)  # barrier
                times.append(time.time() - t0)
                poses.append(poses[-1] @ T)
                rel_meas.append(T)
                n_inliers.append(int(res.registration.num_inliers))
                if loops:
                    corr.append((np.asarray(res.corr_P), np.asarray(res.corr_Q),
                                 np.asarray(res.registration.inliers),
                                 bool(res.registration.success)))
                rec = dict(
                    pair=(i - 1, i), wall_s=times[-1],
                    num_corr=int(res.num_correspondences),
                    num_inliers=n_inliers[-1],
                    success=bool(res.registration.success),
                )
                if gt_poses is not None and i < len(gt_poses):
                    # Our T maps scan i into scan i-1's frame, i.e. the GT
                    # relative pose inv(world_from_{i-1}) @ world_from_i.
                    T_gt = np.linalg.inv(gt_poses[i - 1]) @ gt_poses[i]
                    r, t = registration_error(T, T_gt)
                    rec["rot_err_deg"] = r
                    rec["trans_err"] = t
                    rot_errs.append(r)
                    trans_errs.append(t)
                if log:
                    log.log(rec)
            prev_feat = feat
    finally:
        close = getattr(scans, "close", None)
        if close:
            close()

    out: Dict = dict(
        scans=len(paths),
        pairs=len(times),
        mean_wall_s=float(np.mean(times[1:])) if len(times) > 1 else (times[0] if times else None),
        total_wall_s=time.time() - t_start,
        mean_inliers=float(np.mean(n_inliers)) if n_inliers else 0.0,
        native_prefetch=native.available(),
    )

    poses_opt = None
    if loops and len(poses) > loop_min_gap:
        poses_opt, loop_stats = _close_loops(
            poses, rel_meas, n_inliers, feats, cfg, corr,
            loop_radius=loop_radius, loop_min_gap=loop_min_gap,
            max_loops=max_loops, loop_min_inliers=loop_min_inliers,
            loop_gate=loop_gate, pgo_iters=pgo_iters, log=log,
        )
        out.update(loop_stats)

    if gt_poses is not None:
        n = min(len(poses), len(gt_poses))
        out["ate_rmse"] = ate(np.asarray(poses[:n]), np.asarray(gt_poses[:n]))["rmse"]
        if poses_opt is not None:
            out["ate_rmse_optimized"] = ate(
                np.asarray(poses_opt[:n]), np.asarray(gt_poses[:n])
            )["rmse"]
        if rot_errs:
            out["mean_rot_err_deg"] = float(np.mean(rot_errs))
            out["mean_trans_err"] = float(np.mean(trans_errs))
    final = poses_opt if poses_opt is not None else poses
    out["trajectory"] = [np.asarray(p)[:3, :].reshape(-1).tolist() for p in final]
    return out


def _close_loops(
    poses, rel_meas, n_inliers, feats, cfg, corr,
    loop_radius, loop_min_gap, max_loops, loop_min_inliers,
    loop_gate, pgo_iters, log=None,
):
    """Propose -> confirm -> robustly optimize loop closures.

    Edges carry full [6, 6] information matrices derived from each
    registration's inlier statistics (`corr` holds the correspondence sets
    the main loop cached; slam/frontend.edge_information) — so residuals
    are chi^2_6-whitened and the documented robust-loss calibration
    applies, instead of the r3 weight-only whitening with mixed
    meter/radian units.

    Returns (optimized poses [M, 4, 4] ndarray or the input chain when no
    loop confirmed, stats dict).
    """
    from saccot.slam.frontend import propose_loop_candidates
    from saccot.slam.posegraph import (
        PoseGraph, edge_errors, optimize_pose_graph,
    )

    poses_np = np.asarray(poses, np.float64)
    if loop_radius is None:
        steps = np.linalg.norm(
            poses_np[1:, :3, 3] - poses_np[:-1, :3, 3], axis=-1
        )
        # 5x the median step: candidates are CONFIRMED by registration, so
        # a generous radius only costs compute (capped at max_loops), while
        # a tight one silently misses closures once accumulated drift
        # exceeds the step size — exactly the long-sequence regime where
        # closures matter most (the r5 128-scan run found 0 candidates at
        # the previous 1.5x default with ~0.5 m drift on 0.3 m steps).
        loop_radius = 5.0 * float(np.median(steps)) if len(steps) else 1.0
    cand = propose_loop_candidates(
        poses_np, min_gap=loop_min_gap, radius=loop_radius,
        max_candidates=max_loops,
    )

    loop_e, loop_Z, loop_w, loop_corr = [], [], [], []
    for (i, j) in cand:
        # Register scan j (src) against scan i (tgt): T maps j into i's
        # frame, which IS the pose-graph measurement Z_ij = T_i^{-1} T_j.
        res = register_scan_features(feats[j], feats[i], cfg)
        ni = int(res.registration.num_inliers)
        ok = bool(res.registration.success) and ni >= loop_min_inliers
        if log:
            log.log(dict(loop_candidate=[int(i), int(j)],
                         num_inliers=ni, confirmed=ok))
        if ok:
            loop_e.append((int(i), int(j)))
            loop_Z.append(np.asarray(res.registration.T, np.float64))
            loop_w.append(float(ni))
            loop_corr.append((np.asarray(res.corr_P), np.asarray(res.corr_Q),
                              np.asarray(res.registration.inliers),
                              bool(res.registration.success)))

    stats = dict(
        loop_candidates=len(cand),
        loop_closures=len(loop_e),
        loop_radius=float(loop_radius),
    )
    if not loop_e:
        return None, stats

    M = len(poses_np)
    mean_inl = max(float(np.mean(n_inliers)), 1.0)
    ei = list(range(M - 1)) + [e[0] for e in loop_e]
    ej = list(range(1, M)) + [e[1] for e in loop_e]
    meas = np.stack([np.asarray(Z, np.float64) for Z in rel_meas] + loop_Z)
    w = np.asarray(list(n_inliers) + loop_w, np.float64) / mean_inl

    # [E, 6, 6] information from the registrations' inlier statistics: the
    # correspondence sets cached by the main loop (odometry) and the loop
    # confirmations above. Measurement direction matches: meas = T maps the
    # edge's SOURCE scan (j) into the target's frame, and edge_information
    # is the Gauss-Newton information of exactly that transform.
    from saccot.engine.sac_cot import RegistrationResult
    from saccot.slam.frontend import edge_information

    all_corr = list(corr) + loop_corr
    meas_f = jnp.asarray(meas, jnp.float32)
    reg_b = RegistrationResult(
        R=meas_f[:, :3, :3],
        t=meas_f[:, :3, 3],
        T=meas_f,
        inliers=jnp.asarray(np.stack([c[2] for c in all_corr])),
        num_inliers=jnp.asarray(list(n_inliers) + [int(x) for x in loop_w],
                                jnp.int32),
        best_score=jnp.zeros((len(ei),), jnp.float32),
        num_valid_triangles=jnp.zeros((len(ei),), jnp.int32),
        success=jnp.asarray([c[3] for c in all_corr]),
    )
    info = edge_information(
        reg_b,
        jnp.asarray(np.stack([c[0] for c in all_corr]), jnp.float32),
        jnp.asarray(np.stack([c[1] for c in all_corr]), jnp.float32),
    )
    graph = PoseGraph(
        poses=jnp.asarray(poses_np, jnp.float32),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        meas=meas_f,
        weight=jnp.asarray(w, jnp.float32),
        info=info,
    )
    # Two-stage robust schedule on chi^2_6-whitened residuals. A correct
    # loop closure's *initial* residual equals the accumulated odometry
    # drift, so a hard TLS gate up front would cut exactly the edge meant
    # to correct large drift. Stage 1: Huber — its linear tail keeps a
    # nonzero pull from every edge, so consistent loops get absorbed no
    # matter how large the drift. Stage 2: TLS at the chi^2_6 99% gate
    # (delta ~ 4.1, valid because the info matrices whiten the residuals —
    # see posegraph.robust_weight), floored by 2x the post-Huber median so
    # an uncalibrated noise model cannot cut half the graph.
    pgo_h = optimize_pose_graph(
        graph, iters=pgo_iters, robust="huber", delta=3.0
    )
    s = np.asarray(edge_errors(pgo_h.poses, graph), np.float64)
    med = float(np.median(np.sqrt(np.maximum(s, 0.0))))
    gate = max(4.1, 2.0 * med, float(loop_gate))
    pgo = optimize_pose_graph(
        graph._replace(poses=pgo_h.poses), iters=pgo_iters,
        robust="tls", delta=gate,
    )
    stats["pgo_initial_cost"] = float(pgo_h.initial_cost)
    stats["pgo_final_cost"] = float(pgo.final_cost)
    stats["tls_gate"] = gate
    return np.asarray(pgo.poses, np.float64), stats
