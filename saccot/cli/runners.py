"""Runners for the driver configs: generate/load data, execute, evaluate.

Each runner returns a metrics dict (and writes per-pair JSONL when given a
log path). These are the reference's L6 driver loops (SURVEY.md section
3.1-3.2) rebuilt around the batched/sharded engine.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from saccot.cli.configs import RunConfig
from saccot.engine.sac_cot import register_batch
from saccot.evaluation.metrics import (
    ate, is_registered, model_rmse, registration_error,
)
from saccot.features.pipeline import (
    extract_scan_features, register_clouds, register_scan_features,
)
from saccot.io.synthetic import (
    correspondence_problem, model_views, slam_sequence, two_view_pair,
)
from saccot.utils.checkpoint import SweepCheckpointer
from saccot.utils.logging import JsonlLogger


def run_pipeline_config(cfg: RunConfig, log: Optional[JsonlLogger] = None) -> Dict:
    """Configs 1-2: full cloud->transform pipeline over synthetic view pairs."""
    ok, rot_errs, trans_errs, times = 0, [], [], []
    pipe = cfg.pipeline
    for p in range(cfg.n_pairs):
        pair = two_view_pair(seed=cfg.seed + p, n_points=cfg.n_points,
                             overlap=cfg.overlap, noise=0.002)
        t0 = time.time()
        res = register_clouds(
            jnp.asarray(pair["source"]), jnp.asarray(pair["target"]), pipe
        )
        jax.block_until_ready(res.registration.T)
        dt = time.time() - t0
        T = np.asarray(res.registration.T, np.float64)
        r, t = registration_error(T, pair["T_gt"])
        if cfg.use_model_rmse:
            # U3M protocol: model-point RMSE under T_est vs T_gt, in mesh-
            # resolution multiples.
            rmse = model_rmse(T, pair["T_gt"], pair["source"].astype(np.float64))
            hit = rmse < cfg.rmse_mult * float(res.resolution)
        else:
            rmse = None
            hit = is_registered(T, pair["T_gt"], cfg.rot_thresh_deg, cfg.trans_thresh)
        ok += hit
        rot_errs.append(r); trans_errs.append(t); times.append(dt)
        if log:
            log.log(dict(config=cfg.name, pair=p, rot_err_deg=r, trans_err=t,
                         model_rmse=rmse, registered=bool(hit), wall_s=dt,
                         num_corr=int(res.num_correspondences),
                         num_inliers=int(res.registration.num_inliers)))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, recall=ok / cfg.n_pairs,
        overlap=cfg.overlap,
        mean_rot_err_deg=float(np.mean(rot_errs)),
        mean_trans_err=float(np.mean(trans_errs)),
        mean_wall_s=float(np.mean(times[1:])) if len(times) > 1 else times[0],
    )


def sweep_problems(cfg: RunConfig):
    """The planted correspondence problems of a sweep config, in order."""
    return [
        correspondence_problem(
            seed=cfg.seed + s, n=cfg.n_corr, outlier_ratio=cfg.outlier_ratio,
            noise=cfg.noise,
        )
        for s in range(cfg.n_pairs)
    ]


def run_sweep_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                     ckpt: Optional[str] = None, batch: int = 16,
                     fail_after_shard: Optional[int] = None) -> Dict:
    """Config 3: external correspondences, batched estimation, recall.

    `fail_after_shard` is the fault-injection hook (SURVEY.md section 5,
    failure detection): the process hard-exits after checkpointing that
    shard, simulating a lost host; a rerun with the same --ckpt resumes
    from the shard boundary.
    """
    probs = sweep_problems(cfg)
    fn = jax.jit(lambda a, b: register_batch(a, b, cfg.params))
    ckptr = SweepCheckpointer(ckpt)
    results_T, results_inl = {}, {}
    t_total, n_done = 0.0, 0
    # Warm the compile outside the timed loop so pairs_per_sec reflects
    # steady-state throughput (the other runners drop times[0] instead).
    warm = probs[:1] * batch
    _ = np.asarray(
        fn(
            jnp.stack([jnp.asarray(p["P"]) for p in warm]),
            jnp.stack([jnp.asarray(p["Q"]) for p in warm]),
        ).num_inliers
    )
    for s0 in range(0, cfg.n_pairs, batch):
        shard = s0 // batch
        chunk = probs[s0 : s0 + batch]
        if len(chunk) < batch:  # pad the last shard
            chunk = chunk + [chunk[-1]] * (batch - len(chunk))
        if ckptr.is_done(shard):
            T_all = ckptr.done[shard]["T"]
            inl_all = ckptr.done[shard].get("num_inliers")
        else:
            Pa = jnp.stack([jnp.asarray(p["P"]) for p in chunk])
            Qa = jnp.stack([jnp.asarray(p["Q"]) for p in chunk])
            t0 = time.time()
            res = fn(Pa, Qa)
            T_all = np.asarray(res.T, np.float64)
            inl_all = np.asarray(res.num_inliers)
            t_total += time.time() - t0
            n_done += batch
            ckptr.record(shard, dict(T=T_all, num_inliers=inl_all))
            if fail_after_shard is not None and shard >= fail_after_shard:
                import os
                print(f"[fault-injection] exiting after shard {shard}", flush=True)
                os._exit(17)
        for b in range(batch):
            if s0 + b < cfg.n_pairs:
                results_T[s0 + b] = T_all[b]
                results_inl[s0 + b] = (
                    None if inl_all is None else int(inl_all[b])
                )

    flags, rots, trans = [], [], []
    for idx, T in results_T.items():
        r, t = registration_error(T, probs[idx]["T_gt"])
        hit = is_registered(T, probs[idx]["T_gt"], cfg.rot_thresh_deg, cfg.trans_thresh)
        flags.append(hit); rots.append(r); trans.append(t)
        if log:
            log.log(dict(config=cfg.name, pair=idx, rot_err_deg=r, trans_err=t,
                         registered=bool(hit), num_inliers=results_inl[idx]))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, recall=float(np.mean(flags)),
        mean_rot_err_deg=float(np.mean(rots)), mean_trans_err=float(np.mean(trans)),
        pairs_per_sec=(n_done / t_total) if t_total > 0 else None,
    )


def run_kitti_config(cfg: RunConfig, log: Optional[JsonlLogger] = None) -> Dict:
    """Config 4: LiDAR-scale N (>=50k) pairs through the blockwise engine."""
    from saccot.engine.sac_cot import register_pair

    flags, rots, trans, times, success = [], [], [], [], []
    # Scene-scale spread (KITTI frames span ~100 m); cfg.noise is metric, so
    # the generator (unit-blob coordinates) gets noise / scale.
    scale = 30.0
    for s in range(cfg.n_pairs):
        prob = correspondence_problem(
            seed=cfg.seed + s, n=cfg.n_corr, outlier_ratio=cfg.outlier_ratio,
            noise=cfg.noise / scale, n_points=4 * cfg.n_corr, max_angle=0.3,
            max_trans=3.0,
        )
        P = jnp.asarray(prob["P"] * scale)
        Q = jnp.asarray(prob["Q"] * scale)
        T_gt = prob["T_gt"].copy()
        T_gt[:3, 3] *= scale
        t0 = time.time()
        res = register_pair(P, Q, cfg.params)
        jax.block_until_ready(res.T)
        dt = time.time() - t0
        T = np.asarray(res.T, np.float64)
        r, t = registration_error(T, T_gt)
        hit = is_registered(T, T_gt, cfg.rot_thresh_deg, cfg.trans_thresh)
        flags.append(hit); rots.append(r); trans.append(t); times.append(dt)
        success.append(bool(res.success))
        if log:
            log.log(dict(config=cfg.name, pair=s, n=cfg.n_corr, rot_err_deg=r,
                         trans_err=t, registered=bool(hit), wall_s=dt,
                         success=success[-1]))
    return dict(
        config=cfg.name, pairs=cfg.n_pairs, n_corr=cfg.n_corr,
        recall=float(np.mean(flags)), mean_rot_err_deg=float(np.mean(rots)),
        mean_trans_err=float(np.mean(trans)),
        mean_wall_s=float(np.mean(times[1:])) if len(times) > 1 else times[0],
        all_success=all(success),
    )


def run_slam_config(cfg: RunConfig, log: Optional[JsonlLogger] = None,
                    ckpt: Optional[str] = None) -> Dict:
    """Config 5: sequence SLAM — SAC-COT edges, pose graph, track BA, ATE.

    With `ckpt`, BA checkpoints every 2 GN iterations and a rerun resumes
    mid-solve (utils/checkpoint.save_slam_state; SURVEY.md section 5).
    """
    from saccot.slam.frontend import run_sequence

    seq = slam_sequence(
        seed=cfg.seed, n_scans=cfg.n_scans, n_corr=cfg.n_corr,
        outlier_ratio=cfg.outlier_ratio, noise=cfg.noise, loop_every=cfg.loop_every,
    )
    t0 = time.time()
    res = run_sequence(
        n_scans=cfg.n_scans, edges=seq["edges"], edge_P=seq["edge_P"],
        edge_Q=seq["edge_Q"], params=cfg.params,
        ckpt_path=ckpt, ba_ckpt_every=2 if ckpt else 0, log=log,
    )
    jax.block_until_ready(res.poses)
    dt = time.time() - t0
    err_pgo = ate(np.asarray(res.pose_graph_result.poses, np.float64), seq["poses_gt"])
    err_final = ate(np.asarray(res.poses, np.float64), seq["poses_gt"])
    out = dict(
        config=cfg.name, scans=cfg.n_scans, edges=int(seq["edges"].shape[0]),
        ate_rmse=err_final["rmse"], ate_rmse_pgo=err_pgo["rmse"],
        edges_registered=int(np.asarray(res.registration.success).sum()),
        wall_s=dt,
    )
    if res.ba_stats is not None:
        out["ba_tracks"] = res.ba_stats["n_tracks_kept"]
        out["ba_multiview_tracks"] = res.ba_stats["multiview_tracks"]
        out["ba_obs_truncated"] = res.ba_stats["n_obs_truncated"]
    if log:
        log.log(dict(**out))
    return out


def run_u3m_allpairs_config(cfg: RunConfig, log: Optional[JsonlLogger] = None) -> Dict:
    """Config 2, full U3M semantics: the complete V(V-1)/2 pairwise sweep
    over one model's view set (BASELINE.json:8), recall aggregated over the
    pair list with the model-RMSE criterion.

    Views are index subsets of one shared model cloud (io/synthetic.
    model_views), so every pair's surface overlap is exact:
    |idx_i & idx_j| / min(|i|, |j|). Per-view features are extracted ONCE
    and reused across the V-1 pairs each view participates in (the same
    economy sequence mode uses). Recall is reported over all pairs AND over
    the >= `overlap`-threshold subset (low-overlap pairs are unregistrable
    in principle — U3M's published recalls are vs overlap bands), plus a
    recall-vs-overlap-band table.
    """
    mv = model_views(seed=cfg.seed, n_views=cfg.n_views,
                     n_points=cfg.n_points, noise=0.002)
    V = cfg.n_views
    pipe = cfg.pipeline

    feats = [extract_scan_features(jnp.asarray(v), pipe) for v in mv["views"]]
    sets = [set(ix.tolist()) for ix in mv["idx"]]

    bands = [(0.0, 0.2), (0.2, 0.4), (0.4, 0.6), (0.6, 1.01)]
    band_hit = [0] * len(bands)
    band_tot = [0] * len(bands)
    ok_all, n_all, ok_elig, n_elig = 0, 0, 0, 0
    times = []
    for i in range(V):
        for j in range(i + 1, V):
            ov = len(sets[i] & sets[j]) / max(min(len(sets[i]), len(sets[j])), 1)
            T_gt = mv["T"][j] @ np.linalg.inv(mv["T"][i])
            t0 = time.time()
            res = register_scan_features(feats[i], feats[j], pipe)
            T = np.asarray(res.registration.T, np.float64)
            times.append(time.time() - t0)
            rmse = model_rmse(T, T_gt, np.asarray(mv["views"][i], np.float64))
            hit = bool(rmse < cfg.rmse_mult * float(res.resolution))
            n_all += 1
            ok_all += hit
            if ov >= cfg.overlap:
                n_elig += 1
                ok_elig += hit
            for b, (lo, hi) in enumerate(bands):
                if lo <= ov < hi:
                    band_tot[b] += 1
                    band_hit[b] += hit
            if log:
                log.log(dict(config=cfg.name, view_i=i, view_j=j,
                             overlap=round(ov, 3), model_rmse=float(rmse),
                             registered=hit))
    return dict(
        config=cfg.name, views=V, pairs=n_all,
        recall_all_pairs=ok_all / max(n_all, 1),
        eligible_pairs=n_elig,
        recall=ok_elig / max(n_elig, 1),
        overlap_threshold=cfg.overlap,
        recall_by_overlap_band={
            f"{lo:.1f}-{hi:.1f}": (band_hit[b] / band_tot[b] if band_tot[b] else None)
            for b, (lo, hi) in enumerate(bands)
        },
        pairs_by_overlap_band={
            f"{lo:.1f}-{hi:.1f}": band_tot[b] for b, (lo, hi) in enumerate(bands)
        },
        mean_wall_s=float(np.mean(times[1:])) if len(times) > 1 else times[0],
    )


def run_config(cfg: RunConfig, **kw) -> Dict:
    return {
        "pipeline": run_pipeline_config,
        "u3m": run_u3m_allpairs_config,
        "sweep": run_sweep_config,
        "kitti": run_kitti_config,
        "slam": run_slam_config,
    }[cfg.kind](cfg, **kw)
