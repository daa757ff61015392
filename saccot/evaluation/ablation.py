"""Sampler-ablation harness: the paper's headline comparison, batched.

The SAC-COT paper's central experimental claim (SURVEY.md section 2.1,
"Triangle ranking" / "Guided sampler") is that compatibility-triangle-guided
sampling registers more pairs than uniform random sampling at the same
sample budget, with the gap widening as the outlier rate rises and the
budget shrinks. Reference users reproduce this as a recall-vs-outlier-rate
table over the estimator and its ablations; this module is that experiment
as one vmapped/jitted program per (sampler, outlier-rate) cell:

    sweep = run_sampler_ablation(outlier_ratios=[0.8, 0.9, 0.95], ...)
    sweep["recall"]["saccot"][0.95]   # etc.

Samplers compared (all sharing the Horn solver + scoring + refine tail, so
the sampler really is the only variable — engine/baselines.py):

  random  — classic 3-point RANSAC, K uniform triples
  edge    — top-K compatibility edges + random third point
  saccot  — ranked compatibility triangles (the full estimator)

Registration criterion is the standard RE/TE threshold test
(evaluation/metrics.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from saccot.engine.baselines import _edge_guided, _ransac
from saccot.engine.sac_cot import _register_pair
from saccot.io.synthetic import correspondence_problem
from saccot.utils import se3np
from saccot.utils.params import SacCotParams

SAMPLERS = ("random", "edge", "saccot")


def _batched_estimators(params: SacCotParams):
    """One jitted (P[B,N,3], Q[B,N,3]) -> T[B,4,4] map per sampler."""

    def random_one(p, q, s):
        return _ransac(p, q, None, params, s).T

    def edge_one(p, q, s):
        return _edge_guided(p, q, None, params, s).T

    def saccot_one(p, q, s):
        del s  # deterministic: ranked triangles, no randomness
        m = jnp.ones(p.shape[:1], jnp.float32)
        return _register_pair(p, q, m, params).T

    # Per-pair RNG seeds ride in as a traced argument so each pair draws
    # independent samples under one vmap.
    return {
        "random": jax.jit(jax.vmap(random_one)),
        "edge": jax.jit(jax.vmap(edge_one)),
        "saccot": jax.jit(jax.vmap(saccot_one)),
    }


def run_sampler_ablation(
    params: SacCotParams,
    outlier_ratios: Sequence[float] = (0.8, 0.9, 0.95),
    n_pairs: int = 32,
    n_corr: int = 1000,
    noise: float = 0.004,
    seed: int = 0,
    rot_thresh_deg: float = 5.0,
    trans_thresh: float = 0.05,
    samplers: Sequence[str] = SAMPLERS,
) -> Dict:
    """Recall of each sampler at each outlier rate, plus per-cell timings.

    Returns {"recall": {sampler: {ratio: float}},
             "mean_rot_err_deg": {...}, "secs": {...},
             "budget": params.max_hypotheses, "n_pairs": n_pairs}.
    All samplers see the IDENTICAL correspondence problems per cell.
    """
    unknown = set(samplers) - set(SAMPLERS)
    if unknown:
        raise ValueError(f"unknown samplers: {sorted(unknown)}")
    fns = _batched_estimators(params)
    recall: Dict[str, Dict[float, float]] = {s: {} for s in samplers}
    rot_err: Dict[str, Dict[float, float]] = {s: {} for s in samplers}
    secs: Dict[str, Dict[float, float]] = {s: {} for s in samplers}

    for ratio in outlier_ratios:
        probs = [
            correspondence_problem(
                seed=seed + 7919 * i + int(ratio * 1e4),
                n=n_corr, outlier_ratio=ratio, noise=noise,
            )
            for i in range(n_pairs)
        ]
        P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
        Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
        T_gt = np.stack([p["T_gt"] for p in probs])
        seeds = jnp.arange(n_pairs, dtype=jnp.int32) + seed

        for s in samplers:
            t0 = time.time()
            T_est = np.asarray(fns[s](P_all, Q_all, seeds), np.float64)
            dt = time.time() - t0
            ok = 0
            errs = []
            for b in range(n_pairs):
                E = T_est[b] @ np.linalg.inv(T_gt[b])
                re = se3np.rotation_angle_deg(E[:3, :3])
                te = float(np.linalg.norm(E[:3, 3]))
                errs.append(re)
                if re < rot_thresh_deg and te < trans_thresh:
                    ok += 1
            recall[s][ratio] = ok / n_pairs
            rot_err[s][ratio] = float(np.mean(errs))
            secs[s][ratio] = dt

    return {
        "recall": recall,
        "mean_rot_err_deg": rot_err,
        "secs": secs,
        "budget": params.max_hypotheses,
        "n_pairs": n_pairs,
        "n_corr": n_corr,
    }


def format_table(result: Dict, metric: str = "recall") -> str:
    """Plain-text paper-style table: samplers x outlier rates."""
    cells = result[metric]
    ratios = sorted(next(iter(cells.values())).keys())
    lines = [
        f"{metric} at K={result['budget']} "
        f"({result['n_pairs']} pairs, N={result['n_corr']})",
        "sampler  " + "  ".join(f"{r:>6.0%}" for r in ratios),
    ]
    for s, row in cells.items():
        lines.append(f"{s:8s}" + "  ".join(f"{row[r]:>6.3f}" for r in ratios))
    return "\n".join(lines)
