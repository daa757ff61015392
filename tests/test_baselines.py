"""Baseline-estimator tests: RANSAC / edge-guided samplers and the ablation.

These validate the paper-style comparison the baselines exist for: at equal
sample budgets, triangle-guided sampling (SAC-COT) survives outlier rates
where uniform random sampling collapses, with edge-guided sampling in
between. Budgets/outlier rates are chosen so the ordering is deterministic
at the fixed seeds, not a coin flip.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from saccot.engine.baselines import (
    edge_guided_register_pair, ransac_register_pair, sampler_ablation,
)
from saccot.io.synthetic import correspondence_problem
from saccot.utils import se3np
from saccot.utils.params import SacCotParams

PARAMS = SacCotParams(
    compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
    num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
)


def _rot_err(T_est, T_gt):
    E = np.asarray(T_est, np.float64) @ np.linalg.inv(T_gt)
    return se3np.rotation_angle_deg(E[:3, :3])


def test_ransac_recovers_at_low_outliers():
    prob = correspondence_problem(seed=5, n=400, outlier_ratio=0.3, noise=0.003)
    res = ransac_register_pair(
        jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), PARAMS, seed=1
    )
    # Inlier rate 0.7 -> all-inlier triple probability ~0.34; 512 samples
    # make failure probability ~1e-90.
    assert _rot_err(res.T, prob["T_gt"]) < 3.0
    assert int(res.num_inliers) > 200


def test_edge_guided_recovers_at_moderate_outliers():
    prob = correspondence_problem(seed=6, n=500, outlier_ratio=0.8, noise=0.003)
    res = edge_guided_register_pair(
        jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), PARAMS, seed=1
    )
    assert _rot_err(res.T, prob["T_gt"]) < 3.0
    assert int(res.num_inliers) > 60


def test_ransac_respects_mask():
    prob = correspondence_problem(seed=7, n=300, outlier_ratio=0.3, noise=0.003)
    mask = np.ones(300, np.float32)
    mask[150:] = 0.0
    res = ransac_register_pair(
        jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), PARAMS,
        mask=jnp.asarray(mask), seed=1,
    )
    inl = np.asarray(res.inliers)
    assert not inl[150:].any()
    assert _rot_err(res.T, prob["T_gt"]) < 3.0


def test_sampler_ablation_ordering_at_high_outliers():
    """The paper's headline: guided sampling survives where RANSAC collapses.

    At 97% outliers an all-inlier uniform triple has probability ~2.7e-5,
    so a 512-sample RANSAC budget finds none (seed-checked), while the
    compatibility-graph-guided samplers concentrate on inliers. Refinement
    is disabled to compare the raw samplers, not the polish.
    """
    import dataclasses

    prob = correspondence_problem(seed=8, n=1000, outlier_ratio=0.97, noise=0.003)
    params = dataclasses.replace(PARAMS, refine_iters=0)
    out = sampler_ablation(
        jnp.asarray(prob["P"]), jnp.asarray(prob["Q"]), params, seed=3
    )
    err = {k: _rot_err(v.T, prob["T_gt"]) for k, v in out.items()}
    ninl = {k: int(v.num_inliers) for k, v in out.items()}
    assert err["saccot"] < 3.0, (err, ninl)
    assert ninl["saccot"] >= ninl["edge"] >= ninl["ransac"], (err, ninl)
    assert err["ransac"] > 10.0, (err, ninl)  # random sampling fails here


def test_run_sampler_ablation_sweep():
    """Batched recall-vs-outlier-rate sweep (evaluation/ablation.py): the
    recall ordering saccot >= edge >= random must hold per rate, and the
    gap must be visible at the hardest rate."""
    import dataclasses

    from saccot.evaluation.ablation import format_table, run_sampler_ablation

    params = dataclasses.replace(
        PARAMS, num_anchors=96, neighbors_per_anchor=10, max_hypotheses=128,
        refine_iters=0,
    )
    res = run_sampler_ablation(
        params, outlier_ratios=(0.85, 0.95), n_pairs=8, n_corr=384, seed=5
    )
    rec = res["recall"]
    for r in (0.85, 0.95):
        assert rec["saccot"][r] >= rec["edge"][r] >= rec["random"][r], rec
    assert rec["saccot"][0.95] >= 0.75, rec
    assert rec["random"][0.95] <= 0.25, rec
    table = format_table(res)
    assert "saccot" in table and "85%" in table


def test_cli_ablate_smoke(capsys):
    """`saccot ablate` prints one JSON line with the recall table."""
    import json

    from saccot.cli.main import main

    rc = main([
        "ablate", "--cpu", "--pairs", "4", "--corr", "256",
        "--outliers", "0.85", "--budget", "128",
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(out)
    assert set(payload["recall"]) == {"random", "edge", "saccot"}
    assert payload["budget"] == 128


def test_roofline_model_accounting():
    """Analytic roofline bounds (evaluation/roofline.py): binding resource
    and fraction-of-peak arithmetic against the H100 entry."""
    from saccot.evaluation.roofline import (
        compat_degrees_model, estimator_flop_count, peaks_for,
        roofline_fraction, scoring_model, stage_bound_seconds,
    )

    m = compat_degrees_model(n=1000, batch=32)
    assert m["flops"] == 25.0 * 32 * 1000 * 1000
    assert m["bytes"] == 32 * 7000 * 4.0
    # O(N^2) compute vs O(N) traffic: compute-bound by orders of magnitude.
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    r = roofline_fraction(m, measured_seconds=1e-3, peaks=peaks)
    assert r["binding"] == "compute"
    expect = m["flops"] / peaks.f32_flops / 1e-3
    assert abs(r["fraction_of_peak"] - expect) < 1e-9
    assert stage_bound_seconds(m, peaks) == m["flops"] / peaks.f32_flops

    s = scoring_model(n=1000, k=1024, batch=1)
    assert s["flops"] == 28.0 * 1024 * 1000

    total = estimator_flop_count(1000, PARAMS)
    assert total > m["flops"] / 32  # degrees are included


def test_peak_table_h100_entry():
    from saccot.evaluation.roofline import peaks_for

    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert (p.f32_flops, p.tf32_flops, p.bf16_flops) == (67e12, 495e12, 989e12)
    assert p.hbm_bytes_per_s == 3.35e12
    assert "H100" in p.source


def test_peak_table_unknown_kind_raises():
    from saccot.evaluation.roofline import peaks_for

    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("cpu")
