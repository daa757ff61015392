"""Roofline accounting for the estimator's hot stages.

The reference ships no performance model at all (SURVEY.md section 6).
This module makes "how far from speed of light" checkable: for each hot
stage it derives analytic operation and device-memory byte counts from the
problem shape, takes the card's published peaks from `PEAKS` (keyed by
`jax.Device.device_kind`; a kind not in the table is an error, not a
default), and turns a measured time into a fraction of the bound.

The degree and scoring stages are elementwise work over virtual O(N^2) and
O(K*N) fields with O(N) traffic, so their bound is the f32 rate outside the
tensor cores; the byte counts matter for the small-tensor stages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from saccot.utils.params import SacCotParams


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published dense peak rates of one card."""

    f32_flops: float        # FLOP/s, f32 outside the tensor cores
    tf32_flops: float       # FLOP/s, TF32 tensor cores
    bf16_flops: float       # FLOP/s, bf16 tensor cores
    hbm_bytes_per_s: float  # device-memory bandwidth
    source: str


PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        f32_flops=67e12, tf32_flops=495e12, bf16_flops=989e12,
        hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 SXM data sheet, dense rates at 700 W",
    ),
}


def peaks_for(device_kind: str) -> DevicePeaks:
    """The peak table's entry for `device_kind`; KeyError if it has none."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


# Analytic per-element cost of the score evaluation, counted from
# engine/compat.score_block and kernels/compat.py: 2x 3-coordinate squared
# distance (9 FLOPs each incl. the subtract), 2 sqrt (counted as 1 each),
# |dp-dq|, threshold tests, the affine score, the mask multiplies, and the
# row-sum add — ~25 f32 ops per (i, j) entry.
FLOPS_PER_COMPAT_ENTRY = 25.0
# Scoring (engine/score.py): transform p (15), residual to q (9), sqrt
# (1), threshold+mask+accumulate (3) — ~28 ops per (hypothesis, point).
FLOPS_PER_SCORE_ENTRY = 28.0


def compat_degrees_model(n: int, batch: int = 1) -> Dict[str, float]:
    """Operations and minimum device-memory traffic of one batched degree
    computation: points in, degrees out — nothing quadratic."""
    return {
        "flops": FLOPS_PER_COMPAT_ENTRY * batch * n * n,
        "bytes": batch * (2 * n * 3 + n) * 4.0,
    }


def scoring_model(n: int, k: int, batch: int = 1) -> Dict[str, float]:
    """Operations / device-memory bytes for hypothesis scoring: K
    transforms x N points."""
    return {
        "flops": FLOPS_PER_SCORE_ENTRY * batch * k * n,
        "bytes": batch * (2 * n * 3 + k * 12 + k) * 4.0,
    }


def stage_bound_seconds(model: Dict[str, float], peaks: DevicePeaks) -> float:
    """Speed-of-light time of a stage model: the larger of its f32-compute
    and device-memory bounds."""
    return max(model.get("flops", 0.0) / peaks.f32_flops,
               model.get("bytes", 0.0) / peaks.hbm_bytes_per_s)


def roofline_fraction(
    model: Dict[str, float],
    measured_seconds: float,
    peaks: DevicePeaks,
) -> Dict[str, float]:
    """Compare a measured stage time against its compute/memory bounds.

    Returns the two bound times, which resource binds, and the achieved
    fraction of that bound (1.0 = speed of light; >1 means the analytic
    model undercounts, e.g. fusion did better than the model's traffic).
    """
    t_compute = model["flops"] / peaks.f32_flops
    t_memory = model["bytes"] / peaks.hbm_bytes_per_s
    bound = max(t_compute, t_memory)
    return {
        "compute_bound_s": t_compute,
        "memory_bound_s": t_memory,
        "binding": "compute" if t_compute >= t_memory else "memory",
        "fraction_of_peak": bound / max(measured_seconds, 1e-12),
        "measured_s": measured_seconds,
    }


def estimator_flop_count(n: int, params: SacCotParams, batch: int = 1) -> float:
    """Total analytic FLOPs of one estimator invocation (hot stages only).

    Pool/solve stages are small-tensor layout work and contribute O(K)
    FLOPs — included for completeness, negligible.
    """
    k = params.max_hypotheses
    a = params.num_anchors
    flops = FLOPS_PER_COMPAT_ENTRY * n * n          # degrees
    flops += FLOPS_PER_COMPAT_ENTRY * a * n * 2.0   # anchor rows + pool scores
    flops += 250.0 * k                               # Horn solve per hypothesis
    flops += FLOPS_PER_SCORE_ENTRY * k * n          # scoring
    flops += FLOPS_PER_SCORE_ENTRY * n * (params.refine_iters + 1)
    return batch * flops
