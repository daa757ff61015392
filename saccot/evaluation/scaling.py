"""Scaling-efficiency harness: pairs/sec at increasing mesh sizes.

Measures the DP sweep's throughput at mesh sizes 1, 2, ..., full and
reports efficiency = rate(n) / (n * rate(1)) — the >=80% target from
BASELINE.md. On several cards this measures the sweep's scaling; on
the faked CPU mesh it validates the harness mechanics and the SPMD program
(the numbers themselves are host-bound there). Every timed window ends in
`jax.block_until_ready`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from saccot.dist.mesh import make_mesh
from saccot.dist.sweep import make_sweep_fn
from saccot.io.synthetic import correspondence_problem
from saccot.utils.params import SacCotParams


def measure_scaling(
    params: SacCotParams,
    n_corr: int = 512,
    pairs_per_device: int = 8,
    reps: int = 5,
    corr: int = 1,
    device_counts: Optional[List[int]] = None,
) -> Dict:
    """Throughput at each device count; returns rates + efficiencies."""
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    results = {}
    for d in device_counts:
        mesh = make_mesh(pairs=d // corr if d >= corr else 1, corr=min(corr, d),
                         devices=jax.devices()[:d])
        B = pairs_per_device * mesh.shape["pairs"]
        probs = [
            correspondence_problem(seed=1000 + s, n=n_corr, outlier_ratio=0.7)
            for s in range(B)
        ]
        P = jnp.stack([jnp.asarray(p["P"]) for p in probs])
        Q = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
        mask = jnp.ones((B, n_corr), jnp.float32)
        sweep = make_sweep_fn(mesh, params)
        jax.block_until_ready(sweep(P, Q, mask))  # compile + drain
        t0 = time.perf_counter()
        for _ in range(reps):
            r = sweep(P, Q, mask)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / reps
        results[d] = B / dt

    base = results[device_counts[0]] / device_counts[0]
    efficiency = {d: results[d] / (d * base) for d in device_counts}
    return dict(
        pairs_per_sec=results,
        efficiency=efficiency,
        device_counts=device_counts,
    )
