"""Headline benchmark: registration throughput on one GPU vs the CPU oracle.

Prints ONE JSON line on stdout:
  {"metric": "pairs_per_sec_per_chip", "value": <pairs/s on one card>,
   "unit": "pairs/s", "vs_baseline": <card rate / CPU-oracle rate>}

Problem setup mirrors the reference's operating point (SURVEY.md section 6 /
BASELINE.md): N=1000 putative correspondences per pair at a 20% inlier rate
(typical FPFH-class matching quality), object-scale thresholds. The CPU
baseline is the NumPy oracle — the same exhaustive-enumeration SAC-COT the
reference implements, vectorized (bitset clique intersection) so the
comparison is honest. Target: >=10x (BASELINE.json:5).

Needs a CUDA GPU: exits 1 when JAX finds none. Diagnostics (device, card
name and power limit, compile split, recall, exact-config rate, CPU rate)
go to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from saccot.utils.params import SacCotParams

N = 1000
BATCH = 128
OUTLIER = 0.8
FAST_PARAMS = SacCotParams(
    compat_tau=0.03,
    min_separation=0.05,
    inlier_tau=0.03,
    num_anchors=256,
    neighbors_per_anchor=12,
    max_hypotheses=1024,
    degree_block_rows=256,
    score_block_k=256,
    # Pool variants, all recall-neutral (checked below at this point and
    # at 0.9/0.95 outliers in tests/test_engine.py):
    # - duplicate triangles keep the argmax landscape (engine/triangles.py)
    # - approx_max_k for the candidate -> K selection
    # - per_anchor_candidates=4: each anchor keeps its own top-4
    #   triangles; with A*T == K the global selection is the identity.
    dedup_triangles=False,
    approx_topk=True,
    per_anchor_candidates=4,
)
# The exact configuration: dedup on, exact top-k over every candidate.
EXACT_PARAMS = dataclasses.replace(
    FAST_PARAMS, dedup_triangles=True, approx_topk=False,
    per_anchor_candidates=0,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card(s), one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def planted_batch(seed0: int = 1000, n: int = N, batch: int = BATCH,
                  outlier: float = OUTLIER):
    """`batch` planted problems: (list of problem dicts, P [B,N,3], Q)."""
    from saccot.io.synthetic import correspondence_problem

    probs = [
        correspondence_problem(seed=seed0 + s, n=n, outlier_ratio=outlier,
                               noise=0.004)
        for s in range(batch)
    ]
    P = np.stack([p["P"] for p in probs])
    Q = np.stack([p["Q"] for p in probs])
    return probs, P, Q


def recall(T_all: np.ndarray, probs) -> float:
    """Share of pairs within 5 deg / 0.05 of the planted T_gt."""
    from saccot.utils import se3np

    ok = 0
    for T, p in zip(np.asarray(T_all, np.float64), probs):
        E = T @ np.linalg.inv(p["T_gt"])
        if (se3np.rotation_angle_deg(E[:3, :3]) < 5.0
                and np.linalg.norm(E[:3, 3]) < 0.05):
            ok += 1
    return ok / len(probs)


def time_batches(fn, args, reps: int) -> float:
    """Seconds per call of `fn(*args)`, steady state, ended on the device."""
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU found (JAX sees {dev.platform}); nothing to measure")
        return 1
    import jax.numpy as jnp

    from saccot.engine.sac_cot import register_batch
    from saccot.oracle import sac_cot as oracle_sac_cot
    from saccot.utils.compile_cache import enable_compile_cache

    log(f"cache: {enable_compile_cache()}")
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    log(f"card: {card_name_and_power_limit()}")

    probs, P_np, Q_np = planted_batch()
    P_all, Q_all = jnp.asarray(P_np), jnp.asarray(Q_np)

    fn = jax.jit(lambda a, b: register_batch(a, b, FAST_PARAMS))
    t0 = time.perf_counter()
    lowered = fn.lower(P_all, Q_all)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(P_all, Q_all))
    t_first = time.perf_counter() - t0
    log(f"cold start: trace+lower {t_trace:.2f}s, compile {t_compile:.2f}s "
        f"(~0 on a persistent-cache hit), first run {t_first:.3f}s")
    log(f"recall on planted problems: {recall(res.T, probs):.3f}")

    reps = 32
    dt = time_batches(compiled, (P_all, Q_all), reps)
    rate = BATCH / dt
    log(f"fast config: {dt * 1e3:.3f} ms/batch of {BATCH} -> "
        f"{rate:.1f} pairs/s")

    fn_exact = jax.jit(lambda a, b: register_batch(a, b, EXACT_PARAMS))
    dt_e = time_batches(fn_exact, (P_all, Q_all), 8)
    log(f"exact config (dedup + exact top-k): {dt_e * 1e3:.3f} ms/batch -> "
        f"{BATCH / dt_e:.1f} pairs/s")

    # CPU oracle baseline on the identical problems.
    n_cpu = 16
    t0 = time.perf_counter()
    for s in range(n_cpu):
        oracle_sac_cot(probs[s]["P"], probs[s]["Q"], FAST_PARAMS)
    cpu_rate = n_cpu / (time.perf_counter() - t0)
    log(f"cpu oracle: {cpu_rate:.3f} pairs/s")

    print(json.dumps({
        "metric": "pairs_per_sec_per_chip",
        "value": round(rate, 3),
        "unit": "pairs/s",
        "vs_baseline": round(rate / cpu_rate, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
