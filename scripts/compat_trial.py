"""Triton degree kernel vs XLA's plain degree loop, alone and end to end.

    python scripts/compat_trial.py [--trace DIR]

Needs a CUDA GPU. Times, at the bench point (N=1000 x 128 pairs, bench.py's
fast params) and at the kitti point (N=50,000 x 1 pair):

  1. the degree stage alone: the kernel at a few tile shapes, and
     `engine.compat.degrees`;
  2. the whole estimator through `_register_pair`, once with the kernel
     (what the platform picks on CUDA) and once with the plain loop,
     in the order kernel, plain, plain, kernel.

With --trace it also writes one profiler trace of each estimator run to
DIR/<point>_<path>/ for stage attribution. Prints one JSON line per
measurement; times are medians of wall-clock reps ended by
`jax.block_until_ready`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    from saccot.cli.configs import CONFIGS
    from saccot.engine import compat as compat_mod
    from saccot.engine import sac_cot
    from saccot.io.synthetic import correspondence_problem
    from saccot.kernels.compat import degrees_triton
    from saccot.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}; {jax.devices()[0].device_kind}")

    from bench import FAST_PARAMS

    kitti = CONFIGS["kitti"]
    points = {
        "bench": dict(n=1000, batch=128, params=FAST_PARAMS, outlier=0.8,
                      noise=0.004, scale=1.0),
        "kitti": dict(n=50000, batch=1, params=kitti.params,
                      outlier=kitti.outlier_ratio, noise=kitti.noise / 30.0,
                      scale=30.0),
    }

    def plain_degrees(P, Q, P_full, Q_full, params, row_offset, m, m_full):
        return compat_mod.degrees(
            P, Q, P_full, Q_full, params, row_offset=row_offset,
            mask_rows=m, mask_cols=m_full,
            block_rows=min(params.degree_block_rows, P.shape[0]),
        )

    kernel_degrees = sac_cot._degrees
    for name, pt in points.items():
        n, batch, params = pt["n"], pt["batch"], pt["params"]
        probs = [
            correspondence_problem(
                seed=1000 + s, n=n, outlier_ratio=pt["outlier"],
                noise=pt["noise"],
                **({} if name == "bench" else dict(n_points=4 * n,
                                                    max_angle=0.3,
                                                    max_trans=3.0)),
            )
            for s in range(batch)
        ]
        P = jnp.asarray(np.stack([p["P"] for p in probs]) * pt["scale"])
        Q = jnp.asarray(np.stack([p["Q"] for p in probs]) * pt["scale"])
        reps = 20 if name == "bench" else 10

        ref = jax.jit(jax.vmap(lambda p, q: compat_mod.degrees(
            p, q, p, q, params, block_rows=min(params.degree_block_rows, n))))
        d_ref = np.asarray(ref(P, Q))
        ms = _median_ms(ref, (P, Q), reps)
        print(json.dumps(dict(point=name, what="degrees_plain", ms=ms)))
        for tr, tc, nw in [(64, 64, 4), (32, 128, 4), (64, 128, 8),
                           (128, 64, 8), (128, 128, 8)]:
            fn = jax.jit(jax.vmap(lambda p, q: degrees_triton(
                p, q, p, q, params, tile_rows=tr, tile_cols=tc,
                num_warps=nw)))
            d = np.asarray(fn(P, Q))
            tol = 1.0 + 1e-5 * np.abs(d_ref)
            n_diff = int(np.sum(np.abs(d - d_ref) > tol))
            ms = _median_ms(fn, (P, Q), reps)
            print(json.dumps(dict(
                point=name, what="degrees_kernel", tiles=[tr, tc, nw], ms=ms,
                rows_out_of_tol=n_diff,
                max_abs_diff=float(np.max(np.abs(d - d_ref))),
            )))

        def estimator():
            return jax.jit(jax.vmap(
                lambda p, q: sac_cot._register_pair(p, q, None, params)))

        results = {"kernel": [], "plain": []}
        for label in ("kernel", "plain", "plain", "kernel"):
            sac_cot._degrees = kernel_degrees if label == "kernel" else plain_degrees
            fn = estimator()
            t0 = time.perf_counter()
            compiled = fn.lower(P, Q).compile()
            t_compile = time.perf_counter() - t0
            sac_cot._degrees = kernel_degrees
            ms = _median_ms(compiled, (P, Q), reps)
            res = compiled(P, Q)
            results[label].append(ms)
            print(json.dumps(dict(
                point=name, what="estimator", degrees=label, ms=ms,
                compile_s=t_compile,
                mean_inliers=float(np.mean(np.asarray(res.num_inliers))),
            )))
            if len(results[label]) == 1:  # first run of each path
                if args.trace:
                    with jax.profiler.trace(
                            os.path.join(args.trace, f"{name}_{label}")):
                        for _ in range(3):
                            jax.block_until_ready(compiled(P, Q))
                print(f"memory_analysis[{name}, {label}]: "
                      f"{compiled.memory_analysis()}")
        print(json.dumps(dict(
            point=name, what="estimator_summary",
            kernel_ms=results["kernel"], plain_ms=results["plain"],
        )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
