"""Device time of each estimator stage from one profiler trace.

    python scripts/stage_times.py [--out DIR]   # traces go to DIR/<point>

Needs a CUDA GPU. Compiles the estimator at the bench point (N=1000 x 128
pairs, bench.py's fast params) and at the kitti point (N=50,000 x 1 pair),
traces 3 calls of each, and sums the device time of every kernel by the
`saccot_*` named scope (engine/sac_cot.py) that its HLO instruction came
from: degrees, triangles (the pool), svd3 (the 3-point solve), score,
refine. Kernels whose instruction carries no such scope are "other".
Also reports the device's busy share of the traced window.

The process runs with XLA's command buffers (CUDA graphs) off, so each
kernel event in the trace names the HLO instruction it came from; the
untraced wall time it prints is for that setting.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
).strip()

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
_SCOPE = re.compile(r"saccot_(\w+)")


def scope_of_instructions(hlo_text: str):
    """HLO instruction name -> first saccot_* scope in its op_name."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            s = _SCOPE.search(m.group(2))
            if s:
                out[m.group(1)] = s.group(1)
    return out


def stage_device_ms(trace_dir: str, scopes, calls: int):
    """Per-stage device ms per call, busy ms per call, window ms per call,
    and the ten heaviest (stage, kernel) pairs in ms per call."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))[0]
    pd = ProfileData.from_file(path)
    per = collections.Counter()
    kernels = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                stage = scopes.get(str(stats.get("hlo_op", "")))
                if stage is None:
                    m = _SCOPE.search(str(stats.get("tf_op", "")) + e.name)
                    stage = m.group(1) if m else None
                if stage == "compat_degrees":
                    stage = "degrees"
                per[stage or "other"] += e.duration_ns
                kernels[(stage or "other", e.name[:60])] += e.duration_ns
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    return (
        {k: v / 1e6 / calls for k, v in sorted(per.items())},
        busy / 1e6 / calls,
        window / 1e6 / calls,
        [(s, k, v / 1e6 / calls) for (s, k), v in kernels.most_common(10)],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/stages")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    from bench import FAST_PARAMS, card_name_and_power_limit, planted_batch
    from saccot.cli.configs import CONFIGS
    from saccot.engine.sac_cot import register_batch
    from saccot.io.synthetic import correspondence_problem
    from saccot.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"card: {card_name_and_power_limit()}; jax {jax.__version__}")
    _, P_b, Q_b = planted_batch()
    kp = CONFIGS["kitti"]
    prob = correspondence_problem(seed=500, n=50000, outlier_ratio=0.7,
                                  noise=0.05 / 30.0, n_points=200000,
                                  max_angle=0.3, max_trans=3.0)
    points = {
        "bench": (P_b, Q_b, FAST_PARAMS),
        "kitti": (prob["P"][None] * 30.0, prob["Q"][None] * 30.0, kp.params),
    }
    calls = 3
    for name, (P_np, Q_np, params) in points.items():
        P, Q = jnp.asarray(P_np, jnp.float32), jnp.asarray(Q_np, jnp.float32)
        compiled = jax.jit(
            lambda a, b, params=params: register_batch(a, b, params)
        ).lower(P, Q).compile()
        for _ in range(3):
            jax.block_until_ready(compiled(P, Q))
        t0 = time.perf_counter()
        for _ in range(10):
            out = compiled(P, Q)
        jax.block_until_ready(out)
        wall_ms = (time.perf_counter() - t0) / 10 * 1e3
        tdir = os.path.join(args.out, name)
        with jax.profiler.trace(tdir):
            for _ in range(calls):
                jax.block_until_ready(compiled(P, Q))
        hlo = compiled.as_text()
        with open(os.path.join(tdir, "hlo.txt"), "w") as f:
            f.write(hlo)
        stages, busy, window, top = stage_device_ms(
            tdir, scope_of_instructions(hlo), calls)
        print(json.dumps(dict(
            point=name, wall_ms_untraced=wall_ms,
            device_ms_per_call=stages, busy_ms_per_call=busy,
            window_ms_per_call=window,
            idle_share=1.0 - busy / window if window else None,
            top_kernels=top,
        )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
