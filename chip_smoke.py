"""Run the registration engine's main path once on a CUDA GPU and check it.

    python chip_smoke.py               # one card: phases 1-8 below
    python chip_smoke.py --four-cards  # the sharded sweep + sharded SLAM
                                       # steps on four cards, nothing else

Everything runs in this one process (a second JAX process could not reserve
the card's memory). The script stops with a non-zero exit at the first
failed check and catches no exception. Its last stdout line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.

One-card phases:
  1. device      - JAX's first device is a GPU, else exit 1.
  2. bench point - register_batch at N=1000 x 128 pairs, 80% outliers, with
                   bench.py's fast and exact params: recall >= 0.95; 8 pairs
                   re-run on the CPU device agree; the NumPy oracle recovers
                   T_gt on 2 pairs.
  3. compat      - the Triton degree kernel vs engine/compat.degrees at
                   N=1000 x 128 and N=50,000 x 1.
  4. kitti       - run_config(kitti): N=50,000 x 2 pairs, success on both.
  5. threedmatch - run_config(threedmatch): N=2048 x 32 pairs; 4 pairs
                   re-run on the CPU device agree.
  6. bunny       - run_config(bunny): the full cloud -> transform pipeline.
  7. slam        - run_config(slam) on the card and on the CPU device.
  8. CLI         - saccot.cli.main.main(["threedmatch", "--pairs", "8"]).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np


def say(*a):
    print(*a, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        say(f"FAILED: {what}")
        sys.exit(1)


@contextlib.contextmanager
def phase(name: str):
    say(f"== {name}")
    t0 = time.perf_counter()
    yield
    say(f"== {name} passed in {time.perf_counter() - t0:.1f}s")


def require_gpu():
    """Phase 1: the first JAX device must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        say(f"FAILED: no GPU found (JAX's first device is {dev.platform})")
        sys.exit(1)
    return dev


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _agree(res_a, res_b, scale, what, rot_deg=0.05, trans_rel=1e-3):
    """num_inliers within 1, rotations within rot_deg, translations within
    trans_rel of the scene scale, pair by pair."""
    from saccot.utils import se3np

    inl_a = np.asarray(res_a.num_inliers, np.int64)
    inl_b = np.asarray(res_b.num_inliers, np.int64)
    d_inl = int(np.max(np.abs(inl_a - inl_b)))
    T_a = np.asarray(res_a.T, np.float64)
    T_b = np.asarray(res_b.T, np.float64)
    d_rot = max(se3np.rotation_angle_deg(
        T_a[b, :3, :3] @ T_b[b, :3, :3].T) for b in range(len(T_a)))
    d_t = float(np.max(np.linalg.norm(T_a[:, :3, 3] - T_b[:, :3, 3], axis=-1)))
    say(f"  {what}: max |d inliers| {d_inl}, max rotation {d_rot:.4f} deg, "
        f"max translation {d_t:.3e} (scene scale {scale:.3f})")
    check(d_inl <= 1, f"{what}: num_inliers differ by {d_inl}")
    check(d_rot <= rot_deg, f"{what}: rotations differ by {d_rot} deg")
    check(d_t <= trans_rel * scale, f"{what}: translations differ by {d_t}")


def bench_point(cpu):
    import jax
    import jax.numpy as jnp

    from bench import EXACT_PARAMS, FAST_PARAMS, planted_batch, recall
    from saccot.engine.sac_cot import register_batch
    from saccot.oracle import sac_cot as oracle_sac_cot

    probs, P_np, Q_np = planted_batch()
    P, Q = jnp.asarray(P_np), jnp.asarray(Q_np)
    scale = float(np.max(np.linalg.norm(Q_np - Q_np.mean(axis=1, keepdims=True),
                                        axis=-1)))
    for label, params in (("fast", FAST_PARAMS), ("exact", EXACT_PARAMS)):
        fn = jax.jit(lambda a, b, params=params: register_batch(a, b, params))
        t0 = time.perf_counter()
        lowered = fn.lower(P, Q)
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        res = jax.block_until_ready(compiled(P, Q))
        t3 = time.perf_counter()
        say(f"  {label}: trace+lower {t1 - t0:.2f}s, compile {t2 - t1:.2f}s, "
            f"first run {t3 - t2:.3f}s")
        say(f"  {label}: memory_analysis {compiled.memory_analysis()}")
        r = recall(res.T, probs)
        say(f"  {label}: recall {r:.3f} over {len(probs)} pairs")
        check(r >= 0.95, f"bench point {label} recall {r} < 0.95")
        sub = slice(0, 8)
        res_cpu = fn(jax.device_put(P_np[sub], cpu),
                     jax.device_put(Q_np[sub], cpu))
        check(list(res_cpu.T.devices())[0].platform == "cpu",
              "CPU re-run did not run on the CPU")
        gpu8 = jax.tree_util.tree_map(lambda x: np.asarray(x)[sub], res)
        _agree(gpu8, res_cpu, scale, f"{label} card vs CPU (8 pairs)")

    from saccot.utils import se3np

    for b in range(2):
        out = oracle_sac_cot(probs[b]["P"], probs[b]["Q"], FAST_PARAMS)
        E = out["T"] @ np.linalg.inv(probs[b]["T_gt"])
        ok = (se3np.rotation_angle_deg(E[:3, :3]) < 5.0
              and np.linalg.norm(E[:3, 3]) < 0.05)
        say(f"  oracle pair {b}: recovers T_gt: {ok}")
        check(ok, f"NumPy oracle missed T_gt on pair {b}")


def compat_kernel():
    """Kernel vs the XLA reference at HIGHEST; rows beyond the f32 tolerance
    are re-derived in float64 to see which side is off."""
    import jax
    import jax.numpy as jnp

    from bench import FAST_PARAMS, planted_batch
    from saccot.cli.configs import CONFIGS
    from saccot.engine import compat as compat_mod
    from saccot.io.synthetic import correspondence_problem
    from saccot.kernels.compat import degrees_triton

    _, P_b, Q_b = planted_batch()
    kp = CONFIGS["kitti"].params
    prob = correspondence_problem(seed=500, n=50000, outlier_ratio=0.7,
                                  noise=0.05 / 30.0, n_points=200000,
                                  max_angle=0.3, max_trans=3.0)
    cases = [
        ("N=1000 x 128", P_b, Q_b, FAST_PARAMS),
        ("N=50000 x 1", prob["P"][None] * 30.0, prob["Q"][None] * 30.0, kp),
    ]
    for what, P_np, Q_np, params in cases:
        P, Q = jnp.asarray(P_np, jnp.float32), jnp.asarray(Q_np, jnp.float32)
        n = P.shape[1]
        ref = jax.jit(jax.vmap(lambda p, q: compat_mod.degrees(
            p, q, p, q, params, block_rows=min(params.degree_block_rows, n))))
        ker = jax.jit(jax.vmap(lambda p, q: degrees_triton(p, q, p, q, params)))
        d_ref = np.asarray(ref(P, Q), np.float64)
        d_ker = np.asarray(ker(P, Q), np.float64)
        P64, Q64 = np.asarray(P, np.float64), np.asarray(Q, np.float64)
        check(np.all(np.isfinite(d_ker)), f"{what}: non-finite degrees")
        diff = np.abs(d_ker - d_ref)
        off = diff > 1.0 + 1e-5 * np.abs(d_ref)
        say(f"  {what}: {int(np.sum(diff > 0))} rows differ at all, "
            f"{int(off.sum())} beyond 1 + 1e-5|deg| of the f32 reference "
            f"(max |d| {diff.max():.4f})")
        # Adjudicate those rows in float64 with direct differences.
        for b, i in zip(*np.nonzero(off)):
            p, q = P64[b], Q64[b]
            dp = np.linalg.norm(p - p[i], axis=-1)
            dq = np.linalg.norm(q - q[i], axis=-1)
            delta = np.abs(dp - dq)
            ok = ((delta < params.compat_tau) & (dp > params.min_separation)
                  & (dq > params.min_separation))
            ok[i] = False
            exact = float(np.sum(np.where(ok, 1 - delta / params.compat_tau, 0)))
            tol = 1.0 + 1e-5 * abs(exact)
            say(f"    row {i}: kernel {d_ker[b, i]:.4f}, f32 reference "
                f"{d_ref[b, i]:.4f}, float64 {exact:.4f}")
            check(abs(d_ker[b, i] - exact) <= tol,
                  f"{what}: kernel row {i} is off the float64 degree")


def kitti():
    from saccot.cli.configs import CONFIGS
    from saccot.cli.runners import run_config

    m = run_config(CONFIGS["kitti"])
    say(f"  {json.dumps(m)}")
    check(m["all_success"], "kitti: a pair found no valid triangle")


def threedmatch(cpu):
    import jax
    import jax.numpy as jnp

    from saccot.cli.configs import CONFIGS
    from saccot.cli.runners import run_config, sweep_problems
    from saccot.engine.sac_cot import register_batch
    from saccot.evaluation.metrics import is_registered
    from saccot.utils.logging import JsonlLogger

    cfg = CONFIGS["threedmatch"]
    buf = io.StringIO()
    m = run_config(cfg, log=JsonlLogger(stream=buf))
    say(f"  {json.dumps(m)}")
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    card = {r["pair"]: r for r in recs}
    probs = sweep_problems(cfg)[:4]
    with jax.default_device(cpu):
        res = register_batch(
            jnp.asarray(np.stack([p["P"] for p in probs])),
            jnp.asarray(np.stack([p["Q"] for p in probs])), cfg.params,
        )
        T = np.asarray(res.T, np.float64)
        inl = np.asarray(res.num_inliers)
    check(list(res.T.devices())[0].platform == "cpu",
          "CPU re-run did not run on the CPU")
    for b, p in enumerate(probs):
        hit = bool(is_registered(T[b], p["T_gt"], cfg.rot_thresh_deg,
                                 cfg.trans_thresh))
        say(f"  pair {b}: card registered={card[b]['registered']} "
            f"inliers={card[b]['num_inliers']}; CPU registered={hit} "
            f"inliers={int(inl[b])}")
        check(hit == card[b]["registered"], f"threedmatch pair {b}: flags differ")
        check(abs(int(inl[b]) - card[b]["num_inliers"]) <= 1,
              f"threedmatch pair {b}: num_inliers differ")


def bunny():
    from saccot.cli.configs import CONFIGS
    from saccot.cli.runners import run_config

    m = run_config(CONFIGS["bunny"])
    say(f"  {json.dumps(m)}")
    check(np.isfinite(m["mean_rot_err_deg"]), "bunny: non-finite error")


def slam(cpu):
    import jax

    from saccot.cli.configs import CONFIGS
    from saccot.cli.runners import run_config

    m = run_config(CONFIGS["slam"])
    say(f"  card: {json.dumps(m)}")
    check(np.isfinite(m["ate_rmse"]) and np.isfinite(m["ate_rmse_pgo"]),
          "slam: non-finite ATE")
    with jax.default_device(cpu):
        mc = run_config(CONFIGS["slam"])
    say(f"  CPU:  {json.dumps(mc)}")
    gap = abs(m["ate_rmse"] - mc["ate_rmse"])
    check(gap <= max(0.1 * mc["ate_rmse"], 0.01),
          f"slam: ate_rmse {m['ate_rmse']} vs CPU {mc['ate_rmse']}")


def cli():
    from saccot.cli.main import main as cli_main

    check(cli_main(["threedmatch", "--pairs", "8"]) == 0, "CLI returned non-zero")


def four_cards():
    """The sharded sweep on four meshes + sharded BA/PGO on four cards."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from saccot.cli.configs import CONFIGS
    from saccot.cli.runners import sweep_problems
    from saccot.dist.mesh import make_mesh
    from saccot.dist.sweep import make_sweep_fn
    from saccot.engine.sac_cot import register_batch
    from saccot.slam.dryrun import dryrun_ba_step, dryrun_pgo_step

    check(len(jax.devices()) == 4, f"need 4 cards, have {len(jax.devices())}")
    cfg = dataclasses.replace(CONFIGS["threedmatch"], n_pairs=8)
    probs = sweep_problems(cfg)
    P_np = np.stack([p["P"] for p in probs])
    Q_np = np.stack([p["Q"] for p in probs])
    scale = float(np.max(np.linalg.norm(Q_np - Q_np.mean(axis=1, keepdims=True),
                                        axis=-1)))
    P, Q = jnp.asarray(P_np), jnp.asarray(Q_np)
    mask = jnp.ones(P.shape[:2], jnp.float32)
    with phase("single-card reference"):
        ref = register_batch(P, Q, cfg.params)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    for kw, ring in [(dict(pairs=4), False), (dict(pairs=2, corr=2), False),
                     (dict(pairs=2, corr=2), True),
                     (dict(pairs=1, hyp=2, corr=2), False)]:
        what = f"sweep mesh {kw} ring_compat={ring}"
        with phase(what):
            params = dataclasses.replace(cfg.params, ring_compat=ring)
            res = make_sweep_fn(make_mesh(**kw), params)(P, Q, mask)
            _agree(res, ref, scale, what, rot_deg=0.2, trans_rel=5e-3)
    with phase("sharded BA + PGO, corr=4"):
        mesh = make_mesh(pairs=1, corr=4)
        one = make_mesh(pairs=1, corr=1, devices=jax.devices()[:1])
        for step, kw in ((dryrun_ba_step, dict(landmark_blocks=4)),
                         (dryrun_pgo_step, {})):
            got, want = step(mesh), step(one, **kw)
            gap = abs(float(got.final_cost) - float(want.final_cost))
            say(f"  {step.__name__}: final cost {float(got.final_cost):.6f} "
                f"on 4 cards vs {float(want.final_cost):.6f} on one")
            check(gap <= 1e-3 * max(abs(float(want.final_cost)), 1e-6),
                  f"{step.__name__}: 4-card cost differs from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    dev = require_gpu()
    import jax

    from saccot.utils.compile_cache import enable_compile_cache

    say(card_line())
    say(f"jax {jax.__version__}; platform={dev.platform} "
        f"kind={dev.device_kind} count={len(jax.devices())}; "
        f"compile cache {enable_compile_cache()}")
    if args.four_cards:
        four_cards()
    else:
        cpu = jax.devices("cpu")[0]
        with phase("bench point"):
            bench_point(cpu)
        with phase("compat kernel"):
            compat_kernel()
        with phase("kitti"):
            kitti()
        with phase("threedmatch"):
            threedmatch(cpu)
        with phase("bunny"):
            bunny()
        with phase("slam"):
            slam(cpu)
        with phase("CLI"):
            cli()
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
