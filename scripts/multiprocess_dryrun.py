"""Multi-process rehearsal on the CPU: 2 real processes x 4 faked CPU devices.

This is a CPU/gloo rehearsal of the process-group path, run by
tests/test_multiprocess.py; it never touches a GPU.

SURVEY.md section 2.2's comm-backend row specifies "multi-host process group
via jax.distributed.initialize"; every test and dryrun elsewhere runs
single-process, so this harness is the proof that the process-group path
(dist/mesh.init_distributed + cross-process collectives) actually executes:
two local processes join a coordinator on localhost, form one 8-device
("pairs", "hyp", "corr") mesh spanning the process boundary, and run

  1. the DP x SP registration sweep (dist/sweep.make_sweep_fn) — the
     all-gather/psum collectives cross processes over the gloo transport
     (the CPU stand-in for the inter-card transport), and
  2. one distributed Schur-complement BA step (slam/dryrun.dryrun_ba_step).

Usage:
  python scripts/multiprocess_dryrun.py            # parent: spawns 2 workers
  python scripts/multiprocess_dryrun.py --proc I N PORT   # worker role

Exit code 0 + final "multiprocess dryrun ok" line = pass. Used by
tests/test_multiprocess.py.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def _worker(proc_id: int, n_proc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # Workers are spawned by absolute script path; make the repo importable.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Cross-process CPU collectives ride the gloo transport.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from saccot.dist.mesh import init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc,
        process_id=proc_id,
    )
    assert jax.process_count() == n_proc, jax.process_count()
    assert jax.device_count() == 4 * n_proc, jax.devices()
    print(
        f"proc {proc_id}: joined process group "
        f"(local={jax.local_device_count()} global={jax.device_count()})",
        flush=True,
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from saccot.dist.mesh import make_mesh
    from saccot.dist.sweep import make_sweep_fn
    from saccot.io.synthetic import correspondence_problem
    from saccot.utils.params import SacCotParams

    mesh = make_mesh(pairs=4, corr=2)
    n, B = 64, 8
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=16, neighbors_per_anchor=6, max_hypotheses=32,
        degree_block_rows=64,
    )
    # Identical host-local data on every process (same seeds), stitched into
    # global arrays below.
    probs = [correspondence_problem(seed=s, n=n, outlier_ratio=0.4) for s in range(B)]
    P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
    mask = jnp.ones((B, n), jnp.float32)
    P_g, Q_g, m_g = multihost_utils.host_local_array_to_global_array(
        (P_all, Q_all, mask), mesh, (P(), P(), P())
    )

    sweep = make_sweep_fn(mesh, params)
    res = sweep(P_g, Q_g, m_g)
    jax.block_until_ready(res.T)
    success = np.asarray(multihost_utils.process_allgather(res.success, tiled=True))
    inl = np.asarray(multihost_utils.process_allgather(res.num_inliers, tiled=True))
    assert success.all(), f"proc {proc_id}: sweep failed: {success}"
    print(
        f"proc {proc_id}: DPxSP sweep across the process boundary ok "
        f"(B={B}, mean inliers={inl.mean():.1f})",
        flush=True,
    )

    from saccot.slam.dryrun import dryrun_ba_step

    dryrun_ba_step(mesh)
    multihost_utils.sync_global_devices("dryrun_done")
    if proc_id == 0:
        print("multiprocess dryrun ok", flush=True)


def _worker4(proc_id: int, n_proc: int, port: int) -> None:
    """4 OS processes x 2 faked devices: the corr axis SPANS process
    boundaries and the estimator runs the RING compat path
    (params.ring_compat -> dist/ring.degrees_ring), so the ppermute ring
    schedule crosses processes over gloo. Results are
    parity-checked against an unsharded single-process reference computed
    locally from the same seeds.
    """
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from saccot.dist.mesh import init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc,
        process_id=proc_id,
    )
    assert jax.process_count() == n_proc
    assert jax.device_count() == 2 * n_proc

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from saccot.dist.mesh import make_mesh
    from saccot.dist.sweep import make_sweep_fn
    from saccot.engine.sac_cot import register_batch
    from saccot.io.synthetic import correspondence_problem
    from saccot.utils.params import SacCotParams

    # corr=4 over 8 devices: each corr group {4d, 4d+1, 4d+2, 4d+3} spans
    # two processes (2 local devices each), so every ring hop that crosses
    # a 2-device block is a cross-process ppermute.
    mesh = make_mesh(pairs=2, corr=4)
    n, B = 64, 4
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=16, neighbors_per_anchor=6, max_hypotheses=32,
        degree_block_rows=16, ring_compat=True,
    )
    probs = [correspondence_problem(seed=s, n=n, outlier_ratio=0.4) for s in range(B)]
    P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
    Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
    mask = jnp.ones((B, n), jnp.float32)
    P_g, Q_g, m_g = multihost_utils.host_local_array_to_global_array(
        (P_all, Q_all, mask), mesh, (P(), P(), P())
    )
    sweep = make_sweep_fn(mesh, params)
    res = sweep(P_g, Q_g, m_g)
    jax.block_until_ready(res.T)
    T_np = np.asarray(multihost_utils.process_allgather(res.T, tiled=True),
                      np.float64)
    inl = np.asarray(multihost_utils.process_allgather(res.num_inliers, tiled=True))

    # Parity: unsharded local reference (ring off) from identical data.
    import dataclasses as _dc
    ref_params = _dc.replace(params, ring_compat=False)
    ref = register_batch(P_all, Q_all, params=ref_params, mask=mask)
    T_ref = np.asarray(ref.T, np.float64).reshape(T_np.shape)
    inl_ref = np.asarray(ref.num_inliers).reshape(inl.shape)
    assert np.allclose(T_np, T_ref, atol=1e-5), (
        f"proc {proc_id}: ring-sharded transforms diverge from reference"
    )
    assert (inl == inl_ref).all(), (inl, inl_ref)
    print(
        f"proc {proc_id}: 4-process corr-ring sweep ok "
        f"(mesh pairs=2 x corr=4, inliers {inl.tolist()})",
        flush=True,
    )
    multihost_utils.sync_global_devices("proc4_done")
    if proc_id == 0:
        print("multiprocess-4 ring dryrun ok", flush=True)


def _worker_ckpt_sweep(
    proc_id: int, n_proc: int, port: int,
    ckpt_dir: str, out_path: str, fault_after: int,
) -> None:
    """Checkpointed sharded sweep worker for the kill-one-process fault
    test (SURVEY.md section 5, failure detection).

    Runs a 6-shard pair sweep over the 2-process mesh, checkpointing each
    shard's (all-gathered, replicated) results from process 0. With
    `fault_after >= 0`, process 1 SIGKILLs itself right after the shard
    barrier that guarantees that shard's checkpoint is on disk — process 0
    then dies on the next cross-process collective and the job is gone,
    exactly like a lost host. A relaunch with the same ckpt_dir resumes
    from the shard boundary: completed shards come from the checkpoint,
    only the remainder is recomputed.
    """
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from saccot.dist.mesh import init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc,
        process_id=proc_id,
    )

    import signal

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from saccot.dist.mesh import make_mesh
    from saccot.dist.sweep import make_sweep_fn
    from saccot.io.synthetic import correspondence_problem
    from saccot.utils.checkpoint import SweepCheckpointer
    from saccot.utils.params import SacCotParams

    mesh = make_mesh(pairs=4, corr=2)
    n, B, n_shards = 64, 4, 6
    params = SacCotParams(
        compat_tau=0.03, min_separation=0.05, inlier_tau=0.03,
        num_anchors=16, neighbors_per_anchor=6, max_hypotheses=32,
        degree_block_rows=64,
    )
    sweep = make_sweep_fn(mesh, params)
    # Every process reads the shared checkpoint; only process 0 writes it,
    # so the done-shard view is consistent across the group at (re)start.
    ckptr = SweepCheckpointer(os.path.join(ckpt_dir, "sweep"))
    if proc_id != 0:
        ckptr.path = None  # read-only on non-zero processes

    for shard in range(n_shards):
        if ckptr.is_done(shard):
            print(f"proc {proc_id}: shard {shard} restored from checkpoint",
                  flush=True)
            continue
        probs = [
            correspondence_problem(seed=100 * shard + b, n=n, outlier_ratio=0.4)
            for b in range(B)
        ]
        P_all = jnp.stack([jnp.asarray(p["P"]) for p in probs])
        Q_all = jnp.stack([jnp.asarray(p["Q"]) for p in probs])
        mask = jnp.ones((B, n), jnp.float32)
        P_g, Q_g, m_g = multihost_utils.host_local_array_to_global_array(
            (P_all, Q_all, mask), mesh, (P(), P(), P())
        )
        res = sweep(P_g, Q_g, m_g)
        T_np = np.asarray(
            multihost_utils.process_allgather(res.T, tiled=True), np.float64
        )
        ckptr.record(shard, dict(T=T_np))  # persists on proc 0 only
        # Barrier AFTER the write: once every process passes it, the shard's
        # checkpoint is durably on disk — the fault below cannot lose it.
        multihost_utils.sync_global_devices(f"shard_{shard}_done")
        print(f"proc {proc_id}: shard {shard} computed", flush=True)
        if fault_after >= 0 and shard >= fault_after and proc_id == 1:
            print(f"proc {proc_id}: SIGKILL self after shard {shard}",
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    multihost_utils.sync_global_devices("sweep_complete")
    if proc_id == 0:
        merged = ckptr.merged()["T"]
        np.save(out_path, merged)
        print(f"sweep complete: {merged.shape[0]} pair results", flush=True)


def _run_group(args_per_proc, env, timeout=540):
    """Spawn one worker per arg list; reap them, tolerating a planted kill:
    once any worker dies, surviving workers that block on the now-broken
    process group are killed after a grace period (the job-level failure
    detection a cluster scheduler provides)."""
    import time as _time

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + a, env=env
        )
        for a in args_per_proc
    ]
    rcs = [None] * len(procs)
    deadline = _time.time() + timeout
    grace_until = None
    while any(rc is None for rc in rcs) and _time.time() < deadline:
        for i, p in enumerate(procs):
            if rcs[i] is None:
                rcs[i] = p.poll()
        # Start the kill-survivors grace period only on an ABNORMAL exit:
        # a clean rc=0 worker finishing slightly ahead of its peer (e.g.
        # while proc 0 still merges/saves results) must not doom the rest.
        abnormal = any(rc is not None and rc != 0 for rc in rcs)
        if abnormal and grace_until is None:
            grace_until = _time.time() + 20.0
        if grace_until is not None and _time.time() > grace_until:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    p.kill()
        _time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    return [p.returncode for p in procs]


def run_fault_test() -> int:
    """Kill-one-process fault injection + resume."""
    import shutil
    import tempfile

    import numpy as np

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    work = tempfile.mkdtemp(prefix="saccot_fault_")
    try:
        ck_fault = os.path.join(work, "ck_fault")
        ck_clean = os.path.join(work, "ck_clean")
        out_fault = os.path.join(work, "fault.npy")
        out_clean = os.path.join(work, "clean.npy")

        # Phase A: group dies after shard 2 is checkpointed (proc 1
        # SIGKILLs itself; proc 0 is lost with the group).
        port = _free_port()
        rcs = _run_group(
            [["--ckpt-proc", str(i), "2", str(port), ck_fault, out_fault, "2"]
             for i in range(2)],
            env,
        )
        print(f"phase A (faulted) exit codes: {rcs}")
        if rcs[1] != -9:
            print("expected proc 1 to die by SIGKILL", file=sys.stderr)
            return 1
        if os.path.exists(out_fault):
            print("faulted run must not have produced final results",
                  file=sys.stderr)
            return 1

        # Phase B: restart the group on a fresh coordinator, same ckpt dir.
        port = _free_port()
        rcs = _run_group(
            [["--ckpt-proc", str(i), "2", str(port), ck_fault, out_fault, "-1"]
             for i in range(2)],
            env,
        )
        print(f"phase B (resumed) exit codes: {rcs}")
        if any(rcs):
            return 1

        # Phase C: uninterrupted reference run.
        port = _free_port()
        rcs = _run_group(
            [["--ckpt-proc", str(i), "2", str(port), ck_clean, out_clean, "-1"]
             for i in range(2)],
            env,
        )
        print(f"phase C (clean) exit codes: {rcs}")
        if any(rcs):
            return 1

        T_fault = np.load(out_fault)
        T_clean = np.load(out_clean)
        if T_fault.shape != T_clean.shape or not np.allclose(
            T_fault, T_clean, atol=1e-6
        ):
            print("resumed results differ from the uninterrupted run",
                  file=sys.stderr)
            return 1
        print(
            f"fault-injection test ok: killed proc 1 after shard 2, resumed "
            f"from the shard boundary, {T_fault.shape[0]} pair results "
            f"identical to the uninterrupted run"
        )
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--proc":
        _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--proc4":
        _worker4(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--four":
        n_proc = 4
        port = _free_port()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        rcs = _run_group(
            [["--proc4", str(i), str(n_proc), str(port)] for i in range(n_proc)],
            env,
        )
        if any(rcs):
            print(f"worker exit codes: {rcs}", file=sys.stderr)
            return 1
        print("multiprocess-4 dryrun: all workers exited cleanly")
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--ckpt-proc":
        _worker_ckpt_sweep(
            int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5], sys.argv[6], int(sys.argv[7]),
        )
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--fault-test":
        return run_fault_test()

    n_proc = 2
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--proc", str(i),
             str(n_proc), str(port)],
            env=env,
        )
        for i in range(n_proc)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        print(f"worker exit codes: {rcs}", file=sys.stderr)
        return 1
    print("multiprocess dryrun: all workers exited cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
