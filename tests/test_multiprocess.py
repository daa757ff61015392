"""Real multi-process process-group validation.

Launches scripts/multiprocess_dryrun.py: 2 OS processes x 4 faked CPU
devices join a jax.distributed coordinator on localhost and run the DP x SP
sweep + distributed BA across the process boundary — the only coverage of
dist/mesh.init_distributed actually initializing a process group.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multiprocess_dryrun.py")


def test_multiprocess_dryrun():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device-count flag
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, SCRIPT],
        capture_output=True, text=True, timeout=540, env=env,
    )
    if out.returncode != 0 and "UNAVAILABLE" in out.stderr:
        pytest.skip(f"distributed coordinator unavailable: {out.stderr[-200:]}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "all workers exited cleanly" in out.stdout
    assert "DPxSP sweep across the process boundary ok" in out.stdout

def test_multiprocess_fault_injection():
    """Kill-one-process fault injection (SURVEY.md section 5 failure
    detection): a 2-process checkpointed sweep loses
    process 1 to SIGKILL mid-sweep, the group is restarted with the same
    checkpoint dir, and the resumed run's results are identical to an
    uninterrupted run — restart-from-shard-boundary is the elasticity
    mechanism."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, SCRIPT, "--fault-test"],
        capture_output=True, text=True, timeout=540, env=env,
    )
    if out.returncode != 0 and "UNAVAILABLE" in out.stderr:
        pytest.skip(f"distributed coordinator unavailable: {out.stderr[-200:]}")
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    assert "fault-injection test ok" in out.stdout
    assert "SIGKILL self after shard 2" in out.stdout
    assert "restored from checkpoint" in out.stdout


def test_multiprocess_four_proc_ring():
    """4 OS processes x 2 faked devices: the corr mesh
    axis spans process boundaries and the estimator runs the ppermute RING
    compat path across them, parity-checked in-worker against an unsharded
    reference."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, SCRIPT, "--four"],
        capture_output=True, text=True, timeout=540, env=env,
    )
    if out.returncode != 0 and "UNAVAILABLE" in out.stderr:
        pytest.skip(f"distributed coordinator unavailable: {out.stderr[-200:]}")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "multiprocess-4 ring dryrun ok" in out.stdout
    assert out.stdout.count("4-process corr-ring sweep ok") == 4
