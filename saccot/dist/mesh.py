"""Device-mesh setup and multi-host initialization.

The reference is single-process with no communication layer at all
(SURVEY.md section 2.2); this module is the runtime the north-star adds: a `jax.sharding.Mesh` whose axes carry the framework's two
parallelism dimensions —

  "pairs": data parallelism over independent scan pairs (the sweep axis),
  "corr":  sequence-parallel analog over the correspondence axis inside one
           (large-N) registration problem,

with XLA collectives doing all communication (NCCL between GPUs; no
hand-written transport). Multi-host runs use one process per host via
`jax.distributed.initialize`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """One-process-per-host initialization for multi-host pods.

    No-ops on single-process runs (the common CI / one-card case). The
    process count defaults to the JAX_NUM_PROCESSES environment variable;
    pass the coordinator address, process count and id explicitly when
    nothing on the machine describes the cluster.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    pairs: int = 0,
    corr: int = 1,
    hyp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("pairs", "hyp", "corr") mesh.

    pairs=0 means "use all remaining devices on the pairs axis". Axis order
    is ("pairs", "hyp", "corr"): "corr" carries the psum/all_gather
    collectives of one registration problem, "hyp" (the TP analog:
    hypothesis-axis sharding of solve+scoring, SURVEY.md section 2.2) the
    champion reduction, and "pairs" no collectives at all. The cards of one
    host are joined all to all, so the layout follows the algorithm alone;
    across hosts, keep "corr" and "hyp" inside a host. hyp=1 (the default)
    degenerates to the classic two-dimensional DP x SP layout; every
    PartitionSpec that ignores "hyp" keeps working.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    inner = corr * hyp
    if corr < 1 or hyp < 1 or n % max(inner, 1):
        raise ValueError(f"corr*hyp={inner} must divide the device count {n}")
    if pairs == 0:
        pairs = n // inner
    if pairs * inner > n:
        raise ValueError(f"mesh {pairs}x{hyp}x{corr} exceeds {n} devices")
    grid = np.asarray(devs[: pairs * inner]).reshape(pairs, hyp, corr)
    return Mesh(grid, axis_names=("pairs", "hyp", "corr"))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [B, N, ...] batches: pairs over "pairs", N over "corr"."""
    return NamedSharding(mesh, P("pairs", "corr"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_batch_size(total: int, mesh: Mesh, axis: str = "pairs") -> int:
    size = mesh.shape[axis]
    if total % size:
        raise ValueError(f"batch {total} not divisible by mesh axis {axis}={size}")
    return total // size
