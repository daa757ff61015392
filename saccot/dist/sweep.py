"""Sharded registration sweep: DP over pairs x TP over hypotheses x SP over
correspondences.

The reference's dataset sweep is a serial C++ loop over pairs (SURVEY.md
section 3.2) — trivially parallel, which is exactly the axis the target
DP-shards. `make_sweep_fn` compiles one SPMD program over the ("pairs",
"hyp", "corr") mesh:

  - the pair batch [B, N, 3] is sharded B over "pairs" and N over "corr"
    (replicated over "hyp");
  - inside shard_map, each pairs-group runs the estimator on its local
    pairs, with the correspondence axis sharded over "corr" (all-gather of
    points + psum of scores/moments) and the hypothesis pool sharded over
    "hyp" (each device solves/scores K/d hypotheses, best reduced globally
    — the TP analog, SURVEY.md section 2.2; see engine/sac_cot.py);
  - per-pair results come back sharded over "pairs" and are consumed
    host-side by the evaluation harness.

corr=hyp=1 degenerates to pure DP with zero collectives in the hot loop.
The ring compat path (params.ring_compat) rides in the static params.
"""

from __future__ import annotations


from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from saccot.engine.sac_cot import RegistrationResult, _register_pair
from saccot.utils.params import SacCotParams


def make_sweep_fn(
    mesh: Mesh,
    params: SacCotParams,
):
    """Compile a sharded sweep: (P [B,N,3], Q [B,N,3], mask [B,N]) -> results.

    Every device holds B/pairs x N/corr of the problem (and K/hyp of each
    pair's hypothesis pool). Returned RegistrationResult fields are sharded
    [B, ...] over "pairs" (inlier masks additionally over "corr"); scalars
    become per-pair vectors.
    """
    corr_axis = "corr" if mesh.shape.get("corr", 1) > 1 else None
    hyp_axis = "hyp" if mesh.shape.get("hyp", 1) > 1 else None

    def per_pair(p, q, m):
        return _register_pair(
            p, q, m, params, corr_axis=corr_axis, hyp_axis=hyp_axis,
        )

    def local_batch(Pb, Qb, Mb):
        return jax.vmap(per_pair)(Pb, Qb, Mb)

    in_specs = (P("pairs", "corr"), P("pairs", "corr"), P("pairs", "corr"))
    out_specs = RegistrationResult(
        R=P("pairs"),
        t=P("pairs"),
        T=P("pairs"),
        inliers=P("pairs", "corr"),
        num_inliers=P("pairs"),
        best_score=P("pairs"),
        num_valid_triangles=P("pairs"),
        success=P("pairs"),
    )

    sweep = shard_map(
        local_batch, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sweep)


def run_sweep(
    sweep_fn,
    P_all: jnp.ndarray,
    Q_all: jnp.ndarray,
    mask_all: Optional[jnp.ndarray] = None,
) -> RegistrationResult:
    """Convenience driver for a compiled sweep fn on a full batch."""
    if mask_all is None:
        mask_all = jnp.ones(P_all.shape[:2], jnp.float32)
    return sweep_fn(P_all, Q_all, mask_all)
