"""Ring-scheduled compatibility degrees over `ppermute` (SP alternative).

SURVEY.md section 2.2 frames the large-N compatibility matrix as the
ring-attention analog: stream column blocks around the device ring while
each chip accumulates its row-block reductions. This module implements that
schedule literally: at step s, device i holds the column block originally
owned by device (i - s) mod d, scores its local rows against it, adds the
row sums, and forwards the block to its right neighbor.

Note on when to use it: because every matrix entry is a function of six
floats of point data, the default SP path (engine/sac_cot.py) instead does
one [N, 3] `all_gather` and computes blocks locally — same O(N) bytes over
the interconnect, fewer synchronization points. The ring variant is kept as
a tested alternative because it never holds more than 2 column blocks in
memory. The `ppermute` between steps is an XLA collective (NCCL on GPUs);
the compiler's async collectives provide whatever overlap there is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from saccot.engine import compat as compat_mod
from saccot.utils.params import SacCotParams


def degrees_ring(
    P_loc: jnp.ndarray,
    Q_loc: jnp.ndarray,
    params: SacCotParams,
    axis_name: str,
    mask_loc: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Weighted degrees of the local row chunk via a column-block ring.

    Must be called inside shard_map with the correspondence axis sharded
    over `axis_name` (equal chunk sizes). Returns deg [N_local] — identical
    (up to f32 summation order) to the all-gather + blockwise path.
    """
    d = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    n_loc = P_loc.shape[0]
    m_loc = jnp.ones((n_loc,), jnp.float32) if mask_loc is None else mask_loc.astype(jnp.float32)

    row_ids = i * n_loc + jnp.arange(n_loc, dtype=jnp.int32)
    perm = [(j, (j + 1) % d) for j in range(d)]

    deg = jnp.zeros((n_loc,), jnp.float32)
    block: Tuple[jnp.ndarray, ...] = (P_loc, Q_loc, m_loc)
    src = i
    for step in range(d):  # static ring schedule, d known at trace time
        pc, qc, mc = block
        col_ids = src * n_loc + jnp.arange(n_loc, dtype=jnp.int32)
        S = compat_mod.score_block(
            P_loc, Q_loc, pc, qc, params,
            row_ids=row_ids, col_ids=col_ids,
            mask_rows=m_loc, mask_cols=mc,
        )
        deg = deg + jnp.sum(S, axis=-1)
        if step + 1 < d:
            block = lax.ppermute(block, axis_name, perm)
            src = (src - 1) % d
    return deg
