"""Compatibility degrees as a Pallas kernel through Triton (CUDA GPUs).

The degree stage is the estimator's only O(N^2) work: deg_i = sum_j S_ij
over the virtual score matrix of engine/compat.py. The XLA path streams
[block_rows, N] row blocks through a Gram-trick einsum and materializes the
block's intermediates in device memory. This kernel keeps every entry in
registers instead: one program owns a tile of `tile_rows` rows and loops
over column tiles, evaluating the two squared distances as direct f32
differences (exact for identical points, no cancellation), the rigidity
test, the score, the column mask and the self-pair exclusion, and adding
into a [tile_rows, tile_cols] register accumulator. Each row's degree is
stored once. Device-memory traffic is O(N) points in and O(N) degrees out.

`degrees_triton` has the contract of `engine.compat.degrees`. The
estimator calls it only on CUDA (engine/sac_cot._degrees); tests run it
with `interpret=True` on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from saccot.utils.params import SacCotParams

# Fastest of (rows, cols, warps) in {(64,64,4), (32,128,4), (64,128,8),
# (128,64,8), (128,128,8)} at both N=1000 x 128 pairs and N=50,000 on an
# H100 SXM at 700 W (scripts/compat_trial.py; PERF.md).
TILE_ROWS = 32
TILE_COLS = 128
NUM_WARPS = 4

# Rows of the packed per-point operand: P xyz, Q xyz, mask, and one unused
# row, since Triton block shapes must be powers of two.
_PACK = 8


def _degree_kernel(rid_ref, rows_ref, cols_ref, out_ref, *,
                   n_col_tiles: int, tile_cols: int, tau: float,
                   min_sep: float):
    rid = rid_ref[...]                                    # [TR] global ids
    r = [rows_ref[c, :] for c in range(7)]                # 7 x [TR]

    def body(j, acc):
        c0 = j * tile_cols
        cols = pl.ds(c0, tile_cols)
        c = [cols_ref[k, cols] for k in range(7)]         # 7 x [TC]
        dp2 = None
        dq2 = None
        for k in range(3):
            dpk = r[k][:, None] - c[k][None, :]
            dqk = r[3 + k][:, None] - c[3 + k][None, :]
            dp2 = dpk * dpk if dp2 is None else dp2 + dpk * dpk
            dq2 = dqk * dqk if dq2 is None else dq2 + dqk * dqk
        dp = jnp.sqrt(dp2)
        dq = jnp.sqrt(dq2)
        delta = jnp.abs(dp - dq)
        cid = c0 + lax.broadcasted_iota(jnp.int32, (1, tile_cols), 1)
        ok = (
            (delta < tau)
            & (dp > min_sep)
            & (dq > min_sep)
            & (rid[:, None] != cid)
        )
        s = jnp.where(ok, 1.0 - delta * (1.0 / tau), 0.0)
        return acc + s * c[6][None, :]

    acc = lax.fori_loop(
        0, n_col_tiles, body,
        jnp.zeros((rid.shape[0], tile_cols), jnp.float32),
    )
    out_ref[...] = jnp.sum(acc, axis=1) * r[6]


def _pack(P: jnp.ndarray, Q: jnp.ndarray, m: jnp.ndarray, n_pad: int):
    """[N, 3] x 2 + [N] mask -> [8, n_pad] f32, zero (mask 0) padding."""
    x = jnp.concatenate(
        [P.astype(jnp.float32).T, Q.astype(jnp.float32).T,
         m.astype(jnp.float32)[None, :],
         jnp.zeros((1, P.shape[0]), jnp.float32)],
        axis=0,
    )
    return jnp.pad(x, ((0, 0), (0, n_pad - P.shape[0])))


def degrees_triton(
    P_rows: jnp.ndarray,
    Q_rows: jnp.ndarray,
    P_cols: jnp.ndarray,
    Q_cols: jnp.ndarray,
    params: SacCotParams,
    row_offset: int | jnp.ndarray = 0,
    mask_rows: Optional[jnp.ndarray] = None,
    mask_cols: Optional[jnp.ndarray] = None,
    interpret: bool = False,
    tile_rows: int = TILE_ROWS,
    tile_cols: int = TILE_COLS,
    num_warps: int = NUM_WARPS,
) -> jnp.ndarray:
    """Weighted degree of each row node against all column nodes.

    Same contract as `engine.compat.degrees`: P_rows/Q_rows [R, 3],
    P_cols/Q_cols [C, 3] -> deg [R]; `row_offset` is the global index of
    row 0 (nonzero under correspondence-axis sharding). Tile sizes must be
    powers of two.
    """
    R = P_rows.shape[0]
    C = P_cols.shape[0]
    r_pad = pl.cdiv(R, tile_rows) * tile_rows
    n_col_tiles = pl.cdiv(C, tile_cols)
    mr = jnp.ones((R,), jnp.float32) if mask_rows is None else mask_rows
    mc = jnp.ones((C,), jnp.float32) if mask_cols is None else mask_cols
    rows = _pack(P_rows, Q_rows, mr, r_pad)
    cols = _pack(P_cols, Q_cols, mc, n_col_tiles * tile_cols)
    rid = jnp.asarray(row_offset, jnp.int32) + jnp.arange(r_pad, dtype=jnp.int32)

    out = pl.pallas_call(
        functools.partial(
            _degree_kernel,
            n_col_tiles=n_col_tiles,
            tile_cols=tile_cols,
            tau=float(params.compat_tau),
            min_sep=float(params.min_separation),
        ),
        out_shape=jax.ShapeDtypeStruct((r_pad,), jnp.float32),
        grid=(r_pad // tile_rows,),
        in_specs=[
            pl.BlockSpec((tile_rows,), lambda i: (i,)),
            pl.BlockSpec((_PACK, tile_rows), lambda i: (0, i)),
            pl.BlockSpec(cols.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tile_rows,), lambda i: (i,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="saccot_compat_degrees",
    )(rid, rows, cols)
    return out[:R]
