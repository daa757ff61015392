"""Compatibility degrees: the XLA loop, the Triton kernel, and who runs which.

`engine.compat.degrees` is checked against the row sums of the dense
`compat_matrix`; the Triton kernel (kernels/compat.py) runs in Pallas
interpret mode here and is checked against `engine.compat.degrees`; the
estimator's platform choice is checked by lowering it for CUDA and for the
CPU without a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from saccot.engine import compat as jcompat
from saccot.engine.sac_cot import register_pair
from saccot.io.synthetic import correspondence_problem
from saccot.kernels.compat import degrees_triton
from saccot.utils.params import SacCotParams

PARAMS = SacCotParams(compat_tau=0.03, min_separation=0.05, inlier_tau=0.03)
# Per row: one pair within f32 rounding of a threshold may flip (worth at
# most 1 degree unit), and the summation order differs.
ROW_ATOL = 1.0


def _problem(n, masked):
    prob = correspondence_problem(seed=n, n=n, outlier_ratio=0.5)
    P, Q = jnp.asarray(prob["P"]), jnp.asarray(prob["Q"])
    mask = None
    if masked:
        mask = jnp.asarray((np.arange(n) % 5 != 3).astype(np.float32))
    return P, Q, mask


def _check_rows(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= ROW_ATOL + 1e-5 * np.abs(want))
    # Flips are rare: nearly every row agrees to f32 summation noise.
    assert np.mean(np.abs(got - want) < 1e-3 + 1e-5 * np.abs(want)) > 0.99


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("n", [100, 257, 1000])
def test_degrees_match_dense_row_sums(n, masked):
    P, Q, mask = _problem(n, masked)
    S = jcompat.compat_matrix(P, Q, PARAMS, mask=mask)
    deg = jcompat.degrees(P, Q, P, Q, PARAMS, mask_rows=mask, mask_cols=mask,
                          block_rows=128)
    _check_rows(deg, jnp.sum(S, axis=-1))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("n", [100, 257, 1000])
def test_degrees_triton_interpret_matches_plain(n, masked):
    P, Q, mask = _problem(n, masked)
    want = jcompat.degrees(P, Q, P, Q, PARAMS, mask_rows=mask, mask_cols=mask)
    got = degrees_triton(P, Q, P, Q, PARAMS, mask_rows=mask, mask_cols=mask,
                         interpret=True)
    _check_rows(got, want)


def test_degrees_triton_interpret_row_offset():
    """A row chunk with a nonzero global offset (the corr-sharded call).
    With a negative min_separation the separation gate passes self-pairs,
    so only the global-id test keeps S_ii out: a wrong offset would add
    1 to every row."""
    import dataclasses

    params = dataclasses.replace(PARAMS, min_separation=-1.0)
    n = 300
    P, Q, mask = _problem(n, True)
    lo, hi = 77, 190
    want = jcompat.degrees(P[lo:hi], Q[lo:hi], P, Q, params, row_offset=lo,
                           mask_rows=mask[lo:hi], mask_cols=mask)
    got = degrees_triton(P[lo:hi], Q[lo:hi], P, Q, params, row_offset=lo,
                         mask_rows=mask[lo:hi], mask_cols=mask,
                         interpret=True, tile_rows=32, tile_cols=64)
    _check_rows(got, want)


def test_estimator_picks_kernel_only_for_cuda():
    """The degree stage lowers to the Triton custom call for CUDA and to
    plain XLA for the CPU — the platform decides, no flag."""
    params = SacCotParams(num_anchors=16, neighbors_per_anchor=6,
                          max_hypotheses=32)
    P = jnp.ones((64, 3), jnp.float32)
    traced = jax.jit(lambda p, q: register_pair(p, q, params)).trace(P, P)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert cuda.count("__gpu$xla.gpu.triton") == 1
    assert "saccot_compat_degrees" in cuda
    assert "triton" not in cpu


@pytest.mark.gpu
def test_degrees_triton_compiled_on_card(gpu_device):
    """The kernel as compiled for the card agrees with the XLA loop."""
    P, Q, mask = _problem(1000, True)
    P, Q, mask = (jax.device_put(x, gpu_device) for x in (P, Q, mask))
    want = jcompat.degrees(P, Q, P, Q, PARAMS, mask_rows=mask, mask_cols=mask)
    got = jax.jit(lambda p, q, m: degrees_triton(
        p, q, p, q, PARAMS, mask_rows=m, mask_cols=m))(P, Q, mask)
    _check_rows(got, want)
