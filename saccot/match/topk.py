"""Descriptor matching as batched GEMM + top-k.

Replaces the reference's FLANN kd-tree nearest-neighbor search over
descriptors (SURVEY.md section 2.1, "Matcher"): a kd-tree is a pointer-chasing
CPU structure with data-dependent control flow — the jitted equivalent is
a dense distance GEMM (descriptors are a few hundred dims, so the [Ns, Nt]
similarity matrix is one matmul) followed by `lax.top_k`. For the
correspondence counts this pipeline uses (N ~ 250-5000 keypoints), the brute
force GEMM is exact and static-shaped.

Outputs fixed-size correspondence sets (static shapes), with a validity mask
carrying the effective count — the padding/bucketing convention used across
the framework.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class Matches(NamedTuple):
    src_idx: jnp.ndarray   # [M] int32 indices into source keypoints
    tgt_idx: jnp.ndarray   # [M] int32 indices into target keypoints
    distance: jnp.ndarray  # [M] float32 descriptor distances
    valid: jnp.ndarray     # [M] bool


def _sq_distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[Ns, D] x [Nt, D] -> squared L2 distances [Ns, Nt] via the Gram trick."""
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    g = jnp.einsum("id,jd->ij", a, b, precision=lax.Precision.HIGHEST)
    return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * g, 0.0)


def match_descriptors(
    desc_src: jnp.ndarray,
    desc_tgt: jnp.ndarray,
    mask_src: Optional[jnp.ndarray] = None,
    mask_tgt: Optional[jnp.ndarray] = None,
    mutual: bool = True,
    ratio_test: float = 0.0,
) -> Matches:
    """Nearest-neighbor correspondences in descriptor space.

    Args:
      desc_src: [Ns, D] source descriptors (padded rows allowed).
      desc_tgt: [Nt, D] target descriptors.
      mask_src/mask_tgt: optional validity masks for padded rows.
      mutual: additionally require the match to be mutual (src's NN in tgt
        has src as its NN back) — the standard reciprocal check.
      ratio_test: if > 0, Lowe-style ratio test d1/d2 < ratio_test.

    Returns one candidate correspondence per valid source keypoint ([Ns]
    fixed shape) with `valid` marking survivors of the filters.
    """
    BIG = jnp.asarray(1e30, desc_src.dtype)
    d2 = _sq_distance_matrix(desc_src, desc_tgt)  # [Ns, Nt]
    if mask_tgt is not None:
        d2 = jnp.where(mask_tgt.astype(bool)[None, :], d2, BIG)

    # Two smallest target distances per source row (for the ratio test);
    # degenerate single-target clouds get d2nd == d1 (ratio test then
    # rejects everything, which is the only sane answer).
    k2 = min(2, d2.shape[1])
    neg_top2, idx_top2 = lax.top_k(-d2, k2)
    nn_idx = idx_top2[:, 0]
    d1 = -neg_top2[:, 0]
    d2nd = -neg_top2[:, k2 - 1]

    valid = jnp.ones(desc_src.shape[0], dtype=bool)
    if mask_src is not None:
        valid &= mask_src.astype(bool)
    valid &= d1 < BIG

    if ratio_test > 0.0:
        valid &= jnp.sqrt(d1) < ratio_test * jnp.sqrt(jnp.maximum(d2nd, 1e-30))

    if mutual:
        d2_t = jnp.swapaxes(d2, 0, 1)  # [Nt, Ns]
        if mask_src is not None:
            d2_t = jnp.where(mask_src.astype(bool)[None, :], d2_t, BIG)
        back = jnp.argmin(d2_t, axis=-1)  # [Nt] best source per target
        valid &= back[nn_idx] == jnp.arange(desc_src.shape[0])

    return Matches(
        src_idx=jnp.arange(desc_src.shape[0], dtype=jnp.int32),
        tgt_idx=nn_idx.astype(jnp.int32),
        distance=jnp.sqrt(d1).astype(jnp.float32),
        valid=valid,
    )


def mutual_filter(matches: Matches, max_matches: int) -> Matches:
    """Compact the best `max_matches` valid matches (by descriptor distance)
    into a fixed-size, front-packed correspondence set.

    Invalid slots get distance +inf and valid=False; downstream consumers use
    the mask. This keeps a static shape while letting configs cap N.
    """
    score = jnp.where(matches.valid, -matches.distance, -jnp.inf)
    _, order = lax.top_k(score, min(max_matches, score.shape[0]))
    take = lambda x: x[order]
    valid = take(matches.valid)
    return Matches(
        src_idx=take(matches.src_idx),
        tgt_idx=take(matches.tgt_idx),
        distance=jnp.where(valid, take(matches.distance), jnp.inf),
        valid=valid,
    )


def gather_correspondences(
    kp_src: jnp.ndarray, kp_tgt: jnp.ndarray, matches: Matches
):
    """Materialize (P, Q, mask) point arrays for the estimator."""
    P = kp_src[matches.src_idx]
    Q = kp_tgt[matches.tgt_idx]
    return P, Q, matches.valid.astype(jnp.float32)
