"""Mesh-resolution estimation.

The reference expresses all thresholds in multiples of the cloud's mesh
resolution `pr` (mean nearest-neighbor spacing) so object-scale and
scene-scale datasets share one parameter table (SURVEY.md section 2.1,
"Preprocess"). Same convention here: `SacCotParams.with_scale(pr)`.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from saccot.features.neighbors import knn, neighbor_validity


def mesh_resolution(
    points: jnp.ndarray, mask: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Mean distance to the nearest (non-self) neighbor. [N, 3] -> scalar."""
    d, _ = knn(points, points, k=1, query_mask=mask, ref_mask=mask, exclude_self=True)
    ok = neighbor_validity(d)[:, 0]
    if mask is not None:
        ok &= mask.astype(bool)
    w = ok.astype(points.dtype)
    return jnp.sum(d[:, 0] * w) / jnp.maximum(jnp.sum(w), 1.0)
