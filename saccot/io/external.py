"""External (learned) descriptor ingestion — the FCGF-style path.

The reference's 3DMatch experiments consume learned FCGF descriptors from
files rather than computing SHOT/FPFH (SURVEY.md section 2.1,
"Descriptors"). This module loads keypoint+descriptor pairs from `.npz`
archives (keys: `xyz` [N, 3], `desc` [N, D]) and produces the padded,
masked correspondence sets the estimator consumes — the estimator API takes
correspondences, so any descriptor source plugs in here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import jax.numpy as jnp

from saccot.match.topk import match_descriptors, mutual_filter


def load_descriptors_npz(path: str) -> Dict[str, np.ndarray]:
    """Load {xyz [N,3], desc [N,D]} from an .npz archive."""
    with np.load(path) as z:
        xyz = np.asarray(z["xyz"], np.float32)
        desc = np.asarray(z["desc"], np.float32)
    if xyz.shape[0] != desc.shape[0]:
        raise ValueError(f"{path}: xyz/desc row mismatch {xyz.shape} vs {desc.shape}")
    return dict(xyz=xyz, desc=desc)


def save_descriptors_npz(path: str, xyz: np.ndarray, desc: np.ndarray) -> None:
    np.savez_compressed(path, xyz=np.asarray(xyz, np.float32), desc=np.asarray(desc, np.float32))


def correspondences_from_descriptors(
    src: Dict[str, np.ndarray],
    tgt: Dict[str, np.ndarray],
    max_correspondences: int = 2048,
    mutual: bool = True,
    ratio_test: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(P, Q, mask) correspondence arrays from two descriptor sets.

    Pads both clouds' keypoints to equal static shapes, matches in
    descriptor space (GEMM + top-k), and compacts the best
    `max_correspondences` matches.
    """
    ds = jnp.asarray(src["desc"])
    dt = jnp.asarray(tgt["desc"])
    m = match_descriptors(ds, dt, mutual=mutual, ratio_test=ratio_test)
    m = mutual_filter(m, max_correspondences)
    P = jnp.asarray(src["xyz"])[m.src_idx]
    Q = jnp.asarray(tgt["xyz"])[m.tgt_idx]
    return P, Q, m.valid.astype(jnp.float32)
