"""Parameter surface of the SAC-COT estimator.

The reference exposes its configuration as hard-coded C++ parameter tables
(SURVEY.md section 2.1): compatibility distance threshold ``t_d``, inlier
threshold ``t_in`` (both in units of mesh resolution for object-scale data or
metric units for scene/LiDAR scale), max sample count ``K``, correspondence
count ``N``, and a minimum pair-separation guard. This dataclass is the
JAX equivalent: a frozen, hashable config that is *static* under
``jax.jit`` so every threshold folds into the compiled program.

The triangle pool is data-dependent in the reference (3-clique enumeration
over an adjacency list). XLA needs static shapes, so the estimator instead
uses a fixed-budget ranked pool: ``num_anchors`` graph nodes with the highest
weighted degree, each contributing its ``neighbors_per_anchor`` strongest
edges; candidate triangles are formed among those neighbors and the global
top ``max_hypotheses`` by triangle score are kept. With ``num_anchors >= N``
and ``neighbors_per_anchor >= N-1`` this pool is a superset of the full
clique enumeration, which is what the oracle-parity tests exercise.
"""

from __future__ import annotations

import dataclasses



@dataclasses.dataclass(frozen=True)
class SacCotParams:
    """Static configuration for one SAC-COT registration problem size."""

    # --- geometric thresholds -------------------------------------------
    # Edge (i, j) exists iff | ||p_i-p_j|| - ||q_i-q_j|| | < compat_tau and
    # both intra-cloud distances exceed min_separation.
    compat_tau: float = 0.1
    min_separation: float = 0.05
    # Correspondence i is an inlier of hypothesis T iff ||T p_i - q_i|| < inlier_tau.
    inlier_tau: float = 0.1

    # --- triangle pool budget (static shapes) ---------------------------
    num_anchors: int = 256
    neighbors_per_anchor: int = 16
    max_hypotheses: int = 1024  # "K" in the paper: ranked triangles tried

    # --- refinement -----------------------------------------------------
    # Fixed-count re-fit iterations on the best hypothesis' inlier set
    # (weighted Umeyama), the standard RANSAC polish.
    refine_iters: int = 2

    # --- scoring --------------------------------------------------------
    # "count": plain inlier counting (the reference behavior).
    # "weighted": inliers weighted by 1 - d/tau (soft MSAC-style score).
    scoring: str = "count"

    # --- blocking (perf tuning only, no semantic effect) ----------------
    degree_block_rows: int = 256   # row-block size of the virtual compat matrix
    score_block_k: int = 256       # hypothesis-axis block size in scoring

    # --- triangle-pool fast paths ---------------------------------------
    # dedup_triangles=True drops duplicate triangles (exact, oracle-parity
    # semantics). False skips the dedup; a triangle reachable from up to 3
    # anchors then occupies up to 3 of the K slots — harmless for
    # estimation (same argmax landscape).
    dedup_triangles: bool = True
    # approx_topk=True uses lax.approx_max_k for the candidate->K selection
    # (recall_target 0.95 of the exact top-K ranking where the backend
    # approximates; the estimator only needs enough well-ranked triangles).
    approx_topk: bool = False
    # Under correspondence-axis sharding, compute degrees with the ppermute
    # column-block ring (dist/ring.py) instead of the point all-gather +
    # local blocks. Same result up to f32 summation order.
    ring_compat: bool = False
    # >0: pre-reduce each anchor's B(B-1)/2 candidate triangles to its own
    # top-T (engine/triangles._pool_from_neighbors), so the global top-K
    # runs over A*T candidates instead of A*B(B-1)/2; with A*T <= K the
    # global selection is the identity and disappears. Caps any one
    # anchor's contribution to the pool at T; with the budget K ~ 4*A this
    # is recall-neutral (checked at 0.9-0.95 outlier rates in
    # tests/test_engine.py). Under correspondence-axis sharding it also
    # shards the pool's anchor axis. Requires dedup_triangles=False.
    # 0 = exact global ranking.
    per_anchor_candidates: int = 0

    def __post_init__(self):
        if self.compat_tau <= 0:
            raise ValueError("compat_tau must be positive")
        if self.inlier_tau <= 0:
            raise ValueError("inlier_tau must be positive")
        if self.neighbors_per_anchor < 2:
            raise ValueError("neighbors_per_anchor must be >= 2 to form triangles")
        if self.scoring not in ("count", "weighted"):
            raise ValueError(f"unknown scoring mode: {self.scoring!r}")
        if self.per_anchor_candidates and self.dedup_triangles:
            raise ValueError(
                "per_anchor_candidates requires dedup_triangles=False "
                "(the pre-reduced pool has no canonical ordering to dedup)"
            )

    def with_scale(self, resolution: float) -> "SacCotParams":
        """Scale thresholds expressed in mesh-resolution units to metric units.

        The paper expresses thresholds as multiples of the cloud's mesh
        resolution ``pr`` so object-scale and scene-scale datasets share one
        configuration; this helper applies that convention.
        """
        return dataclasses.replace(
            self,
            compat_tau=self.compat_tau * resolution,
            min_separation=self.min_separation * resolution,
            inlier_tau=self.inlier_tau * resolution,
        )


def num_candidate_triangles(p: SacCotParams) -> int:
    """Size of the static candidate-triple pool before ranking."""
    b = p.neighbors_per_anchor
    return p.num_anchors * (b * (b - 1) // 2)
