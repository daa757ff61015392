"""Real-3DMatch-protocol driver: per-fragment `.npz` descriptors + gt.log.

The reference's headline 3DMatch experiment (SURVEY.md section 2.1,
Evaluation row; BASELINE.json config 3) consumes *learned* (FCGF-class)
descriptors computed offline per fragment, matches them, runs the estimator
on the resulting correspondences, and reports recall under the
RE<15deg / TE<30cm criterion over the pairs listed in the scene's `gt.log`.
This module is that protocol end-to-end from files on disk:

  python -m saccot.cli.main external --dir <fragments/> --gt-log <gt.log>

Inputs:
  - a directory of `<anything>_<index>.npz` archives (keys `xyz` [N,3],
    `desc` [N,D] — io/external.py's format; the trailing integer in the
    stem is the fragment index gt.log refers to);
  - a 3DMatch-style `gt.log` (io/loaders.load_gt_log) following the
    canonical Redwood/3DMatch convention: entry (i, j) holds
    T = inv(pose_i) @ pose_j, the 4x4 transform taking fragment *j*'s
    points into fragment *i*'s frame. The estimator's T maps P (source)
    into Q's (target) frame, so each pair is registered with fragment j as
    the source and fragment i as the target.

All fragments are padded to one static keypoint bucket and every gt pair is
matched + registered through one jitted batched program, so the whole sweep
compiles exactly twice (matcher + estimator) regardless of pair count.
"""

from __future__ import annotations

import functools
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from saccot.engine.sac_cot import register_batch
from saccot.evaluation.metrics import registration_error
from saccot.io.external import load_descriptors_npz
from saccot.io.loaders import load_gt_log
from saccot.match.topk import match_descriptors, mutual_filter
from saccot.utils.params import SacCotParams


def discover_fragments(desc_dir: str) -> Dict[int, str]:
    """Map fragment index -> npz path, from trailing integers in filenames."""
    out: Dict[int, str] = {}
    for name in sorted(os.listdir(desc_dir)):
        if not name.endswith(".npz"):
            continue
        m = re.search(r"(\d+)\.npz$", name)
        if m is None:
            continue
        out[int(m.group(1))] = os.path.join(desc_dir, name)
    return out


def _pad_fragment(
    frag: Dict[str, np.ndarray], bucket: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (xyz, desc) to `bucket` rows with a validity mask."""
    n = frag["xyz"].shape[0]
    if n > bucket:
        raise ValueError(f"fragment has {n} keypoints > bucket {bucket}")
    pad = bucket - n
    xyz = np.concatenate([frag["xyz"], np.zeros((pad, 3), np.float32)])
    desc = np.concatenate(
        [frag["desc"], np.zeros((pad, frag["desc"].shape[1]), np.float32)]
    )
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return xyz, desc, mask


@functools.partial(jax.jit, static_argnames=("max_corr", "mutual", "ratio_test"))
def _match_pair(
    xyz_s, desc_s, m_s, xyz_t, desc_t, m_t, max_corr, mutual, ratio_test
):
    """One fragment pair -> fixed-size (P, Q, mask) correspondence set."""
    m = match_descriptors(
        desc_s, desc_t, mask_src=m_s, mask_tgt=m_t,
        mutual=mutual, ratio_test=ratio_test,
    )
    m = mutual_filter(m, max_corr)
    return xyz_s[m.src_idx], xyz_t[m.tgt_idx], m.valid.astype(jnp.float32)


def run_external(
    desc_dir: str,
    gt_log_path: str,
    params: Optional[SacCotParams] = None,
    max_correspondences: int = 2048,
    mutual: bool = True,
    ratio_test: float = 0.0,
    rot_thresh_deg: float = 15.0,
    trans_thresh: float = 0.30,
    batch: int = 8,
    log=None,
    out_log: Optional[str] = None,
) -> Dict:
    """Run the external-descriptor registration protocol; return metrics."""
    if params is None:
        # Scene-scale (metric) thresholds — the threedmatch config's values.
        params = SacCotParams(
            compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
            num_anchors=256, neighbors_per_anchor=16, max_hypotheses=2048,
        )
    frags = discover_fragments(desc_dir)
    if not frags:
        raise FileNotFoundError(f"no *_<index>.npz fragments under {desc_dir}")
    gt = load_gt_log(gt_log_path)
    pair_ids: List[Tuple[int, int]] = [
        (i, j) for (i, j) in sorted(gt) if i in frags and j in frags
    ]
    if not pair_ids:
        raise ValueError("gt.log lists no pairs with fragments present on disk")

    loaded = {k: load_descriptors_npz(frags[k]) for k in frags}
    bucket = 1
    for f in loaded.values():
        bucket = max(bucket, f["xyz"].shape[0])
    bucket = 1 << (bucket - 1).bit_length()  # next power of two
    padded = {k: _pad_fragment(f, bucket) for k, f in loaded.items()}

    # Warm both jitted programs (matcher + estimator) before the timer so
    # pairs_per_sec is steady-state, consistent with bench.py's methodology;
    # trace+compile time is reported separately as `compile_s`.
    n_pairs = len(pair_ids)
    max_c = min(max_correspondences, bucket)
    reg = jax.jit(lambda a, b, m: register_batch(a, b, params, mask=m))
    t_c0 = time.time()
    i0, j0 = pair_ids[0]
    xs, ds, ms = padded[j0]
    xt, dt_, mt = padded[i0]
    Pw, Qw, mw = _match_pair(
        jnp.asarray(xs), jnp.asarray(ds), jnp.asarray(ms),
        jnp.asarray(xt), jnp.asarray(dt_), jnp.asarray(mt),
        max_c, mutual, ratio_test,
    )
    _ = np.asarray(reg(
        jnp.stack([Pw] * batch), jnp.stack([Qw] * batch), jnp.stack([mw] * batch)
    ).num_inliers)
    compile_s = time.time() - t_c0

    t0 = time.time()
    # Stage 1: match every gt pair (one compiled matcher, fixed shapes).
    # Redwood direction (module docstring): gt (i, j) maps fragment j into
    # fragment i's frame, so fragment j is the source, fragment i the target.
    P_list, Q_list, m_list = [], [], []
    for (i, j) in pair_ids:
        xs, ds, ms = padded[j]
        xt, dt_, mt = padded[i]
        P, Q, m = _match_pair(
            jnp.asarray(xs), jnp.asarray(ds), jnp.asarray(ms),
            jnp.asarray(xt), jnp.asarray(dt_), jnp.asarray(mt),
            max_c, mutual, ratio_test,
        )
        P_list.append(P)
        Q_list.append(Q)
        m_list.append(m)

    # Stage 2: register in fixed-size batches (pad the tail with repeats so
    # the estimator compiles once; padded entries are simply not evaluated).
    n_batches = -(-n_pairs // batch)
    results_T = np.zeros((n_pairs, 4, 4), np.float64)
    results_inl = np.zeros((n_pairs,), np.int64)
    for bi in range(n_batches):
        sl = [min(bi * batch + k, n_pairs - 1) for k in range(batch)]
        res = reg(
            jnp.stack([P_list[s] for s in sl]),
            jnp.stack([Q_list[s] for s in sl]),
            jnp.stack([m_list[s] for s in sl]),
        )
        T_np = np.asarray(res.T, np.float64)
        inl_np = np.asarray(res.num_inliers, np.int64)
        for k in range(batch):
            s = bi * batch + k
            if s < n_pairs:
                results_T[s] = T_np[k]
                results_inl[s] = inl_np[k]
    dt_total = time.time() - t0

    # Evaluation: RE/TE recall over the gt.log pairs.
    flags = []
    for s, (i, j) in enumerate(pair_ids):
        re_deg, te = registration_error(results_T[s], gt[(i, j)])
        ok = (re_deg < rot_thresh_deg) and (te < trans_thresh)
        flags.append(ok)
        if log is not None:
            log.log(dict(
                pair=[i, j], rot_err_deg=re_deg, trans_err=te,
                registered=bool(ok), num_inliers=int(results_inl[s]),
            ))
    recall = float(np.mean(flags))

    if out_log:
        # Standard .log trajectory of the ESTIMATED transforms, consumable
        # by the public 3DMatch/Redwood evaluation scripts (io/loaders.save_log).
        from saccot.io.loaders import save_log

        save_log(
            out_log,
            {pair_ids[s]: results_T[s] for s in range(n_pairs)},
            n_fragments=len(frags),
        )

    return dict(
        config="external",
        n_fragments=len(frags),
        n_pairs=n_pairs,
        bucket=bucket,
        recall=recall,
        mean_inliers=float(results_inl.mean()),
        pairs_per_sec=n_pairs / dt_total,
        compile_s=compile_s,
        rot_thresh_deg=rot_thresh_deg,
        trans_thresh=trans_thresh,
    )
