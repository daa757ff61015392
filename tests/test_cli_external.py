"""External-protocol (real-3DMatch-style) driver test: per-fragment .npz
descriptors + gt.log on disk -> RE/TE recall through the CLI path
(BASELINE.json config 3)."""

import json
import os

import numpy as np
import pytest

from saccot.io.external import save_descriptors_npz
from saccot.utils import se3np
from saccot.utils.params import SacCotParams


def _write_scene(tmp_path, n_frag=4, n_world=600, n_keep=320, dim=32, seed=5):
    """Fabricate a scene: world points with persistent random descriptors,
    fragments = posed subsets, gt.log = exact relative poses."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(-1.5, 1.5, size=(n_world, 3)).astype(np.float32)
    D = rng.normal(size=(n_world, dim)).astype(np.float32)

    frag_dir = tmp_path / "fragments"
    frag_dir.mkdir()
    poses = []  # T_k: local k -> world
    subsets = []
    for k in range(n_frag):
        T = se3np.random_transform(rng, max_angle_rad=0.8, max_trans=0.5)
        poses.append(T)
        idx = np.sort(rng.choice(n_world, size=n_keep, replace=False))
        subsets.append(idx)
        # local coords: x = T^-1 W  (W = T x)
        x = se3np.apply_T(se3np.inv_T(T), W[idx]).astype(np.float32)
        x += rng.normal(scale=0.003, size=x.shape).astype(np.float32)
        d = (D[idx] + rng.normal(scale=0.05, size=(n_keep, dim))).astype(np.float32)
        save_descriptors_npz(str(frag_dir / f"cloud_bin_{k}.npz"), x, d)

    # gt.log: consecutive pairs + one loop (0, n_frag-1). Canonical
    # Redwood/3DMatch convention: entry (i, j) holds T = inv(pose_i) @ pose_j,
    # mapping fragment j's local points into fragment i's frame:
    # x_i = T_i^-1 T_j x_j.
    pairs = [(i, i + 1) for i in range(n_frag - 1)] + [(0, n_frag - 1)]
    gt_path = tmp_path / "gt.log"
    with open(gt_path, "w") as f:
        for (i, j) in pairs:
            T_ij = se3np.inv_T(poses[i]) @ poses[j]
            f.write(f"{i} {j} {n_frag}\n")
            for r in range(4):
                f.write(" ".join(f"{v:.9f}" for v in T_ij[r]) + "\n")
    return str(frag_dir), str(gt_path), pairs


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _write_scene(tmp_path_factory.mktemp("ext3dm"))


def test_run_external_recall(scene):
    from saccot.cli.external import run_external

    frag_dir, gt_path, pairs = scene
    params = SacCotParams(
        compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
        num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        degree_block_rows=128,
    )
    out = run_external(
        frag_dir, gt_path, params=params, max_correspondences=256, batch=4
    )
    assert out["n_pairs"] == len(pairs)
    assert out["n_fragments"] == 4
    assert out["recall"] == 1.0, out
    assert out["mean_inliers"] > 50


def test_external_cli_entrypoint(scene, tmp_path, capsys, monkeypatch):
    """`python -m saccot.cli.main external --dir ... --gt-log ...` prints
    one JSON metrics line and logs per-pair JSONL records."""
    from saccot.cli import external as ext_mod
    from saccot.cli.main import main

    frag_dir, gt_path, pairs = scene
    # The CLI's default scene-scale params use max_hypotheses=2048 — slow on
    # the CPU test backend; shrink via the module default for the test.
    small = SacCotParams(
        compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
        num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        degree_block_rows=128,
    )
    orig = ext_mod.run_external

    def patched(desc_dir, gt_log_path, **kw):
        kw.setdefault("params", small)
        kw.setdefault("batch", 4)
        return orig(desc_dir, gt_log_path, **kw)

    monkeypatch.setattr(ext_mod, "run_external", patched)
    log_path = tmp_path / "pairs.jsonl"
    rc = main([
        "external", "--dir", frag_dir, "--gt-log", gt_path,
        "--max-corr", "256", "--log", str(log_path),
    ])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    metrics = json.loads(line)
    assert metrics["config"] == "external"
    assert metrics["recall"] == 1.0
    records = [json.loads(ln) for ln in open(log_path)]
    assert len(records) == len(pairs)
    assert all(r["registered"] for r in records)


def test_external_out_log_roundtrip(scene, tmp_path):
    """--out-log writes a standard 3DMatch-style .log of the estimated
    transforms that load_gt_log round-trips, with each entry matching the
    corresponding gt transform (the run has recall 1.0)."""
    from saccot.cli.external import run_external
    from saccot.io.loaders import load_gt_log
    from saccot.utils import se3np as _se3

    frag_dir, gt_path, pairs = scene
    params = SacCotParams(
        compat_tau=0.05, min_separation=0.1, inlier_tau=0.05,
        num_anchors=128, neighbors_per_anchor=12, max_hypotheses=512,
        degree_block_rows=128,
    )
    out_log = str(tmp_path / "est.log")
    out = run_external(
        frag_dir, gt_path, params=params, max_correspondences=256, batch=4,
        out_log=out_log,
    )
    assert out["recall"] == 1.0
    est = load_gt_log(out_log)
    gt = load_gt_log(gt_path)
    assert set(est) == set(gt)
    for key in gt:
        E = est[key] @ np.linalg.inv(gt[key])
        assert _se3.rotation_angle_deg(E[:3, :3]) < 2.0
        assert np.linalg.norm(E[:3, 3]) < 0.05
