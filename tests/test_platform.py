"""What the program needs from the machine it runs on.

The compile-cache location, the native library built from committed
sources, NumPy checkpoints, chip_smoke.py refusing to run without
a GPU, and f32 matmuls pinned to full precision (a GPU may otherwise run
them in TF32).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_compile_cache_env_unset_uses_checkout_dir(monkeypatch,
                                                   restore_cache_config):
    from saccot.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_set_sets_no_dir(monkeypatch, tmp_path,
                                           restore_cache_config):
    from saccot.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_native_library_built_at_first_use(tmp_path):
    from saccot.io import native

    lib_path = str(tmp_path / "lib" / "libsaccot_native.so")
    assert native.build(lib_path) == lib_path
    mtime = os.path.getmtime(lib_path)
    assert native.build(lib_path) == lib_path  # fresh: not rebuilt
    assert os.path.getmtime(lib_path) == mtime
    lib = ctypes.CDLL(lib_path)
    for sym in ("saccot_load_kitti_bin", "saccot_voxel_downsample",
                "saccot_prefetch_create"):
        assert hasattr(lib, sym)
    assert not [f for f in os.listdir(tmp_path / "lib") if f.endswith(".tmp")]


def test_checkpoint_npz_roundtrip(tmp_path):
    from saccot.utils.checkpoint import restore, save

    path = str(tmp_path / "state")
    assert restore(path) is None
    state = {"poses": np.arange(32, dtype=np.float32).reshape(2, 4, 4),
             "gn_iter": np.asarray(3), "lam": np.asarray(1e-3)}
    save(path, state)
    save(path, dict(state, gn_iter=np.asarray(4)))  # overwrite in place
    got = restore(path)
    assert set(got) == set(state)
    np.testing.assert_array_equal(got["poses"], state["poses"])
    assert int(got["gn_iter"]) == 4
    assert os.listdir(tmp_path) == ["state"]  # no temp file left behind


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtypes = {str(v.aval.dtype) for v in eqn.invars}
            out.append((dtypes, eqn.params["precision"]))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _dot_precisions(sub, out)
    return out


def _traced_fn(which):
    from saccot.engine.icp import IcpParams, icp
    from saccot.engine.sac_cot import register_pair
    from saccot.utils.params import SacCotParams

    x = jnp.ones((64, 3), jnp.float32)
    if which == "register_pair":
        params = SacCotParams(num_anchors=16, neighbors_per_anchor=6,
                              max_hypotheses=32)
        return jax.make_jaxpr(lambda p, q: register_pair(p, q, params))(x, x)
    variant = which.split("_")[1]
    return jax.make_jaxpr(lambda p, q: icp(
        p, q, IcpParams(max_iters=2, variant=variant),
        tgt_normals=q if variant == "plane" else None))(x, x)


@pytest.mark.parametrize("which", ["register_pair", "icp_point", "icp_plane"])
def test_f32_contractions_pinned_highest(which):
    dots = _dot_precisions(_traced_fn(which).jaxpr, [])
    f32 = [p for dtypes, p in dots if dtypes == {"float32"}]
    assert f32, "expected f32 contractions in the traced program"
    highest = jax.lax.Precision.HIGHEST
    for p in f32:
        assert p is not None and all(x == highest for x in p), p
