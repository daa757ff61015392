"""Test configuration: run on a faked 8-device CPU backend by default.

Multi-card hardware is not available in CI; per SURVEY.md section 4.3 the
distributed paths are validated on `--xla_force_host_platform_device_count=8`
so collectives (psum, ppermute rings, Schur reductions) execute for real in
one process. Must run before the first `import jax` anywhere.

Tests marked `gpu` need a CUDA GPU and skip without one; on the card run
them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    import jax

    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 faked CPU devices, got {devs}"
    return devs


@pytest.fixture
def gpu_device():
    """The first CUDA GPU; skips the test when JAX finds none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA GPU; on the card run "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
