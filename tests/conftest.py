"""Test harness config: CPU backend with 8 virtual devices — unless the
on-card run is requested.

Multi-device behavior is tested on a CPU-simulated mesh
(SURVEY.md §4 "implication for the rebuild") — the reference could only
test distribution on the real cluster; we can do it on any machine.
Must run before jax is first imported anywhere.

`LAM_TPU_GPU_TESTS=1 pytest -m gpu` runs the tests marked `gpu` on the
GPU JAX finds (the assertions that need compiled kernels and the card's
own arithmetic, tests/test_gpu.py); the switch leaves the platform
alone. Without it the suite is pinned to the CPU, and a `gpu` test
skips inside its fixture when JAX has no GPU.
"""

import os

import pytest

GPU_RUN = os.environ.get("LAM_TPU_GPU_TESTS") == "1"

if not GPU_RUN:
    # the unit suite must be deterministic, f64-native, and able to
    # build the 8-device virtual mesh
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        )


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX computes on a GPU (decided here, at run time,
    never while a module is imported)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run "
                    "`LAM_TPU_GPU_TESTS=1 pytest -m gpu tests/` on the card")


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """A `gpu` test runs only where JAX computes on a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        request.getfixturevalue("gpu")
