"""Platform/config plumbing: compile-cache gating, force_platform."""

import jax

import lam_tpu


def test_compile_cache_gated_off_for_cpu_env():
    """conftest forces JAX_PLATFORMS=cpu, so the import-time gate must
    leave the persistent compilation cache disabled: XLA:CPU AOT
    executables are compiled for one host's CPU and risk SIGILL on
    another (lam_tpu/__init__.py)."""
    assert jax.config.jax_compilation_cache_dir is None


def test_force_platform_cpu_disables_cache_and_is_idempotent():
    lam_tpu.force_platform("cpu")
    lam_tpu.force_platform("cpu")
    assert jax.default_backend() == "cpu"
    assert jax.config.jax_compilation_cache_dir is None
