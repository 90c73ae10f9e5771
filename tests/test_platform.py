"""The platform table, the compile-cache placement, the removed engine
names, and chip_smoke.py rehearsed on the CPU at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import lam_tpu
from lam_tpu import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gpu_row_is_native_f64_xla_and_compiled_triton():
    row = platform.lookup("gpu")
    assert (row.precision, row.engine) == ("f64", "xla")
    assert row.pallas_interpret is False
    assert row.pallas_backend == "triton"


def test_cpu_row_interprets_the_kernel():
    row = platform.lookup("cpu")
    assert (row.precision, row.engine) == ("f64", "xla")
    assert row.pallas_interpret is True


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="no row"):
        platform.lookup(name)


def test_current_row_and_auto_resolution():
    from lam_tpu.solver.operators import resolve
    assert platform.current() is platform.PLATFORMS["cpu"]
    assert resolve("auto", "auto") == ("f64", "xla")
    assert resolve("ir", "pallas_symm_packed") == ("ir",
                                                   "pallas_symm_packed")


def test_force_platform_rejects_unknown():
    with pytest.raises(RuntimeError, match="no row"):
        lam_tpu.force_platform("rocm")


def test_expects_gpu_false_when_pinned_to_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert platform.expects_gpu() is False


def test_require_gpu_refuses_on_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        platform.require_gpu()


# -- compile cache -----------------------------------------------------------


def test_compile_cache_fixed_path_in_checkout_on_gpu():
    d = lam_tpu.compile_cache_dir(environ={}, gpu=True)
    assert d == lam_tpu.CACHE_DIR
    assert os.path.dirname(d) == REPO
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert "/" + os.path.basename(d) + "/" in ignored


def test_compile_cache_defers_to_jax_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert lam_tpu.compile_cache_dir(environ=env, gpu=True) is None


def test_compile_cache_off_on_cpu():
    assert lam_tpu.compile_cache_dir(environ={}, gpu=False) is None
    import jax
    assert not jax.config.jax_compilation_cache_dir


# -- removed engine names ----------------------------------------------------


@pytest.mark.parametrize("engine", ["pallas", "pallas_symm"])
def test_removed_engines_raise_in_api(engine):
    from lam_tpu import ConjugateGradient
    with pytest.raises(ValueError, match="removed"):
        ConjugateGradient(backend="local", engine=engine)


@pytest.mark.parametrize("engine", ["pallas", "pallas_symm"])
def test_removed_engines_raise_in_sharded_operator(engine):
    from lam_tpu.parallel.mesh import make_mesh
    from lam_tpu.parallel.pcg import ShardedDenseOperator
    a = np.eye(64)
    with pytest.raises(ValueError, match="removed"):
        ShardedDenseOperator.from_dense(a, mesh=make_mesh(2), engine=engine)


@pytest.mark.parametrize("engine", ["pallas", "pallas_symm"])
def test_removed_engines_rejected_by_cli(engine, capsys):
    from lam_tpu.cli import main
    with pytest.raises(SystemExit) as e:
        main(["-s", "64", "--engine", engine])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


# -- chip_smoke.py -----------------------------------------------------------


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return None


def test_chip_smoke_refuses_without_gpu():
    out = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


@pytest.fixture
def smoke(monkeypatch, tmp_path):
    """chip_smoke imported from the checkout, working under tmp_path."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.chdir(tmp_path)
    import chip_smoke
    return chip_smoke


def test_smoke_phase_gen(smoke):
    out = smoke.phase_gen(n=600, iters=15)
    row = out["csv"].split(",")
    assert row[0] == "600" and int(row[6]) == 16


def test_smoke_phases_file_and_ir(smoke):
    system = smoke.make_system(n=300, seed=42)
    f64 = smoke.phase_file(system)["f64"]
    ir = smoke.phase_ir(system)
    for res in [f64, *ir.values()]:
        assert res["true_rel"] <= smoke.TRUE_REL_BOUND
    assert set(ir) == {"ir", "ir_packed", "irfq"}


def test_smoke_phase_walk(smoke):
    (f32, q16) = smoke.phase_walk(sizes=(1000,))
    for res, itemsize in ((f32, 4), (q16, 2)):
        assert res["rel_err"] <= smoke.WALK_REL_BOUND
        assert res["tiles"] == 3
        assert res["bytes_per_matvec"] == 3 * 512 * 512 * itemsize


def test_smoke_phase_heat(smoke):
    out = smoke.phase_heat(nx=40, ny=30)
    for precision in ("auto", "ir"):
        res = out[precision]
        assert res["true_rel"] <= smoke.HEAT_TRUE_REL_BOUND
        assert res["rel_err"] <= res["rel_err_bound"]


def test_smoke_heat_exact_is_the_dense_solution(smoke):
    """The sine-basis solution and the smallest eigenvalue against the
    assembled 5-point system."""
    from lam_tpu.apps import heat
    b = heat.boundary_rhs(heat.initial_grid(12, 9))
    nyi, nxi = b.shape
    n = nyi * nxi
    a = np.stack([smoke.laplace_host(e.reshape(nyi, nxi)).reshape(-1)
                  for e in np.eye(n)], axis=1)
    np.testing.assert_allclose(smoke.heat_exact(b).reshape(-1),
                               np.linalg.solve(a, b.reshape(-1)),
                               rtol=1e-12)
    np.testing.assert_allclose(smoke.laplace_eigenvalues(nyi, nxi).min(),
                               np.linalg.eigvalsh(a).min(), rtol=1e-12)


def test_smoke_phase_multi_on_virtual_devices(smoke):
    out = smoke.phase_multi(n=1024, n_devices=4)
    assert set(out) == {"reference", "gather", "ring", "sharded2d",
                        "irfq_band_pair"}


# -- XLA flags ---------------------------------------------------------------


def test_gpu_row_turns_the_autotuner_off():
    """Compiling a matvec over a resident 36.5 GiB matrix must not ask
    for a second operand-sized buffer."""
    assert platform.lookup("gpu").xla_flags == (
        "--xla_gpu_autotune_level=0",)
    assert platform.lookup("cpu").xla_flags == ()


@pytest.mark.parametrize("before,after", [
    ("", "--xla_gpu_autotune_level=0"),
    ("--xla_dump_to=/d", "--xla_dump_to=/d --xla_gpu_autotune_level=0"),
    ("--xla_gpu_autotune_level=4", "--xla_gpu_autotune_level=4"),
])
def test_add_xla_flags_keeps_what_the_environment_sets(before, after):
    env = {"XLA_FLAGS": before} if before else {}
    platform.add_xla_flags(("--xla_gpu_autotune_level=0",), environ=env)
    assert env["XLA_FLAGS"] == after


def test_gpu_flags_set_before_the_backend_starts_do_not_warn(recwarn):
    env = {}
    assert platform.set_gpu_xla_flags(env, backend_started=False) == [
        "--xla_gpu_autotune_level=0"]
    assert env["XLA_FLAGS"] == "--xla_gpu_autotune_level=0"
    assert not recwarn.list


def test_gpu_flags_after_the_backend_started_warn():
    with pytest.warns(RuntimeWarning, match="cannot take effect"):
        platform.set_gpu_xla_flags({}, backend_started=True)


def test_gpu_flags_the_environment_holds_do_not_warn(recwarn):
    env = {"XLA_FLAGS": "--xla_gpu_autotune_level=2"}
    assert platform.set_gpu_xla_flags(env, backend_started=True) == []
    assert env["XLA_FLAGS"] == "--xla_gpu_autotune_level=2"
    assert not recwarn.list


def test_the_backend_start_is_read_from_jax():
    """Without the argument the check asks JAX (here the CPU backend has
    long started)."""
    import jax
    jax.devices()
    with pytest.warns(RuntimeWarning):
        platform.set_gpu_xla_flags({})


def test_bench_refuses_without_gpu():
    out = _run_smoke(REPO, os.path.join(REPO, "bench.py"))
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "needs an NVIDIA GPU" in out.stderr
