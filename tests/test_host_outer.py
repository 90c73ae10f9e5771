"""Host-exact-outer refinement (solver/host_outer.py) + q1-only loads.

Exact f64 outer residuals leave the irfq iteration count unchanged
within +-1 at the reference spectrum. These tests pin the machinery:
the q1-only operator (partial pack-cache read == cold-path subset
upload), the refusal contract on its accurate matvec, and convergence
of the host-outer driver to a TRUE (host-recomputed) 1e-9 residual.
"""

import os

import numpy as np
import pytest

from lam_tpu import DenseOperator, cg_solve_ir_host
from lam_tpu.solver import pack_cache as pc
from lam_tpu.solver.host_outer import host_matvec


def _spd_file(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = (q * np.exp(3.5 * rng.uniform(-1, 1, n))) @ q.T
    a = 0.5 * (a + a.T)
    b = rng.uniform(-1, 1, n)
    path = tmp_path / "A.npy"
    np.save(path, a)
    return str(path), a, b


def test_host_outer_converges_true_1e9(tmp_path):
    path, a, b = _spd_file(tmp_path, 700, 5)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True)
    res = cg_solve_ir_host(a, op_q1, b, max_iters=10000, rel_error=1e-9)
    assert bool(res.converged)
    true_rel = np.linalg.norm(b - a @ res.x) / np.linalg.norm(b)
    assert true_rel < 1e-9
    # rel_residual IS the true residual here, recomputed on the host
    # with the solver's own (symmetric) host matvec
    r = b - host_matvec(a)(res.x)
    assert res.rel_residual == np.sqrt((r @ r) / (b @ b))
    assert 200 < res.num_iters < 1000


def test_q1_partial_cache_load_matches_cold_upload(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    cold = DenseOperator.from_file_fq_q1(path, pack_cache=True)
    assert pc.load(path, "fq") is not None   # cold path published
    warm = DenseOperator.from_file_fq_q1(path, pack_cache=True)
    for i in (0, 3, 6, 7):   # q1, s1, dh, dl
        np.testing.assert_array_equal(np.asarray(cold.operand[i]),
                                      np.asarray(warm.operand[i]))
    # and both equal the FULL fq operator's buffers (shared layout)
    full = DenseOperator.from_file_fq(path, pack_cache=True)
    for i in (0, 3, 6, 7):
        np.testing.assert_array_equal(np.asarray(warm.operand[i]),
                                      np.asarray(full.operand[i]))


def test_q1_only_accurate_matvec_refuses(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=False)
    with pytest.raises(NotImplementedError, match="q1-only"):
        op_q1.matvec(np.zeros(op_q1.n_padded))
    # the inner view works fine
    res = cg_solve_ir_host(a, op_q1, b, rel_error=1e-9)
    assert bool(res.converged)


def test_host_outer_callable_operator(tmp_path):
    """Matrix-free / file-streaming callers pass a callable outer."""
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True)
    calls = []

    def outer(x):
        calls.append(1)
        return a @ x

    res = cg_solve_ir_host(outer, op_q1, b, rel_error=1e-9)
    assert bool(res.converged)
    assert calls  # one call per refinement cycle
    assert len(calls) < 15


def test_host_matvec_symv_matches_gemv(tmp_path):
    """The dsymv fast path (half the streamed bytes via the a.T
    F-contiguity trick) must agree with a plain a @ x to f64 rounding,
    including through a memmap."""
    path, a, b = _spd_file(tmp_path, 300, 11)
    am = np.load(path, mmap_mode="r")
    mv = host_matvec(am)
    x = np.random.default_rng(0).uniform(-1, 1, 300)
    np.testing.assert_allclose(mv(x), a @ x, rtol=1e-13, atol=1e-13)


def test_host_outer_zero_rhs(tmp_path):
    path, a, b = _spd_file(tmp_path, 600, 7)
    op_q1 = DenseOperator.from_file_fq_q1(path, pack_cache=True)
    res = cg_solve_ir_host(a, op_q1, np.zeros(600), rel_error=1e-9)
    assert bool(res.converged) and res.num_iters == 0
    assert np.all(res.x == 0)


def test_api_outer_host(tmp_path):
    """ConjugateGradient(outer='host'): file-mode irfq solve with
    host-exact outer residuals through the reference 4-method facade."""
    from lam_tpu import ConjugateGradient
    from lam_tpu import io as lio
    path, a, b = _spd_file(tmp_path, 700, 5)
    rhs = tmp_path / "b.bin"
    lio.write_matrix(str(rhs), b.reshape(-1, 1))
    cg = ConjugateGradient(backend="local", precision="irfq",
                           outer="host", pack_cache=True)
    assert cg.load_matrix_from_file(path)
    assert cg.load_rhs_from_file(str(rhs))
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    x = np.asarray(cg.result.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9
    assert cg.timings["num_iters"] > 200


def test_api_outer_host_validation():
    from lam_tpu import ConjugateGradient
    with pytest.raises(ValueError, match="outer='host' requires"):
        ConjugateGradient(backend="local", precision="df64",
                          outer="host")
    with pytest.raises(ValueError, match="outer must be"):
        ConjugateGradient(outer="remote")


def test_cli_outer_host(tmp_path):
    """`lam-cg --precision irfq --outer host` end-to-end: same CSV
    contract, solution written, converged."""
    import subprocess
    import sys as _sys

    from lam_tpu import io as lio
    path, a, b = _spd_file(tmp_path, 700, 5)
    rhs, out = tmp_path / "b.bin", tmp_path / "x.bin"
    lio.write_matrix(str(rhs), b.reshape(-1, 1))
    r = subprocess.run(
        [_sys.executable, "-m", "lam_tpu.cli", "-A", path,
         "-b", str(rhs), "-o", str(out), "-e", "1e-9", "-i", "10000",
         "--backend", "local", "--precision", "irfq", "--outer", "host",
         "--pack-cache"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    fields = r.stdout.strip().splitlines()[-1].split(",")
    assert len(fields) == 9
    assert float(fields[7]) < 1e-9   # converged residual column
    x = lio.read_vector(str(out))
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9
