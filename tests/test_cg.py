"""CG engine vs. the numpy oracle: iteration-count and residual parity."""

import numpy as np
import jax.numpy as jnp
import pytest

from lam_tpu import DenseOperator, cg_solve, cg_solve_ir
from lam_tpu import generate as gen
from lam_tpu.solver.operators import MatrixFreeOperator

from oracle import oracle_cg


def _spd_system(n=96, seed=0):
    return gen.random_spd_matrix(n, seed=seed), gen.random_rhs(n, seed + 10)


def test_f64_matches_oracle_random_spd():
    a, b = _spd_system()
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, rel_ref, conv_ref = oracle_cg(a, b, 1000, 1e-9)
    assert bool(res.converged) and conv_ref
    # XLA's dot-product reduction order differs from numpy's; on an
    # ill-conditioned system the last few 1e-9-boundary iterations can
    # shift. Same algorithm, same stopping rule, ~same count.
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)
    # true residual really is small, not just the recurrence value
    true_rel = np.linalg.norm(b - a @ np.asarray(res.x)) / np.linalg.norm(b)
    assert true_rel < 1e-8


def test_f64_matches_oracle_tridiagonal():
    n = 64
    a = gen.tridiagonal_matrix(n)
    b = gen.ones_rhs(n)
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, _, _ = oracle_cg(a, b, 1000, 1e-9)
    assert int(res.num_iters) == iters_ref
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-8)


def test_non_convergence_reports_max_iters():
    # gen-mode throughput probes cap at -i 15 and report num_iter=15
    # without converging (TESTS/BEST_RESULTS gen rows, SURVEY §8.8)
    n = 128
    a = gen.tridiagonal_matrix(n)
    b = gen.ones_rhs(n)
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    res = cg_solve(op, b, max_iters=15, rel_error=1e-9)
    assert not bool(res.converged)
    assert int(res.num_iters) == 15
    _, iters_ref, rel_ref, conv_ref = oracle_cg(a, b, 15, 1e-9)
    assert not conv_ref and iters_ref == 15
    np.testing.assert_allclose(float(res.rel_residual), rel_ref, rtol=1e-10)


def test_df64_xla_matches_f64():
    a, b = _spd_system(seed=7)
    op64 = DenseOperator.from_dense(a, precision="f64", engine="xla")
    opdf = DenseOperator.from_dense(a, precision="df64", engine="xla")
    r64 = cg_solve(op64, b, max_iters=1000, rel_error=1e-9)
    rdf = cg_solve(opdf, b, max_iters=1000, rel_error=1e-9)
    assert bool(rdf.converged)
    # df64 carries ~2^-48 precision: iteration count may differ by a hair
    assert abs(int(rdf.num_iters) - int(r64.num_iters)) <= 2
    np.testing.assert_allclose(np.asarray(rdf.x), np.asarray(r64.x),
                               rtol=1e-6, atol=1e-9)


def test_f32_converges_to_loose_tolerance():
    a, b = _spd_system(seed=9)
    op = DenseOperator.from_dense(a, precision="f32", engine="xla")
    res = cg_solve(op, b.astype(np.float32), max_iters=1000, rel_error=1e-4)
    assert bool(res.converged)
    true_rel = np.linalg.norm(b - a @ np.asarray(res.x, dtype=np.float64)
                              ) / np.linalg.norm(b)
    assert true_rel < 1e-3


def test_ir_reaches_f64_quality_residual():
    a, b = _spd_system(seed=11)
    op = DenseOperator.from_dense(a, precision="df64", engine="xla")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    true_rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert true_rel < 1e-9


def test_matrix_free_operator():
    # CG on a matrix-free SPD operator (diagonal + Laplacian-like stencil)
    n = 50
    diag = np.linspace(2.0, 4.0, n)

    def mv(operand, p):
        d = operand
        lap = 2 * p - jnp.concatenate([p[1:], jnp.zeros(1)]) \
            - jnp.concatenate([jnp.zeros(1), p[:-1]])
        return d * p + lap

    op = MatrixFreeOperator(mv, jnp.asarray(diag), n)
    b = gen.random_rhs(n, seed=13)
    res = cg_solve(op, b, max_iters=500, rel_error=1e-10)
    assert bool(res.converged)
    # check against dense assembly
    a = np.diag(diag) + 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    x_ref = np.linalg.solve(a, b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-7)


def test_padding_is_exact():
    # operators pad to tile multiples with zeros; results must be identical
    a, b = _spd_system(n=100, seed=15)
    op_nopad = DenseOperator.from_dense(a, precision="f64", engine="xla")
    assert op_nopad.n_padded == 100  # xla engine: no padding
    # force padding through the pallas-shaped path but with xla matvec:
    from lam_tpu.solver import operators as ops_mod
    import numpy as _np
    pad = ops_mod.padded_size(100)
    a_p = _np.zeros((pad, pad))
    a_p[:100, :100] = a
    op_pad = ops_mod.DenseOperator(
        ops_mod._MATVEC_DOT[("f64", "xla")], jnp.asarray(a_p), 100, pad,
        jnp.float64, "f64", "xla")
    r1 = cg_solve(op_nopad, b, max_iters=1000, rel_error=1e-9)
    r2 = cg_solve(op_pad, b, max_iters=1000, rel_error=1e-9)
    # zero padding is value-exact per op, but XLA groups the (padded)
    # reductions differently, so late-stage rounding can shift the stop
    # iteration by a few on ill-conditioned systems
    assert abs(int(r1.num_iters) - int(r2.num_iters)) <= 5
    assert bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               rtol=1e-5, atol=1e-8)


def test_divergence_exits_early_and_reports_failure():
    # A pathological operator (zero matrix) drives the recurrence to
    # NaN. The reference spins to max_iters printing -nan
    # (TESTS/BEST_RESULTS:114, SURVEY §8 "divergence is not an error");
    # we exit as soon as the residual is no longer comparable and report
    # non-convergence with max_iters, matching the reference's output
    # contract without burning the remaining iterations.
    n = 64
    a = np.zeros((n, n))
    b = np.ones(n)
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    res = cg_solve(op, b, max_iters=10000, rel_error=1e-9)
    assert not bool(res.converged)
    assert int(res.num_iters) == 10000  # reference-contract reporting
    assert not np.isfinite(float(res.rel_residual))


def test_jacobi_preconditioned_cg():
    # a diagonally-dominant system with wildly varying diagonal: Jacobi
    # preconditioning should cut iterations substantially
    n = 200
    rng = np.random.default_rng(19)
    d = np.exp(rng.uniform(0, 8, n))          # diag spread 1..3000
    a = np.diag(d) + rng.uniform(-0.5, 0.5, (n, n))
    a = 0.5 * (a + a.T)
    a += n * 0.01 * np.eye(n)
    b = rng.uniform(-1, 1, n)
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    plain = cg_solve(op, b, max_iters=5000, rel_error=1e-9)
    pre = cg_solve(op, b, max_iters=5000, rel_error=1e-9,
                   preconditioner="jacobi")
    assert bool(pre.converged)
    x = np.asarray(pre.x)
    true_rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert true_rel < 1e-8
    assert int(pre.num_iters) < int(plain.num_iters)


def test_ir_jacobi_preconditioned():
    """ir + jacobi (round 3 closes the last rejected combination): the
    inner f32 loop is diagonal-scaled, the outer refinement recurrence
    is untouched, and on a badly-scaled system the preconditioned inner
    spends fewer total iterations than the plain one."""
    n = 200
    rng = np.random.default_rng(19)
    d = np.exp(rng.uniform(0, 8, n))          # diag spread 1..3000
    a = np.diag(d) + rng.uniform(-0.5, 0.5, (n, n))
    a = 0.5 * (a + a.T)
    a += n * 0.01 * np.eye(n)
    b = rng.uniform(-1, 1, n)
    op = DenseOperator.from_dense(a, precision="df64", engine="xla")
    plain = cg_solve_ir(op.as_f32(), op, b, max_iters=20000,
                        rel_error=1e-9)
    pre = cg_solve_ir(op.as_f32(), op, b, max_iters=20000,
                      rel_error=1e-9, preconditioner="jacobi")
    assert bool(pre.converged)
    x = np.asarray(pre.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9
    assert int(pre.num_iters) < int(plain.num_iters)


def test_block_cg_multiple_rhs():
    from lam_tpu.solver.cg import cg_solve_block
    n, k = 96, 5
    a = gen.random_spd_matrix(n, seed=23)
    rng = np.random.default_rng(24)
    bs = rng.uniform(-1, 1, (n, k))
    op = DenseOperator.from_dense(a, precision="f64", engine="xla")
    res = cg_solve_block(op, bs, max_iters=2000, rel_error=1e-9)
    assert res.x.shape == (n, k)
    assert np.all(np.asarray(res.converged))
    x = np.asarray(res.x)
    for j in range(k):
        true_rel = np.linalg.norm(bs[:, j] - a @ x[:, j]) \
            / np.linalg.norm(bs[:, j])
        assert true_rel < 1e-8
    # per-column iteration counts match single solves (columns are
    # independent recurrences)
    single = cg_solve(op, bs[:, 0], max_iters=2000, rel_error=1e-9)
    assert abs(int(np.asarray(res.num_iters)[0]) - int(single.num_iters)) <= 1


def test_cg_with_symmetric_engine():
    """Full f32 solve through the triangle-walk kernel: the
    ('f32','pallas_symm_packed') MATVEC entry drives it directly."""
    a = gen.random_spd_matrix(96, seed=71)
    b = gen.random_rhs(96, seed=72)
    op = DenseOperator.from_dense(a, precision="f32",
                                  engine="pallas_symm_packed")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-4)
    assert bool(res.converged)
    x = np.asarray(res.x, np.float64)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-3


def test_df64_solve_with_symmetric_engine():
    """Plain df64 solve on packed storage routes through the f64
    triangle walk (('df64','pallas_symm_packed') in operators.MATVEC)
    and must converge to a true 1e-9."""
    a = gen.random_spd_matrix(96, seed=75)
    b = gen.random_rhs(96, seed=76)
    op = DenseOperator.from_dense(a, precision="df64",
                                  engine="pallas_symm_packed")
    res = cg_solve(op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x, np.float64)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_ir_with_symmetric_engine():
    """The ir inner loop routes through ('f32@df64','pallas_symm_packed'),
    i.e. the triangle-walk kernel on the shared hi plane."""
    from lam_tpu import cg_solve_ir
    a = gen.random_spd_matrix(96, seed=73)
    b = gen.random_rhs(96, seed=74)
    op = DenseOperator.from_dense(a, precision="df64",
                                  engine="pallas_symm_packed")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9


def test_block_cg_on_packed_and_dfq(monkeypatch):
    """Block CG works on packed-triangle storage too — the
    einsum triangle walk (_packed_block_walk) replaces the plain matmul
    the packed layout cannot express."""
    from lam_tpu.solver.cg import cg_solve_block
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 256)
    n, k = 700, 3
    a = gen.random_spd_matrix(n, seed=25)
    rng = np.random.default_rng(26)
    bs = rng.uniform(-1, 1, (n, k))
    for op in (DenseOperator.from_dense(a, precision="df64",
                                        engine="pallas_symm_packed"),
               DenseOperator.from_dense_dfq(a)):
        res = cg_solve_block(op, bs, max_iters=3000, rel_error=1e-9)
        assert np.all(np.asarray(res.converged))
        x = np.asarray(res.x)[:n]
        true_rel = np.linalg.norm(bs - a @ x) / np.linalg.norm(bs)
        assert true_rel < 1e-7
