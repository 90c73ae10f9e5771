"""Sharded CG on the 8-device virtual CPU mesh vs single-device results.

The reference never had single-machine multi-rank tests (SURVEY §4); this
is the rebuild's answer: sharded-vs-local equality on a simulated mesh.
"""

import jax
import numpy as np
import pytest

from lam_tpu import DenseOperator, cg_solve
from lam_tpu import generate as gen
from lam_tpu.parallel.mesh import make_mesh
from lam_tpu.parallel.pcg import ShardedDenseOperator

from oracle import oracle_cg


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    return make_mesh(8)


def _spd_system(n=96, seed=21):
    return gen.random_spd_matrix(n, seed=seed), gen.random_rhs(n, seed + 10)


def test_sharded_matvec_matches_numpy(mesh8):
    a, _ = _spd_system(n=64)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="f64",
                                         engine="xla")
    p = gen.random_rhs(64, seed=1)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:64]
    np.testing.assert_allclose(ap, a @ p, rtol=1e-12)


def test_sharded_cg_matches_oracle(mesh8):
    a, b = _spd_system()
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="f64",
                                         engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 1000, 1e-9)
    assert bool(res.converged) and conv_ref
    # reduction order differs across shards (psum of per-shard partials):
    # the 1e-9-boundary iterations can shift by a few
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)


def test_sharded_equals_local(mesh8):
    a, b = _spd_system(seed=33)
    local = DenseOperator.from_dense(a, precision="f64", engine="xla")
    shard = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="f64",
                                            engine="xla")
    r1 = cg_solve(local, b, max_iters=1000, rel_error=1e-9)
    r2 = cg_solve(shard, b, max_iters=1000, rel_error=1e-9)
    assert abs(int(r1.num_iters) - int(r2.num_iters)) <= 6
    # both are CG solutions to 1e-9 recurrence residual; with cond(A) up
    # to ~e^7 the iterates themselves agree to ~residual*cond
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               rtol=1e-4, atol=1e-7)


def test_sharded_df64_converges(mesh8):
    a, b = _spd_system(seed=41)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="df64",
                                         engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    true_rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert true_rel < 1e-8


def test_sharded_from_row_blocks_tridiagonal(mesh8):
    n = 80
    op = ShardedDenseOperator.from_row_block_fn(
        lambda s, m: gen.tridiagonal_rows(s, m, n), n, mesh=mesh8,
        precision="f64", engine="xla")
    b = gen.ones_rhs(n)
    res = cg_solve(op, b, max_iters=500, rel_error=1e-9)
    a = gen.tridiagonal_matrix(n)
    _, iters_ref, _, _ = oracle_cg(a, b, 500, 1e-9)
    assert abs(int(res.num_iters) - iters_ref) <= 1
    x_ref = np.linalg.solve(a, b)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6)


def test_sharded_file_load(mesh8, tmp_path):
    from lam_tpu import io as lio
    a, b = _spd_system(n=48, seed=55)
    path = tmp_path / "m.bin"
    lio.write_matrix(path, a)
    op = ShardedDenseOperator.from_file(path, mesh=mesh8, precision="f64",
                                        engine="xla")
    assert op.n == 48
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    assert bool(res.converged)
    x_ref, _, _, _ = oracle_cg(a, b, 1000, 1e-9)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)


def test_sharded_ir_reaches_f64_quality(mesh8):
    from lam_tpu import cg_solve_ir
    a, b = _spd_system(seed=77)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="df64",
                                         engine="xla")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    true_rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert true_rel < 1e-9


# -- ring-overlap matvec (comm="ring") ---------------------------------------

def test_ring_matvec_matches_gather(mesh8):
    a, _ = _spd_system(n=64, seed=91)
    p = gen.random_rhs(64, seed=2)
    ap_ref = a @ p
    for precision in ("f64", "df64"):
        gather = ShardedDenseOperator.from_dense(
            a, mesh=mesh8, precision=precision, engine="xla")
        ring = ShardedDenseOperator.from_dense(
            a, mesh=mesh8, precision=precision, engine="xla", comm="ring")
        apg = np.asarray(gather.matvec(gather.prepare_b(p)))[:64]
        apr = np.asarray(ring.matvec(ring.prepare_b(p)))[:64]
        # ring sums G block-partials in a different order than the full
        # row gemv: agreement to f64 rounding, not bitwise
        np.testing.assert_allclose(apr, ap_ref, rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(apr, apg, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("precision,rtol", [("df64", 1e-12),
                                            ("f64", 1e-12),
                                            ("f32", 1e-5)])
def test_ring_matvec_pallas_interpret(mesh8, precision, rtol):
    # the ring's column-stripe products (a dynamic slice of the local
    # row block, XLA) for every storage precision
    a, _ = _spd_system(n=64, seed=92)
    p = gen.random_rhs(64, seed=3)
    ring = ShardedDenseOperator.from_dense(
        a, mesh=mesh8, precision=precision, comm="ring")
    apr = np.asarray(ring.matvec(ring.prepare_b(p)), np.float64)[:64]
    np.testing.assert_allclose(apr, a @ p, rtol=rtol)


def test_ring_cg_matches_oracle(mesh8):
    a, b = _spd_system(seed=93)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="f64",
                                         engine="xla", comm="ring")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 1000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)


def test_ring_ir_reaches_f64_quality(mesh8):
    from lam_tpu import cg_solve_ir
    a, b = _spd_system(seed=94)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="df64",
                                         engine="xla", comm="ring")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    true_rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    assert true_rel < 1e-9


# -- 2-D (SUMMA-style) mesh ---------------------------------------------------

def test_2d_matvec_matches_numpy():
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    mesh = make_mesh2d(2)  # 2x2 grid of the 8 virtual devices
    a, _ = _spd_system(n=64, seed=101)
    p = gen.random_rhs(64, seed=4)
    for precision in ("f64", "df64"):
        op = Sharded2DOperator.from_dense(a, mesh=mesh,
                                          precision=precision,
                                          engine="xla")
        ap = np.asarray(op.matvec(op.prepare_b(p)))[:64]
        np.testing.assert_allclose(ap, a @ p, rtol=1e-10, atol=1e-13)


def test_2d_cg_matches_oracle():
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    mesh = make_mesh2d(2)
    a, b = _spd_system(seed=102)
    op = Sharded2DOperator.from_dense(a, mesh=mesh, precision="f64",
                                      engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 1000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)


def test_2d_ir_reaches_f64_quality():
    from lam_tpu import cg_solve_ir
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    mesh = make_mesh2d(2)
    a, b = _spd_system(seed=103)
    op = Sharded2DOperator.from_dense(a, mesh=mesh, precision="df64",
                                      engine="xla")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9


def test_2d_from_file(tmp_path):
    from lam_tpu import io as lio
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    mesh = make_mesh2d(2)
    a, b = _spd_system(n=48, seed=104)
    path = tmp_path / "m2d.bin"
    lio.write_matrix(path, a)
    op = Sharded2DOperator.from_file(path, mesh=mesh, precision="f64",
                                     engine="xla")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    assert bool(res.converged)
    x_ref, _, _, _ = oracle_cg(a, b, 1000, 1e-9)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("precision", ["df64", "f64"])
def test_2d_pallas_interpret(precision):
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    mesh = make_mesh2d(2)
    a, _ = _spd_system(n=64, seed=105)
    p = gen.random_rhs(64, seed=5)
    op = Sharded2DOperator.from_dense(a, mesh=mesh, precision=precision)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:64]
    np.testing.assert_allclose(ap, a @ p, rtol=1e-10, atol=1e-13)


# -- preconditioner + block-CG across backends (no single-backend surplus) --


def test_sharded_diagonal_extraction(mesh8):
    a, _ = _spd_system(n=96, seed=41)
    for precision in ("f64", "df64"):
        op = ShardedDenseOperator.from_dense(a, mesh=mesh8,
                                             precision=precision,
                                             engine="xla")
        d = np.asarray(op.diagonal())
        np.testing.assert_allclose(d[:96], np.diagonal(a), rtol=1e-12)
        assert np.all(d[96:] == 0)  # padded rows have zero diagonal


def test_sharded_jacobi_pcg_matches_local(mesh8):
    a, b = _spd_system(n=96, seed=42)
    # badly-scaled diagonal so Jacobi actually changes the iteration path
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)
    local = DenseOperator.from_dense(a, precision="f64", engine="xla")
    r_local = cg_solve(local, b, max_iters=2000, rel_error=1e-9,
                       preconditioner="jacobi")
    for comm in ("gather", "ring"):
        shard = ShardedDenseOperator.from_dense(
            a, mesh=mesh8, precision="f64", engine="xla", comm=comm)
        r = cg_solve(shard, b, max_iters=2000, rel_error=1e-9,
                     preconditioner="jacobi")
        assert bool(r.converged), comm
        assert abs(int(r.num_iters) - int(r_local.num_iters)) <= 10, comm
        resid = np.linalg.norm(b - a @ np.asarray(r.x))
        assert resid / np.linalg.norm(b) < 1e-8, comm


def test_sharded_ir_jacobi_matches_local(mesh8):
    """ir + jacobi on the sharded backends follows the local trajectory
    (round 3: the shared _make_local_ir gained a preconditioned inner
    loop). Covers the 1-D band program and the 2-D grid program."""
    from lam_tpu import cg_solve_ir
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    a, b = _spd_system(n=96, seed=42)
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)
    local = DenseOperator.from_dense(a, precision="df64", engine="xla")
    r_local = cg_solve_ir(local.as_f32(), local, b, max_iters=20000,
                          rel_error=1e-9, preconditioner="jacobi")
    assert bool(r_local.converged)
    bn = np.linalg.norm(b)
    shard = ShardedDenseOperator.from_dense(a, mesh=mesh8,
                                            precision="df64",
                                            engine="xla")
    r = cg_solve_ir(shard.as_f32(), shard, b, max_iters=20000,
                    rel_error=1e-9, preconditioner="jacobi")
    assert bool(r.converged)
    assert abs(int(r.num_iters) - int(r_local.num_iters)) <= 20
    assert np.linalg.norm(b - a @ np.asarray(r.x)) / bn < 1e-8
    op2d = Sharded2DOperator.from_dense(a, mesh=make_mesh2d(2),
                                        precision="df64", engine="xla")
    r2 = cg_solve_ir(op2d.as_f32(), op2d, b, max_iters=20000,
                     rel_error=1e-9, preconditioner="jacobi")
    assert bool(r2.converged)
    assert abs(int(r2.num_iters) - int(r_local.num_iters)) <= 20
    assert np.linalg.norm(b - a @ np.asarray(r2.x)) / bn < 1e-8


def test_symm_sharded_ir_jacobi(mesh8):
    """ir + jacobi on the band-pair symmetric operator (the replicated
    _cg_ir_loop route through _build_symm_cg_ir's precond leg)."""
    from lam_tpu import cg_solve_ir
    a, b = _spd_system(n=512, seed=54)
    s = np.exp(np.linspace(0, 3, 512))
    a = a * np.outer(s, s)
    op = _symm_op(a, 4)
    r = cg_solve_ir(op.as_f32(), op, b, max_iters=20000, rel_error=1e-9,
                    preconditioner="jacobi")
    assert bool(r.converged)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(r.x)) / bn < 1e-8


def test_sharded_block_cg(mesh8):
    from lam_tpu.solver.cg import cg_solve_block
    a, _ = _spd_system(n=96, seed=43)
    rng = np.random.default_rng(7)
    bb = rng.uniform(-1, 1, size=(96, 4))
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="f64",
                                         engine="xla")
    res = cg_solve_block(op, bb, max_iters=1000, rel_error=1e-9)
    assert bool(np.all(np.asarray(res.converged)))
    x = np.asarray(res.x)
    resid = np.linalg.norm(bb - a @ x, axis=0) / np.linalg.norm(bb, axis=0)
    assert np.all(resid < 1e-8)


def test_2d_diagonal_jacobi_and_block():
    from lam_tpu.parallel.pcg2d import Sharded2DOperator, make_mesh2d
    from lam_tpu.solver.cg import cg_solve_block
    a, b = _spd_system(n=96, seed=44)
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)
    mesh = make_mesh2d(2)
    op = Sharded2DOperator.from_dense(a, mesh=mesh, precision="f64",
                                      engine="xla")
    d = np.asarray(op.diagonal())
    np.testing.assert_allclose(d[:96], np.diagonal(a), rtol=1e-12)
    r = cg_solve(op, b, max_iters=2000, rel_error=1e-9,
                 preconditioner="jacobi")
    assert bool(r.converged)
    resid = np.linalg.norm(b - a @ np.asarray(r.x)) / np.linalg.norm(b)
    assert resid < 1e-8
    rng = np.random.default_rng(8)
    bb = rng.uniform(-1, 1, size=(96, 3))
    res = cg_solve_block(op, bb, max_iters=2000, rel_error=1e-9)
    assert bool(np.all(np.asarray(res.converged)))
    xb = np.asarray(res.x)
    rb = np.linalg.norm(bb - a @ xb, axis=0) / np.linalg.norm(bb, axis=0)
    assert np.all(rb < 1e-8)


def test_sharded_df64_jacobi_pcg(mesh8):
    # the df64 pair layout must also feed the preconditioned program
    a, b = _spd_system(n=96, seed=45)
    op = ShardedDenseOperator.from_dense(a, mesh=mesh8, precision="df64",
                                         engine="xla")
    r = cg_solve(op, b, max_iters=2000, rel_error=1e-9,
                 preconditioner="jacobi")
    assert bool(r.converged)
    resid = np.linalg.norm(b - a @ np.asarray(r.x)) / np.linalg.norm(b)
    assert resid < 1e-8


# -- symmetric band-pair sharded operator (pcg_symm) ------------------------


def _symm_op(a, g, tb=128):
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    return SymmShardedOperator.from_dense(a, mesh=make_mesh(g), tb=tb)


def test_symm_sharded_matvec_matches_numpy(mesh8):
    a, _ = _spd_system(n=512, seed=51)
    p = gen.random_rhs(512, seed=1)
    for g in (1, 2, 8):
        op = _symm_op(a, g)
        ap = np.asarray(op.matvec(op.prepare_b(p)))[:512]
        np.testing.assert_allclose(ap, a @ p, rtol=1e-12,
                                   atol=1e-12 * np.abs(a @ p).max())
        # f32 triangle-walk view
        ap32 = np.asarray(op.as_f32().matvec(
            op.as_f32().prepare_b(p.astype(np.float32))))[:512]
        ref = a @ p
        assert (np.linalg.norm(ap32 - ref) / np.linalg.norm(ref)) < 1e-5


def test_symm_sharded_cg_matches_oracle(mesh8):
    a, b = _spd_system(n=512, seed=52)
    op = _symm_op(a, 4)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8
    # replicated vectors -> result independent of shard count
    res2 = cg_solve(_symm_op(a, 2), b, max_iters=2000, rel_error=1e-9)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(res2.x))


def test_symm_sharded_ir_reaches_f64_quality(mesh8):
    from lam_tpu.solver.cg import cg_solve_ir
    a, b = _spd_system(n=512, seed=53)
    op = _symm_op(a, 4)
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                      rel_error=1e-9)
    assert bool(res.converged)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8


def test_symm_sharded_diagonal_and_pcg(mesh8):
    a, b = _spd_system(n=512, seed=54)
    s = np.exp(np.linspace(0, 3, 512))
    a = a * np.outer(s, s)
    op = _symm_op(a, 4)
    d = np.asarray(op.diagonal())
    np.testing.assert_allclose(d[:512], np.diagonal(a), rtol=1e-12)
    r = cg_solve(op, b, max_iters=3000, rel_error=1e-9,
                 preconditioner="jacobi")
    assert bool(r.converged)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(r.x)) / bn < 1e-8


def test_symm_sharded_rejects_asymmetric():
    a = np.triu(np.ones((64, 64))) + 3 * np.eye(64)
    with pytest.raises(ValueError, match="symmetric"):
        _symm_op(a, 2)


def test_sharded_non_power_of_two_mesh():
    """g=3 exercises the lcm-based shard padding (max() alone yielded a
    padded size not divisible by g and construction crashed)."""
    a, b = _spd_system(200, seed=9)
    op = ShardedDenseOperator.from_dense(a, mesh=make_mesh(3),
                                         precision="df64")
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x = np.asarray(res.x)
    assert bool(res.converged)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_symm_sharded_rejects_bad_tile(mesh8):
    """Non-power-of-two tb would reinterpret the tile tables in the
    wrong units (silently corrupt matvecs before round 2's guard)."""
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    a = np.eye(512) * 2.0
    with pytest.raises(ValueError, match="power-of-two"):
        SymmShardedOperator.from_dense(a, mesh=mesh8, tb=192)


def test_symm_sharded_via_api(mesh8):
    """--backend sharded --engine pallas_symm_packed routing (gen
    mode)."""
    from lam_tpu.solver.api import ConjugateGradient
    cg = ConjugateGradient(backend="sharded", precision="ir",
                           engine="pallas_symm_packed", n_devices=4)
    cg.generate_matrix(300)
    cg.generate_rhs()
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    from lam_tpu import generate as g2
    a = g2.tridiagonal_matrix(300)
    b = g2.ones_rhs(300)
    assert (np.linalg.norm(b - a @ cg.x) / np.linalg.norm(b)) < 1e-8
    assert cg.measure_gemv(repeats=3) > 0


def test_symm_sharded_from_file(mesh8, tmp_path):
    from lam_tpu import io as lio
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    a, b = _spd_system(n=256, seed=55)
    path = tmp_path / "m.bin"
    lio.write_matrix(path, a)
    op = SymmShardedOperator.from_file(str(path), mesh=make_mesh(4),
                                       tb=128)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    assert bool(res.converged)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8


@pytest.mark.parametrize("precision", ["auto", "df64"])
def test_sharded_gen_tridiagonal_device_side(precision):
    """ShardedDenseOperator.from_gen_tridiagonal (device-side iota
    build) must produce the same operator as the host-built gen path:
    the f64 matrix itself by default, the (hi, 0) pair for df64."""
    from lam_tpu import generate as gen
    from lam_tpu.parallel.mesh import make_mesh
    from lam_tpu.parallel.pcg import ShardedDenseOperator

    n = 96
    mesh = make_mesh(4)
    op = ShardedDenseOperator.from_gen_tridiagonal(n, mesh=mesh,
                                                   precision=precision)
    a = gen.tridiagonal_matrix(n)
    n_p = op.n_padded
    want = np.zeros((n_p, n_p))
    want[:n, :n] = a
    if precision == "auto":
        assert op.precision == "f64"
        np.testing.assert_array_equal(np.asarray(op.operand), want)
    else:
        assert op.precision == "df64"
        hi, lo = op.operand
        np.testing.assert_array_equal(np.asarray(hi), want)
        assert not np.asarray(lo).any()
    b = gen.ones_rhs(n)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x = np.asarray(res.x, np.float64)[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_symm_sharded_gen_tridiagonal_device_side():
    """SymmShardedOperator.from_gen_tridiagonal builds the hi plane in
    band-pair slab order on device; matvec must equal the dense A @ p."""
    from lam_tpu import generate as gen
    from lam_tpu.parallel.mesh import make_mesh
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator

    n = 96
    mesh = make_mesh(2)
    op = SymmShardedOperator.from_gen_tridiagonal(n, mesh=mesh, tb=128)
    ref = SymmShardedOperator.from_row_block_fn(
        lambda s, m: gen.tridiagonal_rows(s, m, n), n, mesh=mesh, tb=128)
    np.testing.assert_array_equal(np.asarray(op.operand[0]),
                                  np.asarray(ref.operand[0]))
    assert not np.asarray(op.operand[1]).any()
    a = gen.tridiagonal_matrix(n)
    b = gen.ones_rhs(n)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x = np.asarray(res.x, np.float64)[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


# -- packed triangle storage on the band-pair operator (round 3) ------------


def test_symm_sharded_packed_matches_slab(mesh8):
    """packed=True must reproduce the slab operator's matvec (accurate
    path within f64 reduction-order noise; the f32 views — the kernel
    over packed tiles, one XLA product over the slab rows — each at f32
    accuracy) at half the stored bytes."""
    a, _ = _spd_system(n=512, seed=61)
    p = gen.random_rhs(512, seed=2)
    for g in (1, 2, 4):
        slab = _symm_op(a, g)
        pk = _symm_op_packed(a, g)
        # capacity: packed stores exactly the lower-triangle tile count
        # (= (nblk+1)/(2*nblk) of the square -> 1/2 for large nblk)
        assert pk.operand[0].shape[1] == 128
        nblk = slab.n_padded // 128
        tri = nblk * (nblk + 1) // 2
        assert pk.operand[0].shape[0] == tri * 128
        ap_s = np.asarray(slab.matvec(slab.prepare_b(p)))[:512]
        ap_p = np.asarray(pk.matvec(pk.prepare_b(p)))[:512]
        np.testing.assert_allclose(ap_p, ap_s, rtol=1e-13, atol=1e-13)
        f32s = np.asarray(slab.as_f32().matvec(
            slab.as_f32().prepare_b(p.astype(np.float32))))
        f32p = np.asarray(pk.as_f32().matvec(
            pk.as_f32().prepare_b(p.astype(np.float32))))
        ref32 = (a @ p.astype(np.float32).astype(np.float64))
        for y in (f32s, f32p):
            y = np.asarray(y, np.float64)[:512]
            assert np.linalg.norm(y - ref32) / np.linalg.norm(ref32) < 1e-5


def _symm_op_packed(a, g, tb=128):
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    return SymmShardedOperator.from_dense(a, mesh=make_mesh(g), tb=tb,
                                          packed=True)


def test_symm_sharded_packed_cg_and_ir(mesh8):
    from lam_tpu.solver.cg import cg_solve_ir
    a, b = _spd_system(n=512, seed=62)
    op = _symm_op_packed(a, 4)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                       rel_error=1e-9)
    assert bool(res2.converged)
    assert np.linalg.norm(b - a @ np.asarray(res2.x)) / bn < 1e-8


def test_symm_sharded_packed_diagonal_and_pcg(mesh8):
    a, b = _spd_system(n=512, seed=63)
    s = np.exp(np.linspace(0, 3, 512))
    a = a * np.outer(s, s)
    op = _symm_op_packed(a, 4)
    d = np.asarray(op.diagonal())
    np.testing.assert_allclose(d[:512], np.diagonal(a), rtol=1e-12)
    r = cg_solve(op, b, max_iters=3000, rel_error=1e-9,
                 preconditioner="jacobi")
    assert bool(r.converged)
    bn = np.linalg.norm(b)
    assert np.linalg.norm(b - a @ np.asarray(r.x)) / bn < 1e-8


def test_symm_sharded_packed_gen_tridiagonal(mesh8):
    """Device-built packed gen-mode operator: walk-order hi plane plus a
    broadcast (tb, tb) zero lo tile — matvec must be exact."""
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    n = 700
    op = SymmShardedOperator.from_gen_tridiagonal(n, mesh=make_mesh(4),
                                                  tb=128, packed=True)
    assert op.operand[1].shape[0] == 4 * 128  # one zero tile per shard
    at = gen.tridiagonal_matrix(n)
    p = gen.random_rhs(n, seed=5)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:n]
    np.testing.assert_allclose(ap, at @ p, rtol=1e-13, atol=1e-13)
    b = gen.ones_rhs(n)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    assert bool(res.converged)
    assert np.linalg.norm(b - at @ np.asarray(res.x)) / np.linalg.norm(
        b) < 1e-8


# -- quantized-lo (dfq) storage on the band-pair operator (round 3) ---------


def _symm_op_dfq(a, g, tb=128):
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    return SymmShardedOperator.from_dense(a, mesh=make_mesh(g), tb=tb,
                                          precision="dfq")


def test_symm_sharded_dfq_matvec_diag_capacity(mesh8):
    """Sharded dfq: 6 B/element per shard (f32 hi + int16 lo tiles),
    matvec within the quantization bound of the dense product, diagonal
    carried exactly as a slab-order df64 pair."""
    a, _ = _spd_system(n=512, seed=71)
    p = gen.random_rhs(512, seed=3)
    for g in (1, 2, 4):
        op = _symm_op_dfq(a, g)
        assert op._storage == "dfq" and op.precision == "dfq"
        hi, loq, sc, dh, dl, *_ = op.operand
        assert hi.dtype == np.float32 and loq.dtype == np.int16
        assert hi.shape == loq.shape          # 4 B + 2 B per element
        assert dh.shape == (op.n_padded,) and dl.shape == (op.n_padded,)
        ap = np.asarray(op.matvec(op.prepare_b(p)))[:512]
        ref = a @ p
        err = np.linalg.norm(ap - ref) / np.linalg.norm(ref)
        assert err < 1e-9, err                # ~2^-39-scale quantization
        d = np.asarray(op.diagonal())[:512]
        np.testing.assert_allclose(d, np.diagonal(a), rtol=0,
                                   atol=1e-12)


def test_symm_sharded_dfq_stores_local_dfq_tiles(mesh8, monkeypatch):
    """AT THE SAME TILE WIDTH the band-pair walk stores the same tiles
    as the local packed triangle (different order, extra zero padding
    tiles); per-tile quantization is order-free, so every real tile's
    (hi, loq, scale) content must match the local operator's bit for
    bit (storage comparison; the matvecs are compared against numpy
    elsewhere)."""
    from lam_tpu.ops.gemv import _symm_tables
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    tb = 128
    a, _ = _spd_system(n=512, seed=72)
    local = DenseOperator.from_dense_dfq(a)
    lhi, lloq, lsc, _, _ = (np.asarray(x) for x in local.operand)
    assert lhi.shape[1] == tb
    nblk_l = local.n_padded // tb
    lit, lkt = _symm_tables(nblk_l)
    tiles = {(int(i), int(k)): t for t, (i, k) in enumerate(zip(lit,
                                                                lkt))}
    op = _symm_op_dfq(a, 4, tb=tb)
    shi, sloq, ssc = (np.asarray(x) for x in op.operand[:3])
    sit, skt = (np.asarray(x) for x in op.operand[5:7])
    g, T = sit.shape
    checked = 0
    for c in range(g):
        for t in range(T):
            i, k = int(sit[c, t]), int(skt[c, t])
            row = c * T + t
            if (i, k) in tiles:
                tl = tiles[(i, k)]
                np.testing.assert_array_equal(
                    shi[row * tb:(row + 1) * tb],
                    lhi[tl * tb:(tl + 1) * tb])
                np.testing.assert_array_equal(
                    sloq[row * tb:(row + 1) * tb],
                    lloq[tl * tb:(tl + 1) * tb])
                assert ssc[c, t] == lsc[tl]
                checked += 1
            else:                     # band-padding tile: exact zeros
                assert not shi[row * tb:(row + 1) * tb].any()
                assert not sloq[row * tb:(row + 1) * tb].any()
    assert checked == len(tiles)      # every real tile stored once


def test_symm_sharded_dfq_cg_and_irq(mesh8):
    from lam_tpu.solver.cg import cg_solve_ir
    a, b = _spd_system(n=512, seed=73)
    op = _symm_op_dfq(a, 4)
    bn = np.linalg.norm(b)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                       rel_error=1e-9)
    assert bool(res2.converged)
    assert np.linalg.norm(b - a @ np.asarray(res2.x)) / bn < 1e-8


def test_symm_sharded_irq_via_api(mesh8, tmp_path):
    """backend='sharded' + precision='irq' routes to the dfq band-pair
    operator (engine auto -> pallas_symm_packed) and solves through the
    facade, including the file path."""
    from lam_tpu import io as lio
    from lam_tpu.solver.api import ConjugateGradient

    n = 512
    a, b = _spd_system(n=n, seed=74)
    mpath, bpath = tmp_path / "m.bin", tmp_path / "b.bin"
    lio.write_matrix(str(mpath), a)
    lio.write_matrix(str(bpath), b)
    cg = ConjugateGradient(backend="sharded", precision="irq",
                           n_devices=4)
    assert cg.load_matrix_from_file(str(mpath))
    assert cg.load_rhs_from_file(str(bpath))
    assert cg.op._storage == "dfq"
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    x = cg.x[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def _symm_op_fq(a, g, tb=128):
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    return SymmShardedOperator.from_dense(a, mesh=make_mesh(g), tb=tb,
                                          precision="fq")


def test_symm_sharded_fq_matvec_diag_capacity(mesh8):
    """Sharded fq (round 3b): three int16 cascade planes per shard
    (6 B/element), accurate matvec at the ~2^-48 storage bound of the
    dense product (the planes are rebuilt in native f64), diagonal
    carried exactly as a slab-order df64 pair, and the f32 view's
    matvec reads only the q1 plane (~2^-16 tile-relative)."""
    a, _ = _spd_system(n=512, seed=81)
    p = gen.random_rhs(512, seed=5)
    ref = a @ p
    for g in (1, 2, 4):
        op = _symm_op_fq(a, g)
        assert op._storage == "fq" and op.precision == "fq"
        q1, q2, q3, s1, s2, s3, dh, dl, *_ = op.operand
        assert (q1.dtype == q2.dtype == q3.dtype == np.int16
                and q1.shape == q2.shape == q3.shape)
        assert dh.shape == (op.n_padded,) and dl.shape == (op.n_padded,)
        ap = np.asarray(op.matvec(op.prepare_b(p)))[:512]
        err = np.linalg.norm(ap - ref) / np.linalg.norm(ref)
        assert err < 1e-11, err
        d = np.asarray(op.diagonal())[:512]
        np.testing.assert_allclose(d, np.diagonal(a), rtol=0,
                                   atol=1e-12)
        op32 = op.as_f32()
        assert op32.operand is op.operand
        y32 = np.asarray(op32.matvec(op32.prepare_b(
            p.astype(np.float32))), np.float64)[:512]
        assert np.linalg.norm(y32 - ref) / np.linalg.norm(ref) < 1e-3


def test_symm_sharded_fq_stores_local_fq_tiles(mesh8, monkeypatch):
    """Per-tile quantization is order-free, so every real tile of the
    band-pair fq walk must match the local from_dense_fq pack bit for
    bit at the same tile width (the band walk adds zero padding tiles,
    which quantize to scale 0)."""
    from lam_tpu.ops.gemv import _symm_tables
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    tb = 128
    a, _ = _spd_system(n=512, seed=82)
    local = DenseOperator.from_dense_fq(a)
    lq = [np.asarray(x) for x in local.operand[:3]]
    ls = [np.asarray(x) for x in local.operand[3:6]]
    nblk_l = local.n_padded // tb
    lit, lkt = _symm_tables(nblk_l)
    tiles = {(int(i), int(k)): t for t, (i, k) in enumerate(
        zip(lit, lkt))}
    op = _symm_op_fq(a, 4, tb=tb)
    sq = [np.asarray(x) for x in op.operand[:3]]
    ss = [np.asarray(x) for x in op.operand[3:6]]
    sit, skt = (np.asarray(x) for x in op.operand[8:10])
    g = sit.shape[0]
    T = sit.shape[1]
    for c in range(g):
        for t in range(T):
            i, k = int(sit[c, t]), int(skt[c, t])
            lt_ = tiles.get((i, k))
            row = c * T + t
            if lt_ is None:        # padding tile: zero planes + scales
                for q, sY in zip(sq, ss):
                    assert not q[row * tb:(row + 1) * tb].any()
                    assert sY[c, t] == 0.0
                continue
            for q, sY, lqp, lsp in zip(sq, ss, lq, ls):
                np.testing.assert_array_equal(
                    q[row * tb:(row + 1) * tb],
                    lqp[lt_ * tb:(lt_ + 1) * tb])
                assert sY[c, t] == lsp[lt_]


def test_symm_sharded_fq_cg_and_irfq(mesh8):
    from lam_tpu.solver.cg import cg_solve_ir
    a, b = _spd_system(n=512, seed=83)
    op = _symm_op_fq(a, 4)
    bn = np.linalg.norm(b)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    assert np.linalg.norm(b - a @ np.asarray(res.x)) / bn < 1e-8
    # irfq: the inner loop reads only the q1 plane; the coarse operator
    # needs the 1e-2 floor
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                       rel_error=1e-9, inner_floor=1e-2)
    assert bool(res2.converged)
    assert np.linalg.norm(b - a @ np.asarray(res2.x)) / bn < 1e-8


def test_symm_sharded_gen_fq_device_built(mesh8):
    """Sharded gen-mode fq (SymmShardedOperator.from_gen_fq): the
    device-built quantization-EXACT q1 plane + per-chip broadcast zero
    residual tiles reproduce the gen tridiagonal's matvecs across mesh
    sizes — including a non-tile-multiple n — and irfq on the
    device-built operator converges to the true solution."""
    from lam_tpu import cg_solve_ir
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    n = 700
    a = gen.tridiagonal_rows(0, n, n)
    p = gen.random_rhs(n, seed=9)
    ref = a @ p
    rn = np.linalg.norm(ref)
    for g in (1, 2, 4):
        op = SymmShardedOperator.from_gen_fq(n, mesh=make_mesh(g),
                                             tb=128)
        assert op._storage == "fq" and op.precision == "fq"
        q1, q2, q3, s1, s2, s3, dh, dl, *_ = op.operand
        assert q2.shape == (g * 128, 128)   # ONE broadcast tile/chip
        assert q3.shape == (g * 128, 128)
        y = np.asarray(op.matvec(op.prepare_b(p)))[:n]
        assert np.linalg.norm(y - ref) / rn < 1e-12
        op32 = op.as_f32()
        y32 = np.asarray(op32.matvec(op32.prepare_b(
            p.astype(np.float32))), np.float64)[:n]
        assert np.linalg.norm(y32 - ref) / rn < 1e-5
        d = np.asarray(op.diagonal())[:n]
        np.testing.assert_array_equal(d, np.full(n, 2.0))
    op = SymmShardedOperator.from_gen_fq(n, mesh=make_mesh(2), tb=128)
    b = gen.ones_rhs(n)
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000,
                      rel_error=1e-6, inner_floor=1e-2)
    assert bool(res.converged)
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-5


def test_symm_sharded_irfq_via_api(mesh8, tmp_path):
    """backend='sharded' + precision='irfq' routes to the fq band-pair
    operator (engine auto -> pallas_symm_packed) and solves through the
    facade, including the file path."""
    from lam_tpu import io as lio
    from lam_tpu.solver.api import ConjugateGradient

    n = 512
    a, b = _spd_system(n=n, seed=84)
    mpath, bpath = tmp_path / "m.bin", tmp_path / "b.bin"
    lio.write_matrix(str(mpath), a)
    lio.write_matrix(str(bpath), b)
    cg = ConjugateGradient(backend="sharded", precision="irfq",
                           n_devices=4)
    assert cg.load_matrix_from_file(str(mpath))
    assert cg.load_rhs_from_file(str(bpath))
    assert cg.op._storage == "fq"
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    x = cg.x[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8
