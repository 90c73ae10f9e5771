"""SYMMETRIC 2-D grid (half storage + O(N/R) exchange) on the virtual
mesh — lam_tpu/parallel/pcg2d_symm.py: the triangle walk on the
diagonal chips and the XLA half-slab products on the others.

The reference has no symmetric storage anywhere (its backends stream all
N^2 elements every matvec, ConjugateGradient_GPU_CUDA.cu:171-211); this
operator is surplus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lam_tpu import DenseOperator, cg_solve, cg_solve_ir
from lam_tpu import generate as gen
from lam_tpu.parallel.pcg2d import make_mesh2d
from lam_tpu.parallel.pcg2d_symm import Symm2DOperator

from oracle import oracle_cg

TB = 128  # small tile -> small padding on the CPU mesh


@pytest.fixture(scope="module")
def mesh2x2():
    assert len(jax.devices()) >= 4, "conftest should provide 8 cpu devices"
    return make_mesh2d(2)


def _spd_system(n=96, seed=21):
    return gen.random_spd_matrix(n, seed=seed), gen.random_rhs(n, seed + 10)


# -- half-slab products (XLA) ------------------------------------------------


def _half_slab(buf, ms, n, dtype):
    from lam_tpu.parallel.pcg2d_symm import _rect_tiles_dense
    return _rect_tiles_dense(jnp.asarray(buf), ms // TB, n // TB, TB, dtype)


def _dual(sdn, p, q):
    hi = jax.lax.Precision.HIGHEST
    return (np.asarray(jnp.matmul(sdn, p, precision=hi), np.float64),
            np.asarray(jnp.matmul(sdn.T, q, precision=hi), np.float64))


def test_dual_kernel_f32_matches_numpy():
    from lam_tpu.ops.gemv import pack_rect_host
    rng = np.random.default_rng(0)
    ms, n = 256, 512
    s = rng.standard_normal((ms, n)).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    q = rng.standard_normal(ms).astype(np.float32)
    buf = pack_rect_host(s, TB, pad_tiles=3)  # pad tiles must be inert
    sdn = _half_slab(buf, ms, n, jnp.float32)
    np.testing.assert_array_equal(np.asarray(sdn), s)
    d, t = _dual(sdn, jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(d, s @ p, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(t, s.T @ q, rtol=2e-5, atol=1e-4)


def test_dual_kernel_df64_matches_numpy():
    from lam_tpu.ops.gemv import pack_rect_host
    from lam_tpu.solver.operators import split_f64_host
    rng = np.random.default_rng(1)
    ms, n = 256, 384
    s = rng.standard_normal((ms, n))
    p = rng.standard_normal(n)
    q = rng.standard_normal(ms)
    sh, sl = split_f64_host(s)
    sdn = (_half_slab(pack_rect_host(sh, TB), ms, n, jnp.float64)
           + _half_slab(pack_rect_host(sl, TB), ms, n, jnp.float64))
    d, t = _dual(sdn, jnp.asarray(p), jnp.asarray(q))
    # the (hi, lo) pair rebuilt in f64: f64 products
    assert np.linalg.norm(d - s @ p) / np.linalg.norm(s @ p) < 1e-13
    assert np.linalg.norm(t - s.T @ q) / np.linalg.norm(s.T @ q) < 1e-13


def test_dual_kernel_rejects_bad_geometry():
    from lam_tpu.parallel.pcg2d_symm import _rect_tiles_dense
    buf = jnp.zeros((128, 128), jnp.float32)  # 1 tile
    with pytest.raises(ValueError, match="packed buffer has"):
        _rect_tiles_dense(buf, 1, 2, TB, jnp.float32)  # needs 2 tiles


# -- operator ----------------------------------------------------------------


def test_sym2d_matvec_matches_numpy(mesh2x2):
    a, _ = _spd_system(n=200, seed=101)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    p = gen.random_rhs(200, seed=4)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:200]
    np.testing.assert_allclose(ap, a @ p, rtol=1e-10, atol=1e-12)


def test_sym2d_stores_half_the_elements(mesh2x2):
    n = 256
    a, _ = _spd_system(n=n, seed=107)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    hi, lo = op.operand
    # exact footprint: R^2 chips x tri_tile_count(c) tiles of tb^2 =
    # n_p * (n_p + R*tb) / 2 -> ratio (c+1)/2c of a full square plane
    # (the +1 is per-chip tile padding; -> 1/2 as c = m/tb grows)
    r = 2
    c = (op.n_padded // r) // TB
    assert hi.size == r * r * (c * (c + 1) // 2) * TB * TB
    assert hi.size == op.n_padded * (op.n_padded + r * TB) // 2
    assert hi.size == lo.size


def test_sym2d_cg_matches_oracle(mesh2x2):
    a, b = _spd_system(seed=102)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    x_ref, iters_ref, _, conv_ref = oracle_cg(a, b, 1000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    n = a.shape[0]
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_ir_reaches_f64_quality(mesh2x2):
    a, b = _spd_system(seed=103)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    n = a.shape[0]
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-9


def test_sym2d_diagonal_and_jacobi(mesh2x2):
    a, b = _spd_system(n=96, seed=44)
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    d = np.asarray(op.diagonal())
    np.testing.assert_allclose(d[:96], np.diagonal(a), rtol=1e-12)
    assert np.all(d[96:] == 0)
    r = cg_solve(op, b, max_iters=2000, rel_error=1e-9,
                 preconditioner="jacobi")
    assert bool(r.converged)
    x = np.asarray(r.x)[:96]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_ir_jacobi(mesh2x2):
    """ir + jacobi on the symmetric 2-D grid (round 3: the shared
    _make_local_ir preconditioned inner loop through
    _build_sym2d_cg_ir's precond leg)."""
    a, b = _spd_system(n=96, seed=44)
    s = np.exp(np.linspace(0, 4, 96))
    a = a * np.outer(s, s)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    r = cg_solve_ir(op.as_f32(), op, b, max_iters=20000, rel_error=1e-9,
                    preconditioner="jacobi")
    assert bool(r.converged)
    x = np.asarray(r.x)[:96]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_from_file(tmp_path, mesh2x2):
    from lam_tpu import io as lio
    a, b = _spd_system(n=48, seed=104)
    path = tmp_path / "msym2d.bin"
    lio.write_matrix(path, a)
    op = Symm2DOperator.from_file(path, mesh=mesh2x2, tb=TB)
    res = cg_solve(op, b, max_iters=1000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)[:48]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_gen_tridiagonal_matches_dense(mesh2x2):
    n = 200
    op = Symm2DOperator.from_gen_tridiagonal(n, mesh=mesh2x2, tb=TB)
    ag = np.asarray(gen.tridiagonal_matrix(n))
    p = gen.random_rhs(n, seed=9)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:n]
    np.testing.assert_allclose(ap, ag @ p, rtol=1e-12, atol=1e-12)
    b = np.ones(n)
    res = cg_solve(op, b, max_iters=500, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(b - ag @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_gen_quarter_footprint(mesh2x2):
    n = 200
    op = Symm2DOperator.from_gen_tridiagonal(n, mesh=mesh2x2, tb=TB)
    hi, lo = op.operand
    r = 2
    assert lo.shape == (r * TB, r * TB)  # broadcast zero tile per chip
    assert hi.size == op.n_padded * (op.n_padded + r * TB) // 2


def test_sym2d_rejects_asymmetric(mesh2x2):
    a, _ = _spd_system(n=48, seed=105)
    a = np.asarray(a).copy()
    a[0, 1] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)


def test_sym2d_matches_local_solution(mesh2x2):
    a, b = _spd_system(seed=106)
    local = DenseOperator.from_dense(a, precision="f64", engine="xla")
    sym = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    r1 = cg_solve(local, b, max_iters=1000, rel_error=1e-9)
    r2 = cg_solve(sym, b, max_iters=1000, rel_error=1e-9)
    assert abs(int(r1.num_iters) - int(r2.num_iters)) <= 6
    n = a.shape[0]
    np.testing.assert_allclose(np.asarray(r2.x)[:n], np.asarray(r1.x),
                               rtol=1e-6, atol=1e-8)


def test_sym2d_matvec_chain_normalized(mesh2x2):
    a, _ = _spd_system(n=96, seed=108)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB)
    p = gen.random_rhs(96, seed=11)
    out = np.asarray(op.matvec_chain(op.prepare_b(p), 3))
    # chain normalizes each step: unit-norm result, direction of A^3 p
    ref = a @ (a @ (a @ p))
    ref = np.pad(ref / np.linalg.norm(ref), (0, op.n_padded - 96))
    assert abs(np.linalg.norm(out) - 1.0) < 1e-10
    np.testing.assert_allclose(np.abs(out), np.abs(ref), rtol=1e-8,
                               atol=1e-10)


def test_api_routes_sym2d(mesh2x2):
    from lam_tpu import ConjugateGradient
    a, b = _spd_system(n=96, seed=109)
    cg = ConjugateGradient(backend="sharded2d",
                           engine="pallas_symm_packed", n_devices=4)
    import lam_tpu.io as lio
    import tempfile
    import os
    d = tempfile.mkdtemp()
    mp = os.path.join(d, "m.bin")
    rp = os.path.join(d, "r.bin")
    lio.write_matrix(mp, np.asarray(a))
    lio.write_matrix(rp, np.asarray(b).reshape(-1, 1))
    cg.load_matrix_from_file(mp)
    cg.load_rhs_from_file(rp)
    assert cg.solve(max_iters=2000, rel_error=1e-9)
    assert type(cg.op).__name__ == "Symm2DOperator"
    x = np.asarray(cg.result.x)[:96]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8
    # gen mode routes too, and the probe CSV path works
    cg2 = ConjugateGradient(backend="sharded2d",
                            engine="pallas_symm_packed", n_devices=4)
    cg2.generate_matrix(96)
    cg2.generate_rhs()
    assert cg2.solve(max_iters=300, rel_error=1e-9)
    assert type(cg2.op).__name__ == "Symm2DOperator"
    assert cg2.measure_gemv(3) > 0


def test_api_sym2d_rejects_f32_precision():
    from lam_tpu import ConjugateGradient
    cg = ConjugateGradient(backend="sharded2d",
                           engine="pallas_symm_packed", precision="f32",
                           n_devices=4)
    with pytest.raises(ValueError, match="df64/ir"):
        cg.generate_matrix(96)


# -- quantized-lo (dfq) storage on the 2-D grid ------------------------------


def test_dual_kernel_dfq_matches_df64_on_reconstructed_lo():
    """Dequantization must be exact: given the same effective lo plane,
    the dfq and df64 accurate half-slab products agree bit for bit."""
    from lam_tpu.ops.gemv import pack_rect_host, quantize_lo_tiles
    from lam_tpu.solver.operators import split_f64_host
    tb = 128
    ms, n = 256, 512
    rng = np.random.default_rng(7)
    s = rng.uniform(-1, 1, (ms, n))
    hi, lo = split_f64_host(s)
    hip = pack_rect_host(hi, tb, pad_tiles=1)
    lop = pack_rect_host(lo, tb, pad_tiles=1)
    q, sc = quantize_lo_tiles(lop, tb)
    lo_rec = (q.astype(np.float32)
              * np.repeat(sc, tb)[:, None].astype(np.float32))
    from lam_tpu.ops.gemv import dequantize_tiles
    T = q.shape[0] // tb
    f64 = jnp.float64
    deq = (jnp.asarray(hip)[:T * tb].astype(f64)
           + dequantize_tiles(jnp.asarray(q), jnp.asarray(sc), T, f64))
    rec = (jnp.asarray(hip).astype(f64) + jnp.asarray(lo_rec).astype(f64))
    p = jnp.asarray(rng.uniform(-1, 1, n))
    qv = jnp.asarray(rng.uniform(-1, 1, ms))
    out_q = _dual(_half_slab(deq, ms, n, f64), p, qv)
    out_d = _dual(_half_slab(rec, ms, n, f64), p, qv)
    for xq, xd in zip(out_q, out_d):
        np.testing.assert_array_equal(xq, xd)
    np.testing.assert_allclose(out_q[0], s @ np.asarray(p), rtol=1e-9)


def test_sym2d_dfq_matvec_diag_capacity(mesh2x2):
    """2-D dfq: 6 B/element stored ONCE across the grid; matvec within
    the quantization bound; diagonal carried as a P(ROWS) df64 pair."""
    a, _ = _spd_system(n=700, seed=81)
    p = gen.random_rhs(700, seed=6)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB,
                                   precision="dfq")
    assert op._storage == "dfq" and op.precision == "dfq"
    hi, loq, sc, dh, dl = op.operand
    assert hi.dtype == np.float32 and loq.dtype == np.int16
    assert hi.shape == loq.shape
    assert dh.shape == (op.n_padded,) and dl.shape == (op.n_padded,)
    y = np.asarray(op.matvec(op.prepare_b(p)))[:700]
    ref = a @ p
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-9
    d = np.asarray(op.diagonal())[:700]
    np.testing.assert_allclose(d, np.diagonal(a), rtol=0, atol=1e-12)


def test_sym2d_dfq_cg_irq_and_jacobi(mesh2x2):
    a, b = _spd_system(n=700, seed=82)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB,
                                   precision="dfq")
    bn = np.linalg.norm(b)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    _, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    assert np.linalg.norm(b - a @ np.asarray(res.x)[:700]) / bn < 1e-8
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                       rel_error=1e-9)
    assert bool(res2.converged)
    assert np.linalg.norm(b - a @ np.asarray(res2.x)[:700]) / bn < 1e-8
    res3 = cg_solve(op, b, max_iters=3000, rel_error=1e-9,
                    preconditioner="jacobi")
    assert bool(res3.converged)


def test_sym2d_irq_via_api(mesh2x2, tmp_path):
    """backend='sharded2d' + precision='irq' routes to the dfq grid
    (engine auto -> pallas_symm_packed), through the file path."""
    from lam_tpu import io as lio
    from lam_tpu.solver.api import ConjugateGradient
    n = 700
    a, b = _spd_system(n=n, seed=83)
    mp, bp = tmp_path / "m.bin", tmp_path / "b.bin"
    lio.write_matrix(str(mp), a)
    lio.write_matrix(str(bp), b)
    cg = ConjugateGradient(backend="sharded2d", precision="irq",
                           n_devices=4)
    assert cg.load_matrix_from_file(str(mp))
    assert cg.load_rhs_from_file(str(bp))
    assert cg.op._storage == "dfq"
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    x = cg.x[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sym2d_fq_matvec_diag_capacity(mesh2x2):
    """2-D fq (round 3b): the three-int16 cascade stored ONCE across
    the grid (6 B/element); accurate matvec at the ~2^-48 storage
    bound (the planes are rebuilt in native f64); diagonal as a
    P(ROWS) df64 pair; the f32 view reads only the 2-byte q1 plane."""
    a, _ = _spd_system(n=700, seed=91)
    p = gen.random_rhs(700, seed=7)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB,
                                   precision="fq")
    assert op._storage == "fq" and op.precision == "fq"
    q1, q2, q3, s1, s2, s3, dh, dl = op.operand
    assert q1.dtype == q2.dtype == q3.dtype == np.int16
    assert q1.shape == q2.shape == q3.shape
    assert dh.shape == (op.n_padded,) and dl.shape == (op.n_padded,)
    ref = a @ p
    y = np.asarray(op.matvec(op.prepare_b(p)))[:700]
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-11
    d = np.asarray(op.diagonal())[:700]
    np.testing.assert_allclose(d, np.diagonal(a), rtol=0, atol=1e-12)
    op32 = op.as_f32()
    assert op32.operand is op.operand
    y32 = np.asarray(op32.matvec(op32.prepare_b(
        p.astype(np.float32))), np.float64)[:700]
    assert np.linalg.norm(y32 - ref) / np.linalg.norm(ref) < 1e-3


def test_sym2d_fq_cg_and_irfq(mesh2x2):
    a, b = _spd_system(n=700, seed=92)
    op = Symm2DOperator.from_dense(a, mesh=mesh2x2, tb=TB,
                                   precision="fq")
    bn = np.linalg.norm(b)
    res = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
    _, iters_ref, _, conv_ref = oracle_cg(a, b, 2000, 1e-9)
    assert bool(res.converged) and conv_ref
    assert abs(int(res.num_iters) - iters_ref) <= max(3, iters_ref // 20)
    assert np.linalg.norm(b - a @ np.asarray(res.x)[:700]) / bn < 1e-8
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                       rel_error=1e-9, inner_floor=1e-2)
    assert bool(res2.converged)
    assert np.linalg.norm(b - a @ np.asarray(res2.x)[:700]) / bn < 1e-8


def test_sym2d_irfq_via_api(mesh2x2, tmp_path):
    """backend='sharded2d' + precision='irfq' routes to the fq grid
    (engine auto -> pallas_symm_packed), through the file path."""
    from lam_tpu import io as lio
    from lam_tpu.solver.api import ConjugateGradient
    n = 700
    a, b = _spd_system(n=n, seed=93)
    mp, bp = tmp_path / "m.bin", tmp_path / "b.bin"
    lio.write_matrix(str(mp), a)
    lio.write_matrix(str(bp), b)
    cg = ConjugateGradient(backend="sharded2d", precision="irfq",
                           n_devices=4)
    assert cg.load_matrix_from_file(str(mp))
    assert cg.load_rhs_from_file(str(bp))
    assert cg.op._storage == "fq"
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    x = cg.x[:n]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_dual_kernel_fq_broadcast_residual_tiles():
    """The f64 rebuild of the fq cascade accepts ONE (tb, tb) broadcast
    tile for the q2/q3 residual planes (gen mode,
    Symm2DOperator.from_gen_fq) and matches the full-zero-plane form bit
    for bit; a malformed plane is rejected."""
    from lam_tpu.ops.gemv import pack_rect_host, quantize_fq_tiles
    from lam_tpu.parallel.pcg_symm import _rebuild64
    tb = 128
    ms, n = 256, 512
    rng = np.random.default_rng(11)
    s = rng.uniform(-1, 1, (ms, n))
    sp = pack_rect_host(s, tb, pad_tiles=1)
    q1, _, _, s1, _, _ = quantize_fq_tiles(sp, tb)
    T = q1.shape[0] // tb
    zs = jnp.zeros((T,), jnp.float32)
    scales = (jnp.asarray(s1), zs, zs)
    q1 = jnp.asarray(q1)
    full = _rebuild64((q1, jnp.zeros_like(q1), jnp.zeros_like(q1)),
                      scales, T, tb)
    bcast_tile = jnp.zeros((tb, tb), jnp.int16)
    bc = _rebuild64((q1, bcast_tile, bcast_tile), scales, T, tb)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(bc))
    p = jnp.asarray(rng.uniform(-1, 1, n))
    qv = jnp.asarray(rng.uniform(-1, 1, ms))
    d, t = _dual(_half_slab(bc, ms, n, jnp.float64), p, qv)
    # q1 alone: the ~2^-16 tile-relative first plane
    np.testing.assert_allclose(d, s @ np.asarray(p), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="tiles"):
        _rebuild64((q1, bcast_tile[:64], bcast_tile), scales, T, tb)


def test_sym2d_gen_fq_matches_dense(mesh2x2):
    """Device-built gen-mode fq on the 2-D grid: quantization-EXACT q1
    plane (off-diag entries {0, 1} against the 2^-14 scale), diagonal
    extracted to the P(ROWS) df64 pair, broadcast-zero residual
    planes — the accurate matvec must equal the closed-form
    tridiagonal product and both solves must converge."""
    n = 200
    op = Symm2DOperator.from_gen_fq(n, mesh=mesh2x2, tb=TB)
    assert op._storage == "fq" and op.precision == "fq"
    q1, q2, q3, s1, s2, s3, dh, dl = op.operand
    r = 2
    # residual planes are ONE broadcast (tb, tb) tile per chip
    assert q2.shape == (r * TB, r * TB) and q3.shape == (r * TB, r * TB)
    assert q1.dtype == np.int16
    ag = np.asarray(gen.tridiagonal_matrix(n))
    p = gen.random_rhs(n, seed=9)
    ap = np.asarray(op.matvec(op.prepare_b(p)))[:n]
    np.testing.assert_allclose(ap, ag @ p, rtol=1e-12, atol=1e-12)
    d = np.asarray(op.diagonal())[:n]
    np.testing.assert_allclose(d, np.full(n, 2.0), rtol=0, atol=0)
    # f32 view (the irfq inner engine) reads only the q1 plane
    p32 = p.astype(np.float32)
    op32 = op.as_f32()
    y32 = np.asarray(op32.matvec(op32.prepare_b(p32)), np.float64)[:n]
    assert np.linalg.norm(y32 - ag @ p) / np.linalg.norm(ag @ p) < 1e-6
    b = np.ones(n)
    bn = np.linalg.norm(b)
    res = cg_solve(op, b, max_iters=500, rel_error=1e-9)
    assert bool(res.converged)
    assert np.linalg.norm(b - ag @ np.asarray(res.x)[:n]) / bn < 1e-8
    res2 = cg_solve_ir(op.as_f32(), op, b, max_iters=5000,
                       rel_error=1e-9, inner_floor=1e-2)
    assert bool(res2.converged)
    assert np.linalg.norm(b - ag @ np.asarray(res2.x)[:n]) / bn < 1e-8


def test_sym2d_gen_fq_offsets_and_padding(mesh2x2):
    """The corner element and padding rows land on the right chips for
    an n that pads (n < n_padded) and one that does not."""
    for n in (160, 2 * 2 * TB * 2):  # padded and exact-fit sizes
        op = Symm2DOperator.from_gen_fq(n, mesh=mesh2x2, tb=TB)
        ag = np.asarray(gen.tridiagonal_matrix(n))
        p = gen.random_rhs(n, seed=3)
        ap = np.asarray(op.matvec(op.prepare_b(p)))[:n]
        np.testing.assert_allclose(ap, ag @ p, rtol=1e-12, atol=1e-12)


def test_api_gen_fq_routes_sym2d(mesh2x2, monkeypatch):
    """Gen mode with --backend sharded2d --precision irfq routes to the
    device-built fq grid (_generate_fast) on every platform: no host
    build, no host->device matrix transfer."""
    import lam_tpu.parallel.pcg2d_symm as s2
    from lam_tpu.solver.api import ConjugateGradient
    cg = ConjugateGradient(backend="sharded2d", precision="irfq",
                           n_devices=4)
    op = cg._generate_fast(300)
    assert isinstance(op, s2.Symm2DOperator)
    assert op._storage == "fq"
    q1, q2, q3 = op.operand[0], op.operand[1], op.operand[2]
    assert q1.dtype == np.int16
    # residual planes are broadcast tiles, not full planes
    assert q2.shape[0] < q1.shape[0] and q3.shape[0] < q1.shape[0]
