"""Quantized-lo packed storage ("dfq"): the 6-byte f64 element.

Exact quantization bounds and reconstruction, the accurate matvec
(dequantize to f64, then the plain XLA walk) bitwise against the df64
pair holding the reconstructed lo plane, operator plumbing (diagonal
extraction, as_f32 view identity, error paths), and end-to-end irq
solves to a true 1e-9 residual.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lam_tpu.ops.gemv import SYMM_TB, pack_tri_host, quantize_lo_tiles
from lam_tpu.solver.operators import MATVEC, DenseOperator, split_f64_host


def _sym(n, seed, zero_diag=False):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    a = (m + m.T) / 2
    if zero_diag:
        np.fill_diagonal(a, 0.0)
    return a


def _spd(n, seed):
    from lam_tpu import generate as gen
    return gen.random_spd_system(n, seed=seed)


def test_quantize_lo_tiles_bound_and_exact_reconstruction():
    tb = 256
    a = _sym(1024, 0, zero_diag=True)
    _, lo = split_f64_host(a)
    lop = pack_tri_host(lo, tb)
    q, sc = quantize_lo_tiles(lop, tb)
    assert q.dtype == np.int16 and sc.dtype == np.float32
    scales = np.repeat(sc, tb)[:, None].astype(np.float64)
    rec = q.astype(np.float64) * scales
    # error bound: half a quantization step per element
    assert (np.abs(rec - lop) <= scales / 2 + 1e-300).all()
    # power-of-two scales -> int16 * scale reconstructs EXACTLY in f32
    rec32 = q.astype(np.float32) * scales.astype(np.float32)
    np.testing.assert_array_equal(rec32.astype(np.float64), rec)
    # all-zero tiles quantize to scale 0 (reconstruct to exactly 0)
    zq, zs = quantize_lo_tiles(np.zeros((tb, tb), np.float32), tb)
    assert zs[0] == 0.0 and not zq.any()


def test_dfq_kernel_bitwise_matches_df64_on_reconstructed_lo():
    # the dequantization (int16 -> f32 * scale) must be exact; given
    # the same effective lo plane, dfq and df64 walk identically
    tb = 256
    n = 1024
    a = _sym(n, 1, zero_diag=True)
    hi, lo = split_f64_host(a)
    hip = pack_tri_host(hi, tb)
    lop = pack_tri_host(lo, tb)
    q, sc = quantize_lo_tiles(lop, tb)
    rec = q.astype(np.float32) * np.repeat(sc, tb)[:, None]
    rng = np.random.default_rng(2)
    p = rng.uniform(-1, 1, n)
    zero = jnp.zeros((n,), jnp.float32)      # zero diagonal: dh = dl = 0
    y_q = MATVEC[("dfq", "pallas_symm_packed")](
        (jnp.asarray(hip), jnp.asarray(q), jnp.asarray(sc), zero, zero),
        jnp.asarray(p))
    y_d = MATVEC[("df64", "pallas_symm_packed")](
        (jnp.asarray(hip), jnp.asarray(rec)), jnp.asarray(p))
    np.testing.assert_array_equal(np.asarray(y_q), np.asarray(y_d))
    assert np.linalg.norm(np.asarray(y_q) - a @ p) < 1e-10 * np.linalg.norm(
        a @ p)


def test_dfq_operator_matvec_and_diagonal():
    n = 700  # not a tile multiple: exercises padding
    a, _ = _spd(n, 3)
    op = DenseOperator.from_dense(a, precision="dfq")
    assert op.precision == "dfq" and op.engine == "pallas_symm_packed"
    assert op.n_padded % SYMM_TB == 0
    hi, loq, sc, dh, dl = op.operand
    assert loq.dtype == jnp.int16
    # diagonal is extracted as a df64 pair (hi + lo carries ~2^-48
    # relative accuracy — the split itself rounds the f64 tail) and
    # zeroed in the planes
    d = np.asarray(op.diagonal())[:n]
    np.testing.assert_allclose(d, np.diagonal(a), rtol=1e-13, atol=0)
    rng = np.random.default_rng(4)
    p = rng.uniform(-1, 1, n)
    y = np.asarray(op.extract_x(op.matvec(op.prepare_b(p))))
    # quantized lo plane: ~2^-39 tile-relative, in an f64 walk
    assert np.linalg.norm(y - a @ p) / np.linalg.norm(a @ p) < 1e-10


def test_dfq_as_f32_shares_operand_and_adds_diagonal():
    n = 512
    a, _ = _spd(n, 5)
    op = DenseOperator.from_dense(a, precision="dfq")
    op32 = op.as_f32()
    assert op32.operand is op.operand  # HBM shared, not copied
    rng = np.random.default_rng(6)
    p = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(op32.extract_x(op32.matvec(op32.prepare_b(p))),
                   np.float64)
    ref = a @ p.astype(np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-5


def test_irq_solve_end_to_end():
    from lam_tpu import cg_solve_ir
    n = 600
    a, b = _spd(n, 7)
    op = DenseOperator.from_dense(a, precision="dfq")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 2e-9


def test_irq_through_api_and_cli():
    from lam_tpu.solver.api import ConjugateGradient
    n = 400
    a, b = _spd(n, 8)
    cg = ConjugateGradient(backend="local", precision="irq")
    import lam_tpu.io as lio
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        am, bm = os.path.join(td, "A.bin"), os.path.join(td, "b.bin")
        lio.write_matrix(am, a)
        lio.write_matrix(bm, b)
        assert cg.load_matrix_from_file(am)
        assert cg.load_rhs_from_file(bm)
        assert cg.op.precision == "dfq"
        ok = cg.solve(max_iters=5000, rel_error=1e-5)
        assert ok
        x = cg.x
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-4
        # measure_gemv times the inner f32 matvec for irq (the hot one)
        assert cg.measure_gemv(repeats=2) > 0


def test_dfq_error_paths():
    a = _sym(512, 9)  # symmetric but indefinite: fine for matvec tests
    with pytest.raises(ValueError, match="not combinable"):
        DenseOperator.from_dense(a, precision="dfq", engine="xla")
    asym = np.triu(np.ones((512, 512)))
    with pytest.raises(ValueError, match="symmetric"):
        DenseOperator.from_dense(asym, precision="dfq")
    # sharded dfq/irq is supported (band-pair quantized storage) — but
    # only as packed triangle tiles; the full-row engine has no
    # quantized form and is rejected cleanly
    from lam_tpu.solver.api import ConjugateGradient
    cg = ConjugateGradient(backend="sharded", precision="irq",
                           engine="pallas_symm_packed", n_devices=2)
    assert cg.generate_matrix(512)
    assert cg.op._storage == "dfq" and cg.op.precision == "dfq"
    bad = ConjugateGradient(backend="sharded", precision="irq",
                            engine="xla", n_devices=2)
    with pytest.raises(ValueError, match="packed"):
        bad.generate_matrix(512)
