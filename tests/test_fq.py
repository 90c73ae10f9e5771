"""Fully-quantized packed storage ("fq"/"irfq") — CPU suite.

Covers the quantization cascade's mathematical guarantees (per-plane
bound, exact power-of-two reconstruction), the int16 triangle walk (the
kernel in interpret mode) against a dequantization oracle, operator
plumbing (diagonal extraction, as_f32 view identity, padding, block
matvec, error paths), and end-to-end irfq solves to a true 1e-9
residual.

The reference has no quantized storage anywhere — its backends stream
8-byte fp64 for every element every matvec
(ConjugateGradient_GPU_CUDA.cu:171-223); fq is capability surplus aimed
at the N=70000 north-star scale (SURVEY.md §6).
"""

import numpy as np
import pytest

from lam_tpu.ops.gemv import (_symm_tables, pack_tri_host,
                              quantize_fq_tiles, tri_walk)
from lam_tpu.solver.operators import DenseOperator


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


def test_quantize_fq_cascade_bounds_and_exactness():
    tb = 256
    a = _sym(1024, 0, zero_diag=True)
    packed = pack_tri_host(a, tb)
    q1, q2, q3, s1, s2, s3 = quantize_fq_tiles(packed, tb)
    assert q1.dtype == q2.dtype == q3.dtype == np.int16
    T = packed.shape[0] // tb

    def deq(q, s):
        return q.astype(np.float64) * np.repeat(s, tb)[:, None]

    r1 = packed - deq(q1, s1)
    r2 = r1 - deq(q2, s2)
    r3 = r2 - deq(q3, s3)
    for r, s in ((r1, s1), (r2, s2), (r3, s3)):
        bound = np.repeat(s, tb)[:, None].astype(np.float64) / 2
        assert (np.abs(r) <= bound + 1e-300).all()
    # cascade: each scale table drops by ~2^-16
    assert (s2[s1 > 0] <= s1[s1 > 0] * 2.0 ** -15).all()
    # total storage error is df64-pair class relative to the tile max
    tile_max = np.abs(packed).reshape(T, -1).max(axis=1)
    rel = np.abs(r3).reshape(T, -1).max(axis=1) / np.maximum(tile_max,
                                                             1e-300)
    assert rel.max() < 2.0 ** -45
    # power-of-two scales -> int16 * scale reconstructs EXACTLY in f32
    rec32 = q1.astype(np.float32) * np.repeat(s1, tb)[:, None].astype(
        np.float32)
    np.testing.assert_array_equal(rec32.astype(np.float64), deq(q1, s1))
    # zero input quantizes to zero scales and planes
    z = quantize_fq_tiles(np.zeros((tb, tb)), tb)
    assert not any(arr.any() for arr in z)


def test_q16_kernel_matches_dequantization_oracle():
    tb = 128
    nblk = 4
    n = tb * nblk
    a = _sym(n, 1, zero_diag=True)
    packed = pack_tri_host(a, tb)
    q1, _, _, s1, _, _ = quantize_fq_tiles(packed, tb)
    rng = np.random.default_rng(2)
    p = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(tri_walk(q1, p, scales=s1))
    it, kt = _symm_tables(nblk)
    aq = np.zeros((n, n))
    for t, (i, k) in enumerate(zip(it, kt)):
        tile = q1[t * tb:(t + 1) * tb].astype(np.float64) * float(s1[t])
        aq[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tile
        if k < i:
            aq[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tile.T
    ref = aq @ p.astype(np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-5


def test_q16_padded_plane_matches_unpadded():
    """The Q16_P-padded plane (the fq storage format) must walk EXACTLY
    like the unpadded one on integer data: with small-int tiles, a
    power-of-two scale and small-int p, every product and partial sum
    is exact in f32, so reading a pad tile would show up as a bit
    difference."""
    from lam_tpu.ops.gemv import (Q16_P, padded_tri_tile_count,
                                  tri_tile_count)
    tb = 128
    nblk = 4
    n = tb * nblk
    T = tri_tile_count(nblk)
    tp = padded_tri_tile_count(nblk)
    assert T % Q16_P != 0 and tp % Q16_P == 0  # both grids exercised
    rng = np.random.default_rng(7)
    q1 = rng.integers(-3, 4, (T * tb, tb)).astype(np.int16)
    s1 = np.full((T,), 0.5, np.float32)          # power of two: exact
    p = rng.integers(-3, 4, n).astype(np.float32)
    y_one = np.asarray(tri_walk(q1, p, scales=s1))
    q1p = np.concatenate(
        [q1, np.ones(((tp - T) * tb, tb), np.int16)])
    s1p = np.concatenate([s1, np.ones((tp - T,), np.float32)])
    y_blk = np.asarray(tri_walk(q1p, p, scales=s1p))
    np.testing.assert_array_equal(y_one, y_blk)
    # wrong tile counts still rejected
    with pytest.raises(ValueError, match="tiles"):
        tri_walk(q1[: (T - 1) * tb], p, scales=s1[: T - 1])


def test_fq_planes_are_padded_to_the_blocked_grid():
    """from_dense_fq (and the native/file paths that promise bitwise
    identity with it) stores Q16_P-padded planes: all-zero pad tiles,
    zero pad scales."""
    from lam_tpu.ops.gemv import SYMM_TB, padded_tri_tile_count
    n = 700
    a, _ = _spd(n, 9)
    op = DenseOperator.from_dense(a, precision="fq")
    tb = SYMM_TB
    nblk = op.n_padded // tb
    tp = padded_tri_tile_count(nblk)
    q1, q2, q3, s1, s2, s3, _, _ = op.operand
    from lam_tpu.ops.gemv import tri_tile_count
    t = tri_tile_count(nblk)
    for plane in (q1, q2, q3):
        assert plane.shape == (tp * tb, tb)
        assert not np.asarray(plane[t * tb:]).any()
    for sc in (s1, s2, s3):
        assert sc.shape == (tp,)
        assert not np.asarray(sc[t:]).any()


def test_fq_operator_matvec_diagonal_and_padding():
    n = 700  # not a tile multiple: exercises padding
    a, _ = _spd(n, 3)
    op = DenseOperator.from_dense(a, precision="fq")
    assert op.precision == "fq" and op.engine == "pallas_symm_packed"
    q1, q2, q3, s1, s2, s3, dh, dl = op.operand
    assert q1.dtype == q2.dtype == q3.dtype == np.int16
    d = np.asarray(op.diagonal())[:n]
    np.testing.assert_allclose(d, np.diagonal(a), rtol=1e-13, atol=0)
    rng = np.random.default_rng(4)
    p = rng.uniform(-1, 1, n)
    y = np.asarray(op.extract_x(op.matvec(op.prepare_b(p))))
    # the ~2^-48 tile-relative storage bound, in an f64 walk
    assert np.linalg.norm(y - a @ p) / np.linalg.norm(a @ p) < 1e-12


def test_fq_as_f32_shares_operand_and_adds_diagonal():
    n = 512
    a, _ = _spd(n, 5)
    op = DenseOperator.from_dense(a, precision="fq")
    op32 = op.as_f32()
    assert op32.operand is op.operand  # HBM shared, not copied
    rng = np.random.default_rng(6)
    p = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(op32.extract_x(op32.matvec(op32.prepare_b(p))),
                   np.float64)
    ref = a @ p.astype(np.float64)
    # the inner view reads only the ~2^-16 tile-relative q1 plane
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-3


def test_irfq_solve_end_to_end():
    from lam_tpu import cg_solve_ir
    n = 600
    a, b = _spd(n, 7)
    op = DenseOperator.from_dense(a, precision="fq")
    # the coarse inner operator needs the 1e-2 floor
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000,
                      rel_error=1e-9, inner_floor=1e-2)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 2e-9


def test_irfq_default_floor_schedule():
    """The production default floor for irfq is the measured
    loose-early/tight-late SCHEDULE (solver/cg.py IRFQ_INNER_FLOOR);
    a schedule-valued inner_floor must solve to the same residual as
    the flat floor (cycle c uses floors[min(c, len-1)])."""
    from lam_tpu import cg_solve_ir
    from lam_tpu.solver.cg import default_inner_floor
    sched = default_inner_floor("irfq")
    assert tuple(np.atleast_1d(sched)) == (3e-2, 1e-2)
    assert default_inner_floor("ir") == 1e-5
    n = 600
    a, b = _spd(n, 7)
    op = DenseOperator.from_dense(a, precision="fq")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000,
                      rel_error=1e-6, inner_floor=sched)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-5


def test_block_cg_on_fq():
    from lam_tpu.solver.cg import cg_solve_block
    n = 384
    a, _ = _spd(n, 8)
    rng = np.random.default_rng(9)
    b = rng.uniform(-1, 1, (n, 3))
    op = DenseOperator.from_dense(a, precision="fq")
    res = cg_solve_block(op, b, max_iters=3000, rel_error=1e-6)
    x = np.asarray(res.x)
    rel = (np.linalg.norm(b - a @ x, axis=0)
           / np.linalg.norm(b, axis=0)).max()
    assert rel < 1e-5


def test_gen_fq_matches_from_dense(monkeypatch):
    """The device-built gen-mode fq operator (EXACT q1 plane +
    broadcast zero q2/q3 tiles, DenseOperator.from_gen_fq) produces
    the same accurate matvec, f32-view matvec, and block matvec as
    from_dense_fq on the host-assembled tridiagonal — including a
    non-tile-multiple n (padding)."""
    import jax
    import jax.numpy as jnp

    from lam_tpu import generate as gen
    from lam_tpu.ops.gemv import SYMM_TB
    from lam_tpu.solver.operators import padded_size
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    tb = 128
    for n in (384, 300):
        n_p = padded_size(n, tb)
        it, kt = _symm_tables(n_p // tb)
        q1 = jax.jit(gen._tridiag_q1_packed_impl,
                     static_argnums=(0, 1, 4))(n, tb, jnp.asarray(it),
                                               jnp.asarray(kt),
                                               n_p // tb)
        gop = DenseOperator.from_gen_fq(q1, n, n_p)
        a = gen.tridiagonal_rows(0, n, n)
        ref = DenseOperator.from_dense_fq(a, check_symmetric=False)
        rng = np.random.default_rng(11)
        p = rng.uniform(-1, 1, n)
        pp = gop.prepare_b(p)
        np.testing.assert_allclose(np.asarray(gop.matvec(pp))[:n],
                                   np.asarray(ref.matvec(pp))[:n],
                                   rtol=0, atol=1e-12)
        p32 = jnp.asarray(p, jnp.float32)
        p32p = jnp.pad(p32, (0, n_p - n))
        g32 = gop.as_f32()
        r32 = ref.as_f32()
        np.testing.assert_array_equal(
            np.asarray(g32.matvec(p32p))[:n],
            np.asarray(r32.matvec(p32p))[:n])
        # block matvec skips the broadcast zero planes
        blk = rng.uniform(-1, 1, (n, 2))
        yb = np.asarray(gop._mv_block(gop.operand, gop.prepare_b_block(blk)))
        np.testing.assert_allclose(yb[:n], a @ blk, rtol=0, atol=1e-12)


def test_gen_fq_irfq_solve(monkeypatch):
    """End-to-end irfq on the gen-built operator: the outer fq matvec
    (broadcast zero residual planes) is EXACT for the tridiagonal, so
    refinement converges to the true solution."""
    import jax
    import jax.numpy as jnp

    from lam_tpu import cg_solve_ir
    from lam_tpu import generate as gen
    from lam_tpu.solver.operators import padded_size
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    tb, n = 128, 500
    n_p = padded_size(n, tb)
    it, kt = _symm_tables(n_p // tb)
    q1 = jax.jit(gen._tridiag_q1_packed_impl,
                 static_argnums=(0, 1, 4))(n, tb, jnp.asarray(it),
                                           jnp.asarray(kt), n_p // tb)
    op = DenseOperator.from_gen_fq(q1, n, n_p)
    b = gen.ones_rhs(n)
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000,
                      rel_error=1e-6, inner_floor=1e-2)
    assert bool(res.converged)
    a = gen.tridiagonal_rows(0, n, n)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-5


def test_irfq_through_api_and_file(tmp_path):
    from lam_tpu.solver.api import ConjugateGradient
    import lam_tpu.io as lio
    n = 400
    a, b = _spd(n, 10)
    cg = ConjugateGradient(backend="local", precision="irfq")
    am, bm = str(tmp_path / "A.bin"), str(tmp_path / "b.bin")
    lio.write_matrix(am, a)
    lio.write_matrix(bm, b)
    assert cg.load_matrix_from_file(am)
    assert cg.load_rhs_from_file(bm)
    assert cg.op.precision == "fq"
    ok = cg.solve(max_iters=5000, rel_error=1e-5)
    assert ok
    x = cg.x
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-4
    # measure_gemv times the inner q16 matvec for irfq (the hot one)
    assert cg.measure_gemv(repeats=2) > 0
    assert "avg_gemv_acc_s" in cg.timings


def test_fq_error_paths():
    with pytest.raises(ValueError, match="not combinable"):
        DenseOperator.from_dense(_sym(512, 11), precision="fq",
                                 engine="xla")
    asym = np.triu(np.ones((512, 512)))
    with pytest.raises(ValueError, match="symmetric"):
        DenseOperator.from_dense(asym, precision="fq")
    # fq/irfq runs on every backend (local, 1-D band-pair, 2-D grid —
    # tests/test_sharded.py::test_symm_sharded_fq_*,
    # tests/test_sharded2d_symm.py::test_sym2d_fq_*); a non-symmetric
    # 2-D engine rejects cleanly
    from lam_tpu.solver.api import ConjugateGradient
    cg = ConjugateGradient(backend="sharded2d", precision="irfq",
                           engine="xla", n_devices=4)
    with pytest.raises(ValueError, match="symmetric grid"):
        cg.generate_matrix(512)
