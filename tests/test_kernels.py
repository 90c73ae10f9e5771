"""The packed triangle walk: the Pallas kernel (interpret mode on CPU)
and the plain XLA forms against numpy f64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lam_tpu.ops import gemv


def _symm(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(n, n))
    return m + m.T, rng.uniform(-1, 1, size=n)


def _stored(a, tb, storage):
    """Packed walk-order tiles of `a` in `storage` ('f32' or 'q16') and
    the exact f64 matrix those stored values represent."""
    nblk = a.shape[0] // tb
    if storage == "f32":
        buf = gemv.pack_tri_host(a.astype(np.float32), tb)
        return buf, None, a.astype(np.float32).astype(np.float64)
    q1, _, _, s1, _, _ = gemv.quantize_fq_tiles(gemv.pack_tri_host(a, tb),
                                                tb)
    # the dense matrix of the stored int16 x scale values
    dense = np.zeros_like(a)
    it, kt = gemv._symm_tables(nblk)
    for t, (i, k) in enumerate(zip(it, kt)):
        tile = q1[t * tb:(t + 1) * tb].astype(np.float64) * float(s1[t])
        dense[i * tb:(i + 1) * tb, k * tb:(k + 1) * tb] = tile
        if k < i:
            dense[k * tb:(k + 1) * tb, i * tb:(i + 1) * tb] = tile.T
    return q1, s1, dense


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


# one tile, several tiles, a wider tile
WALK_CASES = [(128, 128), (512, 128), (1024, 256)]


@pytest.mark.parametrize("storage", ["f32", "q16"])
@pytest.mark.parametrize("n,tb", WALK_CASES)
def test_kernel_walk_matches_f64(storage, n, tb):
    a, p = _symm(n, n + tb)
    buf, scales, dense = _stored(a, tb, storage)
    p32 = p.astype(np.float32)
    y = np.asarray(gemv.tri_walk(jnp.asarray(buf), jnp.asarray(p32),
                                 None if scales is None
                                 else jnp.asarray(scales)), np.float64)
    # f32 products and sums over n terms against the f64 product of the
    # same stored values
    assert _rel(y, dense @ p32.astype(np.float64)) < 1e-5


@pytest.mark.parametrize("storage", ["f32", "q16"])
def test_kernel_partials_per_tile(storage):
    """direct[t] = T_t @ p[kt], trans[t] = T_t^T @ p[it] off the
    diagonal and exactly 0 on diagonal tiles."""
    n, tb = 384, 128
    a, p = _symm(n, 3)
    buf, scales, _ = _stored(a, tb, storage)
    it, kt = gemv._symm_tables(n // tb)
    p32 = p.astype(np.float32)
    direct, trans = gemv.tri_walk_partials(
        jnp.asarray(buf), jnp.asarray(p32), jnp.asarray(it),
        jnp.asarray(kt), None if scales is None else jnp.asarray(scales))
    direct, trans = np.asarray(direct), np.asarray(trans)
    for t, (i, k) in enumerate(zip(it, kt)):
        tile = buf[t * tb:(t + 1) * tb].astype(np.float64)
        if scales is not None:
            tile = tile * float(scales[t])
        pk = p32[k * tb:(k + 1) * tb].astype(np.float64)
        pi = p32[i * tb:(i + 1) * tb].astype(np.float64)
        assert _rel(direct[t], tile @ pk) < 1e-5
        if k < i:
            assert _rel(trans[t], tile.T @ pi) < 1e-5
        else:
            assert not trans[t].any()


@pytest.mark.parametrize("storage", ["f32", "q16"])
def test_kernel_agrees_with_xla_walk(storage):
    n, tb = 512, 128
    a, p = _symm(n, 4)
    buf, scales, _ = _stored(a, tb, storage)
    args = (jnp.asarray(buf), jnp.asarray(p.astype(np.float32)),
            None if scales is None else jnp.asarray(scales))
    y_k = np.asarray(gemv.tri_walk(*args), np.float64)
    y_x = np.asarray(gemv.tri_walk(*args, kernel=False), np.float64)
    assert _rel(y_k, y_x) < 1e-6


@pytest.mark.parametrize("nblk", [3, 5])
def test_kernel_ignores_q16_pad_tiles(nblk):
    """fq planes are padded to a multiple of Q16_P walk tiles; the walk
    never reads past its T tiles, so pad contents cannot matter."""
    tb = 128
    n = nblk * tb
    a, p = _symm(n, nblk)
    q1, s1, dense = _stored(a, tb, "q16")
    T = gemv.tri_tile_count(nblk)
    Ts = gemv.padded_tri_tile_count(nblk)
    assert Ts % gemv.Q16_P == 0 and Ts > T
    q_pad = np.full((Ts * tb, tb), 32767, np.int16)
    q_pad[:T * tb] = q1
    s_pad = np.full((Ts,), 2.0 ** 20, np.float32)
    s_pad[:T] = s1
    p32 = p.astype(np.float32)
    y = np.asarray(gemv.tri_walk(jnp.asarray(q_pad), jnp.asarray(p32),
                                 jnp.asarray(s_pad)), np.float64)
    assert _rel(y, dense @ p32.astype(np.float64)) < 1e-5


@pytest.mark.parametrize("storage", ["f32", "q16"])
def test_kernel_slab_tables_sum_to_full_matvec(storage):
    """The band-pair walk: each device's packed tiles in its own walk
    order (pcg_symm._band_tables); per-device partials folded by global
    row/column tile sum to A @ p."""
    from lam_tpu.parallel.pcg_symm import _band_tables
    n, g, tb = 1024, 2, 128
    it, kt, _ = _band_tables(g, n // (2 * g) // tb, tb)
    a, p = _symm(n, 5)
    _, _, dense = _stored(a, tb, storage)
    p32 = jnp.asarray(p.astype(np.float32))
    y = np.zeros(n)
    for c in range(g):
        packed = gemv.pack_tri_host(dense, tb, it=it[c], kt=kt[c])
        if storage == "f32":
            buf, scales = packed.astype(np.float32), None
        else:
            buf, _, _, scales, _, _ = gemv.quantize_fq_tiles(packed, tb)
            scales = jnp.asarray(scales)
        direct, trans = gemv.tri_walk_partials(
            jnp.asarray(buf), p32, jnp.asarray(it[c]), jnp.asarray(kt[c]),
            scales)
        yd, yt = gemv.fold_partials(direct, trans, jnp.asarray(it[c]),
                                    jnp.asarray(kt[c]), n // tb, n // tb)
        y += np.asarray(yd, np.float64) + np.asarray(yt, np.float64)
    assert _rel(y, dense @ np.asarray(p32, np.float64)) < 1e-5


@pytest.mark.parametrize("rows,num_warps,num_stages",
                         [(8, 4, 3), (16, 8, 2), (128, 4, 1)])
def test_kernel_configs_agree(rows, num_warps, num_stages, monkeypatch):
    """Every chunking gives the same product (rows is capped at tb)."""
    monkeypatch.setitem(gemv.KERNEL_CONFIG, np.dtype(np.float32),
                        dict(rows=rows, num_warps=num_warps,
                             num_stages=num_stages))
    # the configuration is read at trace time: drop traces made with
    # another one, before and after
    gemv.tri_walk_partials.clear_cache()
    n, tb = 512, 128
    a, p = _symm(n, 6)
    buf, _, dense = _stored(a, tb, "f32")
    p32 = p.astype(np.float32)
    try:
        y = np.asarray(gemv.tri_walk(jnp.asarray(buf), jnp.asarray(p32)),
                       np.float64)
    finally:
        gemv.tri_walk_partials.clear_cache()
    assert _rel(y, dense @ p32.astype(np.float64)) < 1e-5


def test_kernel_config_table_covers_both_storages():
    assert set(gemv.KERNEL_CONFIG) == {np.dtype(np.float32),
                                       np.dtype(np.int16)}
    for cfg in gemv.KERNEL_CONFIG.values():
        assert cfg["rows"] & (cfg["rows"] - 1) == 0   # power of two
        assert gemv.SYMM_TB % cfg["rows"] == 0


def test_f64_walk_of_quantized_tiles_is_exact():
    """The accurate walk: dequantized int16 tiles in f64 reproduce the
    stored matrix to f64 rounding."""
    n, tb = 512, 128
    a, p = _symm(n, 7)
    q1, s1, dense = _stored(a, tb, "q16")
    y = np.asarray(gemv.tri_walk(jnp.asarray(q1), jnp.asarray(p),
                                 jnp.asarray(s1), kernel=False))
    assert _rel(y, dense @ p) < 1e-13


def test_packing_never_reads_upper_triangle():
    n, tb = 512, 128
    a, p = _symm(n, 8)
    poisoned = a.copy()
    for bi in range(n // tb):
        poisoned[bi * tb:(bi + 1) * tb, (bi + 1) * tb:] = np.nan
    buf = gemv.pack_tri_host(poisoned.astype(np.float32), tb)
    y = np.asarray(gemv.tri_walk(jnp.asarray(buf),
                                 jnp.asarray(p.astype(np.float32))),
                   np.float64)
    assert np.isfinite(y).all()
    assert _rel(y, a @ p) < 1e-5


def _bad_walk(case):
    p = jnp.zeros((512,), jnp.float32)
    it, kt = (jnp.asarray(t) for t in gemv._symm_tables(4))
    tiles = jnp.zeros((10 * 128, 128), jnp.float32)
    if case == "tb":
        return (jnp.zeros((10 * 96, 96), jnp.float32),
                jnp.zeros((384,), jnp.float32), it, kt, None)
    if case == "n":
        return tiles, jnp.zeros((500,), jnp.float32), it, kt, None
    if case == "short":
        return tiles[:9 * 128], p, it, kt, None
    if case == "scales":
        return tiles.astype(jnp.int16), p, it, kt, None
    return tiles.astype(jnp.float64), p, it, kt, None


@pytest.mark.parametrize("case,match", [
    ("tb", "power of two"), ("n", "multiple"), ("short", "tiles"),
    ("scales", "scale"), ("dtype", "float32 or int16")])
def test_kernel_rejects_bad_walks(case, match):
    with pytest.raises(ValueError, match=match):
        gemv.tri_walk_partials(*_bad_walk(case))


def test_kernel_runs_interpreted_on_cpu_only():
    """The cpu row interprets the kernel; the gpu row compiles it
    through Triton (lam_tpu/platform.py)."""
    from lam_tpu import platform
    assert jax.default_backend() == "cpu"
    assert platform.current().pallas_interpret
    assert not platform.PLATFORMS["gpu"].pallas_interpret
    assert platform.PLATFORMS["gpu"].pallas_backend == "triton"


# -- XLA matvecs: f32 products at HIGHEST precision -------------------------


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _f32_matvecs():
    from lam_tpu.solver import operators as ops
    a = jnp.zeros((256, 256), jnp.float32)
    p = jnp.zeros((256,), jnp.float32)
    buf = jnp.zeros((3 * 128, 128), jnp.float32)
    it, kt = (jnp.asarray(t) for t in gemv._symm_tables(2))
    return {
        "mv_xla": (ops._mv_xla, a, p),
        "mv_cols_xla": (lambda a, p: ops._mv_cols_xla(a, p, 1), a, p[:128]),
        "f32_of_f64": (ops._mv_f32_of_f64_xla, a.astype(jnp.float64), p),
        "tri_walk_xla": (lambda b, v: gemv.tri_walk_xla(b, v, it, kt),
                         buf, p),
    }


@pytest.mark.parametrize("name", ["mv_xla", "mv_cols_xla", "f32_of_f64",
                                  "tri_walk_xla"])
def test_f32_xla_products_ask_for_highest(name):
    fn, *args = _f32_matvecs()[name]
    precisions = _dot_precisions(fn, *args)
    assert precisions
    hi = jax.lax.Precision.HIGHEST
    for prec in precisions:
        assert prec is not None and all(x == hi for x in prec), prec


# -- operators over packed storage ------------------------------------------


def test_symmetry_check_and_engine_guard():
    from lam_tpu.solver.operators import DenseOperator, _verifies_symmetric
    rng = np.random.default_rng(6)
    m = rng.standard_normal((64, 64))
    assert _verifies_symmetric(m + m.T)
    # a SINGLE corrupted entry must be caught (entry sampling would
    # almost surely miss it; the matvec check cannot)
    bad = m + m.T
    bad[13, 57] += 1e-6
    assert not _verifies_symmetric(bad)
    with pytest.raises(ValueError, match="symmetric"):
        DenseOperator.from_dense(m, precision="f32",
                                 engine="pallas_symm_packed")


@pytest.mark.parametrize("engine", ["pallas", "pallas_symm"])
def test_removed_engines_raise(engine):
    from lam_tpu.solver.operators import DenseOperator
    a, _ = _symm(128, 9)
    with pytest.raises(ValueError, match="removed"):
        DenseOperator.from_dense(a, precision="f32", engine=engine)


def test_packed_operator_solve_matches_symm_engine():
    """The packed df64 pair (accurate walk in f64) solves like the f64
    square on engine='xla' (the full-square symmetric engine it was
    once compared with is gone): same iteration count to a 1e-9
    residual."""
    from lam_tpu import DenseOperator, cg_solve
    from lam_tpu import generate as gen
    n = 700
    a, b = gen.random_spd_system(n, seed=25)
    iters = {}
    for precision, engine in (("df64", "pallas_symm_packed"),
                              ("f64", "xla")):
        op = DenseOperator.from_dense(a, precision=precision, engine=engine)
        r = cg_solve(op, b, max_iters=2000, rel_error=1e-9)
        assert bool(r.converged)
        x = np.asarray(r.x, np.float64)
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 2e-9
        iters[engine] = int(r.num_iters)
    assert abs(iters["xla"] - iters["pallas_symm_packed"]) <= 2


def test_packed_operator_diagonal_and_pcg():
    from lam_tpu import DenseOperator, cg_solve
    from lam_tpu import generate as gen
    n = 600
    a, b = gen.random_spd_system(n, seed=26)
    op = DenseOperator.from_dense(a, precision="df64",
                                  engine="pallas_symm_packed")
    d = np.asarray(op.diagonal())[:n]
    assert np.abs(d - np.diagonal(a)).max() < 1e-12
    r = cg_solve(op, b, max_iters=2000, rel_error=1e-7,
                 preconditioner="jacobi")
    assert bool(r.converged)
    x = np.asarray(r.x, np.float64)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-6


def test_packed_operator_pads_to_whole_tiles():
    """n=700 pads to 1024 = two 512 tiles; padding is exact zeros, so
    the padded matvec equals the unpadded one on the first n rows."""
    from lam_tpu import DenseOperator
    a, p = _symm(700, 27)
    op = DenseOperator.from_dense(a, precision="f32",
                                  engine="pallas_symm_packed")
    assert op.n_padded == 1024
    tb = gemv.SYMM_TB
    assert op.operand.shape == (gemv.tri_tile_count(2) * tb, tb)
    y = np.asarray(op.matvec(op.prepare_b(p.astype(np.float32))),
                   np.float64)
    assert not y[700:].any()
    assert _rel(y[:700], a @ p) < 1e-5


def test_from_packed_f32_matvec():
    # the gen-mode f32 device-build path: operator from a pre-packed
    # walk-order f32 plane (lam_tpu/solver/api.py _generate_fast)
    from lam_tpu import generate as gen
    from lam_tpu.solver.operators import DenseOperator, padded_size
    n, tb = 700, 128
    n_p = padded_size(n, tb)
    full = np.zeros((n_p, n_p), np.float32)
    full[:n, :n] = gen.tridiagonal_matrix(n, dtype=np.float32)
    op = DenseOperator.from_packed_f32(gemv.pack_tri_host(full, tb), n, n_p)
    p = gen.random_rhs(n).astype(np.float32)
    y = np.asarray(op.matvec(op.prepare_b(p)))[:n]
    ref = gen.tridiagonal_matrix(n) @ p.astype(np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-6
