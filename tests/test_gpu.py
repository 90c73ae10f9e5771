"""On-card assertions: `LAM_TPU_GPU_TESTS=1 pytest -m gpu tests/`.

These need a GPU: the triangle-walk kernel compiled through Triton (the
CPU suite runs it in the interpreter), the card's own f32 products (an
f32 dot left at default precision may run in TF32 there), and the
main-path solves to host-checked true residuals. Without a GPU every
test here skips (tests/conftest.py).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def spd_system(gpu):
    # requests `gpu` so that the CPU suite skips before building it
    from lam_tpu import generate as gen
    return gen.random_spd_system(2048, seed=7)


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _true_rel(a, b, x):
    x = np.asarray(x, np.float64)[:a.shape[0]]
    return np.linalg.norm(b - a @ x) / np.linalg.norm(b)


def test_triangle_walk_compiled_not_interpreted():
    from lam_tpu import platform
    row = platform.current()
    assert not row.pallas_interpret and row.pallas_backend == "triton"


@pytest.mark.parametrize("storage", ["f32", "q16"])
def test_triangle_walk_at_real_width(storage):
    """The compiled kernel at the production tile width (512) against
    the f64 product of the same stored values."""
    import jax
    import jax.numpy as jnp

    from lam_tpu.ops import gemv
    tb, n = gemv.SYMM_TB, 8192
    T = gemv.tri_tile_count(n // tb)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    if storage == "f32":
        buf = jax.random.uniform(k1, (T * tb, tb), jnp.float32, -1, 1)
        scales = None
    else:
        buf = jax.random.randint(k1, (T * tb, tb), -32767, 32768,
                                 jnp.int32).astype(jnp.int16)
        scales = 2.0 ** jax.random.randint(k3, (T,), -24, -8).astype(
            jnp.float32)
    p = jax.random.uniform(k2, (n,), jnp.float32, -1, 1)
    y = np.asarray(gemv.tri_walk(buf, p, scales), np.float64)
    ref = np.asarray(gemv.tri_walk(buf, p.astype(jnp.float64), scales,
                                   kernel=False))
    assert _rel(y, ref) < 1e-5


def test_q16_walk_exact_on_integer_data_and_pad_tiles_unread():
    """Small-integer tiles, a power-of-two scale and small-integer p
    make every product and sum exact in f32: the compiled kernel must
    match numpy BITWISE, with or without Q16_P pad tiles."""
    import jax.numpy as jnp

    from lam_tpu.ops import gemv
    tb, nblk = 512, 5
    n = nblk * tb
    it, kt = gemv._symm_tables(nblk)
    T, Ts = len(it), gemv.padded_tri_tile_count(nblk)
    rng = np.random.default_rng(41)
    q1 = rng.integers(-3, 4, (Ts * tb, tb)).astype(np.int16)
    s1 = np.full((Ts,), 0.5, np.float32)
    p = rng.integers(-3, 4, n).astype(np.float32)
    ref = np.zeros(n)
    for t, (i, k) in enumerate(zip(it, kt)):
        tile = q1[t * tb:(t + 1) * tb].astype(np.float64) * 0.5
        ref[i * tb:(i + 1) * tb] += tile @ p[k * tb:(k + 1) * tb]
        if k < i:
            ref[k * tb:(k + 1) * tb] += tile.T @ p[i * tb:(i + 1) * tb]
    for rows in (Ts, T):          # pad tiles hold nonzero garbage
        y = gemv.tri_walk(jnp.asarray(q1[:rows * tb]), jnp.asarray(p),
                          jnp.asarray(s1[:rows]))
        np.testing.assert_array_equal(np.asarray(y, np.float64), ref)


def test_packed_equals_device_built_bitwise():
    """Host-packed and device-built walk-order tiles of the gen-mode
    tridiagonal give bit-identical kernel walks."""
    import jax
    import jax.numpy as jnp

    from lam_tpu import generate as gen
    from lam_tpu.ops import gemv
    tb, n = gemv.SYMM_TB, 3000
    n_p = -(-n // tb) * tb
    it, kt = gemv._symm_tables(n_p // tb)
    dev = jax.jit(gen._tridiag_hi_packed_impl, static_argnums=(0, 1, 4))(
        n, tb, jnp.asarray(it), jnp.asarray(kt), n_p // tb)
    full = np.zeros((n_p, n_p), np.float32)
    full[:n, :n] = gen.tridiagonal_matrix(n, dtype=np.float32)
    host = jnp.asarray(gemv.pack_tri_host(full, tb))
    np.testing.assert_array_equal(np.asarray(dev), np.asarray(host))
    p = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, n_p),
                    jnp.float32)
    np.testing.assert_array_equal(np.asarray(gemv.tri_walk(dev, p)),
                                  np.asarray(gemv.tri_walk(host, p)))


def test_f32_xla_matvec_is_not_tf32():
    """At HIGHEST precision the card's f32 matvec keeps f32 accuracy; a
    TF32 product would miss by ~1e-3."""
    import jax.numpy as jnp

    from lam_tpu.solver.operators import _mv_xla
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (4096, 4096)).astype(np.float32)
    p = rng.uniform(-1, 1, 4096).astype(np.float32)
    y = np.asarray(_mv_xla(jnp.asarray(a), jnp.asarray(p)), np.float64)
    assert _rel(y, a.astype(np.float64) @ p.astype(np.float64)) < 1e-5


def test_default_solve_is_native_f64(spd_system):
    from lam_tpu import DenseOperator, cg_solve
    a, b = spd_system
    op = DenseOperator.from_dense(a)
    assert (op.precision, op.engine) == ("f64", "xla")
    res = cg_solve(op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    assert _true_rel(a, b, res.x) < 2e-9


@pytest.mark.parametrize("precision,engine", [
    ("ir", "auto"), ("ir", "pallas_symm_packed"), ("irfq", "auto")])
def test_refinement_solves_true_residual(spd_system, tmp_path, precision,
                                         engine):
    """ir on the f64 square (f32 view), ir on the packed f32 pair and
    irfq on the int16 planes (both inner walks are the kernel)."""
    from lam_tpu import ConjugateGradient
    from lam_tpu import io as lio
    a, b = spd_system
    path = str(tmp_path / "a.bin")
    lio.write_matrix(path, a)
    cg = ConjugateGradient(backend="local", precision=precision,
                           engine=engine)
    cg.load_matrix_from_file(path)
    cg.rhs = b
    assert cg.solve(max_iters=10000, rel_error=1e-9)
    assert _true_rel(a, b, cg.x) < 2e-9


def test_fq_storage_accuracy(spd_system):
    from lam_tpu import DenseOperator
    a, _ = spd_system
    op = DenseOperator.from_dense(a, precision="fq")
    p = np.random.default_rng(12).uniform(-1, 1, a.shape[0])
    y = np.asarray(op.extract_x(op.matvec(op.prepare_b(p))))
    assert _rel(y, a @ p) < 1e-12            # the ~2^-48 cascade
    op32 = op.as_f32()
    y32 = np.asarray(op32.extract_x(op32.matvec(
        op32.prepare_b(p.astype(np.float32)))), np.float64)
    assert _rel(y32, a @ p) < 1e-3           # the 2-byte q1 plane


def test_dfq_storage_accuracy_and_irq(spd_system):
    from lam_tpu import DenseOperator, cg_solve_ir
    a, b = spd_system
    op = DenseOperator.from_dense(a, precision="dfq")
    p = np.random.default_rng(11).uniform(-1, 1, a.shape[0])
    y = np.asarray(op.extract_x(op.matvec(op.prepare_b(p))))
    assert _rel(y, a @ p) < 5e-11
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=5000, rel_error=1e-9)
    assert bool(res.converged)
    assert _true_rel(a, b, res.x) < 2e-9


@pytest.mark.parametrize("precision", ["df64", "fq"])
def test_sharded_packed_one_card_mesh(spd_system, precision):
    """The band-pair program on a 1-device mesh: the shard_map path and
    the compiled kernel over slab tables."""
    from lam_tpu import cg_solve_ir
    from lam_tpu.parallel.mesh import make_mesh
    from lam_tpu.parallel.pcg_symm import SymmShardedOperator
    from lam_tpu.solver.cg import default_inner_floor
    a, b = spd_system
    op = SymmShardedOperator.from_dense(a, mesh=make_mesh(1), packed=True,
                                        precision=precision)
    floor = default_inner_floor("irfq" if precision == "fq" else "ir")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000,
                      rel_error=1e-9, inner_floor=floor)
    assert bool(res.converged)
    assert _true_rel(a, b, res.x) < 2e-9


def test_sym2d_fq_one_card_grid(spd_system):
    """fq on the 2-D grid, 1x1 mesh: lax.switch compiles every branch,
    so the kernel (diagonal chips) and the XLA half-slab products
    (off-diagonal chips) must all lower."""
    from lam_tpu import cg_solve_ir
    from lam_tpu.parallel.pcg2d import make_mesh2d
    from lam_tpu.parallel.pcg2d_symm import Symm2DOperator
    from lam_tpu.solver.cg import default_inner_floor
    a, b = spd_system
    op = Symm2DOperator.from_dense(a, mesh=make_mesh2d(1), precision="fq")
    p = np.random.default_rng(18).uniform(-1, 1, a.shape[0])
    y = np.asarray(op.matvec(op.prepare_b(p)))[:a.shape[0]]
    assert _rel(y, a @ p) < 1e-12
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
                      inner_floor=default_inner_floor("irfq"))
    assert bool(res.converged)
    assert _true_rel(a, b, res.x) < 2e-9


@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_gen_mode_device_built(backend):
    """Gen mode builds its matrix on the card: f64 on the full square
    by default, and the quantization-exact irfq plane."""
    from lam_tpu import ConjugateGradient
    from lam_tpu import generate as gen
    n = 4000
    a = gen.tridiagonal_rows(0, n, n)
    b = gen.ones_rhs(n)
    for precision in ("auto", "irfq"):
        cg = ConjugateGradient(backend=backend, precision=precision,
                               n_devices=1)
        cg.generate_matrix(n)
        cg.generate_rhs()
        assert cg.solve(max_iters=20000, rel_error=1e-9)
        assert _true_rel(a, b, cg.x) < 2e-9
