"""On-disk pack cache (solver/pack_cache.py): reloads of dfq/fq packed
operators must come bit-identical from the cached planes, and every
invalid-cache condition (stale source, truncation, garbage, tile-size
change) must fall back to a fresh pack — never an error, never stale
data. The reference re-reads the raw fp64 file every run
(ConjugateGradient_CPU_MPI_OMP.hpp:325-363); the cache is this
system's answer to the load times its read_time CSV column measures."""

import numpy as np
import pytest

from lam_tpu import generate as gen
from lam_tpu import io as lio
from lam_tpu.solver import pack_cache as pc
from lam_tpu.solver.operators import DenseOperator

CTORS = {"dfq": DenseOperator.from_file_dfq,
         "fq": DenseOperator.from_file_fq,
         "f32": DenseOperator.from_file_f32,
         "df64": DenseOperator.from_file_df64}
ALL_PRECISIONS = sorted(CTORS)


def _write_system(tmp_path, n=300, seed=11):
    a = gen.random_spd_matrix_fast(n, seed=seed)
    path = tmp_path / "m.bin"
    lio.write_matrix(str(path), a)
    return str(path), a


def _bufs(op):
    # f32's operand is a single plane, not a tuple
    return op.operand if isinstance(op.operand, tuple) else (op.operand,)


def _assert_operands_equal(op, ref, label):
    assert op.precision == ref.precision
    assert op.n_padded == ref.n_padded
    for i, (x, y) in enumerate(zip(_bufs(op), _bufs(ref))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{label}: operand[{i}]")


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_reload_is_bit_identical_and_skips_the_pack(
        tmp_path, monkeypatch, precision):
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, _ = _write_system(tmp_path)
    ctor = CTORS[precision]
    ref = ctor(path, pack_cache=True)
    assert pc.load(path, precision) is not None

    # poison every pack path: a second load must be served PURELY from
    # the cache (this is the claim that makes reloads ~7x faster)
    def _boom(*a, **k):
        raise AssertionError("cache miss: pack path was invoked")
    for fn in ("pack_dfq", "pack_fq", "pack_f32", "pack_df64"):
        monkeypatch.setattr(f"lam_tpu._native_io.{fn}", _boom)
    monkeypatch.setattr(DenseOperator, "_host_pack_tri", _boom)
    monkeypatch.setattr(DenseOperator, "_host_pack_planes", _boom)
    op = ctor(path, pack_cache=True)
    _assert_operands_equal(op, ref, f"{precision} cache reload")


@pytest.mark.parametrize("precision", ALL_PRECISIONS)
def test_stale_cache_is_repacked_not_served(tmp_path, monkeypatch,
                                            precision):
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, _ = _write_system(tmp_path, seed=11)
    ctor = CTORS[precision]
    ctor(path, pack_cache=True)

    # rewrite the source with a DIFFERENT system (same size: only the
    # (size, mtime_ns) stamp distinguishes them)
    a2 = gen.random_spd_matrix_fast(300, seed=99)
    lio.write_matrix(path, a2)
    op = ctor(path, pack_cache=True)
    ref = ctor(path)  # fresh pack, cache bypassed
    _assert_operands_equal(op, ref, f"{precision} after source rewrite")


def test_truncated_or_garbage_cache_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, _ = _write_system(tmp_path)
    ref = DenseOperator.from_file_fq(path, pack_cache=True)
    cpath = pc.cache_path(path, "fq")

    # truncation (e.g. disk filled mid-write of a non-atomic copy)
    data = open(cpath, "rb").read()
    open(cpath, "wb").write(data[:len(data) // 2])
    assert pc.load(path, "fq") is None
    op = DenseOperator.from_file_fq(path, pack_cache=True)
    _assert_operands_equal(op, ref, "fq repack after truncation")
    assert pc.load(path, "fq") is not None  # repack re-published

    # garbage magic
    open(cpath, "wb").write(b"not a pack cache")
    assert pc.load(path, "fq") is None
    op = DenseOperator.from_file_fq(path, pack_cache=True)
    _assert_operands_equal(op, ref, "fq repack after garbage")


def test_tile_size_change_invalidates(tmp_path, monkeypatch):
    """A cache packed under a different SYMM_TB must be repacked: the
    walk layout is tb-dependent and serving it would corrupt the
    triangle walk."""
    path, _ = _write_system(tmp_path)
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    DenseOperator.from_file_fq(path, pack_cache=True)
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 256)
    op = DenseOperator.from_file_fq(path, pack_cache=True)
    ref = DenseOperator.from_file_fq(path)  # fresh pack at tb=256
    _assert_operands_equal(op, ref, "fq tb=128->256")


def test_source_rewritten_mid_pack_is_not_cached(tmp_path, monkeypatch):
    """save() must REFUSE to publish when the source changed between
    the pre-pack stat and publication: a multi-minute pack reads a live
    memory map, so the planes could mix old and new bytes — tagging
    them with the new file's (size, mtime_ns) would defeat the
    self-invalidation contract and serve a wrong operator forever."""
    import os

    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, _ = _write_system(tmp_path, seed=11)

    # stat captured at pack START (as _from_file_packed does) ...
    pre_stat = os.stat(path)
    # ... then the source is swapped mid-pack (same size, new mtime)
    a2 = gen.random_spd_matrix_fast(300, seed=99)
    lio.write_matrix(path, a2)
    op = DenseOperator.from_file_fq(path)  # packs the NEW content

    assert not pc.save(path, "fq", op.n, op.n_padded, 128, op.operand,
                       src_stat=pre_stat)
    assert pc.load(path, "fq") is None  # nothing was published

    # and the normal path (stat matches) still publishes
    assert pc.save(path, "fq", op.n, op.n_padded, 128, op.operand,
                   src_stat=os.stat(path))
    assert pc.load(path, "fq") is not None


def test_save_failure_is_best_effort(tmp_path, monkeypatch):
    """An unwritable cache location must not fail the solve that
    triggered the caching."""
    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, a = _write_system(tmp_path)

    def _deny(src, dst):
        raise OSError("read-only filesystem")
    monkeypatch.setattr("os.replace", _deny)
    op = DenseOperator.from_file_fq(path, pack_cache=True)
    ref = DenseOperator.from_dense_fq(a, check_symmetric=False)
    _assert_operands_equal(op, ref, "fq with unwritable cache dir")


# -- per-shard cache (sharded / 2-D backends; round 4, VERDICT r3 #3) --------


def _sharded_cg(precision, pack_cache):
    from lam_tpu import ConjugateGradient
    cg = ConjugateGradient(backend="sharded", precision=precision,
                           pack_cache=pack_cache)
    return cg


def test_sharded_fq_pack_cache_roundtrip(tmp_path, monkeypatch, capsys):
    """backend=sharded --pack-cache: first load publishes one shard
    file per chip; the reload is served bitwise-identically WITHOUT
    invoking the quantizer, and no 'ignored' notice is printed."""
    import os

    from lam_tpu.parallel.pcg_symm import SymmShardedOperator

    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, a = _write_system(tmp_path, n=500, seed=21)

    cg = _sharded_cg("irfq", pack_cache=True)
    assert cg.load_matrix_from_file(path)
    assert "ignored" not in capsys.readouterr().err
    ref_bufs = [np.asarray(b) for b in cg.op.operand]
    g = cg.op.mesh.shape[cg.op.axis]
    for c in range(g):
        assert os.path.exists(
            pc.shard_cache_path(path, "fq", "g", g, c)), c

    # reload must never quantize (pure cache reads)
    def _boom(*args, **kw):
        raise AssertionError("cache miss: quantizer was invoked")
    monkeypatch.setattr(
        "lam_tpu.solver.operators.quantize_storage_tiles", _boom)
    cg2 = _sharded_cg("irfq", pack_cache=True)
    assert cg2.load_matrix_from_file(path)
    for i, (x, y) in enumerate(zip(cg2.op.operand, ref_bufs)):
        np.testing.assert_array_equal(np.asarray(x), y,
                                      err_msg=f"operand[{i}]")

    # and the cached operator still solves to the true answer
    b = gen.random_rhs(500, seed=31)
    cg2.rhs = b
    assert cg2.solve(max_iters=5000, rel_error=1e-9)
    x = np.asarray(cg2.x, np.float64)[:500]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_sharded_shard_cache_is_stale_proof_and_mesh_keyed(
        tmp_path, monkeypatch):
    """A rewritten source misses every shard file; a different mesh
    geometry (g) misses by key, not by accident."""
    import os

    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, _ = _write_system(tmp_path, n=500, seed=22)

    cg = _sharded_cg("irq", pack_cache=True)
    assert cg.load_matrix_from_file(path)
    g = cg.op.mesh.shape[cg.op.axis]
    spec_probe = pc.shard_cache_path(path, "dfq", "g", g, 0)
    assert os.path.exists(spec_probe)

    # stale: rewrite the source -> load_shard must miss
    a2 = gen.random_spd_matrix_fast(500, seed=99)
    lio.write_matrix(path, a2)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 7))
    # the shard file exists but no longer matches the source identity
    cg2 = _sharded_cg("irq", pack_cache=True)
    assert cg2.load_matrix_from_file(path)  # repacks (no stale serve)
    b = gen.random_rhs(500, seed=32)
    cg2.rhs = b
    assert cg2.solve(max_iters=5000, rel_error=1e-9)
    x = np.asarray(cg2.x, np.float64)[:500]
    assert np.linalg.norm(b - a2 @ x) / np.linalg.norm(b) < 1e-8, \
        "stale shard cache served after source rewrite"

    # different topology size -> different file, absent
    assert not os.path.exists(
        pc.shard_cache_path(path, "dfq", "g", g + 1, 0))


def test_sharded2d_fq_pack_cache_roundtrip(tmp_path, monkeypatch):
    """The 2-D grid's per-chip packs cache under topology code 'r'
    with shard index i*r+j and reload bitwise-identically."""
    import os

    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, a = _write_system(tmp_path, n=500, seed=23)

    from lam_tpu import ConjugateGradient
    cg = ConjugateGradient(backend="sharded2d", precision="irfq",
                           pack_cache=True)
    assert cg.load_matrix_from_file(path)
    ref_bufs = [np.asarray(b) for b in cg.op.operand]
    r = cg.op.mesh.shape["rows"]
    for i in range(r):
        for j in range(r):
            assert os.path.exists(pc.shard_cache_path(
                path, "fq", "r", r, i * r + j)), (i, j)

    def _boom(*args, **kw):
        raise AssertionError("cache miss: quantizer was invoked")
    monkeypatch.setattr(
        "lam_tpu.solver.operators.quantize_storage_tiles", _boom)
    cg2 = ConjugateGradient(backend="sharded2d", precision="irfq",
                            pack_cache=True)
    assert cg2.load_matrix_from_file(path)
    for i, (x, y) in enumerate(zip(cg2.op.operand, ref_bufs)):
        np.testing.assert_array_equal(np.asarray(x), y,
                                      err_msg=f"operand[{i}]")

    b = gen.random_rhs(500, seed=33)
    cg2.rhs = b
    assert cg2.solve(max_iters=5000, rel_error=1e-9)
    x = np.asarray(cg2.x, np.float64)[:500]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-8


def test_prepack_script_publishes_a_served_cache(tmp_path, monkeypatch):
    """scripts/prepack_bench_caches.py builds the same fq cache the
    solve path would (bench.py's irfq legs then load it inside the
    driver's window at raw-read speed), and a second prepack run is a
    no-op on an already-valid cache."""
    import importlib.util
    import os

    monkeypatch.setattr("lam_tpu.ops.gemv.SYMM_TB", 128)
    path, a = _write_system(tmp_path, n=300, seed=17)

    spec = importlib.util.spec_from_file_location(
        "prepack_bench_caches",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "prepack_bench_caches.py"))
    prepack = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prepack)

    prepack.prepack(path)
    assert pc.load(path, "fq") is not None
    ref = DenseOperator.from_file_fq(path)  # fresh pack, no cache

    # the solve path must be served purely from the prepacked planes
    def _boom(*args, **kw):
        raise AssertionError("cache miss: pack path was invoked")
    monkeypatch.setattr("lam_tpu._native_io.pack_fq", _boom)
    monkeypatch.setattr(DenseOperator, "_host_pack_tri", _boom)
    op = DenseOperator.from_file_fq(path, pack_cache=True)
    _assert_operands_equal(op, ref, "prepacked fq reload")

    # idempotence: a valid cache is not repacked (the pack paths are
    # still poisoned, so any repack attempt would raise)
    prepack.prepack(path)
