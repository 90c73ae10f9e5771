"""Symmetric band-sharded CG: half the matrix bytes per sharded matvec.

The plain sharded operator (lam_tpu/parallel/pcg.py) streams the full
N^2 elements of A per matvec, like every reference backend does
(ConjugateGradient_GPU_CUDA.cu:171-211 and clones). But CG's matrix is
symmetric by contract, so a matvec can read only the lower triangle
(ops/gemv.py). This module extends that to the MESH:

  * Row-tiles are grouped into 2G bands; device g owns the band PAIR
    (g, 2G-1-g). Lower-triangle tile counts of every pair are equal
    (sum over a pair of (i+1) tile-rows is constant), so the walk is
    load-balanced by construction — the classic triangle balancing.
  * Packed storage keeps only each device's lower-triangle tiles, in
    its walk order (half the capacity of the band rows). The f32 inner
    matvec runs the triangle-walk kernel over them: each loaded tile
    A_ik contributes BOTH A_ik @ p_k (direct) and A_ik^T @ p_i
    (transpose) — every matrix byte is read once per matvec across the
    whole mesh. The unpacked SLAB layout keeps each band pair's full
    rows and multiplies them with one XLA row-block product.
  * VECTORS ARE REPLICATED (N*8 B <= a few MB — trivial next to the
    GB-scale matrix shards): vector algebra and dots run redundantly
    per device with zero communication, and the matvec needs exactly
    ONE psum of an N-vector per iteration (direct + transpose
    partials). Per-iteration collective volume: 1 psum(N) — vs the
    reference GPU backends' broadcast(N) + gather(N) + bcast(1) with
    rank-0-only algebra (..._NCCL.cu:355-396).
  * The accurate matvec rebuilds the stored planes in f64 (exactly)
    and walks the same tiles in native f64 under XLA.

The single-device CG/ir loops (solver/cg.py) run UNCHANGED inside
shard_map — replicated vectors make their plain vdots correct per
shard; only the matvec communicates. One more configuration of the one
engine, not another solver copy.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lam_tpu.ops import gemv
from lam_tpu.parallel.mesh import ROWS_AXIS, make_mesh
from lam_tpu.solver.cg import CGResult, _cg_ir_loop, _cg_loop
from lam_tpu.solver.operators import (
    LinearOperator,
    _wrap_matvec,
    padded_size,
    df64_plane_provider,
)

shard_map = jax.shard_map

_HIGHEST = jax.lax.Precision.HIGHEST


def band_padded_size(n, g, tb):
    """Pad so each of the 2g bands is a whole number of (tb) tile-rows."""
    return padded_size(n, 2 * g * tb)


def _validate_tb(tb):
    """The walk tables are expressed in tb-tile units, and the kernel's
    blocks are powers of two: reject any other tile width at operator
    construction, before matrices are materialized."""
    if tb < 128 or tb & (tb - 1):
        raise ValueError(
            f"tb={tb} is not a power-of-two multiple of 128; use 128, "
            f"256, 512, ...")
    return tb


@functools.lru_cache(maxsize=None)
def _band_tables(g, mt, tb):
    """Per-chip (it, kt, lt) tile tables for the band-pair walk.

    g chips, mt tile-rows per band (2g bands). Chip c owns global
    tile-rows [c*mt, (c+1)*mt) and [(2g-1-c)*mt, (2g-c)*mt); for each
    owned tile-row i (ascending) the row's lower-triangle tiles are
    k = 0..i. Every chip's table has the same length
    mt^2*(2g-1) + mt*(mt+1) tiles — balanced by construction."""
    its, kts, lts = [], [], []
    for c in range(g):
        it_c, kt_c, lt_c = [], [], []
        rows = (list(range(c * mt, (c + 1) * mt)),
                list(range((2 * g - 1 - c) * mt, (2 * g - c) * mt)))
        for half, band in enumerate(rows):
            for local, i in enumerate(band):
                for k in range(i + 1):
                    it_c.append(i)
                    kt_c.append(k)
                    lt_c.append(half * mt + local)
        its.append(it_c)
        kts.append(kt_c)
        lts.append(lt_c)
    assert len({len(x) for x in its}) == 1  # equal per-chip walks
    return (np.asarray(its, np.int32), np.asarray(kts, np.int32),
            np.asarray(lts, np.int32))


def _geometry(n, mesh, tb):
    """Shared factory prologue: resolve mesh/tb, derive the band layout,
    build the walk tables and the row sharding."""
    if mesh is None:
        mesh = make_mesh()
    if tb is None:
        tb = gemv.SYMM_TB
    _validate_tb(tb)
    axis = mesh.axis_names[0]
    g = mesh.shape[axis]
    n_p = band_padded_size(n, g, tb)
    m = n_p // (2 * g)
    tables = _band_tables(g, m // tb, tb)
    sharding = NamedSharding(mesh, P(axis, None))
    return mesh, tb, axis, g, n_p, m, tables, sharding


def _table_arrays(tables, g, sharding):
    """it/kt/lt host tables -> row-sharded device arrays."""

    def mk(tab):
        return jax.make_array_from_callback(
            (g, tab.shape[1]), sharding, lambda sl: tab[sl])

    return tuple(mk(t) for t in tables)


def _slab_row_ranges(c, g, m):
    """Original-row ranges (start, size) of chip c's two bands."""
    return ((c * m, m), ((2 * g - 1 - c) * m, m))


# -- per-shard matvecs (run inside shard_map; vectors replicated) -----------


def _scatter_bands(yd, yt, c, g, m, n_p):
    """Full-length y partial: yt (transpose terms over all columns)
    plus the slab's direct terms placed at the owned original rows."""
    y = yt
    y = jax.lax.dynamic_update_slice(
        y, yd[:m] + jax.lax.dynamic_slice(y, (c * m,), (m,)), (c * m,))
    r1 = (2 * g - 1 - c) * m
    y = jax.lax.dynamic_update_slice(
        y, yd[m:] + jax.lax.dynamic_slice(y, (r1,), (m,)), (r1,))
    return y


def _walk_y(direct, trans, it0, kt0, nblk):
    """Full-length y partial of a packed walk: direct terms folded by
    their global row tile, transpose terms by their column tile."""
    yd, yt = gemv.fold_partials(direct, trans, it0, kt0, nblk, nblk)
    return yd + yt


def _packed_mv64(tiles, it0, kt0, p):
    """Accurate (f64) full-length y partial over a chip's packed walk —
    the plain XLA walk over tiles already rebuilt in f64."""
    direct, trans = gemv.tri_walk_xla(tiles, p, it0, kt0)
    return _walk_y(direct, trans, it0, kt0, p.shape[0] // tiles.shape[1])


def _rebuild64(planes, scales, T, tb):
    """Sum of dequantized planes in f64 (exact per plane: the scales are
    powers of two). A (tb, tb) plane is one broadcast EXACT-ZERO tile
    (gen mode) — skipped."""
    return sum(gemv.dequantize_tiles(q, s, T, jnp.float64)
               for q, s in zip(planes, scales) if q.shape[0] != tb)


def _own_rows(p, c, g, m):
    """Chip c's owned rows of a replicated vector, in slab order
    (band c then band 2g-1-c) — the dual of _scatter_bands."""
    p0 = jax.lax.dynamic_slice(p, (c * m,), (m,))
    p1 = jax.lax.dynamic_slice(p, ((2 * g - 1 - c) * m,), (m,))
    return jnp.concatenate([p0, p1])


def _make_mv32(axis, g, m, tb, storage="slab"):
    """f32 inner matvec. Packed storages run the triangle-walk kernel
    over the chip's tiles (the int16 q1 plane for fq); the slab stores
    full rows, so its walk is one XLA row-block product."""

    def mv(operand, p):
        c = jax.lax.axis_index(axis)
        nblk = p.shape[0] // tb
        if storage == "slab":
            slab_hi = operand[0]
            yd = jnp.matmul(slab_hi, p, precision=_HIGHEST)
            return jax.lax.psum(
                _scatter_bands(yd, jnp.zeros_like(p), c, g, m,
                               p.shape[0]), axis)
        it0, kt0 = operand[-3][0], operand[-2][0]
        if storage == "fq":
            # the inner loop reads ONLY the 2-byte q1 plane
            buf, scales, dh = operand[0], operand[3][0], operand[6]
        else:
            buf, scales = operand[0], None
            dh = operand[3] if storage == "dfq" else None
        direct, trans = gemv.tri_walk_partials(buf, p, it0, kt0, scales)
        y = _walk_y(direct, trans, it0, kt0, nblk)
        if dh is not None:
            # quantized planes carry zeroed diagonals; the owner adds
            # its (local, slab-order) diagonal term before the psum
            y = _scatter_bands(dh * _own_rows(p, c, g, m), y, c, g, m,
                               p.shape[0])
        return jax.lax.psum(y, axis)

    return mv


def _make_mv_acc(axis, g, m, tb, storage="slab"):
    """Accurate matvec in native f64: the stored planes are rebuilt in
    f64 (exactly) and walked by XLA — full rows for the slab, the plain
    triangle walk for packed storage."""

    def mv(operand, p):
        c = jax.lax.axis_index(axis)
        f64 = p.dtype
        if storage == "slab":
            slab_hi, slab_lo = operand[0], operand[1]
            yd = slab_hi.astype(f64) @ p + slab_lo.astype(f64) @ p
            return jax.lax.psum(
                _scatter_bands(yd, jnp.zeros_like(p), c, g, m,
                               p.shape[0]), axis)
        it0, kt0 = operand[-3][0], operand[-2][0]
        T = it0.shape[0]
        if storage == "fq":
            q1, q2, q3, s1, s2, s3, dh, dl = operand[:8]
            tiles = _rebuild64((q1, q2, q3), (s1[0], s2[0], s3[0]), T, tb)
        elif storage == "dfq":
            hi, loq, sc, dh, dl = operand[:5]
            tiles = (hi[:T * tb].astype(f64)
                     + gemv.dequantize_tiles(loq, sc[0], T, f64))
        else:
            hi, lo = operand[0], operand[1]
            tiles = hi[:T * tb].astype(f64)
            if lo.shape[0] == tb:                 # broadcast zero tile
                tiles = tiles + jnp.tile(lo.astype(f64), (T, 1))
            else:
                tiles = tiles + lo[:T * tb].astype(f64)
            dh = None
        y = _packed_mv64(tiles, it0, kt0, p)
        if dh is not None:
            d = dh.astype(f64) + dl.astype(f64)
            y = _scatter_bands(d * _own_rows(p, c, g, m), y, c, g, m,
                               p.shape[0])
        return jax.lax.psum(y, axis)

    return mv


def _operand_specs(axis, storage="slab"):
    row = P(axis, None)
    if storage == "fq":
        # q1, q2, q3, s1, s2, s3 (row-sharded), diag pair, tables
        return (row, row, row, row, row, row, P(axis), P(axis),
                row, row, row)
    if storage == "dfq":
        # hi, loq, sc, diag_hi, diag_lo (slab-order, row-sharded), tables
        return (row, row, row, P(axis), P(axis), row, row, row)
    return (row, row, row, row, row)  # hi, lo, it, kt, lt


@functools.lru_cache(maxsize=None)
def _build_symm_cg(mesh, axis, g, m, tb, storage):
    mv = _wrap_matvec(_make_mv_acc(axis, g, m, tb, storage))

    def local(operand, b, max_iters, rel_error):
        return _cg_loop(mv, operand, b, max_iters, rel_error)

    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(_operand_specs(axis, storage), P(), P(), P()),
        out_specs=CGResult(x=P(), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_symm_cg_ir(mesh, axis, g, m, tb, max_cycles, storage,
                      precond=False):
    mv32 = _wrap_matvec(_make_mv32(axis, g, m, tb, storage))
    mv_acc = _wrap_matvec(_make_mv_acc(axis, g, m, tb, storage))

    if precond:
        def local(operand, b, inv_diag, max_iters, rel_error,
                  inner_floor):
            return _cg_ir_loop(mv32, mv_acc, operand, b, max_iters,
                               rel_error, max_cycles, inner_floor,
                               inv_diag)

        vec_specs = (P(), P())
    else:
        def local(operand, b, max_iters, rel_error, inner_floor):
            return _cg_ir_loop(mv32, mv_acc, operand, b, max_iters,
                               rel_error, max_cycles, inner_floor)

        vec_specs = (P(),)

    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(_operand_specs(axis, storage),) + vec_specs
                 + (P(), P(), P()),
        out_specs=CGResult(x=P(), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_symm_pcg(mesh, axis, g, m, tb, storage):
    from lam_tpu.solver.cg import _pcg_loop
    mv = _wrap_matvec(_make_mv_acc(axis, g, m, tb, storage))

    def local(operand, b, inv_diag, max_iters, rel_error):
        return _pcg_loop(mv, operand, b, inv_diag, max_iters, rel_error)

    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(_operand_specs(axis, storage), P(), P(), P(), P()),
        out_specs=CGResult(x=P(), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_symm_matvec(mesh, axis, g, m, tb, which, storage):
    mv = (_make_mv32(axis, g, m, tb, storage) if which == "f32"
          else _make_mv_acc(axis, g, m, tb, storage))
    mapped = shard_map(mv, mesh=mesh,
                       in_specs=(_operand_specs(axis, storage), P()),
                       out_specs=P(), check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_symm_chain(mesh, axis, g, m, tb, which, repeats, storage):
    mv = (_make_mv32(axis, g, m, tb, storage) if which == "f32"
          else _make_mv_acc(axis, g, m, tb, storage))

    def local(operand, p):
        def body(_, v):
            w = mv(operand, v)
            return w / jnp.sqrt(jnp.vdot(w, w))

        return jax.lax.fori_loop(0, repeats, body, p)

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(_operand_specs(axis, storage), P()),
                       out_specs=P(), check_vma=False)
    return jax.jit(mapped)


class SymmShardedOperator(LinearOperator):
    """Band-pair sharded SYMMETRIC matrix over a 1-D mesh.

    With packed=True (or a quantized storage) each device stores only
    its lower-triangle walk tiles: the f32 inner matvec of the
    mixed-precision solver runs the triangle-walk kernel over them, the
    accurate matvec walks them in f64, and every matrix element is read
    once across the whole mesh. Requires a symmetric matrix — CG's
    contract anyway (from_dense verifies; from_row_block_fn trusts the
    caller, since verification on a sharded build would need a full
    extra pass)."""

    def __init__(self, operand, n, n_padded, mesh, axis, g, m, tb,
                 packed=False, storage=None):
        if storage is None:
            storage = "packed" if packed else "slab"
        # generic matvec_dot (checkpoint/segmented paths): the same
        # shard_map matvec program, composed under the caller's jit —
        # cached by _build_symm_matvec so instances with equal geometry
        # share one compilation
        super().__init__(
            _wrap_matvec(_build_symm_matvec(mesh, axis, g, m, tb,
                                            "acc", storage)),
            operand, n, n_padded, jnp.float64)
        self.precision = (storage if storage in ("dfq", "fq")
                          else "df64")
        self.engine = "xla" if storage == "slab" else "pallas_symm_packed"
        self.mesh = mesh
        self.axis = axis
        self._g = g
        self._m = m
        self._tb = tb
        self._storage = storage
        self._packed = storage != "slab"
        self._which = "acc"

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, tb=None,
                          packed=False, precision="df64",
                          pack_cache_src=None):
        """Build from per-row-block reads of a SYMMETRIC f64 matrix.

        Each chip materializes only its two bands (the per-rank MPI-IO
        analog, ConjugateGradient_CPU_MPI_OMP.hpp:325-363). packed=True
        stores each chip's lower-triangle tiles only (walk order,
        ops/gemv.py) — HALF the HBM capacity of the slab layout.
        precision='dfq' additionally quantizes the lo plane to int16
        against per-tile power-of-two scales with the diagonal extracted
        as a df64 pair (6 B/element per shard — see
        DenseOperator.from_dense_dfq); implies packed storage.
        pack_cache_src (dfq/fq only): source matrix file path, enables
        the per-shard pack cache (solver/pack_cache.py save_shard)."""
        (mesh, tb, axis, g, n_p, m, tables,
         a_sharding) = _geometry(n, mesh, tb)

        if precision in ("dfq", "fq"):
            return SymmShardedOperator._from_row_block_fn_quantized(
                row_block_fn, n, mesh, tb, axis, g, n_p, m, tables,
                a_sharding, precision, pack_cache_src=pack_cache_src)
        if precision != "df64":
            raise ValueError(
                f"SymmShardedOperator precision must be 'df64', 'dfq' "
                f"or 'fq', got {precision!r}")

        if packed:
            its, kts = tables[0], tables[1]
            T = its.shape[1]
            L = T * tb                 # packed rows per chip

            def packed_block(row_start, num_rows):
                if row_start % tb or num_rows % tb:
                    raise ValueError("packed shard slices must be "
                                     "tile-aligned")
                out = np.empty((num_rows, tb), dtype=np.float64)
                cache_i, cache_rows = -1, None
                for tloc in range(num_rows // tb):
                    tg = row_start // tb + tloc
                    c, tl = divmod(tg, T)
                    i, k = int(its[c, tl]), int(kts[c, tl])
                    if cache_i != i:
                        rows = np.zeros((tb, n_p), np.float64)
                        src = max(0, min(n - i * tb, tb))
                        if src > 0:
                            rows[:src, :n] = row_block_fn(i * tb, src)
                        cache_i, cache_rows = i, rows
                    out[tloc * tb:(tloc + 1) * tb] = (
                        cache_rows[:, k * tb:(k + 1) * tb])
                return out

            plane = df64_plane_provider(lambda key: packed_block(*key))

            def mk(idx):
                return jax.make_array_from_callback(
                    (g * L, tb), a_sharding,
                    lambda sl: plane(
                        (sl[0].start or 0,
                         (sl[0].stop or g * L) - (sl[0].start or 0)),
                        idx))

            operand = (mk(0), mk(1),
                       *_table_arrays(tables, g, a_sharding))
            return SymmShardedOperator(operand, n, n_p, mesh, axis, g,
                                       m, tb, packed=True)

        def slab_block(row_start, num_rows):
            # rows of the stacked band layout S: chip c's slab is
            # S[c*2m:(c+1)*2m] = original bands (c, 2g-1-c)
            out = np.zeros((num_rows, n_p), dtype=np.float64)
            for local in range(0, num_rows, m):
                s_row = row_start + local
                c, half = divmod(s_row // m, 2)
                band = c if half == 0 else 2 * g - 1 - c
                r0 = band * m
                src = max(0, min(n - r0, m))
                if src > 0:
                    out[local:local + src, :n] = row_block_fn(r0, src)
            return out

        plane = df64_plane_provider(lambda key: slab_block(*key))

        def mk(idx):
            return jax.make_array_from_callback(
                (n_p, n_p), a_sharding,
                lambda sl: plane((sl[0].start or 0,
                                  (sl[0].stop or n_p) - (sl[0].start or 0)),
                                 idx))

        operand = (mk(0), mk(1),
                   *_table_arrays(tables, g, a_sharding))
        return SymmShardedOperator(operand, n, n_p, mesh, axis, g, m, tb)

    @staticmethod
    def _from_row_block_fn_quantized(row_block_fn, n, mesh, tb, axis,
                                     g, n_p, m, tables, a_sharding,
                                     storage, pack_cache_src=None):
        """Per-chip quantized pack, shared by storage='dfq' (f32 hi +
        int16 lo against per-tile power-of-two scales) and
        storage='fq' (round 3b: the three-int16 cascade whose inner
        matvec reads only the 2-byte q1 plane; 6 B/element either
        way). Each chip's bands' diagonal is extracted to a slab-order
        df64 pair. One read of the chip's rows (row-block cache, as
        the packed df64 path); a process only packs chips it addresses
        (callback placement). Operand order is (planes..., scales...,
        dh, dl, walk tables) — QUANT_LAYOUT in solver/operators.py.

        pack_cache_src: path of the source matrix FILE the row blocks
        come from; enables the per-shard pack cache (the per-rank
        analog of the reference's MPI-IO reads,
        ConjugateGradient_CPU_MPI_OMP.hpp:325-363): each chip's
        pack is published to <src>.shardpack/<storage>.g<g>.s<c> and
        reloaded at raw disk speed on later runs with the same mesh."""
        from lam_tpu.solver import pack_cache as pc
        from lam_tpu.solver.operators import (QUANT_LAYOUT,
                                              quantize_storage_tiles)
        its, kts, lts = tables
        T = its.shape[1]
        L = T * tb
        plane_dtypes, n_scales = QUANT_LAYOUT[storage]
        n_planes = len(plane_dtypes)
        cache = {}
        # identity captured no later than the bytes-source is bound
        # (the pack reads the live file via row_block_fn for minutes)
        src_stat = (os.stat(pack_cache_src)
                    if pack_cache_src is not None else None)
        shard_specs = ([(dt, (L, tb)) for dt in plane_dtypes]
                       + [(np.float32, (T,))] * n_scales
                       + [(np.float32, (2 * m,))] * 2)

        def chip_pack(c):
            if c not in cache and pack_cache_src is not None:
                hit = pc.load_shard(pack_cache_src, storage, "g", g,
                                    c, n, n_p, tb, shard_specs)
                if hit is not None:
                    cache[c] = hit
            if c not in cache:
                planes = [np.empty((L, tb), dt) for dt in plane_dtypes]
                scales = [np.zeros((T,), np.float32)
                          for _ in range(n_scales)]
                dh = np.zeros((2 * m,), np.float32)
                dl = np.zeros((2 * m,), np.float32)
                cur_i, rows = -1, None
                for t in range(T):
                    i, k = int(its[c, t]), int(kts[c, t])
                    if cur_i != i:
                        rows = np.zeros((tb, n_p), np.float64)
                        src = max(0, min(n - i * tb, tb))
                        if src > 0:
                            rows[:src, :n] = row_block_fn(i * tb, src)
                        cur_i = i
                    tile = rows[:, k * tb:(k + 1) * tb]
                    if i == k:
                        # diagonal entries — systematically the largest
                        # of an SPD matrix — would set the tile's scale;
                        # extract them EXACTLY (df64 pair, slab order)
                        # and quantize the zeroed tile instead
                        tile = tile.copy()
                        dv = np.diagonal(tile).copy()
                        dhi = dv.astype(np.float32)
                        lt = int(lts[c, t])
                        dh[lt * tb:(lt + 1) * tb] = dhi
                        dl[lt * tb:(lt + 1) * tb] = (
                            dv - dhi.astype(np.float64)
                        ).astype(np.float32)
                        np.fill_diagonal(tile, 0.0)
                    out = quantize_storage_tiles(storage, tile, tb)
                    sl = slice(t * tb, (t + 1) * tb)
                    for j in range(n_planes):
                        planes[j][sl] = out[j]
                    for j in range(n_scales):
                        scales[j][t] = out[n_planes + j][0]
                cache[c] = (*planes, *scales, dh, dl)
                if pack_cache_src is not None:
                    pc.save_shard(pack_cache_src, storage, "g", g, c,
                                  n, n_p, tb, cache[c],
                                  src_stat=src_stat)
            return cache[c]

        def chip_rows_cb(which, rows_pc, sl, total):
            r = sl[0]
            start = r.start or 0
            stop = r.stop if r.stop is not None else total
            chunks = []
            pos = start
            while pos < stop:
                c, off = divmod(pos, rows_pc)
                take = min(rows_pc - off, stop - pos)
                chunks.append(chip_pack(c)[which][off:off + take])
                pos += take
            return np.concatenate(chunks, axis=0)

        def mk_plane(which):
            return jax.make_array_from_callback(
                (g * L, tb), a_sharding,
                lambda sl: chip_rows_cb(which, L, sl, g * L)[:, sl[1]])

        def mk_sc(which):
            def cb(sl):
                r = sl[0]
                cs = range(r.start or 0,
                           r.stop if r.stop is not None else g)
                return np.stack([chip_pack(c)[which]
                                 for c in cs])[:, sl[1]]

            return jax.make_array_from_callback((g, T), a_sharding, cb)

        def mk_diag(which):
            return jax.make_array_from_callback(
                (n_p,), NamedSharding(mesh, P(axis)),
                lambda sl: chip_rows_cb(which, 2 * m, sl, n_p))

        nd = n_planes + n_scales
        operand = (*(mk_plane(j) for j in range(n_planes)),
                   *(mk_sc(n_planes + j) for j in range(n_scales)),
                   mk_diag(nd), mk_diag(nd + 1),
                   *_table_arrays(tables, g, a_sharding))
        return SymmShardedOperator(operand, n, n_p, mesh, axis, g, m,
                                   tb, storage=storage)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, tb=None, packed=False):
        """Gen-mode tridiagonal in band-pair slab order, built ON DEVICE
        (each shard materializes in its owner's HBM via out_shardings) —
        see ShardedDenseOperator.from_gen_tridiagonal; here the hi plane
        is generated directly in the slab row permutation
        (lam_tpu/generate.py::_tridiag_hi_slab_impl). packed=True builds
        the walk-order triangle buffer instead and represents the
        identically-zero lo plane as ONE (tb, tb) tile per chip — a
        QUARTER of the slab pair's HBM footprint (tridiagonal entries
        {0,1,2} are exact in f32)."""
        from lam_tpu import generate as gen
        (mesh, tb, axis, g, n_p, m, tables,
         a_sharding) = _geometry(n, mesh, tb)
        if packed:
            its, kts = tables[0], tables[1]
            flat_it = jnp.asarray(its.reshape(-1))
            flat_kt = jnp.asarray(kts.reshape(-1))
            hi = jax.jit(gen._tridiag_hi_packed_impl,
                         static_argnums=(0, 1, 4),
                         out_shardings=a_sharding)(n, tb, flat_it,
                                                   flat_kt, n_p // tb)
            lo = jax.jit(lambda: jnp.zeros((g * tb, tb), jnp.float32),
                         out_shardings=a_sharding)()
            operand = (hi, lo, *_table_arrays(tables, g, a_sharding))
            return SymmShardedOperator(operand, n, n_p, mesh, axis, g,
                                       m, tb, packed=True)
        hi = jax.jit(gen._tridiag_hi_slab_impl, static_argnums=(0, 1, 2, 3),
                     out_shardings=a_sharding)(n, n_p, g, m)
        lo = jax.jit(lambda: jnp.zeros((n_p, n_p), jnp.float32),
                     out_shardings=a_sharding)()
        operand = (hi, lo, *_table_arrays(tables, g, a_sharding))
        return SymmShardedOperator(operand, n, n_p, mesh, axis, g, m, tb)

    @staticmethod
    def from_gen_fq(n, mesh=None, tb=None):
        """Gen-mode fq operator built ON DEVICE on the band-pair mesh:
        the sharded twin of DenseOperator.from_gen_fq. The int16 q1
        plane is quantization-EXACT for the gen tridiagonal ({0,1}
        entries against the 2^-14 scale) and is built by the SAME
        scatter program as the local path — the flat band-walk tables
        cover every triangle tile exactly once, so
        generate._tridiag_q1_packed_impl applies unchanged with
        out_shardings placing each chip's slab in its own HBM. The
        exactly-zero q2/q3 residual planes are ONE broadcast (tb, tb)
        tile per chip; the diagonal (constant 2.0, exact in f32) rides
        as a device-built slab-order df64 pair. 2 B/element per mesh —
        half the packed f32 gen pair — so sharded irfq gen probes run
        beyond the f32 gen frontier."""
        from lam_tpu import generate as gen
        (mesh, tb, axis, g, n_p, m, tables,
         a_sharding) = _geometry(n, mesh, tb)
        its, kts = tables[0], tables[1]
        T = its.shape[1]
        flat_it = jnp.asarray(its.reshape(-1))
        flat_kt = jnp.asarray(kts.reshape(-1))
        q1 = jax.jit(gen._tridiag_q1_packed_impl,
                     static_argnums=(0, 1, 4),
                     out_shardings=a_sharding)(n, tb, flat_it, flat_kt,
                                               n_p // tb)
        zeros_q = jax.jit(lambda: jnp.zeros((g * tb, tb), jnp.int16),
                          out_shardings=a_sharding)()
        s1 = jax.jit(lambda: jnp.full((g, T), gen.TRIDIAG_Q1_SCALE,
                                      jnp.float32),
                     out_shardings=a_sharding)()
        zeros_s = jax.jit(lambda: jnp.zeros((g, T), jnp.float32),
                          out_shardings=a_sharding)()
        d_sharding = NamedSharding(mesh, P(axis))
        dh = jax.jit(gen._gen_diag_slab_impl, static_argnums=(0, 1, 2),
                     out_shardings=d_sharding)(n, g, m)
        dl = jax.jit(lambda: jnp.zeros((n_p,), jnp.float32),
                     out_shardings=d_sharding)()
        operand = (q1, zeros_q, zeros_q, s1, zeros_s, zeros_s, dh, dl,
                   *_table_arrays(tables, g, a_sharding))
        return SymmShardedOperator(operand, n, n_p, mesh, axis, g, m,
                                   tb, storage="fq")

    @staticmethod
    def from_dense(a, mesh=None, tb=None, packed=False,
                   precision="df64"):
        from lam_tpu.solver.operators import _verifies_symmetric
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if not _verifies_symmetric(a):
            raise ValueError(
                "SymmShardedOperator requires a symmetric matrix (the "
                "band walk mirrors the lower triangle)")
        return SymmShardedOperator.from_row_block_fn(
            lambda s, mrows: a[s:s + mrows, :], n, mesh=mesh, tb=tb,
            packed=packed, precision=precision)

    @staticmethod
    def from_file(path, mesh=None, tb=None, packed=False,
                  precision="df64"):
        from lam_tpu import io as lio
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        return SymmShardedOperator.from_row_block_fn(
            lambda s, mrows: lio.read_matrix_rows(path, s, mrows), rows,
            mesh=mesh, tb=tb, packed=packed, precision=precision)

    # -- solve path ----------------------------------------------------------

    def prepare_b(self, b):
        b = np.asarray(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, expected "
                             f"({self.n},)")
        if self.n_padded != self.n:
            b = np.pad(b, (0, self.n_padded - self.n))
        # replicated vectors (multi-process-safe callback placement)
        return jax.make_array_from_callback(
            b.shape, NamedSharding(self.mesh, P()), lambda idx: b[idx])

    def matvec(self, p_padded):
        fn = _build_symm_matvec(self.mesh, self.axis, self._g, self._m,
                                self._tb, self._which, self._storage)
        return fn(self.operand, p_padded)

    def matvec_chain(self, p_padded, repeats):
        fn = _build_symm_chain(self.mesh, self.axis, self._g, self._m,
                               self._tb, self._which, repeats,
                               self._storage)
        return fn(self.operand, p_padded)

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        del loop_fn
        solver = _build_symm_cg(self.mesh, self.axis, self._g, self._m,
                                self._tb, self._storage)
        return solver(self.operand, b_padded, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32())")
        solver = _build_symm_cg_ir(self.mesh, self.axis, self._g,
                                   self._m, self._tb, max_cycles,
                                   self._storage,
                                   precond=inv_diag32 is not None)
        vec_args = ((b_padded, inv_diag32) if inv_diag32 is not None
                    else (b_padded,))
        return solver(self.operand, *vec_args, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype),
                      jnp.asarray(inner_floor, b_padded.dtype))

    def diagonal(self):
        axis, g, m, tb = self.axis, self._g, self._m, self._tb
        n_p = self.n_padded

        if self._storage in ("dfq", "fq"):

            def local_diag(operand):
                # the diagonal already lives in the operand as a
                # slab-order df64 pair; scatter it to original rows
                dh, dl = operand[-5], operand[-4]
                c = jax.lax.axis_index(axis)
                dv = dh.astype(jnp.float64) + dl.astype(jnp.float64)
                d = jnp.zeros(n_p, jnp.float64)
                d = jax.lax.dynamic_update_slice(d, dv[:m], (c * m,))
                d = jax.lax.dynamic_update_slice(
                    d, dv[m:], ((2 * g - 1 - c) * m,))
                return jax.lax.psum(d, axis)

        elif self._packed:
            mt = m // tb

            def local_diag(operand):
                hi, lo, it, kt, lt = operand
                it0, kt0 = it[0], kt[0]
                # each owned band row-tile ends in exactly one diagonal
                # tile -> 2*mt hits per chip, a static count
                pos = jnp.nonzero(it0 == kt0, size=2 * mt)[0]
                s = jnp.arange(tb)
                rr = pos[:, None] * tb + s[None, :]
                dv = hi[rr, s[None, :]].astype(jnp.float64)
                if lo.shape[0] == tb:       # broadcast zero tile
                    dv = dv + lo[s, s].astype(jnp.float64)[None, :]
                else:
                    dv = dv + lo[rr, s[None, :]].astype(jnp.float64)
                gidx = (it0[pos][:, None] * tb + s[None, :]).reshape(-1)
                d = jnp.zeros(n_p, jnp.float64).at[gidx].set(
                    dv.reshape(-1))
                return jax.lax.psum(d, axis)

        else:

            def local_diag(operand):
                hi, lo, _, _, _ = operand
                c = jax.lax.axis_index(axis)
                d = jnp.zeros(n_p, jnp.float64)
                for half in range(2):
                    r0 = c * m if half == 0 else (2 * g - 1 - c) * m
                    rows = hi[half * m:(half + 1) * m]
                    rows_l = lo[half * m:(half + 1) * m]
                    cols = (r0 + jnp.arange(m))[:, None]
                    band_d = (
                        jnp.take_along_axis(rows, cols, axis=1)[:, 0]
                        .astype(jnp.float64)
                        + jnp.take_along_axis(rows_l, cols, axis=1)[:, 0]
                        .astype(jnp.float64))
                    d = jax.lax.dynamic_update_slice(d, band_d, (r0,))
                return jax.lax.psum(d, axis)

        mapped = shard_map(local_diag, mesh=self.mesh,
                           in_specs=(_operand_specs(axis,
                                                    self._storage),),
                           out_specs=P(), check_vma=False)
        return jax.jit(mapped)(self.operand)

    def run_pcg(self, b_padded, max_iters, rel_error):
        d = self.diagonal()
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
        solver = _build_symm_pcg(self.mesh, self.axis, self._g, self._m,
                                 self._tb, self._storage)
        return solver(self.operand, b_padded, inv_d, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def as_f32(self):
        """f32 triangle-walk view sharing this operator's buffers."""
        out = SymmShardedOperator(self.operand, self.n, self.n_padded,
                                  self.mesh, self.axis, self._g, self._m,
                                  self._tb, storage=self._storage)
        out.vector_dtype = jnp.float32
        out.precision = "f32"
        out._which = "f32"
        # generic consumers of _matvec_dot_fn (checkpoint driver,
        # matvec_chain) must get the f32 walk, not the accurate df64
        # program the constructor wired (same fixup as
        # ShardedDenseOperator.as_f32)
        out._matvec_dot_fn = _wrap_matvec(
            _build_symm_matvec(self.mesh, self.axis, self._g, self._m,
                               self._tb, "f32", self._storage))
        return out


