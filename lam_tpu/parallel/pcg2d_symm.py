"""SYMMETRIC 2-D sharded CG: half the storage AND O(N/R) collectives.

Two other mesh programs each cover one axis of the design space: the
band-pair symmetric operator (lam_tpu/parallel/pcg_symm.py) halves
storage and reads but psums a full N-vector per iteration (payload O(N)
per device, device-count-independent); the 2-D SUMMA grid
(lam_tpu/parallel/pcg2d.py) exchanges only O(N/R) blocks but streams
all N^2 matrix elements. This module is the composition:

  * mesh: Mesh(devices[:R*R].reshape(R, R), ('rows', 'cols')); vectors
    P('rows') (replicated over cols), exactly as pcg2d.
  * storage: each matrix element of the symmetric A is stored ONCE
    across the mesh (half the full-square footprint):
      - diagonal chip (i, i): the walk-order PACKED lower-triangle
        tiles of block A_ii ((T*tb, tb), ops/gemv.py packed layout);
      - chips (i, j) / (j, i), i > j: each holds ONE HALF of the lower
        block A_ij as a packed half-slab — (i, j) the top m/2 rows,
        (j, i) the bottom m/2 rows (padded with tiles of zeros to the
        same (T*tb, tb) shape; T = tri_tile_count(m/tb)). Work is
        balanced by construction: every chip owns ~m^2/2 elements.
  * matvec: ONE transpose ppermute delivers p-block j to chip (i, j)
    (as pcg2d); each off-diagonal chip then computes BOTH products of
    its half-slab S: direct S @ p_j -> rows of y_i, transpose
    S^T @ p_i[half] -> y_j.
    The transpose partial belongs to the MIRROR chip's grid row, so a
    second transpose ppermute carries it back; a psum over 'cols'
    completes y. Per-iteration exchange: 2 ppermutes + 1 psum of
    (N/R)-vectors + the dot psums — O(N/R) per chip, vs the reference
    backends' broadcast(N)+gather(N) with rank-0-only algebra
    (ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:355-372).
  * the local CG/PCG/ir loops are the SAME builders pcg2d uses
    (lam_tpu/parallel/pcg.py) — one engine, one more placement config.

df64 pair is the storage layout (precision df64 / ir, like the 1-D
symmetric operator); the f32 view for mixed-precision reads the hi
plane of the same buffers. Square grids only (R = isqrt(G)).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lam_tpu.ops import gemv
from lam_tpu.parallel.pcg import (
    _make_local_cg,
    _make_local_ir,
    _make_local_pcg,
    shard_map,
)
from lam_tpu.parallel.pcg2d import AXES, COLS, ROWS, _transpose_perm, \
    make_mesh2d
from lam_tpu.parallel.pcg_symm import _rebuild64
from lam_tpu.solver.cg import CGResult
from lam_tpu.solver.operators import (
    LinearOperator,
    _wrap_matvec,
    df64_plane_provider,
    padded_size,
)


def sym2d_padded_size(n, r, tb):
    """Pad so each (n/R, n/R) block splits into an EVEN number of
    tb-tile rows (the off-diagonal half-slab boundary is m/2)."""
    return padded_size(n, 2 * r * tb)


def _geometry(n, mesh, tb):
    from lam_tpu.parallel.pcg_symm import _validate_tb
    if mesh is None:
        mesh = make_mesh2d()
    if tb is None:
        tb = gemv.SYMM_TB
    _validate_tb(tb)
    r = mesh.shape[ROWS]
    n_p = sym2d_padded_size(n, r, tb)
    m = n_p // r
    c = m // tb
    T = gemv.tri_tile_count(c)
    sharding = NamedSharding(mesh, P(ROWS, COLS))
    return mesh, tb, r, n_p, m, c, T, sharding


def _scatter_half(d, m, top):
    """(m/2,) partial -> (m,) with the other half zero."""
    z = jnp.zeros(m - d.shape[0], d.dtype)
    return jnp.concatenate([d, z] if top else [z, d])


_HIGHEST = jax.lax.Precision.HIGHEST


def _rect_tiles_dense(buf, c2, c, tb, dtype):
    """Packed half-slab -> dense (m/2, m), for XLA's product."""
    if buf.shape[0] < c2 * c * tb:
        raise ValueError(f"packed buffer has {buf.shape[0] // tb} tiles, "
                         f"the ({c2 * tb}, {c * tb}) half-slab needs "
                         f"{c2 * c}")
    return (buf[: c2 * c * tb].reshape(c2, c, tb, tb).astype(dtype)
            .transpose(0, 2, 1, 3).reshape(c2 * tb, c * tb))


def _route_mv_pair(m, diag_mv, dual_mv, p_own, p_recv):
    """ONE routing scaffold shared by all three storage variants (df64,
    dfq, fq): which half-slab product joins this chip's grid-row psum
    and which rides the payload ppermute — and the p_own[:m2] /
    p_recv[m2:] half-vector slicing — is decided HERE, once, so a
    routing fix cannot silently miss a storage format.

      diag_mv(p) -> (m,): the diagonal chip's full product (including
        its diagonal channel, where the storage has one);
      dual_mv(p_full, q_half) -> (direct (m/2,), transpose (m,)): both
        products of the chip's packed half-slab S in one HBM pass
        (S @ p_full, S^T @ q_half).

    own_partial joins this chip's grid-row psum directly; the payload
    carries the half-slab product that belongs to the MIRROR chip's
    grid row (transpose terms on lower chips, direct terms on upper
    chips) and rides the second transpose ppermute."""
    m2 = m // 2
    i = jax.lax.axis_index(ROWS)
    j = jax.lax.axis_index(COLS)
    zero_blk = jnp.zeros(m, p_own.dtype)

    def diag(_):
        return diag_mv(p_own), zero_blk

    def lower(_):
        d, t = dual_mv(p_recv, p_own[:m2])
        return _scatter_half(d, m, top=True), t

    def upper(_):
        d, t = dual_mv(p_own, p_recv[m2:])
        return t, _scatter_half(d, m, top=False)

    idx = jnp.where(i == j, 0, jnp.where(i > j, 1, 2))
    return jax.lax.switch(idx, [diag, lower, upper], None)


def _make_mv_pair(r, m, tb, which, storage="df64"):
    """Per-chip matvec: (operand, p_own, p_recv) ->
    (own_partial (m,), mirror_payload (m,)). Routing lives in
    _route_mv_pair; only the per-storage tile math is defined here.

    Storages: 'df64' — (hi, lo) f32 planes (lo may be ONE broadcast
    zero tile, gen mode); 'dfq' — (hi, loq, sc, dh, dl), int16 lo
    against per-tile power-of-two scales; 'fq' — (q1, q2, q3, s1, s2,
    s3, dh, dl), the three-int16 cascade. The quantized storages carry
    the matrix diagonal as a P(ROWS) df64 pair (dh, dl), added by the
    diagonal chips. which='f32' is the inner view: the diagonal chips
    run the triangle-walk kernel over their packed triangle (the 2-byte
    q1 plane for fq), the off-diagonal chips an XLA product of their
    half-slab. which='acc' rebuilds the tiles in f64 (exactly) and runs
    both in native f64 under XLA."""
    c = m // tb
    c2 = c // 2
    T = (c * (c + 1)) // 2
    it_np, kt_np = gemv._symm_tables(c)
    it_c, kt_c = jnp.asarray(it_np), jnp.asarray(kt_np)

    def f32_view(operand):
        if storage == "fq":
            return operand[0], operand[3][:, 0], operand[6]
        if storage == "dfq":
            return operand[0], None, operand[3]
        return operand[0], None, None

    def tiles64(operand):
        f64 = jnp.float64
        if storage == "fq":
            q1, q2, q3, s1, s2, s3, dh, dl = operand
            tiles = _rebuild64((q1, q2, q3),
                               (s1[:, 0], s2[:, 0], s3[:, 0]), T, tb)
            return tiles, dh.astype(f64) + dl.astype(f64)
        if storage == "dfq":
            hi, loq, sc, dh, dl = operand
            tiles = (hi[:T * tb].astype(f64)
                     + gemv.dequantize_tiles(loq, sc[:, 0], T, f64))
            return tiles, dh.astype(f64) + dl.astype(f64)
        hi, lo = operand
        tiles = hi[:T * tb].astype(f64)
        if lo.shape[0] == tb:                  # broadcast zero tile
            tiles = tiles + jnp.tile(lo.astype(f64), (T, 1))
        else:
            tiles = tiles + lo[:T * tb].astype(f64)
        return tiles, None

    def mv_pair(operand, p_own, p_recv):
        if which == "f32":
            buf, scales, diag = f32_view(operand)
            rect = (buf if scales is None
                    else gemv.dequantize_tiles(buf, scales, T, jnp.float32))

            def diag_mv(p):
                y = gemv.tri_walk(buf, p, scales)
                return y if diag is None else y + diag * p
        else:
            rect, diag = tiles64(operand)

            def diag_mv(p):
                direct, trans = gemv.tri_walk_xla(rect, p, it_c, kt_c)
                yd, yt = gemv.fold_partials(direct, trans, it_c, kt_c, c,
                                            c)
                y = yd + yt
                return y if diag is None else y + diag * p

        def dual_mv(pf, qh):
            sdn = _rect_tiles_dense(rect, c2, c, tb, pf.dtype)
            return (jnp.matmul(sdn, pf, precision=_HIGHEST),
                    jnp.matmul(sdn.T, qh, precision=_HIGHEST))

        return _route_mv_pair(m, diag_mv, dual_mv, p_own, p_recv)

    return mv_pair


def _make_apply_sym2d(mv_pair, r):
    perm = _transpose_perm(r)

    def apply(operand, p_blk):
        # exchange 1: chip (i, j) needs p-block j (as pcg2d)
        pj = jax.lax.ppermute(p_blk, AXES, perm)
        own, payload = mv_pair(operand, p_blk, pj)
        # exchange 2: hand the mirror chip its half-slab's other product
        back = jax.lax.ppermute(payload, AXES, perm)
        return jax.lax.psum(own + back, COLS)

    return apply


_OPERAND_SPEC = (P(ROWS, COLS), P(ROWS, COLS))
_OPERAND_SPEC_DFQ = (P(ROWS, COLS), P(ROWS, COLS), P(ROWS, COLS),
                     P(ROWS), P(ROWS))
_OPERAND_SPEC_FQ = (P(ROWS, COLS),) * 6 + (P(ROWS), P(ROWS))


def _operand_spec(storage):
    if storage == "fq":
        return _OPERAND_SPEC_FQ
    return _OPERAND_SPEC_DFQ if storage == "dfq" else _OPERAND_SPEC


@functools.lru_cache(maxsize=None)
def _build_sym2d_cg(mesh, m, tb, storage="df64"):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply_sym2d(_make_mv_pair(r, m, tb, "acc",
                                               storage), r)
    mapped = shard_map(
        _make_local_cg(apply_fn, ROWS),
        mesh=mesh,
        in_specs=(_operand_spec(storage), P(ROWS), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sym2d_cg_ir(mesh, m, tb, max_cycles, storage="df64",
                       precond=False):
    r = mesh.shape[ROWS]
    apply32 = _make_apply_sym2d(_make_mv_pair(r, m, tb, "f32",
                                              storage), r)
    apply_acc = _make_apply_sym2d(_make_mv_pair(r, m, tb, "acc",
                                                storage), r)
    vec_specs = ((P(ROWS), P(ROWS)) if precond else (P(ROWS),))
    mapped = shard_map(
        _make_local_ir(apply32, apply_acc, ROWS, max_cycles,
                       precond=precond),
        mesh=mesh,
        in_specs=(_operand_spec(storage),) + vec_specs + (P(), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sym2d_pcg(mesh, m, tb, storage="df64"):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply_sym2d(_make_mv_pair(r, m, tb, "acc",
                                               storage), r)
    mapped = shard_map(
        _make_local_pcg(apply_fn, ROWS),
        mesh=mesh,
        in_specs=(_operand_spec(storage), P(ROWS), P(ROWS), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sym2d_matvec(mesh, m, tb, which, storage="df64"):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply_sym2d(_make_mv_pair(r, m, tb, which,
                                               storage), r)
    mapped = shard_map(apply_fn, mesh=mesh,
                       in_specs=(_operand_spec(storage), P(ROWS)),
                       out_specs=P(ROWS), check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sym2d_chain(mesh, m, tb, which, repeats, storage="df64"):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply_sym2d(_make_mv_pair(r, m, tb, which,
                                               storage), r)

    def local(operand, p):
        def body(_, v):
            w = apply_fn(operand, v)
            nrm = jnp.sqrt(jax.lax.psum(jnp.vdot(w, w), ROWS))
            return w / nrm

        return jax.lax.fori_loop(0, repeats, body, p)

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(_operand_spec(storage), P(ROWS)),
                       out_specs=P(ROWS), check_vma=False)
    return jax.jit(mapped)


def _pack_chip_block(block_fn, n, n_p, m, tb, i, j):
    """Chip (i, j)'s (T*tb, tb) packed f64 buffer from unpadded-matrix
    block reads (`block_fn(r0, c0, h, w)` -> f64)."""
    from lam_tpu.ops.gemv import pack_rect_host, pack_tri_host

    c = m // tb
    c2 = c // 2
    m2 = m // 2

    def padded(r0, c0, h, w):
        src_h = max(0, min(n - r0, h))
        src_w = max(0, min(n - c0, w))
        out = np.zeros((h, w), np.float64)
        if src_h > 0 and src_w > 0:
            out[:src_h, :src_w] = block_fn(r0, c0, src_h, src_w)
        return out

    if i == j:
        return pack_tri_host(padded(i * m, i * m, m, m), tb)
    if i > j:                       # top half of lower block A_ij
        s = padded(i * m, j * m, m2, m)
    else:                           # bottom half of lower block A_ji
        s = padded(j * m + m2, i * m, m2, m)
    return pack_rect_host(s, tb, pad_tiles=c2)


class Symm2DOperator(LinearOperator):
    """Symmetric SPD matrix stored ONCE across an R x R grid (packed
    triangle diagonal + half-slab off-diagonal blocks); O(N/R)
    per-iteration exchange. df64 pair storage (precision df64 / ir)."""

    def __init__(self, operand, n, n_padded, mesh, tb,
                 storage="df64"):
        m = n_padded // mesh.shape[ROWS]
        super().__init__(
            _wrap_matvec(_build_sym2d_matvec(mesh, m, tb, "acc",
                                             storage)),
            operand, n, n_padded, jnp.float64)
        self.precision = (storage if storage in ("dfq", "fq")
                          else "df64")
        self.engine = "pallas_symm_packed"
        self.mesh = mesh
        self._m = m
        self._tb = tb
        self._storage = storage
        self._which = "acc"

    @staticmethod
    def from_block_fn(block_fn, n, mesh=None, tb=None,
                      precision="df64", pack_cache_src=None):
        """Build from `block_fn(r0, c0, h, w)` -> f64 block of the
        UNPADDED symmetric matrix (the 2-D analog of the per-rank
        MPI-IO read; only each chip's OWNED half/triangle is read).
        precision='dfq' quantizes each chip's lo plane to int16 against
        per-tile power-of-two scales with the matrix diagonal extracted
        to a P(ROWS) df64 pair — 6 B/element stored ONCE across the
        grid. pack_cache_src (dfq/fq only): source matrix file path,
        enables the per-shard pack cache (solver/pack_cache.py)."""
        (mesh, tb, r, n_p, m, c, T,
         sharding) = _geometry(n, mesh, tb)
        rows_per_chip = T * tb

        if precision in ("dfq", "fq"):
            return Symm2DOperator._from_block_fn_quantized(
                block_fn, n, mesh, tb, r, n_p, m, c, T, sharding,
                precision, pack_cache_src=pack_cache_src)
        if precision != "df64":
            raise ValueError(
                f"Symm2DOperator precision must be 'df64', 'dfq' or "
                f"'fq', got {precision!r}")

        def chip_block(key):
            i, j = key
            return _pack_chip_block(block_fn, n, n_p, m, tb, i, j)

        plane = df64_plane_provider(chip_block)

        def mk(idx):
            def cb(sl):
                i = (sl[0].start or 0) // rows_per_chip
                j = (sl[1].start or 0) // tb
                return plane((i, j), idx)

            return jax.make_array_from_callback(
                (r * rows_per_chip, r * tb), sharding, cb)

        operand = (mk(0), mk(1))
        return Symm2DOperator(operand, n, n_p, mesh, tb)

    @staticmethod
    def _from_block_fn_quantized(block_fn, n, mesh, tb, r, n_p, m, c,
                                 T, sharding, storage,
                                 pack_cache_src=None):
        """Per-chip quantized pack, shared by storage='dfq' (f32 hi +
        int16 lo) and storage='fq' (round 3b: the three-int16 cascade
        whose inner view reads only the 2-byte q1 plane) — 6 B/element
        stored once across the grid either way, the matrix diagonal
        (from the diagonal chips' walk) extracted to a P(ROWS) df64
        pair BEFORE quantization so it cannot set the tiles' scales.
        Operand order is (planes..., scales..., dh, dl) —
        QUANT_LAYOUT in solver/operators.py.

        pack_cache_src: source matrix file path; enables the per-shard
        pack cache with topology code "r"
        and shard index i*r+j — chip (i, j)'s pack is published to
        <src>.shardpack/<storage>.r<r>.s<i*r+j>."""
        from lam_tpu.solver import pack_cache as pc
        from lam_tpu.solver.operators import (QUANT_LAYOUT,
                                              quantize_storage_tiles)
        rows_per_chip = T * tb
        plane_dtypes, n_scales = QUANT_LAYOUT[storage]
        n_planes = len(plane_dtypes)
        cache = {}
        # identity captured no later than the bytes-source is bound
        src_stat = (os.stat(pack_cache_src)
                    if pack_cache_src is not None else None)
        shard_specs = ([(dt, (rows_per_chip, tb))
                        for dt in plane_dtypes]
                       + [(np.float32, (T,))] * n_scales
                       + [(np.float32, (m,))] * 2)

        def chip_pack(i, j):
            if (i, j) not in cache and pack_cache_src is not None:
                hit = pc.load_shard(pack_cache_src, storage, "r", r,
                                    i * r + j, n, n_p, tb, shard_specs)
                if hit is not None:
                    cache[(i, j)] = hit
            if (i, j) not in cache:
                packed = _pack_chip_block(block_fn, n, n_p, m, tb, i, j)
                dh = np.zeros((m,), np.float32)
                dl = np.zeros((m,), np.float32)
                if i == j:
                    for li in range(c):
                        t = li * (li + 1) // 2 + li
                        tile = packed[t * tb:(t + 1) * tb]
                        dv = np.diagonal(tile).copy()
                        dhi = dv.astype(np.float32)
                        dh[li * tb:(li + 1) * tb] = dhi
                        dl[li * tb:(li + 1) * tb] = (
                            dv - dhi.astype(np.float64)
                        ).astype(np.float32)
                        np.fill_diagonal(
                            packed[t * tb:(t + 1) * tb], 0.0)
                cache[(i, j)] = (*quantize_storage_tiles(storage,
                                                         packed, tb),
                                 dh, dl)
                if pack_cache_src is not None:
                    pc.save_shard(pack_cache_src, storage, "r", r,
                                  i * r + j, n, n_p, tb,
                                  cache[(i, j)], src_stat=src_stat)
            return cache[(i, j)]

        def mk_plane(idx):
            def cb(sl):
                i = (sl[0].start or 0) // rows_per_chip
                j = (sl[1].start or 0) // tb
                return chip_pack(i, j)[idx]

            return jax.make_array_from_callback(
                (r * rows_per_chip, r * tb), sharding, cb)

        def mk_sc(idx):
            def cb(sl):
                i = (sl[0].start or 0) // T
                j = sl[1].start or 0
                return chip_pack(i, j)[idx][:, None]

            return jax.make_array_from_callback((r * T, r), sharding,
                                                cb)

        def mk_diag(idx):
            def cb(sl):
                i = (sl[0].start or 0) // m
                return chip_pack(i, i)[idx]

            return jax.make_array_from_callback(
                (n_p,), NamedSharding(mesh, P(ROWS)), cb)

        nd = n_planes + n_scales
        operand = (*(mk_plane(j) for j in range(n_planes)),
                   *(mk_sc(n_planes + j) for j in range(n_scales)),
                   mk_diag(nd), mk_diag(nd + 1))
        return Symm2DOperator(operand, n, n_p, mesh, tb,
                              storage=storage)

    @staticmethod
    def from_dense(a, mesh=None, tb=None, precision="df64"):
        from lam_tpu.solver.operators import _verifies_symmetric
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if not _verifies_symmetric(a):
            raise ValueError(
                "Symm2DOperator requires a symmetric matrix (each "
                "element is stored once and mirrored by the dual walk)")
        return Symm2DOperator.from_block_fn(
            lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], n, mesh=mesh,
            tb=tb, precision=precision)

    @staticmethod
    def from_file(path, mesh=None, tb=None, precision="df64"):
        from lam_tpu import io as lio
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        return Symm2DOperator.from_block_fn(
            lambda r0, c0, h, w: lio.read_matrix_block(path, r0, c0, h,
                                                       w),
            rows, mesh=mesh, tb=tb, precision=precision)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, tb=None):
        """Gen-mode tridiagonal built ON DEVICE, shard-by-shard: each
        chip materializes only its owned tiles' sparse content (the
        nonzero tiles of a tridiagonal are the diagonal-block triangle
        tiles plus ONE cross-block corner tile on the (i, i-1) chips —
        O(m*tb) work, the sparsity-aware lesson of round 3); the lo
        plane is exactly zero (entries {0,1,2} are exact in f32) and
        stored as one broadcast (tb, tb) tile per chip."""
        from lam_tpu.ops.gemv import _symm_tables

        (mesh, tb, r, n_p, m, c, T,
         sharding) = _geometry(n, mesh, tb)
        it_np, kt_np = _symm_tables(c)
        it_c, kt_c = jnp.asarray(it_np), jnp.asarray(kt_np)
        rows_per_chip = T * tb

        def local_build():
            i = jax.lax.axis_index(ROWS)
            j = jax.lax.axis_index(COLS)
            out = jnp.zeros((rows_per_chip, tb), jnp.float32)

            # diagonal-chip band: only the c diagonal walk tiles are
            # nonzero (2 on the diagonal, 1 on the +-1 offsets) —
            # scatter just those, O(c*tb^2) temporaries, not
            # O(T*tb^2): the earlier dense-iota build allocated ~5x
            # the operand's size during construction and could OOM a
            # triangle that itself fits (same sparsity-aware scatter
            # as from_gen_fq below)
            dpos = jnp.nonzero(it_c == kt_c, size=c, fill_value=0)[0]
            i0 = it_c[dpos]
            rr = jax.lax.broadcasted_iota(jnp.int32, (c, tb, tb), 1)
            cc = jax.lax.broadcasted_iota(jnp.int32, (c, tb, tb), 2)
            gi = i * m + i0[:, None, None] * tb + rr
            gj = i * m + i0[:, None, None] * tb + cc
            d = rr - cc
            vals = jnp.where(d == 0, 2.0,
                             jnp.where((d == 1) | (d == -1), 1.0, 0.0))
            vals = jnp.where((gi < n) & (gj < n) & (i == j), vals, 0.0)
            ridx = (dpos[:, None] * tb
                    + jnp.arange(tb, dtype=jnp.int32)[None, :]
                    ).reshape(-1)
            out = out.at[ridx].set(
                jnp.where(i == j,
                          vals.astype(jnp.float32).reshape(c * tb, tb),
                          out[ridx]))

            # within-chip tile corners: the band crosses local tile
            # boundaries at walk tiles with it == kt + 1, whose
            # top-right element is A[g, g-1] = 1, g = i*m + it*tb
            if c > 1:
                cpos = jnp.nonzero(it_c == kt_c + 1, size=c - 1,
                                   fill_value=0)[0]
                ic = it_c[cpos]
                cval = jnp.where((i == j) & (i * m + ic * tb < n),
                                 jnp.float32(1.0), jnp.float32(0.0))
                out = out.at[cpos * tb, tb - 1].add(cval)

            # cross-block corner: A[i*m, i*m - 1] = 1 lives on the
            # LOWER chip (i, i-1) at local tile (0, c-1) -> packed walk
            # position c-1, in-tile element (0, tb-1)
            cv = jnp.where((i == j + 1) & (i * m < n), jnp.float32(1.0),
                           jnp.float32(0.0))
            return out.at[(c - 1) * tb, tb - 1].add(cv)

        hi = jax.jit(shard_map(local_build, mesh=mesh, in_specs=(),
                               out_specs=P(ROWS, COLS),
                               check_vma=False))()
        lo = jax.jit(lambda: jnp.zeros((r * tb, r * tb), jnp.float32),
                     out_shardings=NamedSharding(mesh,
                                                 P(ROWS, COLS)))()
        return Symm2DOperator((hi, lo), n, n_p, mesh, tb)

    @staticmethod
    def from_gen_fq(n, mesh=None, tb=None):
        """Gen-mode fq operator built ON DEVICE on the 2-D grid — the
        sym2d twin of SymmShardedOperator.from_gen_fq: the int16 q1
        plane is quantization-EXACT for the gen tridiagonal (the
        off-diagonal {0, 1} entries against the 2^-14 scale,
        generate.TRIDIAG_Q1_SCALE), built per chip by the same
        sparsity-aware scatter as from_gen_tridiagonal with the matrix
        diagonal EXTRACTED to a device-built P(ROWS) df64 pair (the fq
        layout's diagonal channel; the constant 2.0 is exact in f32 so
        dl == 0). The exactly-zero q2/q3 residual planes are ONE
        broadcast (tb, tb) tile per chip — 2 B/element stored once
        across the grid, a THIRD of the file-loaded fq footprint."""
        from lam_tpu import generate as gen
        from lam_tpu.ops.gemv import _symm_tables

        (mesh, tb, r, n_p, m, c, T,
         sharding) = _geometry(n, mesh, tb)
        it_np, kt_np = _symm_tables(c)
        it_c, kt_c = jnp.asarray(it_np), jnp.asarray(kt_np)
        rows_per_chip = T * tb
        qv = jnp.int16(round(1.0 / gen.TRIDIAG_Q1_SCALE))

        def local_build():
            i = jax.lax.axis_index(ROWS)
            j = jax.lax.axis_index(COLS)
            out = jnp.zeros((rows_per_chip, tb), jnp.int16)

            # diagonal-chip band: only the c diagonal tiles of the
            # local triangle walk are nonzero (+-1 neighbors; the
            # matrix diagonal itself is extracted to dh), so scatter
            # just those — O(c*tb^2) work, not O(T*tb^2)
            dpos = jnp.nonzero(it_c == kt_c, size=c, fill_value=0)[0]
            i0 = it_c[dpos]
            rr = jax.lax.broadcasted_iota(jnp.int32, (c, tb, tb), 1)
            cc = jax.lax.broadcasted_iota(jnp.int32, (c, tb, tb), 2)
            gi = i * m + i0[:, None, None] * tb + rr
            gj = i * m + i0[:, None, None] * tb + cc
            d = rr - cc
            vals = jnp.where((d == 1) | (d == -1), qv, jnp.int16(0))
            vals = jnp.where((gi < n) & (gj < n) & (i == j), vals,
                             jnp.int16(0))
            ridx = (dpos[:, None] * tb
                    + jnp.arange(tb, dtype=jnp.int32)[None, :]
                    ).reshape(-1)
            out = out.at[ridx].set(
                jnp.where(i == j, vals.reshape(c * tb, tb),
                          out[ridx]))

            # within-chip tile corners: the band crosses local tile
            # boundaries at walk tiles with it == kt + 1, whose
            # top-right element is A[g, g-1] = 1, g = i*m + it*tb
            # (the same cpos scatter as generate._tridiag_q1_packed_impl)
            if c > 1:
                cpos = jnp.nonzero(it_c == kt_c + 1, size=c - 1,
                                   fill_value=0)[0]
                ic = it_c[cpos]
                cval = jnp.where((i == j) & (i * m + ic * tb < n), qv,
                                 jnp.int16(0))
                out = out.at[cpos * tb, tb - 1].add(cval)

            # cross-block corner A[i*m, i*m - 1] = 1: the TOP half of
            # lower block A_(i, i-1) -> chip (i, i-1), rect tile
            # (0, c-1) = buffer row (c-1)*tb, in-tile element
            # (0, tb-1); .add is safe — that slot is zero elsewhere
            cv = jnp.where((i == j + 1) & (i * m < n), qv,
                           jnp.int16(0))
            return out.at[(c - 1) * tb, tb - 1].add(cv)

        q1 = jax.jit(shard_map(local_build, mesh=mesh, in_specs=(),
                               out_specs=P(ROWS, COLS),
                               check_vma=False))()
        zeros_q = jax.jit(lambda: jnp.zeros((r * tb, r * tb),
                                            jnp.int16),
                          out_shardings=sharding)()
        s1 = jax.jit(lambda: jnp.full((r * T, r),
                                      gen.TRIDIAG_Q1_SCALE,
                                      jnp.float32),
                     out_shardings=sharding)()
        zeros_s = jax.jit(lambda: jnp.zeros((r * T, r), jnp.float32),
                          out_shardings=sharding)()
        d_sharding = NamedSharding(mesh, P(ROWS))
        dh = jax.jit(lambda: jnp.where(jnp.arange(n_p) < n,
                                       jnp.float32(2.0),
                                       jnp.float32(0.0)),
                     out_shardings=d_sharding)()
        dl = jax.jit(lambda: jnp.zeros((n_p,), jnp.float32),
                     out_shardings=d_sharding)()
        operand = (q1, zeros_q, zeros_q, s1, zeros_s, zeros_s, dh, dl)
        return Symm2DOperator(operand, n, n_p, mesh, tb, storage="fq")

    # -- solve path ----------------------------------------------------------

    def prepare_b(self, b):
        b = np.asarray(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, expected "
                             f"({self.n},)")
        if self.n_padded != self.n:
            b = np.pad(b, (0, self.n_padded - self.n))
        return jax.make_array_from_callback(
            b.shape, NamedSharding(self.mesh, P(ROWS)),
            lambda idx: b[idx])

    def matvec(self, p_padded):
        fn = _build_sym2d_matvec(self.mesh, self._m, self._tb,
                                 self._which, self._storage)
        return fn(self.operand, p_padded)

    def matvec_chain(self, p_padded, repeats):
        fn = _build_sym2d_chain(self.mesh, self._m, self._tb,
                                self._which, repeats, self._storage)
        return fn(self.operand, p_padded)

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        del loop_fn
        solver = _build_sym2d_cg(self.mesh, self._m, self._tb,
                                 self._storage)
        return solver(self.operand, b_padded, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32())")
        solver = _build_sym2d_cg_ir(self.mesh, self._m, self._tb,
                                    max_cycles, self._storage,
                                    precond=inv_diag32 is not None)
        vec_args = ((b_padded, inv_diag32) if inv_diag32 is not None
                    else (b_padded,))
        return solver(self.operand, *vec_args, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype),
                      jnp.asarray(inner_floor, b_padded.dtype))

    def run_pcg(self, b_padded, max_iters, rel_error):
        d = self.diagonal()
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
        solver = _build_sym2d_pcg(self.mesh, self._m, self._tb,
                                  self._storage)
        return solver(self.operand, b_padded, inv_d, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def diagonal(self):
        """Matrix diagonal: it lives entirely in the diagonal chips'
        packed triangle buffers, at the walk's diagonal-tile positions
        (li*(li+1)/2 + li — static); a psum over COLS re-replicates each
        grid row's piece."""
        m, tb = self._m, self._tb
        c = m // tb
        dpos = np.asarray([li * (li + 1) // 2 + li for li in range(c)],
                          np.int32)

        if self._storage in ("dfq", "fq"):

            def local_diag(operand):
                # the diagonal lives in the operand as a P(ROWS) df64
                # pair, already replicated over COLS
                dh, dl = operand[-2], operand[-1]
                return dh.astype(jnp.float64) + dl.astype(jnp.float64)

            mapped = shard_map(local_diag, mesh=self.mesh,
                               in_specs=(_operand_spec(self._storage),),
                               out_specs=P(ROWS), check_vma=False)
            return jax.jit(mapped)(self.operand)

        def local_diag(operand):
            hi, lo = operand
            i = jax.lax.axis_index(ROWS)
            j = jax.lax.axis_index(COLS)
            s = jnp.arange(tb)
            rr = jnp.asarray(dpos)[:, None] * tb + s[None, :]
            dv = hi[rr, s[None, :]].astype(jnp.float64)
            if lo.shape == (tb, tb):        # broadcast zero tile
                dv = dv + lo[s, s].astype(jnp.float64)[None, :]
            else:
                dv = dv + lo[rr, s[None, :]].astype(jnp.float64)
            d_blk = jnp.where(i == j, dv.reshape(m), 0.0)
            return jax.lax.psum(d_blk, COLS)

        mapped = shard_map(local_diag, mesh=self.mesh,
                           in_specs=(_OPERAND_SPEC,),
                           out_specs=P(ROWS), check_vma=False)
        return jax.jit(mapped)(self.operand)

    def as_f32(self):
        """f32 dual-walk view sharing this operator's buffers."""
        out = Symm2DOperator(self.operand, self.n, self.n_padded,
                             self.mesh, self._tb,
                             storage=self._storage)
        out.vector_dtype = jnp.float32
        out.precision = "f32"
        out._which = "f32"
        out._matvec_dot_fn = _wrap_matvec(
            _build_sym2d_matvec(self.mesh, self._m, self._tb, "f32",
                                self._storage))
        return out
