"""Packed symmetric-triangle storage and its matvec: one Pallas kernel.

CG matrices are symmetric by contract, but every reference backend
streams all N^2 elements per matvec (ConjugateGradient_GPU_CUDA.cu:171-223).
A bandwidth-bound matvec can read only the lower triangle: each
off-diagonal tile A_ik contributes both A_ik @ p_k to y_i (direct) and
A_ik^T @ p_i to y_k (transpose). The walk visits the nblk(nblk+1)/2
lower-triangle (tb, tb) tiles in a fixed row-major order (the it/kt
tables); PACKED storage stacks exactly those tiles, in walk order, into
a (T*tb, tb) buffer — half the capacity of the square, and tile t of the
walk is block-row t of the buffer.

Storage dtypes of the walk:
  * f32 — the hi plane of the df64 pair (inner matvec of precision='ir'
    with the packed engine);
  * int16 with one power-of-two scale per tile — the q1 plane of the fq
    cascade (inner matvec of precision='irfq'): 2 bytes per element.

`tri_walk_partials` is the kernel (Pallas, Triton route): one program
per packed tile, walking the tile in row chunks; it emits two
length-tb partials per tile, T_t @ p[kt] and T_t^T @ p[it] (the latter
zeroed on diagonal tiles, which hold the full dense diagonal block).
XLA's segment_sum folds the partials into y — 2*T*tb floats against the
T*tb*tb stored elements. `tri_walk_xla` is the plain XLA form of the
same walk: the CPU tests' reference, the accurate (f64) walk, and the
competitor the kernel is timed against on the card.

Shapes are pre-padded: n % tb == 0 (operators pad with zeros, which is
exact for CG — lam_tpu/solver/operators.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from lam_tpu import platform

# Tile width of the packed layouts (and of their caches on disk).
SYMM_TB = 512

# The fq planes pad the walk to a multiple of Q16_P tiles (all-zero
# tiles, zero scales) — a storage format shared with the pack caches
# and the native packer; the walk itself never visits the pad tiles.
Q16_P = 8

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _symm_tables(nblk):
    """(it, kt) of the row-major lower-triangle walk over nblk tiles."""
    it, kt = np.tril_indices(nblk)
    return it.astype(np.int32), kt.astype(np.int32)


def tri_tile_count(nblk):
    """Tiles in the lower triangle of an nblk x nblk tile grid."""
    return nblk * (nblk + 1) // 2


def padded_tri_tile_count(nblk, p=Q16_P):
    """Triangle tile count rounded up to a multiple of p — the STORED
    plane size of the fq layouts."""
    t = tri_tile_count(nblk)
    return -(-t // p) * p


@functools.lru_cache(maxsize=None)
def _symm_tables_padded(nblk, p=Q16_P):
    """Walk tables padded to a multiple of p with INERT (i=0, k=1)
    entries: the gen-mode builders scatter over these tables, and an
    (0, 1) entry (k > i) matches no tridiagonal tile, so the pad tiles
    come out all-zero. Requires nblk >= 2 (the entry must be in range)."""
    if nblk < 2:
        raise ValueError("padded walk tables need nblk >= 2 (the inert "
                         "(0, 1) entry must be in range)")
    it, kt = _symm_tables(nblk)
    pad = padded_tri_tile_count(nblk, p) - len(it)
    if pad:
        it = np.concatenate([it, np.zeros(pad, np.int32)])
        kt = np.concatenate([kt, np.ones(pad, np.int32)])
    return it, kt


def pack_tri_host(a, tb, it=None, kt=None):
    """Pack a full square (n_p, n_p) host array into walk-order triangle
    tiles (T*tb, tb). With it/kt given, packs THAT walk (slab tables);
    default is the local row-major triangle walk."""
    a = np.asarray(a)
    if it is None:
        it, kt = _symm_tables(a.shape[0] // tb)
    out = np.empty((len(it) * tb, tb), dtype=a.dtype)
    for t, (i, k) in enumerate(zip(it, kt)):
        out[t * tb:(t + 1) * tb] = a[i * tb:(i + 1) * tb,
                                     k * tb:(k + 1) * tb]
    return out


def pack_rect_host(s, tb, pad_tiles=0):
    """Pack a dense host rectangle (ms, n) into row-major (T*tb, tb)
    tiles, plus `pad_tiles` trailing zero tiles (shape uniformity with
    triangle buffers on the 2-D symmetric grid)."""
    s = np.asarray(s)
    ms, n = s.shape
    mb, cb = ms // tb, n // tb
    out = np.zeros(((mb * cb + pad_tiles) * tb, tb), dtype=s.dtype)
    for li in range(mb):
        for k in range(cb):
            t = li * cb + k
            out[t * tb:(t + 1) * tb] = s[li * tb:(li + 1) * tb,
                                         k * tb:(k + 1) * tb]
    return out


# ---------------------------------------------------------------------------
# Quantized tile storage: int16 planes against per-tile power-of-two scales
# ---------------------------------------------------------------------------
#
# dfq quantizes the LO plane of the df64 pair; fq quantizes the whole
# element as a cascade of three int16 planes,
#
#   A_tile  ~=  q1*s1  +  q2*s2  +  q3*s3,     s_{k+1} ~= s_k * 2^-16,
#
# 6 bytes per element with a storage error <= s3/2 ~= 2^-48 max|A_tile|.
# The inner matvec of 'irfq' reads only q1 (2 bytes per element). The
# matrix diagonal is extracted as an exact df64 pair and zeroed in the
# planes, so the scales track the off-diagonal magnitude.


def _pow2_scale(m):
    """Smallest power of two >= m/32767, frexp-exact (no libm log2
    rounding at power-of-two boundaries). ONE definition shared by the
    dfq and fq numpy packs: the value must stay bit-identical to the
    native pack (native/lam_native.cpp ln_q_scale) or caches/packs
    produced by the numpy and native paths would silently differ."""
    fr, k = np.frexp(m / 32767.0)
    return 2.0 ** (int(k) - 1 if fr == 0.5 else int(k))


def quantize_lo_tiles(lo_packed, tb):
    """Quantize a packed (T*tb, tb) f32 lo plane to (int16 tiles,
    per-tile f32 power-of-two scales). Reconstruction q * scale is exact
    (scale is a power of two); |lo - q*scale| <= scale/2 elementwise."""
    lo_packed = np.asarray(lo_packed, dtype=np.float32)
    T = lo_packed.shape[0] // tb
    q = np.empty_like(lo_packed, dtype=np.int16)
    scales = np.zeros((T,), dtype=np.float32)
    for t in range(T):
        tile = lo_packed[t * tb:(t + 1) * tb]
        m = float(np.abs(tile).max())
        if m == 0.0:
            q[t * tb:(t + 1) * tb] = 0
            continue
        scale = _pow2_scale(m)
        scales[t] = scale
        qt = np.rint(tile.astype(np.float64) / scale)
        q[t * tb:(t + 1) * tb] = np.clip(qt, -32767, 32767)
    return q, scales


def quantize_fq_tiles(a_packed, tb):
    """Quantize a packed (T*tb, tb) f64 buffer into the three-plane fq
    cascade. Returns (q1, q2, q3 int16 planes, s1, s2, s3 (T,) f32
    power-of-two scale tables). Reconstruction q*s is exact per plane;
    residual after plane k is bounded by s_k/2."""
    r = np.array(a_packed, dtype=np.float64, copy=True)
    T = r.shape[0] // tb
    qs, scs = [], []
    for _ in range(3):
        q = np.zeros(r.shape, dtype=np.int16)
        sc = np.zeros((T,), dtype=np.float32)
        for t in range(T):
            tile = r[t * tb:(t + 1) * tb]
            m = float(np.abs(tile).max())
            if m == 0.0:
                continue
            scale = _pow2_scale(m)
            sc[t] = scale
            qt = np.clip(np.rint(tile / scale), -32767, 32767)
            q[t * tb:(t + 1) * tb] = qt
            tile -= qt * scale            # exact: power-of-two scale
        qs.append(q)
        scs.append(sc)
    return qs[0], qs[1], qs[2], scs[0], scs[1], scs[2]


def dequantize_tiles(q, scales, T, dtype):
    """(T*tb, tb) view of int16 tiles times their per-tile scales, in
    `dtype` (exact in f64: the scales are powers of two)."""
    tb = q.shape[1]
    if q.shape[0] < T * tb:
        raise ValueError(f"int16 plane has {q.shape[0] // tb} tiles, "
                         f"the walk needs {T}")
    tiles = q[:T * tb].reshape(T, tb, tb).astype(dtype)
    return (tiles * scales[:T].astype(dtype)[:, None, None]).reshape(
        T * tb, tb)


# ---------------------------------------------------------------------------
# The triangle walk
# ---------------------------------------------------------------------------


def _check_walk(buf, p, it, kt, scales):
    tb = buf.shape[1]
    T = it.shape[0]
    if tb < 16 or tb & (tb - 1):
        raise ValueError(f"packed tile width {tb} must be a power of two "
                         f">= 16")
    if p.shape[0] % tb:
        raise ValueError(f"n={p.shape[0]} is not a multiple of the tile "
                         f"width {tb}")
    if kt.shape != it.shape:
        raise ValueError(f"walk tables differ in length: {it.shape} vs "
                         f"{kt.shape}")
    if buf.shape[0] < T * tb:
        raise ValueError(f"packed buffer has {buf.shape[0] // tb} tiles, "
                         f"the walk visits {T}")
    if buf.dtype == jnp.int16 and (scales is None
                                   or scales.shape[0] < T):
        raise ValueError("int16 tiles need one scale per walk tile")
    return tb, T


def _walk_kernel(it_ref, kt_ref, *refs, tb, rows, scaled):
    """One program = one packed tile t = (i, k): stream its rows in
    chunks, accumulating the direct partial row by row and the
    transpose partial across chunks; products and sums in f32."""
    if scaled:
        sc_ref, a_ref, p_ref, yd_ref, yt_ref = refs
    else:
        a_ref, p_ref, yd_ref, yt_ref = refs
    t = pl.program_id(0)
    i = it_ref[t]
    k = kt_ref[t]
    pk = p_ref[pl.ds(k * tb, tb)]
    scale = sc_ref[t] if scaled else None

    def chunk(c, acc):
        x = a_ref[pl.ds(c * rows, rows), :].astype(jnp.float32)
        if scaled:
            x = x * scale
        yd_ref[pl.ds(c * rows, rows)] = jnp.sum(x * pk[None, :], axis=1)
        pi = p_ref[pl.ds(i * tb + c * rows, rows)]
        return acc + jnp.sum(x * pi[:, None], axis=0)

    acc = jax.lax.fori_loop(0, tb // rows, chunk,
                            jnp.zeros((tb,), jnp.float32))
    # diagonal tiles hold the whole dense diagonal block: direct only
    yt_ref[...] = jnp.where(k < i, acc, 0.0)


# (rows per chunk, num_warps, num_stages) by storage dtype: the fastest
# of six configurations at N=20000 and N=70000 on an H100 80GB HBM3
# (700 W); the int16 walk is sensitive to them (2.4 to 6.8 ms at
# N=70000), the f32 walk is not (3.4 to 3.9 ms).
KERNEL_CONFIG = {
    np.dtype(np.float32): dict(rows=8, num_warps=4, num_stages=3),
    np.dtype(np.int16): dict(rows=32, num_warps=4, num_stages=2),
}


@jax.jit
def tri_walk_partials(buf, p, it, kt, scales=None):
    """Per-tile partials of the packed triangle walk (the kernel).

    buf: (>= T*tb, tb) f32, or int16 with `scales` (>= T,) f32 — tile t
    is block-row t; rows past the walk (fq pad tiles) are never read.
    p: (n,) f32. it, kt: (T,) int32 walk tables (global row/column tile
    of each stored tile). Returns (direct, trans), each (T, tb) f32:
    direct[t] = T_t @ p[kt[t]], trans[t] = T_t^T @ p[it[t]] where
    kt[t] < it[t], else 0. The chunking and launch configuration are
    KERNEL_CONFIG's for the storage dtype."""
    tb, T = _check_walk(buf, p, it, kt, scales)
    if buf.dtype not in (jnp.float32, jnp.int16):
        raise ValueError(f"the kernel reads float32 or int16 tiles, got "
                         f"{buf.dtype}")
    cfg = KERNEL_CONFIG[np.dtype(buf.dtype)]
    rows = min(cfg["rows"], tb)
    scaled = buf.dtype == jnp.int16
    plat = platform.current()
    full = pl.BlockSpec()
    in_specs = [full, full] + ([full] if scaled else []) + [
        pl.BlockSpec((tb, tb), lambda t: (t, 0)),
        full,
    ]
    tile_out = pl.BlockSpec((tb,), lambda t: (t,))
    args = (it, kt) + ((scales,) if scaled else ()) + (buf, p)
    direct, trans = pl.pallas_call(
        functools.partial(_walk_kernel, tb=tb, rows=rows, scaled=scaled),
        grid=(T,),
        in_specs=in_specs,
        out_specs=(tile_out, tile_out),
        out_shape=(jax.ShapeDtypeStruct((T * tb,), jnp.float32),) * 2,
        backend=plat.pallas_backend,
        compiler_params=plt.CompilerParams(num_warps=cfg["num_warps"],
                                           num_stages=cfg["num_stages"]),
        interpret=plat.pallas_interpret,
        name="tri_walk",
    )(*args)
    return direct.reshape(T, tb), trans.reshape(T, tb)


def tri_walk_xla(buf, p, it, kt, scales=None, dtype=None):
    """Plain-XLA per-tile partials of the same walk, in `dtype`
    (default p's): the reference for the kernel, the accurate f64 walk,
    and the form XLA compiles without a kernel. Same (direct, trans)
    contract as tri_walk_partials."""
    dtype = dtype or p.dtype
    tb, T = _check_walk(buf, p, it, kt, scales)
    if scales is not None:
        tiles = dequantize_tiles(buf, scales, T, dtype)
    else:
        tiles = buf[:T * tb].astype(dtype)
    tiles = tiles.reshape(T, tb, tb)
    pb = p.astype(dtype).reshape(-1, tb)
    direct = jnp.einsum("tij,tj->ti", tiles, pb[kt], precision=_HIGHEST)
    trans = jnp.einsum("tij,ti->tj", tiles, pb[it], precision=_HIGHEST)
    return direct, trans * (kt < it)[:, None].astype(dtype)


def fold_partials(direct, trans, rows_of, cols_of, n_rows, n_cols):
    """Sum per-tile partials into vectors: direct by `rows_of` (length
    n_rows*tb), transpose by `cols_of` (length n_cols*tb)."""
    tb = direct.shape[1]
    yd = jax.ops.segment_sum(direct, rows_of, num_segments=n_rows)
    yt = jax.ops.segment_sum(trans, cols_of, num_segments=n_cols)
    return yd.reshape(n_rows * tb), yt.reshape(n_cols * tb)


def tri_walk(buf, p, scales=None, *, kernel=True):
    """y = A @ p over the packed lower triangle of a symmetric A (local
    row-major walk). kernel=False runs the plain-XLA walk in p's dtype."""
    tb = buf.shape[1]
    nblk = p.shape[0] // tb
    it_np, kt_np = _symm_tables(nblk)
    it, kt = jnp.asarray(it_np), jnp.asarray(kt_np)
    if kernel:
        direct, trans = tri_walk_partials(buf, p, it, kt, scales)
    else:
        direct, trans = tri_walk_xla(buf, p, it, kt, scales)
    yd, yt = fold_partials(direct, trans, it, kt, nblk, nblk)
    return yd + yt
