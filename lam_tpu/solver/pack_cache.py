"""On-disk cache of packed quantized-triangle planes.

Packing a multi-GB f64 matrix file into the dfq/fq triangle layouts is
CPU-bound (quantization of N^2/2 elements on the host). The packed
planes are 3-8x SMALLER than the source file (6 B/element on the lower
triangle vs 8 B/element on the full square), so caching them beside the
source turns every RELOAD into a raw sequential read of the small file
— no quantization pass.

The same mechanism covers the UNQUANTIZED packed-triangle planes
(precision "f32": one f32 plane; "df64": the (hi, lo) f32 pair,
diagonal kept in-plane — the layouts of DenseOperator.from_dense with
engine='pallas_symm_packed'): their host-side f64->f32 conversion is
cheaper than quantization, but the conversion + full-square read is
still host work, and the f32 cache is 4x smaller than the source.

File format (version 2, little-endian):
    8 bytes   magic b"LAMPACK2"
    6 x u64   precision code (1=dfq, 2=fq, 3=f32, 4=df64), n,
              n_padded, tb, source file size, source file mtime_ns
    raw buffers in the operand order of _native_io.pack_{dfq,fq}
      dfq: hi (T*tb, tb) f32 | loq (T*tb, tb) i16 | sc (T,) f32
           | dh (n_p,) f32 | dl (n_p,) f32
      fq:  q1, q2, q3 (Tq*tb, tb) i16 | s1, s2, s3 (Tq,) f32
           | dh, dl (n_p,) f32
      f32: hi (T*tb, tb) f32
      df64: hi (T*tb, tb) f32 | lo (T*tb, tb) f32
with T = tri_tile_count(n_padded/tb) and Tq = padded_tri_tile_count
(T rounded up to a multiple of Q16_P — the fq layout change that
bumped the magic from LAMPACK1: fq planes carry all-zero pad tiles,
ops/gemv.py).
All shapes are derivable from (precision, n_padded, tb), so the header
carries no per-buffer metadata. The source (size, mtime_ns) pair makes
the cache self-invalidating: a rewritten matrix file is repacked, not
served stale. Loads never raise on a bad cache — any mismatch or
truncation returns None and the caller repacks (and overwrites).

INVARIANT — bump the magic on ANY layout or quantizer change: the
header keys only (precision code, shapes, source size+mtime), so a
change to the pack pipeline that alters the BYTES it produces for the
same source (e.g. _pow2_scale rounding, plane ordering, tile walk
order) would silently serve packs built by the old algorithm. Any such
change MUST rev the magic (LAMPACK1 -> LAMPACK2), which invalidates
every existing cache file at load time.

The reference has no analog (it re-reads the raw fp64 file every run,
MPI-IO at challenge/main/LAM/src/CPU/ConjugateGradient_CPU_MPI_OMP.hpp:325-363);
this answers the same "load dominates at scale" problem its read_time
CSV column measures.
"""

import os

import numpy as np

MAGIC = b"LAMPACK2"
SHARD_MAGIC = b"LAMSHRD1"
_PREC_CODE = {"dfq": 1, "fq": 2, "f32": 3, "df64": 4}
_HEADER_WORDS = 6
_SHARD_HEADER_WORDS = 9
_TOPO_CODE = {"g": 1, "r": 2}   # 1-D band-pair mesh / R x R grid
_DTYPE_CODE = {np.dtype(np.float32): 1, np.dtype(np.int16): 2,
               np.dtype(np.float64): 3}


def cache_path(src_path, precision):
    """Cache file published beside the source matrix file."""
    return f"{src_path}.{precision}pack"


def _buffer_specs(precision, n_padded, tb):
    """(dtype, shape) per buffer, in operand order."""
    from lam_tpu.ops.gemv import padded_tri_tile_count
    nblk = n_padded // tb
    T = nblk * (nblk + 1) // 2
    plane = (T * tb, tb)
    scale = (T,)
    diag = (n_padded,)
    if precision == "dfq":
        return [(np.float32, plane), (np.int16, plane),
                (np.float32, scale), (np.float32, diag),
                (np.float32, diag)]
    if precision == "fq":
        tq = padded_tri_tile_count(nblk)
        return ([(np.int16, (tq * tb, tb))] * 3
                + [(np.float32, (tq,))] * 3
                + [(np.float32, diag)] * 2)
    if precision == "f32":
        return [(np.float32, plane)]
    if precision == "df64":
        return [(np.float32, plane)] * 2
    raise ValueError(f"unknown packed precision {precision!r}")


def save(src_path, precision, n, n_padded, tb, bufs, src_stat=None):
    """Atomically publish the packed buffers beside `src_path`.

    Best-effort: a full disk or read-only directory must not fail the
    solve that triggered the caching — errors clean up the temp file
    and return False.

    `src_stat` is the os.stat of the source taken BEFORE the pack ran
    (packing a multi-GB file takes minutes). The cache is tagged with
    that pre-pack (size, mtime_ns), and if the source's CURRENT stat
    no longer matches it the save is refused: the packed planes may
    mix old and new content (the pack reads a live memory map), and
    tagging them with the new file's identity would defeat the
    self-invalidation contract — every later load would silently serve
    a wrong operator."""
    dst = cache_path(src_path, precision)
    tmp = dst + ".tmp"
    try:
        st = os.stat(src_path)
        if src_stat is not None:
            if (st.st_size != src_stat.st_size
                    or st.st_mtime_ns != src_stat.st_mtime_ns):
                return False  # source rewritten mid-pack
            st = src_stat
        header = np.array(
            [_PREC_CODE[precision], n, n_padded, tb, st.st_size,
             st.st_mtime_ns], dtype="<u8")
        with open(tmp, "wb") as fh:
            fh.write(MAGIC)
            header.tofile(fh)
            for buf in bufs:
                np.ascontiguousarray(buf).tofile(fh)
        os.replace(tmp, dst)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _validate(fh, src_path, precision):
    """Header + payload-size validation shared by load/load_device.

    Returns (n, n_padded, tb, specs) with the stream positioned at the
    first buffer byte, or None on any mismatch."""
    src_st = os.stat(src_path)
    if fh.read(len(MAGIC)) != MAGIC:
        return None
    header = np.fromfile(fh, dtype="<u8", count=_HEADER_WORDS)
    if header.size != _HEADER_WORDS:
        return None
    code, n, n_padded, tb, src_size, src_mtime = (
        int(v) for v in header)
    if (code != _PREC_CODE[precision] or tb == 0
            or n_padded % tb != 0 or n > n_padded
            or src_size != src_st.st_size
            or src_mtime != src_st.st_mtime_ns):
        return None
    specs = _buffer_specs(precision, n_padded, tb)
    # size check BEFORE any fromfile: a corrupt-but-magic-valid
    # header could otherwise demand an absurd upfront
    # allocation (np.fromfile allocates `count` elements first)
    expect = sum(int(np.prod(s)) * np.dtype(d).itemsize
                 for d, s in specs)
    payload = os.fstat(fh.fileno()).st_size - fh.tell()
    if payload != expect:
        return None  # truncated, padded, or corrupt-header cache
    return n, n_padded, tb, specs


def load(src_path, precision):
    """Packed buffers from the cache beside `src_path`, or None.

    None means "no usable cache" (missing, stale vs the source file's
    (size, mtime_ns), truncated, or wrong precision/format) — the
    caller falls through to a fresh pack."""
    path = cache_path(src_path, precision)
    try:
        with open(path, "rb") as fh:
            v = _validate(fh, src_path, precision)
            if v is None:
                return None
            n, n_padded, tb, specs = v
            bufs = []
            for dtype, shape in specs:
                count = int(np.prod(shape))
                buf = np.fromfile(fh, dtype=dtype, count=count)
                if buf.size != count:
                    return None
                bufs.append(buf.reshape(shape))
        return n, n_padded, tb, tuple(bufs)
    except (OSError, ValueError):
        return None


def load_device(src_path, precision):
    """`load`, but each big plane streams to the DEFAULT DEVICE while
    the next disk chunk reads (ops/transfer.py stream_file_to_device)
    — disk reads and uploads run concurrently AND the upload itself is
    chunked. Returns (n, n_padded, tb, device buffers) or None with
    the same no-usable-cache semantics as `load`."""
    from lam_tpu.ops import transfer
    path = cache_path(src_path, precision)
    try:
        with open(path, "rb") as fh:
            v = _validate(fh, src_path, precision)
            if v is None:
                return None
            n, n_padded, tb, specs = v
            pos = fh.tell()
        bufs = []
        for dtype, shape in specs:
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            bufs.append(transfer.stream_file_to_device(
                path, pos, dtype, shape))
            pos += nbytes
        return n, n_padded, tb, tuple(bufs)
    except (OSError, ValueError):
        return None


def load_device_fq_q1(src_path):
    """Partial fq cache load for HOST-OUTER refinement
    (solver/host_outer.py): stream to the device ONLY the buffers the
    irfq INNER matvec reads — q1, s1, dh, dl — seeking past q2/q3 and
    s2/s3. That is 4.9 of the 14.7 GB at N=70000: on a transfer-bound
    link residency arrives sooner, and the outer residual is computed
    host-side against the exact f64 source instead of the on-device
    cascade.

    Returns (n, n_padded, tb, (q1_dev, s1_dev, dh_dev, dl_dev)) or
    None with `load`'s no-usable-cache semantics."""
    from lam_tpu.ops import transfer
    path = cache_path(src_path, "fq")
    try:
        with open(path, "rb") as fh:
            v = _validate(fh, src_path, "fq")
            if v is None:
                return None
            n, n_padded, tb, specs = v
            pos = fh.tell()
        offs = []
        for dtype, shape in specs:
            offs.append(pos)
            pos += int(np.prod(shape)) * np.dtype(dtype).itemsize
        bufs = tuple(
            transfer.stream_file_to_device(path, offs[i], *specs[i])
            for i in (0, 3, 6, 7))   # q1, s1, dh, dl
        return n, n_padded, tb, bufs
    except (OSError, ValueError):
        return None


# -- per-shard cache (sharded / 2-D backends) --------------------------------
#
# The sharded quantized builds pack per CHIP (pcg_symm chip_pack(c),
# pcg2d_symm chip_pack(i, j)) in mesh-dependent layouts a whole-matrix
# cache cannot serve — so each shard gets its OWN file, keyed on the
# full placement identity (precision, n, n_padded, tb, topology, shard
# index) plus the source's (size, mtime_ns). This mirrors the
# reference's per-rank MPI-IO reads
# (ConjugateGradient_CPU_MPI_OMP.hpp:325-363): every process touches
# only the files of the shards it addresses (callback placement), and a
# re-run on a different mesh shape simply misses and repacks.
#
# Shard files live in one sibling directory, <src>.shardpack/, named
# <precision>.<topo><size>.s<idx> — e.g. matrix.npy.shardpack/fq.g8.s3.
#
# Format (version 1, little-endian):
#     8 bytes  magic b"LAMSHRD1"
#     9 x u64  precision code, n, n_padded, tb, topo code (1=1-D "g",
#              2=2-D "r"), topo size, shard index, source size,
#              source mtime_ns
#     u64      number of buffers
#     per buffer: u64 dtype code (1=f32, 2=i16, 3=f64), u64 ndim,
#                 ndim x u64 dims
#     raw buffers, in operand order
# Unlike the whole-matrix format, buffer shapes are EXPLICIT: the
# per-chip walk lengths depend on topology math that lives with the
# operators, so the caller supplies the expected (dtype, shape) specs
# and load_shard treats any mismatch as a miss. The quantizer-version
# rule applies here too: any change to the per-shard pack layout or
# the quantization algorithm MUST bump SHARD_MAGIC.


def shard_cache_path(src_path, precision, topo, topo_size, shard_idx):
    return os.path.join(
        f"{src_path}.shardpack",
        f"{precision}.{topo}{topo_size}.s{shard_idx}")


def save_shard(src_path, precision, topo, topo_size, shard_idx,
               n, n_padded, tb, bufs, src_stat=None):
    """Atomically publish one shard's packed buffers. Best-effort
    (False on any OSError); refuses to publish when the source's
    current stat no longer matches the pre-pack `src_stat` (the pack
    may have read a mix of old and new bytes)."""
    dst = shard_cache_path(src_path, precision, topo, topo_size,
                           shard_idx)
    tmp = dst + ".tmp"
    try:
        st = os.stat(src_path)
        if src_stat is not None:
            if (st.st_size != src_stat.st_size
                    or st.st_mtime_ns != src_stat.st_mtime_ns):
                return False
            st = src_stat
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        header = np.array(
            [_PREC_CODE[precision], n, n_padded, tb,
             _TOPO_CODE[topo], topo_size, shard_idx, st.st_size,
             st.st_mtime_ns], dtype="<u8")
        with open(tmp, "wb") as fh:
            fh.write(SHARD_MAGIC)
            header.tofile(fh)
            np.array([len(bufs)], dtype="<u8").tofile(fh)
            for buf in bufs:
                arr = np.ascontiguousarray(buf)
                np.array([_DTYPE_CODE[arr.dtype], arr.ndim, *arr.shape],
                         dtype="<u8").tofile(fh)
            for buf in bufs:
                np.ascontiguousarray(buf).tofile(fh)
        os.replace(tmp, dst)
        return True
    except (OSError, KeyError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def load_shard(src_path, precision, topo, topo_size, shard_idx,
               n, n_padded, tb, expected_specs):
    """One shard's packed buffers, or None (missing, stale, truncated,
    or any identity/spec mismatch — the caller falls through to a
    fresh pack). `expected_specs` is the (dtype, shape) list the
    caller's topology math demands; a cache whose recorded buffers
    differ in any way is a miss, never an error."""
    path = shard_cache_path(src_path, precision, topo, topo_size,
                            shard_idx)
    rev_dtype = {v: k for k, v in _DTYPE_CODE.items()}
    try:
        src_st = os.stat(src_path)
        with open(path, "rb") as fh:
            if fh.read(len(SHARD_MAGIC)) != SHARD_MAGIC:
                return None
            header = np.fromfile(fh, dtype="<u8",
                                 count=_SHARD_HEADER_WORDS)
            if header.size != _SHARD_HEADER_WORDS:
                return None
            (code, h_n, h_np, h_tb, h_topo, h_ts, h_si, src_size,
             src_mtime) = (int(v) for v in header)
            if (code != _PREC_CODE[precision]
                    or h_n != n or h_np != n_padded or h_tb != tb
                    or h_topo != _TOPO_CODE[topo] or h_ts != topo_size
                    or h_si != shard_idx
                    or src_size != src_st.st_size
                    or src_mtime != src_st.st_mtime_ns):
                return None
            nb = np.fromfile(fh, dtype="<u8", count=1)
            if nb.size != 1 or int(nb[0]) != len(expected_specs):
                return None
            specs = []
            for _ in range(len(expected_specs)):
                meta = np.fromfile(fh, dtype="<u8", count=2)
                if meta.size != 2:
                    return None
                dcode, ndim = int(meta[0]), int(meta[1])
                if dcode not in rev_dtype or ndim > 4:
                    return None
                dims = np.fromfile(fh, dtype="<u8", count=ndim)
                if dims.size != ndim:
                    return None
                specs.append((rev_dtype[dcode],
                              tuple(int(d) for d in dims)))
            for got, want in zip(specs, expected_specs):
                if (got[0] != np.dtype(want[0])
                        or got[1] != tuple(want[1])):
                    return None
            # size check BEFORE any payload fromfile (as load())
            expect = sum(int(np.prod(s)) * np.dtype(d).itemsize
                         for d, s in specs)
            payload = os.fstat(fh.fileno()).st_size - fh.tell()
            if payload != expect:
                return None
            bufs = []
            for dtype, shape in specs:
                count = int(np.prod(shape))
                buf = np.fromfile(fh, dtype=dtype, count=count)
                if buf.size != count:
                    return None
                bufs.append(buf.reshape(shape))
        return tuple(bufs)
    except (OSError, ValueError):
        return None
