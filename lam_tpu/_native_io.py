"""ctypes bindings for the native IO/generator library (native/).

Loads lam_tpu/liblam_native.so if present; if absent and a toolchain is
available, attempts a one-shot `make -C native` build. All callers
(lam_tpu/io.py, generate paths) fall back to numpy when unavailable, so
the native layer is a pure accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_SO_PATH = os.path.join(os.path.dirname(__file__), "liblam_native.so")
_SRC_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "native")


def _try_build():
    try:
        subprocess.run(["make", "-C", _SRC_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        if os.environ.get("LAM_TPU_NO_NATIVE_BUILD") or not _try_build():
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    u64 = ctypes.c_uint64
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ln_read_rows.argtypes = [ctypes.c_char_p, u64, u64, u64, f64p]
    lib.ln_read_rows.restype = ctypes.c_int
    lib.ln_read_rows_split.argtypes = [ctypes.c_char_p, u64, u64, u64,
                                       f32p, f32p]
    lib.ln_read_rows_split.restype = ctypes.c_int
    lib.ln_split_f64.argtypes = [f64p, u64, f32p, f32p]
    lib.ln_split_f64.restype = None
    lib.ln_write_matrix.argtypes = [ctypes.c_char_p, u64, u64, f64p]
    lib.ln_write_matrix.restype = ctypes.c_int
    lib.ln_tridiagonal_rows.argtypes = [u64, u64, u64, f64p]
    lib.ln_tridiagonal_rows.restype = None
    lib.ln_tridiagonal_rows_split.argtypes = [u64, u64, u64, f32p, f32p]
    lib.ln_tridiagonal_rows_split.restype = None
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.ln_pack_dfq.argtypes = [ctypes.c_char_p, u64, u64, u64, u64,
                                f32p, i16p, f32p, f32p, f32p]
    lib.ln_pack_dfq.restype = ctypes.c_int
    lib.ln_pack_fq.argtypes = [ctypes.c_char_p, u64, u64, u64, u64,
                               i16p, i16p, i16p, f32p, f32p, f32p,
                               f32p, f32p]
    lib.ln_pack_fq.restype = ctypes.c_int
    # newer symbols — a stale .so built before them may still be loaded
    # (the auto-build only fires when the .so is MISSING); register
    # defensively and let has_pack()/has_range_pack() report capability
    if hasattr(lib, "ln_pack_planes"):
        lib.ln_pack_planes.argtypes = [ctypes.c_char_p, u64, u64, u64,
                                       u64, f32p, f32p]
        lib.ln_pack_planes.restype = ctypes.c_int
    if hasattr(lib, "ln_pack_fq_range"):
        lib.ln_pack_fq_range.argtypes = [ctypes.c_char_p, u64, u64, u64,
                                         u64, u64, u64, i16p, i16p,
                                         i16p, f32p, f32p, f32p, f32p,
                                         f32p]
        lib.ln_pack_fq_range.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available():
    return _load() is not None


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_rows(path, row_start, num_rows, cols):
    lib = _load()
    out = np.empty((num_rows, cols), dtype=np.float64)
    rc = lib.ln_read_rows(str(path).encode(), row_start, num_rows, cols,
                          _f64p(out))
    if rc != 0:
        raise IOError(f"native read of {path} failed (rc={rc})")
    return out


def read_rows_split(path, row_start, num_rows, cols):
    """Row block as (hi, lo) f32 planes, split during the read."""
    lib = _load()
    hi = np.empty((num_rows, cols), dtype=np.float32)
    lo = np.empty((num_rows, cols), dtype=np.float32)
    rc = lib.ln_read_rows_split(str(path).encode(), row_start, num_rows,
                                cols, _f32p(hi), _f32p(lo))
    if rc != 0:
        raise IOError(f"native split-read of {path} failed (rc={rc})")
    return hi, lo


def split_f64(a):
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    hi = np.empty(a.shape, dtype=np.float32)
    lo = np.empty(a.shape, dtype=np.float32)
    lib.ln_split_f64(_f64p(a), a.size, _f32p(hi), _f32p(lo))
    return hi, lo


def write_matrix(path, a):
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    rc = lib.ln_write_matrix(str(path).encode(), a.shape[0], a.shape[1],
                             _f64p(a))
    if rc != 0:
        raise IOError(f"native write of {path} failed (rc={rc})")


def tridiagonal_rows(row_start, num_rows, n):
    lib = _load()
    out = np.empty((num_rows, n), dtype=np.float64)
    lib.ln_tridiagonal_rows(row_start, num_rows, n, _f64p(out))
    return out


def pack_dfq(path, data_off, n, n_pad, tb):
    """Fused read+split+quantize of a symmetric f64 matrix file into the
    quantized-lo packed triangle layout (see native ln_pack_dfq): reads
    only the lower-triangle bytes and never materializes f64/f32 plane
    temporaries. Returns (hi, loq, sc, dh, dl) matching
    DenseOperator.from_dense_dfq's host buffers bit-for-bit."""
    lib = _load()
    nblk = n_pad // tb
    T = nblk * (nblk + 1) // 2
    hi = np.empty((T * tb, tb), dtype=np.float32)
    loq = np.empty((T * tb, tb), dtype=np.int16)
    sc = np.empty((T,), dtype=np.float32)
    dh = np.empty((n_pad,), dtype=np.float32)
    dl = np.empty((n_pad,), dtype=np.float32)
    rc = lib.ln_pack_dfq(
        str(path).encode(), data_off, n, n_pad, tb, _f32p(hi),
        loq.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _f32p(sc),
        _f32p(dh), _f32p(dl))
    if rc != 0:
        raise IOError(f"native dfq pack of {path} failed (rc={rc})")
    return hi, loq, sc, dh, dl


def has_range_pack(storage):
    """True when the library provides the chunked (tile-row range)
    pack for this storage — the cold-path pipeline driver's gate
    (solver/operators.py _pack_fq_streamed)."""
    lib = _load()
    return (lib is not None and storage == "fq"
            and hasattr(lib, "ln_pack_fq_range"))


def alloc_fq_buffers(n_pad, tb):
    """Host-side fq plane/scale/diag buffers in operand order, pad
    tiles zeroed — the shared allocation of pack_fq and the streamed
    range-pack driver."""
    from lam_tpu.ops.gemv import padded_tri_tile_count
    nblk = n_pad // tb
    T = nblk * (nblk + 1) // 2
    Ts = padded_tri_tile_count(nblk)
    q1 = np.empty((Ts * tb, tb), dtype=np.int16)
    q2 = np.empty((Ts * tb, tb), dtype=np.int16)
    q3 = np.empty((Ts * tb, tb), dtype=np.int16)
    s1 = np.zeros((Ts,), dtype=np.float32)
    s2 = np.zeros((Ts,), dtype=np.float32)
    s3 = np.zeros((Ts,), dtype=np.float32)
    for q in (q1, q2, q3):
        q[T * tb:] = 0
    dh = np.zeros((n_pad,), dtype=np.float32)
    dl = np.zeros((n_pad,), dtype=np.float32)
    return q1, q2, q3, s1, s2, s3, dh, dl


def pack_fq_range(path, data_off, n, n_pad, tb, row0, row1, bufs):
    """Fill tile-rows [row0, row1) of the fq layout into `bufs` (the
    alloc_fq_buffers tuple). The ctypes call releases the GIL, so a
    worker thread can pack while the main thread uploads finished
    windows (ops/transfer.py Folder)."""
    lib = _load()
    i16 = ctypes.POINTER(ctypes.c_int16)
    q1, q2, q3, s1, s2, s3, dh, dl = bufs
    rc = lib.ln_pack_fq_range(
        str(path).encode(), data_off, n, n_pad, tb, row0, row1,
        q1.ctypes.data_as(i16), q2.ctypes.data_as(i16),
        q3.ctypes.data_as(i16), _f32p(s1), _f32p(s2), _f32p(s3),
        _f32p(dh), _f32p(dl))
    if rc != 0:
        raise IOError(f"native fq range pack of {path} failed "
                      f"(rc={rc}, rows [{row0}, {row1}))")


def has_pack(storage):
    """True when the loaded library provides the fused pack for this
    storage — guards callers against a stale .so built before
    ln_pack_planes existed."""
    lib = _load()
    if lib is None:
        return False
    if storage in ("dfq", "fq"):
        return True
    return hasattr(lib, "ln_pack_planes")


def _pack_planes(path, data_off, n, n_pad, tb, want_lo):
    lib = _load()
    nblk = n_pad // tb
    T = nblk * (nblk + 1) // 2
    hi = np.empty((T * tb, tb), dtype=np.float32)
    lo = np.empty((T * tb, tb), dtype=np.float32) if want_lo else None
    rc = lib.ln_pack_planes(
        str(path).encode(), data_off, n, n_pad, tb, _f32p(hi),
        _f32p(lo) if want_lo else None)
    if rc != 0:
        raise IOError(f"native plane pack of {path} failed (rc={rc})")
    return (hi,) if lo is None else (hi, lo)


def pack_f32(path, data_off, n, n_pad, tb):
    """Fused read+convert of a symmetric f64 matrix file into the f32
    packed-triangle plane (native ln_pack_planes); bit-identical to
    from_dense's a.astype(f32) + pack_tri_host."""
    return _pack_planes(path, data_off, n, n_pad, tb, want_lo=False)


def pack_df64(path, data_off, n, n_pad, tb):
    """Fused read+split of a symmetric f64 matrix file into the (hi, lo)
    f32 packed-triangle planes (native ln_pack_planes); bit-identical
    to from_dense's split_f64_host + pack_tri_host pair."""
    return _pack_planes(path, data_off, n, n_pad, tb, want_lo=True)


def pack_fq(path, data_off, n, n_pad, tb):
    """Fused read+triple-quantize of a symmetric f64 matrix file into
    the fully-quantized packed triangle layout (native ln_pack_fq);
    bit-identical to DenseOperator.from_dense_fq's numpy pack. The
    planes/scales are PADDED to a multiple of Q16_P walk tiles
    (all-zero tiles, zero scales — the fq storage format, ops/gemv.py);
    the native pass fills the real triangle only."""
    from lam_tpu.ops.gemv import padded_tri_tile_count
    lib = _load()
    nblk = n_pad // tb
    T = nblk * (nblk + 1) // 2
    Ts = padded_tri_tile_count(nblk)
    i16 = ctypes.POINTER(ctypes.c_int16)
    q1 = np.empty((Ts * tb, tb), dtype=np.int16)
    q2 = np.empty((Ts * tb, tb), dtype=np.int16)
    q3 = np.empty((Ts * tb, tb), dtype=np.int16)
    s1 = np.zeros((Ts,), dtype=np.float32)
    s2 = np.zeros((Ts,), dtype=np.float32)
    s3 = np.zeros((Ts,), dtype=np.float32)
    for q in (q1, q2, q3):
        q[T * tb:] = 0
    dh = np.empty((n_pad,), dtype=np.float32)
    dl = np.empty((n_pad,), dtype=np.float32)
    rc = lib.ln_pack_fq(
        str(path).encode(), data_off, n, n_pad, tb,
        q1.ctypes.data_as(i16), q2.ctypes.data_as(i16),
        q3.ctypes.data_as(i16), _f32p(s1), _f32p(s2), _f32p(s3),
        _f32p(dh), _f32p(dl))
    if rc != 0:
        raise IOError(f"native fq pack of {path} failed (rc={rc})")
    return q1, q2, q3, s1, s2, s3, dh, dl


def tridiagonal_rows_split(row_start, num_rows, n):
    lib = _load()
    hi = np.empty((num_rows, n), dtype=np.float32)
    lo = np.empty((num_rows, n), dtype=np.float32)
    lib.ln_tridiagonal_rows_split(row_start, num_rows, n, _f32p(hi),
                                  _f32p(lo))
    return hi, lo
