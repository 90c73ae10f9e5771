"""Chunked host->device transfers for large planes.

A multi-GB plane is uploaded in fixed-size chunks and assembled on the
device, so that the upload overlaps the host work that produces it:

  * chunks are device_put by an UPLOADER THREAD while the main thread
    folds them into the destination buffer with a donated
    dynamic_update_slice program (in-place: peak device memory is ONE
    buffer plus a bounded chunk window — a concatenate would briefly
    hold two full copies);
  * ALL chunks share ONE shape — the last chunk is read OVERLAPPING
    the previous one and folded at row M-rpc, rewriting identical
    bytes — so exactly one XLA program exists, compiled once by a
    warm-fold of a zero chunk while the uploader thread keeps real
    transfers moving underneath;
  * stream_file_to_device additionally reads the file in a READER
    THREAD, so disk reads and uploads run concurrently end to end
    (solver/pack_cache.py load_device).

Whether chunking beats one device_put on a given host link has not been
measured on the GPU host.

The reference's analog is the pinned-buffer H2D pipeline of its CUDA
loaders (ConjugateGradient_MultiGPUS_CUDA_MPI.cu:510-516: MPI-IO into
pinned host memory, then cudaMemcpyAsync).
"""

from __future__ import annotations

import functools
import os
import queue
import threading

import numpy as np

_CHUNK_BYTES = int(os.environ.get("LAM_TPU_UPLOAD_CHUNK_MB", "64")) << 20
# below this, chunking is pure overhead
_MIN_CHUNK_TOTAL = 2 * _CHUNK_BYTES
# device_put chunks held ahead of the folder (bounds transient HBM:
# depth x chunk bytes on top of the destination buffer)
_QUEUE_DEPTH = 6


@functools.lru_cache(maxsize=None)
def _updater():
    import jax

    @functools.partial(jax.jit, donate_argnums=(0,))
    def upd(buf, chunk, r0):
        import jax.numpy as jnp
        idx = (r0,) + (jnp.int32(0),) * (buf.ndim - 1)
        return jax.lax.dynamic_update_slice(buf, chunk, idx)

    return upd


def _rows_per_chunk(shape, itemsize, chunk_bytes):
    row_bytes = max(1, int(np.prod(shape[1:])) * itemsize)
    return max(1, chunk_bytes // row_bytes)


def _chunk_starts(m, rpc):
    """Row offsets of equal-size rpc-row chunks covering [0, m): the
    LAST chunk starts at m - rpc and overlaps its predecessor (both
    write identical rows), so every chunk — and therefore the fold
    program — has exactly one shape."""
    if rpc >= m:
        return [0]
    starts = list(range(0, m - rpc + 1, rpc))
    if starts[-1] != m - rpc:
        starts.append(m - rpc)
    return starts


def _assemble(shape, dtype, host_chunks, rpc):
    """Fold (r0, host_chunk) pairs from the `host_chunks` iterator into
    a device buffer. An uploader thread turns host chunks into device
    chunks so transfers continue while the main thread blocks on the
    one-time fold-program compile."""
    import jax
    import jax.numpy as jnp

    qd: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)

    def uploader():
        try:
            for r0, chunk in host_chunks:
                qd.put((r0, jax.device_put(chunk)))
            qd.put(None)
        except BaseException as e:  # surfaced by the consumer
            qd.put(e)

    t = threading.Thread(target=uploader, daemon=True)
    t.start()
    upd = _updater()
    out = jnp.zeros(tuple(shape), dtype=dtype)
    # warm-fold: zero chunk into zero rows — pays the program compile
    # while the uploader streams real chunks underneath
    warm = jnp.zeros((rpc,) + tuple(shape[1:]), dtype=dtype)
    out = upd(out, warm, np.int32(0))
    try:
        while True:
            item = qd.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            r0, chunk = item
            out = upd(out, chunk, np.int32(r0))
    finally:
        t.join(timeout=300)
    return out


class Folder:
    """Incremental chunked upload of a plane whose HOST buffer fills
    progressively (the cold-path pack pipeline: a native range-pack
    thread fills tile-rows while the main thread folds finished 64 MB
    windows to the device — quantize, disk, and upload all overlap).

    advance(host, avail) folds every complete chunk within the first
    `avail` rows; call with avail == rows to finish (the tail folds at
    row M-rpc with the overlap trick, so one program shape serves all
    folds)."""

    def __init__(self, shape, dtype, chunk_bytes=None):
        import jax.numpy as jnp
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.m = int(shape[0])
        cb = chunk_bytes or _CHUNK_BYTES
        self.rpc = _rows_per_chunk(self.shape, self.dtype.itemsize, cb)
        self._next = 0
        self._small = self.rpc >= self.m
        self.out = (None if self._small
                    else jnp.zeros(self.shape, dtype=self.dtype))

    def advance(self, host, avail):
        import jax
        if self._small:
            if avail >= self.m and self.out is None:
                import jax.numpy as jnp
                self.out = jnp.asarray(np.ascontiguousarray(host))
            return
        upd = _updater()
        while self._next + self.rpc <= avail:
            chunk = jax.device_put(
                np.ascontiguousarray(host[self._next:self._next
                                          + self.rpc]))
            self.out = upd(self.out, chunk, np.int32(self._next))
            self._next += self.rpc
        if avail >= self.m and self._next < self.m:
            r0 = self.m - self.rpc     # overlap-aligned tail chunk
            chunk = jax.device_put(np.ascontiguousarray(host[r0:]))
            self.out = upd(self.out, chunk, np.int32(r0))
            self._next = self.m

    def result(self):
        unfinished = (self.out is None if self._small
                      else self._next < self.m)
        if unfinished:
            raise RuntimeError("Folder not finished (advance to m)")
        return self.out


def to_device(buf, chunk_bytes=None):
    """jnp.asarray for big HOST arrays, uploading in chunks.

    Already-on-device arrays and small buffers pass straight through
    to jnp.asarray. The assembled buffer is bit-identical to a direct
    upload (dynamic_update_slice of full rows copies verbatim)."""
    import jax.numpy as jnp

    if not isinstance(buf, np.ndarray):
        return jnp.asarray(buf)
    cb = chunk_bytes or _CHUNK_BYTES
    floor = _MIN_CHUNK_TOTAL if chunk_bytes is None else cb
    if buf.nbytes < floor or buf.ndim == 0:
        return jnp.asarray(buf)
    rpc = _rows_per_chunk(buf.shape, buf.itemsize, cb)
    m = buf.shape[0]
    if rpc >= m:
        return jnp.asarray(buf)

    def chunks():
        for r0 in _chunk_starts(m, rpc):
            yield r0, np.ascontiguousarray(buf[r0:r0 + rpc])

    return _assemble(buf.shape, buf.dtype, chunks(), rpc)


def stream_file_to_device(path, offset, dtype, shape, chunk_bytes=None):
    """Read a contiguous (rows, ...) plane at `offset` bytes of `path`
    and return it as a device array, overlapping the disk read (reader
    thread) with the chunked upload.

    Raises IOError on a short read — callers treat the cache as
    invalid, never silently truncated."""
    import jax.numpy as jnp

    dtype = np.dtype(dtype)
    m = int(shape[0])
    row_elems = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    row_bytes = row_elems * dtype.itemsize
    cb = chunk_bytes or _CHUNK_BYTES
    floor = _MIN_CHUNK_TOTAL if chunk_bytes is None else cb
    rpc = _rows_per_chunk(shape, dtype.itemsize, cb)
    if m * row_bytes < floor or rpc >= m:
        with open(path, "rb") as fh:
            fh.seek(offset)
            buf = np.fromfile(fh, dtype=dtype, count=m * row_elems)
        if buf.size != m * row_elems:
            raise IOError(f"{path}: short read at offset {offset}")
        return jnp.asarray(buf.reshape(tuple(shape)))

    qh: queue.Queue = queue.Queue(maxsize=2)
    starts = _chunk_starts(m, rpc)

    def reader():
        try:
            with open(path, "rb") as fh:
                for r0 in starts:
                    fh.seek(offset + r0 * row_bytes)
                    buf = np.fromfile(fh, dtype=dtype,
                                      count=rpc * row_elems)
                    if buf.size != rpc * row_elems:
                        raise IOError(
                            f"{path}: short read at offset {offset}")
                    qh.put((r0, buf.reshape((rpc,) + tuple(shape[1:]))))
            qh.put(None)
        except BaseException as e:  # surfaced by the consumer
            qh.put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    def chunks():
        try:
            while True:
                item = qh.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            t.join(timeout=300)

    return _assemble(shape, dtype, chunks(), rpc)
