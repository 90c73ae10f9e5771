"""Linear operators: the placement/precision layer under the CG engine.

The reference binds the matrix representation, the matvec kernels, and the
communication strategy into six solver subclasses
(challenge/main/LAM/include/LAM.hpp:1-16). Here the CG loop is fixed
(lam_tpu/solver/cg.py) and an *operator* carries everything
matrix-related: storage precision, padding, which kernel computes A @ p,
and (in lam_tpu/parallel/) how A is sharded over the mesh.

Padding: the packed triangle walk wants tile-aligned shapes, and
`lax.while_loop` requires static shapes, so the matrix/vectors are
ZERO-padded once at construction. Zero padding is exact for CG: padded rows/cols of A are 0,
padded entries of b are 0, so every padded vector entry stays 0 through
the recurrence and every dot product is unchanged. This replaces the
reference's last-rank-takes-the-remainder splitting
(ConjugateGradient_CPU_MPI_OMP.hpp:180-184).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from lam_tpu import platform
from lam_tpu.ops import gemv


def padded_size(n, multiple=None):
    """n rounded up to a multiple (default: the packed tile width)."""
    multiple = multiple or gemv.SYMM_TB
    return -(-n // multiple) * multiple


# quantized-storage layouts: storage -> (per-plane dtypes, n_scales).
# Operand order everywhere is (planes..., scales..., dh, dl, ...).
QUANT_LAYOUT = {
    "dfq": ((np.float32, np.int16), 1),
    "fq": ((np.int16, np.int16, np.int16), 3),
}


def quantize_storage_tiles(storage, buf, tb):
    """Storage-specific quantized planes from a (k*tb, tb) walk-order
    f64 buffer (matrix diagonal already extracted and zeroed):
    'dfq' -> (hi, loq, sc); 'fq' -> (q1, q2, q3, s1, s2, s3), with one
    power-of-two scale per (tb, tb) tile. Shared by the local,
    band-pair, and 2-D grid packs so the plane/scale layouts cannot
    drift between backends."""
    if storage == "dfq":
        hi, lo = split_f64_host(buf)
        loq, sc = gemv.quantize_lo_tiles(lo, tb)
        return (hi, loq, sc)
    if storage != "fq":
        raise ValueError(f"unknown quantized storage {storage!r}")
    return gemv.quantize_fq_tiles(buf, tb)


def _open_matrix_memmap(path):
    """Memory-map a square f64 matrix file (.npy or the reference
    binary format); returns (memmap, data_offset_bytes). Shared by the
    from_file_dfq / from_file_fq native-pack prologues so the
    validation (dtype, squareness) cannot drift between them — a
    non-square .npy fed to the native pack would otherwise be read
    with the wrong row stride and yield a silently wrong operator."""
    path = str(path)
    if path.endswith(".npy"):
        a = np.load(path, mmap_mode="r")
        if a.dtype != np.float64:
            raise ValueError(f"{path}: expected float64, got {a.dtype}")
        data_off = a.offset
    else:
        from lam_tpu import io as lio
        rows, cols = lio.read_header(path)
        if rows != cols:
            # check the HEADER before mmapping: a corrupt header with
            # an overstated size would otherwise fail as a raw mmap
            # OSError instead of this actionable message
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        a = np.memmap(path, dtype=np.float64, mode="r", offset=16,
                      shape=(rows, cols))
        data_off = 16
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{path}: matrix must be square, got "
                         f"{a.shape}")
    return a, data_off


def _verifies_symmetric(a, tol=1e-12):
    """Whole-matrix symmetry check via two random matvecs: A v vs A^T v.

    ||Av - A^T v|| <= tol * (||Av|| + ||A^T v||) catches ANY asymmetry
    (including a single corrupted entry) with probability 1 over the
    random v — unlike entry sampling, which almost surely misses sparse
    corruption. Cost: two streaming passes over A on the host, once per
    operator build. f64 rounding contributes ~sqrt(N)*eps ~ 1e-13, so
    tol=1e-12 does not false-positive on genuinely symmetric matrices.
    Guards the lower-triangle engine (engine='auto'/'pallas_symm')
    against silently solving with sym(A) when the input is not
    symmetric."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    av = a @ v
    atv = v @ a
    scale = np.linalg.norm(av) + np.linalg.norm(atv)
    return bool(np.linalg.norm(av - atv) <= tol * max(scale, 1e-300))


def split_f64_host(a):
    """Host-side f64 -> (hi, lo) f32 split; threaded C++ when built."""
    try:
        from lam_tpu import _native_io
        if _native_io.available():
            return _native_io.split_f64(a)
    except Exception:
        pass
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df64_plane_provider(block_fn):
    """plane(key, idx) for per-shard df64 construction callbacks.

    jax.make_array_from_callback invokes the hi- and lo-plane callbacks
    separately per shard; splitting the same block twice would double
    the (threaded C++) split work, so the first caller splits ONCE and
    parks the sibling plane until its callback shows up. `block_fn(key)`
    produces the f64 block for a shard key; used by all three sharded
    operators (pcg, pcg2d, pcg_symm)."""
    pending = {}

    def plane(key, idx):
        if key in pending:
            return pending.pop(key)[idx]
        planes = split_f64_host(block_fn(key))
        pending[key] = planes
        return planes[idx]

    return plane


# ---------------------------------------------------------------------------
# matvec_dot implementations. Module-level functions so they hash stably as
# jit static arguments (no retracing across operator instances).
#
# Every f32 product XLA computes asks for Precision.HIGHEST: at the
# default precision the GPU may run f32 dots in TF32 (~3 decimal
# digits), which costs the inner CG iterations. f64 products are exact
# either way.
# ---------------------------------------------------------------------------

_HIGHEST = jax.lax.Precision.HIGHEST


def _mv_xla(a, p):
    """Plain XLA dense matvec (any dtype, any backend). Also the local
    shard matvec: a may be a row-block (m, n) with p the full vector,
    and p may be an (n, k) block."""
    return jnp.matmul(a, p, precision=_HIGHEST)


def _mv_df64_xla(operand, p):
    """df64 pair (hi + lo == the f64 matrix) in native f64 arithmetic."""
    hi, lo = operand
    f64 = p.dtype
    return hi.astype(f64) @ p + lo.astype(f64) @ p


# f32 matvec views over an accurate operand — used by the mixed-precision
# solver so the inner loop shares the SAME device buffers as the accurate
# operator (a separate f32 copy passed as its own jit parameter would
# double the matrix footprint).

def _mv_f32_of_df64_xla(operand, p):
    return _mv_xla(operand[0], p)


def _mv_f32_of_f64_xla(operand, p):
    # XLA fuses the cast into each matvec (no f32 copy is kept): the
    # square is read as f64, 8 bytes per element, on every inner
    # iteration (ROADMAP S2)
    return _mv_xla(operand.astype(jnp.float32), p)


# Packed-triangle storage (engine 'pallas_symm_packed'): the operand
# stores ONLY the lower-triangle tiles in walk order (ops/gemv.py) — half
# the capacity of the square. The f32 inner walks run the Pallas kernel;
# the accurate walks run XLA in f64 (the block matvec with one column).

def _mv_f32_packed(a, p):
    return gemv.tri_walk(a, p)


def _mv_f32_of_df64_packed(operand, p):
    # the hi plane of a df64 pair is symmetric whenever A is (elementwise
    # rounding preserves symmetry), so the triangle walk applies
    return gemv.tri_walk(operand[0], p)


def _mv_f32_of_dfq_packed(operand, p):
    # hi plane walk plus the (f32) diagonal term the planes no longer
    # carry
    return gemv.tri_walk(operand[0], p) + operand[3] * p


def _mv_f32_of_fq_packed(operand, p):
    # 2-byte q1 plane walk plus the (f32) diagonal term
    return (gemv.tri_walk(operand[0], p, scales=operand[3])
            + operand[6] * p)


@functools.lru_cache(maxsize=None)
def _wrap_matvec(matvec_fn):
    """fn(operand, p) -> matvec_dot(operand, p); cached so the wrapper is
    a stable jit static argument (same fn -> same wrapper -> no retrace)."""

    def matvec_dot(operand, p):
        ap = matvec_fn(operand, p)
        return ap, jnp.vdot(p, ap)

    return matvec_dot


# Column-block partial matvecs: y_part = A[:, blk*nb:(blk+1)*nb] @ p_blk
# with a TRACED block index — the per-step compute of the ring matvec
# (lam_tpu/parallel/pcg.py).

def _mv_cols_xla(a, p_blk, blk):
    nb = p_blk.shape[0]
    cols = jax.lax.dynamic_slice_in_dim(a, blk * nb, nb, axis=1)
    return _mv_xla(cols, p_blk)


def _mv_cols_df64_xla(operand, p_blk, blk):
    hi, lo = operand
    f64 = p_blk.dtype
    nb = p_blk.shape[0]
    h = jax.lax.dynamic_slice_in_dim(hi, blk * nb, nb, axis=1)
    lw = jax.lax.dynamic_slice_in_dim(lo, blk * nb, nb, axis=1)
    return h.astype(f64) @ p_blk + lw.astype(f64) @ p_blk


def _mv_cols_f32_of_df64_xla(operand, p_blk, blk):
    return _mv_cols_xla(operand[0], p_blk, blk)


def _mv_cols_f32_of_f64_xla(operand, p_blk, blk):
    return _mv_cols_xla(operand.astype(jnp.float32), p_blk, blk)


MATVEC_COLS = {
    ("f64", "xla"): _mv_cols_xla,
    ("f32", "xla"): _mv_cols_xla,
    ("df64", "xla"): _mv_cols_df64_xla,
    ("f32@df64", "xla"): _mv_cols_f32_of_df64_xla,
    ("f32@f64", "xla"): _mv_cols_f32_of_f64_xla,
}

def _packed_diagonal(buf, like=None):
    """Diagonal of a walk-order packed triangle buffer (ops/gemv.py).

    Row-tile i's diagonal tile sits at walk position i(i+1)/2 + i; its
    diagonal is buf[t*tb + s, s]. A broadcast single-tile buffer (the
    zero lo plane, shape (tb, tb)) contributes its own diagonal to
    every row-tile; `like` supplies the packed sibling that defines the
    tile count in that case."""
    tb = buf.shape[1]
    ref_rows = (like if like is not None else buf).shape[0]
    ntri = ref_rows // tb
    # invert T = nblk(nblk+1)/2
    nblk = int((np.sqrt(8 * ntri + 1) - 1) / 2 + 0.5)
    i = np.arange(nblk)
    tdiag = i * (i + 1) // 2 + i
    s = np.arange(tb)
    if buf.shape[0] == tb and like is not None:
        return jnp.tile(buf[s, s], nblk)
    rows = (tdiag[:, None] * tb + s[None, :]).reshape(-1)
    cols = np.tile(s, nblk)
    return buf[jnp.asarray(rows), jnp.asarray(cols)]


def _packed_block_walk(buf_hi, buf_lo, p_block):
    """(n, k) block matvec over a walk-order packed triangle buffer —
    the XLA einsum form of the local triangle walk (direct terms
    scattered by row-tile, transpose terms by column-tile, diagonal
    tiles counted once). Used for block CG on packed storage, where the
    unpacked layouts' plain matmul does not apply. Computes in p's
    dtype (f64 on the block path — same accuracy class as the unpacked
    ('df64', 'xla') block matvec, which also casts the planes up)."""
    tb = buf_hi.shape[1]
    T = buf_hi.shape[0] // tb
    n, k = p_block.shape
    nblk = n // tb
    it, kt = gemv._symm_tables(nblk)
    # [:len(it)]: fq planes are PADDED past the triangle (Q16_P layout);
    # the walk covers the real tiles only
    tiles = buf_hi.reshape(T, tb, tb)[:len(it)].astype(p_block.dtype)
    if buf_lo is not None:
        if buf_lo.shape[0] == tb:            # broadcast zero lo tile
            tiles = tiles + buf_lo.astype(p_block.dtype)[None]
        else:
            tiles = tiles + buf_lo.reshape(T, tb, tb)[:len(it)].astype(
                p_block.dtype)
    pb = p_block.reshape(nblk, tb, k)
    it_j = jnp.asarray(it)
    kt_j = jnp.asarray(kt)
    direct = jnp.einsum("tij,tjk->tik", tiles, pb[kt_j],
                        precision=_HIGHEST)
    yd = jax.ops.segment_sum(direct, it_j, num_segments=nblk)
    mask = (kt < it)[:, None, None]          # diagonal: direct only
    trans = jnp.einsum("tij,tik->tjk", tiles, pb[it_j],
                       precision=_HIGHEST) * mask
    yt = jax.ops.segment_sum(trans, kt_j, num_segments=nblk)
    return (yd + yt).reshape(n, k)


def _mv_block_packed_f32(operand, p):
    return _packed_block_walk(operand, None, p)


def _mv_block_packed_df64(operand, p):
    hi, lo = operand
    return _packed_block_walk(hi, lo, p)


def _mv_block_packed_dfq(operand, p):
    hi, loq, sc, dh, dl = operand
    tb = hi.shape[1]
    T = hi.shape[0] // tb
    lo_deq = (loq.reshape(T, tb, tb).astype(jnp.float32)
              * sc[:, None, None]).reshape(T * tb, tb)
    y = _packed_block_walk(hi, lo_deq, p)
    d = dh.astype(p.dtype) + dl.astype(p.dtype)
    return y + d[:, None] * p


def _mv_block_packed_fq(operand, p):
    q1, q2, q3, s1, s2, s3, dh, dl = operand
    tb = q1.shape[1]
    T = q1.shape[0] // tb
    # reconstruct in p's dtype (f64 on the block path): an f32 sum
    # would round away the q2/q3 planes' contribution. A (tb, tb)
    # plane is one broadcast EXACT-ZERO tile (gen mode) — skip it.
    rec = sum((q.reshape(T, tb, tb).astype(p.dtype)
               * s.astype(p.dtype)[:, None, None]).reshape(T * tb, tb)
              for q, s in ((q1, s1), (q2, s2), (q3, s3))
              if q.shape == q1.shape)
    y = _packed_block_walk(rec, None, p)
    d = dh.astype(p.dtype) + dl.astype(p.dtype)
    return y + d[:, None] * p


_MV_BLOCK_PACKED = {
    "f32": _mv_block_packed_f32,
    "df64": _mv_block_packed_df64,
    "dfq": _mv_block_packed_dfq,
    "fq": _mv_block_packed_fq,
}


def _vector_walk(block_fn):
    def mv(operand, p):
        return block_fn(operand, p[:, None])[:, 0]

    return mv


# Plain local matvec by (precision, engine) — the sharded solvers compose
# these with collectives themselves (lam_tpu/parallel/pcg.py).
MATVEC = {
    ("f64", "xla"): _mv_xla,
    ("f32", "xla"): _mv_xla,
    ("df64", "xla"): _mv_df64_xla,
    ("f32@df64", "xla"): _mv_f32_of_df64_xla,
    ("f32@f64", "xla"): _mv_f32_of_f64_xla,
    ("f32", "pallas_symm_packed"): _mv_f32_packed,
    ("df64", "pallas_symm_packed"): _vector_walk(_mv_block_packed_df64),
    ("f32@df64", "pallas_symm_packed"): _mv_f32_of_df64_packed,
    ("dfq", "pallas_symm_packed"): _vector_walk(_mv_block_packed_dfq),
    ("f32@dfq", "pallas_symm_packed"): _mv_f32_of_dfq_packed,
    ("fq", "pallas_symm_packed"): _vector_walk(_mv_block_packed_fq),
    ("f32@fq", "pallas_symm_packed"): _mv_f32_of_fq_packed,
}

_MATVEC_DOT = {key: _wrap_matvec(fn) for key, fn in MATVEC.items()}

ENGINES = ("xla", "pallas_symm_packed")


def check_engine(engine):
    """Reject engine names that do not exist (anymore): 'pallas' and
    'pallas_symm' named full-square kernels that were removed."""
    if engine in ("pallas", "pallas_symm"):
        raise ValueError(
            f"engine={engine!r} was removed together with its full-square "
            "kernel; use engine='xla' (full square) or "
            "'pallas_symm_packed' (packed triangle)")
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from "
                         f"{', '.join(ENGINES + ('auto',))}")
    return engine


def resolve(precision, engine):
    """(precision, engine) with 'auto' looked up in the platform table
    (lam_tpu/platform.py); removed or unknown engine names raise."""
    check_engine(engine)
    row = platform.current()
    return (row.precision if precision == "auto" else precision,
            row.engine if engine == "auto" else engine)


@functools.partial(jax.jit, static_argnums=(0, 3))
def _matvec_chain_jit(matvec_dot, operand, p, repeats):
    def body(_, v):
        w = matvec_dot(operand, v)[0]
        return w / jnp.sqrt(jnp.vdot(w, w))

    return jax.lax.fori_loop(0, repeats, body, p)


class LinearOperator:
    """Base operator: anything with a matvec usable by cg_solve.

    Mirrors the role of the abstract solver interface
    (challenge/main/LAM/src/ConjugateGradient.hpp:9-28) at the layer this
    design actually varies: the matrix action, not the loop.
    """

    def __init__(self, matvec_dot_fn, operand, n, n_padded, vector_dtype):
        self._matvec_dot_fn = matvec_dot_fn
        self.operand = operand
        self.n = n
        self.n_padded = n_padded
        self.vector_dtype = vector_dtype

    def prepare_b(self, b):
        """Unpadded host/device vector -> padded device vector."""
        b = jnp.asarray(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, expected ({self.n},)")
        if self.n_padded != self.n:
            b = jnp.pad(b, (0, self.n_padded - self.n))
        return b

    def extract_x(self, x_padded):
        return x_padded[: self.n]

    def matvec(self, p_padded):
        return self._matvec_dot_fn(self.operand, p_padded)[0]

    def matvec_chain(self, p_padded, repeats):
        """repeats back-to-back matvecs in ONE device program (normalized
        each step to stay bounded) — for timing the gemv without paying
        per-call dispatch latency."""
        return _matvec_chain_jit(self._matvec_dot_fn, self.operand,
                                 p_padded, repeats)

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        return loop_fn(self._matvec_dot_fn, self.operand, b_padded,
                       max_iters, rel_error)

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        from lam_tpu.solver.cg import _cg_ir_loop
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32()); separate "
                "buffers would double the matrix footprint in HBM")
        return _cg_ir_loop(op32._matvec_dot_fn, self._matvec_dot_fn,
                           self.operand, b_padded,
                           max_iters, rel_error, max_cycles, inner_floor,
                           inv_diag32)

    def prepare_b_block(self, b_block):
        """(n, k) block of right-hand sides -> padded device array."""
        b = jnp.asarray(b_block, dtype=self.vector_dtype)
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(f"rhs block must be ({self.n}, k), "
                             f"got {b.shape}")
        if self.n_padded != self.n:
            b = jnp.pad(b, ((0, self.n_padded - self.n), (0, 0)))
        return b

    def run_cg_block(self, b_block_padded, max_iters, rel_error):
        from lam_tpu.solver.cg import _cg_block_loop
        mv = getattr(self, "_mv_block", None)
        if mv is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no block matvec")
        return _cg_block_loop(mv, self.operand, b_block_padded, max_iters,
                              rel_error)

    def diagonal(self):
        """Matrix diagonal in the vector dtype (for preconditioning).

        Operators that cannot provide one raise; matrix-free operators
        may override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a diagonal")

    def run_pcg(self, b_padded, max_iters, rel_error):
        from lam_tpu.solver.cg import _pcg_loop
        d = self.diagonal()
        # padded entries have d == 0; their residual is 0 anyway, so any
        # finite inverse works — use 1 to avoid inf*0
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
        return _pcg_loop(self._matvec_dot_fn, self.operand, b_padded,
                         inv_d, max_iters, rel_error)


class MatrixFreeOperator(LinearOperator):
    """Operator from an arbitrary matvec function (e.g. a stencil).

    Used by the heat-equation demo to apply the 5-point Laplacian without
    materializing the N^2 matrix — the reference app materializes nothing
    either, it just runs Jacobi sweeps (heat_equation.cpp:75-89); here the
    same system is solved by the CG engine (SURVEY.md §3.5 rebuild note).
    """

    def __init__(self, matvec_fn, operand, n, vector_dtype=jnp.float64):
        # No padding: matrix-free shapes are whatever the stencil wants.
        super().__init__(_wrap_matvec(matvec_fn), operand, n, n,
                         vector_dtype)


class DenseOperator(LinearOperator):
    """Device-resident dense matrix with a precision/storage selection.

    precision:
      'f64'  — f64 storage, XLA matvec. The default on every platform
               (lam_tpu/platform.py) and the correctness oracle.
      'f32'  — f32 storage and matvec. Inner engine of the
               mixed-precision solver.
      'df64' — the f64 matrix split into two f32 planes (hi + lo, the
               same 8 B/element as f64); matvecs in native f64. Its hi
               plane is the f32 view of precision='ir' on packed
               storage.
      'dfq'/'fq' — quantized packed storage (6 B/element).
    engine: 'xla' (full square) or 'pallas_symm_packed' (the packed
    lower triangle; its f32 walks run the Pallas kernel, ops/gemv.py).
    """

    def __init__(self, matvec_dot_fn, operand, n, n_padded, vector_dtype,
                 precision, engine):
        super().__init__(matvec_dot_fn, operand, n, n_padded, vector_dtype)
        self.precision = precision
        self.engine = engine

    @staticmethod
    def from_dense(a, precision="auto", engine="auto"):
        """Build from an (n, n) numpy/jax array (f64 source of truth).
        'auto' resolves through the platform table."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        check_engine(engine)
        if precision == "auto":
            precision = platform.current().precision
        if precision in ("dfq", "fq"):
            if engine not in ("auto", "pallas_symm_packed"):
                raise ValueError(
                    f"precision={precision!r} implies the packed "
                    f"symmetric engine; engine={engine!r} is not "
                    "combinable")
            if precision == "fq":
                return DenseOperator.from_dense_fq(a)
            return DenseOperator.from_dense_dfq(a)
        if engine == "auto":
            engine = platform.current().engine
        packed = engine == "pallas_symm_packed"
        if packed and precision == "f64":
            raise ValueError(
                "engine='pallas_symm_packed' stores f32, df64, dfq or fq "
                "planes; precision='f64' runs on engine='xla'")
        if packed and not _verifies_symmetric(a):
            raise ValueError(
                f"engine={engine!r} requires a symmetric matrix (the "
                "lower-triangle walk mirrors A's lower half); the "
                "random-vector check found A v != A^T v — use "
                "engine='xla'")

        tb = gemv.SYMM_TB
        pad = padded_size(n, tb) if packed else n
        a = np.asarray(a, dtype=np.float64)
        if pad != n:
            a_p = np.zeros((pad, pad), dtype=np.float64)
            a_p[:n, :n] = a
            a = a_p

        if precision == "f64":
            operand = jnp.asarray(a, dtype=jnp.float64)
            vdtype = jnp.float64
        elif precision == "f32":
            a32 = a.astype(np.float32)
            if packed:
                a32 = gemv.pack_tri_host(a32, tb)
            operand = jnp.asarray(a32)
            vdtype = jnp.float32
        elif precision == "df64":
            hi, lo = split_f64_host(a)
            if packed:
                hi = gemv.pack_tri_host(hi, tb)
                lo = gemv.pack_tri_host(lo, tb)
            operand = (jnp.asarray(hi), jnp.asarray(lo))
            vdtype = jnp.float64
        else:
            raise ValueError(f"unknown precision {precision!r}")

        fn = _MATVEC_DOT[(precision, engine)]
        out = DenseOperator(fn, operand, n, pad, vdtype, precision, engine)
        if not packed:
            # block matvec = matmul on the same operand; the XLA variant
            # handles (n, k) blocks for every precision's storage layout
            out._mv_block = MATVEC[(precision, "xla")]
        else:
            # packed layout has no plain-matmul form — use the einsum
            # triangle walk (same f64 accuracy class as the xla variant)
            out._mv_block = _MV_BLOCK_PACKED[precision]
        return out

    @staticmethod
    def from_device(a, n):
        """f64 or f32 operator over a device-resident (n, n) array (the
        gen-mode build, where the matrix never exists on the host)."""
        precision = {jnp.float64: "f64", jnp.float32: "f32"}[
            jnp.dtype(a.dtype).type]
        out = DenseOperator(_MATVEC_DOT[(precision, "xla")], a, n, n,
                            a.dtype, precision, "xla")
        out._mv_block = MATVEC[(precision, "xla")]
        return out

    @staticmethod
    def _host_pack_tri(a, storage, tb):
        """Streaming host pack of a symmetric f64 matrix (`a` may be a
        np.memmap) into the quantized packed-triangle buffers, in the
        operand order of `_native_io.pack_{storage}` — the shared
        fallback behind from_dense_dfq/from_dense_fq and the
        from_file_* constructors when the native library is absent.
        Peak host memory is the packed buffers plus one (tb, i*tb) row
        block; the diagonal is extracted as an exact df64 pair and
        zeroed before quantization."""
        n = a.shape[0]
        n_p = padded_size(n, tb)
        nblk = n_p // tb
        T = gemv.tri_tile_count(nblk)
        # fq planes pad to a multiple of Q16_P walk tiles (all-zero
        # tiles, zero scales; the storage format of ops/gemv.py)
        Ts = gemv.padded_tri_tile_count(nblk) if storage == "fq" else T
        dtypes, n_scales = QUANT_LAYOUT[storage]
        planes = [np.empty((Ts * tb, tb), dt) for dt in dtypes]
        scales = [np.zeros((Ts,), np.float32) for _ in range(n_scales)]
        for plane in planes:
            plane[T * tb:] = 0
        dh = np.zeros((n_p,), np.float32)
        dl = np.zeros((n_p,), np.float32)
        t = 0
        for i in range(nblk):
            r0, r1 = i * tb, min((i + 1) * tb, n)
            width = (i + 1) * tb
            cw = min(width, n)
            blk = np.zeros((tb, width), np.float64)
            if r1 > r0:
                blk[:r1 - r0, :cw] = a[r0:r1, :cw]
                rr = np.arange(r1 - r0)
                dvals = blk[rr, r0 + rr].copy()
                dhi = dvals.astype(np.float32)
                dh[r0:r1] = dhi
                dl[r0:r1] = (dvals - dhi.astype(np.float64)).astype(
                    np.float32)
                blk[rr, r0 + rr] = 0.0
            for k in range(i + 1):
                out = quantize_storage_tiles(
                    storage, blk[:, k * tb:(k + 1) * tb], tb)
                for plane, val in zip(planes, out[:len(planes)]):
                    plane[t * tb:(t + 1) * tb] = val
                for sc, val in zip(scales, out[len(planes):]):
                    sc[t] = val[0]
                t += 1
        return (*planes, *scales, dh, dl)

    @staticmethod
    def _host_pack_planes(a, precision, tb):
        """Streaming host pack of a symmetric f64 matrix (`a` may be a
        np.memmap) into the UNQUANTIZED packed-triangle f32 plane(s) of
        from_dense with engine='pallas_symm_packed' — 'f32' (one plane)
        or 'df64' (hi, lo pair). Unlike _host_pack_tri the diagonal
        stays in the plane and there are no scales. Bit-identical to
        from_dense's astype/split + pack_tri_host, but peak host memory
        is the plane(s) plus one (tb, i*tb) row block — never the full
        f64 square (20 GB at N=50000)."""
        n = a.shape[0]
        n_p = padded_size(n, tb)
        nblk = n_p // tb
        T = gemv.tri_tile_count(nblk)
        hi = np.empty((T * tb, tb), np.float32)
        lo = (np.empty((T * tb, tb), np.float32)
              if precision == "df64" else None)
        t = 0
        for i in range(nblk):
            r0, r1 = i * tb, min((i + 1) * tb, n)
            width = (i + 1) * tb
            cw = min(width, n)
            blk = np.zeros((tb, width), np.float64)
            if r1 > r0:
                blk[:r1 - r0, :cw] = a[r0:r1, :cw]
            bh = blk.astype(np.float32)
            bl = ((blk - bh.astype(np.float64)).astype(np.float32)
                  if lo is not None else None)
            for k in range(i + 1):
                sl = slice(t * tb, (t + 1) * tb)
                hi[sl] = bh[:, k * tb:(k + 1) * tb]
                if lo is not None:
                    lo[sl] = bl[:, k * tb:(k + 1) * tb]
                t += 1
        return (hi,) if lo is None else (hi, lo)

    @staticmethod
    def _plane_operator(precision, bufs, n, n_padded):
        """DenseOperator over unquantized packed-triangle plane(s) —
        the engine='pallas_symm_packed' layouts of from_dense, built
        from _host_pack_planes / _native_io.pack_{f32,df64} /
        pack_cache.load buffers."""
        from lam_tpu.ops import transfer
        if precision == "f32":
            operand = transfer.to_device(bufs[0])
            vdtype = jnp.float32
        elif precision == "df64":
            operand = (transfer.to_device(bufs[0]),
                       transfer.to_device(bufs[1]))
            vdtype = jnp.float64
        else:
            raise ValueError(f"not a plane precision: {precision!r}")
        fn = _MATVEC_DOT[(precision, "pallas_symm_packed")]
        out = DenseOperator(fn, operand, n, n_padded, vdtype, precision,
                            "pallas_symm_packed")
        out._mv_block = _MV_BLOCK_PACKED[precision]
        return out

    @staticmethod
    def _packed_operator(storage, bufs, n, n_padded):
        """DenseOperator over packed quantized-triangle buffers (the
        order of `_host_pack_tri` / `_native_io.pack_*` /
        `pack_cache.load`). Host buffers upload CHUNKED
        (ops/transfer.py); device buffers pass through."""
        from lam_tpu.ops import transfer
        operand = tuple(transfer.to_device(b) for b in bufs)
        fn = _MATVEC_DOT[(storage, "pallas_symm_packed")]
        out = DenseOperator(fn, operand, n, n_padded, jnp.float64,
                            storage, "pallas_symm_packed")
        out._mv_block = _MV_BLOCK_PACKED[storage]
        return out

    @staticmethod
    def from_dense_dfq(a, check_symmetric=True):
        """Quantized-lo packed operator ("dfq"): hi plane f32 + lo plane
        int16 against per-tile power-of-two scales + the diagonal
        extracted as a df64 pair (~2^-48) = 6 bytes/element in the lower
        triangle (3/4 of
        the packed df64 pair, 3/8 of the reference's fp64 square). Built
        STREAMING by row-tile so the host never materializes full hi/lo
        planes — `a` may be a np.memmap; peak host memory is the packed
        buffers plus one (tb, n_p) row block.

        Accuracy: elementwise |A_stored - A| <= max|lo|_tile / 32767
        (~2^-39 * max|A|_tile); see ops/gemv.py `quantize_lo_tiles`. With
        iterative refinement against THIS operator (precision='irq'),
        true residuals land at the 1e-10 scale."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if check_symmetric and not _verifies_symmetric(a):
            raise ValueError(
                "precision='dfq' requires a symmetric matrix (the "
                "lower-triangle kernel mirrors A's lower half); the "
                "random-vector check found A v != A^T v")
        tb = gemv.SYMM_TB
        n_p = padded_size(n, tb)
        bufs = DenseOperator._host_pack_tri(a, "dfq", tb)
        return DenseOperator._packed_operator("dfq", bufs, n, n_p)

    @staticmethod
    def _pack_fq_streamed(path, data_off, n, n_p, tb):
        """Cold-path load pipeline: a worker thread runs the native fq
        range-pack (native/lam_native.cpp ln_pack_fq_range; the ctypes
        call drops the GIL) while the main thread folds every finished
        64 MB plane window to the device (ops/transfer.py Folder) —
        disk read, quantization, and upload overlap instead of running
        back-to-back. Returns (host buffers for pack_cache.save,
        device buffers in operand order)."""
        import threading

        import jax.numpy as jnp

        from lam_tpu import _native_io
        from lam_tpu.ops import transfer

        nblk = n_p // tb
        bufs = _native_io.alloc_fq_buffers(n_p, tb)
        q_planes = bufs[:3]
        # tile-balanced pack chunks: fine enough that uploads start
        # early, coarse enough that per-call overhead vanishes
        chunk_tiles = 512
        bounds = [0]
        acc = 0
        for i in range(nblk):
            acc += i + 1
            if acc >= chunk_tiles:
                bounds.append(i + 1)
                acc = 0
        if bounds[-1] != nblk:
            bounds.append(nblk)

        progress = {"rows": 0, "err": None}
        cv = threading.Condition()

        def worker():
            try:
                for a, b in zip(bounds, bounds[1:]):
                    _native_io.pack_fq_range(path, data_off, n, n_p,
                                             tb, a, b, bufs)
                    with cv:
                        progress["rows"] = b
                        cv.notify()
            except BaseException as e:  # re-raised by the main loop
                with cv:
                    progress["err"] = e
                    cv.notify()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        folders = [transfer.Folder(q.shape, q.dtype) for q in q_planes]
        done = 0
        try:
            while True:
                with cv:
                    while progress["rows"] == done \
                            and progress["err"] is None:
                        cv.wait(timeout=1.0)
                    if progress["err"] is not None:
                        raise progress["err"]
                    done = progress["rows"]
                if done == nblk:
                    avail = q_planes[0].shape[0]  # pads pre-zeroed
                else:
                    avail = (done * (done + 1) // 2) * tb
                for f, q in zip(folders, q_planes):
                    f.advance(q, avail)
                if done == nblk:
                    break
        finally:
            t.join(timeout=600)
        dev = (tuple(f.result() for f in folders)
               + tuple(jnp.asarray(b) for b in bufs[3:]))
        return bufs, dev

    @staticmethod
    def _from_file_packed(path, storage, check_symmetric, pack_cache):
        """Shared body of from_file_dfq / from_file_fq: open the matrix
        file (reference binary format, random_spd_system.cpp:114-116,
        or .npy), then produce the packed buffers from the cheapest
        available source, in order:

        1. the on-disk pack cache beside the file (pack_cache=True;
           solver/pack_cache.py — a raw read of the 3-8x-smaller packed
           planes, skipping the CPU-bound quantization entirely),
        2. the fused native C++ pack (native/lam_native.cpp ln_pack_*,
           reads only the lower-triangle bytes),
        3. the streaming numpy pack over the memory map.

        A fresh pack is published back to the cache when
        pack_cache=True (atomic, best-effort). Symmetry is trusted by
        default (CG's contract; the check costs two full passes over a
        multi-GB file)."""
        from lam_tpu import _native_io
        from lam_tpu.solver import pack_cache as pc

        path = str(path)
        # identity of the content about to be packed — taken BEFORE the
        # memmap binds to an inode, so an atomic replace in either
        # window (stat->open or open->pack) makes pack_cache.save's
        # re-stat mismatch and refuse to publish the stale planes
        src_stat = os.stat(path)
        a, data_off = _open_matrix_memmap(path)
        n = a.shape[0]
        if check_symmetric and not _verifies_symmetric(a):
            raise ValueError(
                f"precision='{storage}' requires a symmetric matrix "
                "(the lower-triangle kernel mirrors A's lower half); "
                "the random-vector check found A v != A^T v")
        tb = gemv.SYMM_TB
        n_p = padded_size(n, tb)
        quantized = storage in ("dfq", "fq")
        mk = (DenseOperator._packed_operator if quantized
              else DenseOperator._plane_operator)
        if pack_cache:
            # load_device streams each plane to the device DURING the
            # disk read (chunked upload + reader thread — the warm-path
            # load-wall fix, ops/transfer.py); mk()'s jnp.asarray is a
            # no-op on the returned device buffers
            hit = pc.load_device(path, storage)
            if hit is not None and hit[0] == n and hit[1] == n_p \
                    and hit[2] == tb:
                return mk(storage, hit[3], n, n_p)
        if (_native_io.available()
                and _native_io.has_range_pack(storage)):
            # cold-path pipeline: range-pack || chunked upload
            host_bufs, dev_bufs = DenseOperator._pack_fq_streamed(
                path, data_off, n, n_p, tb)
            if pack_cache:
                pc.save(path, storage, n, n_p, tb, host_bufs,
                        src_stat=src_stat)
            return mk(storage, dev_bufs, n, n_p)
        if _native_io.available() and _native_io.has_pack(storage):
            pack = getattr(_native_io, f"pack_{storage}")
            bufs = pack(path, data_off, n, n_p, tb)
        elif quantized:
            bufs = DenseOperator._host_pack_tri(a, storage, tb)
        else:
            bufs = DenseOperator._host_pack_planes(a, storage, tb)
        if pack_cache:
            pc.save(path, storage, n, n_p, tb, bufs, src_stat=src_stat)
        return mk(storage, bufs, n, n_p)

    @staticmethod
    def from_file_dfq(path, check_symmetric=False, pack_cache=False):
        """Quantized-lo packed operator straight from a matrix FILE —
        the reference binary format (16-byte header,
        random_spd_system.cpp:114-116) or a .npy. With the native
        library built (native/lam_native.cpp ln_pack_dfq) the pack is
        one fused C++ pass reading only the lower-triangle bytes (~half
        the disk traffic, no numpy temporaries); otherwise falls back
        to the streaming numpy pack over a memory map.
        pack_cache=True additionally publishes/reuses the packed planes
        beside the file (solver/pack_cache.py) so reloads skip the
        quantization pass."""
        return DenseOperator._from_file_packed(
            path, "dfq", check_symmetric, pack_cache)

    @staticmethod
    def from_dense_fq(a, check_symmetric=True):
        """FULLY-quantized packed operator ("fq"): the element is a
        cascade of THREE int16 planes against per-tile power-of-two
        scales (ops/gemv.py quantize_fq_tiles) + the diagonal extracted
        as a df64 pair — 6 bytes/element like dfq at ~2^-48
        tile-relative storage accuracy (better than dfq's 2^-39), and
        the INNER matvec of precision='irfq' reads only the first
        plane: 2 B/element, half the packed f32 inner walk's bytes
        (the triangle-walk kernel, ops/gemv.py). Built
        STREAMING by row-tile (`a` may be a np.memmap)."""
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        if check_symmetric and not _verifies_symmetric(a):
            raise ValueError(
                "precision='fq' requires a symmetric matrix (the "
                "lower-triangle kernel mirrors A's lower half); the "
                "random-vector check found A v != A^T v")
        tb = gemv.SYMM_TB
        n_p = padded_size(n, tb)
        bufs = DenseOperator._host_pack_tri(a, "fq", tb)
        return DenseOperator._packed_operator("fq", bufs, n, n_p)

    @staticmethod
    def from_file_fq(path, check_symmetric=False, pack_cache=False):
        """Fully-quantized packed operator straight from a matrix FILE
        (reference binary format or .npy) — the fq twin of
        from_file_dfq. With the native library built
        (native/lam_native.cpp ln_pack_fq) the triple-quantize is one
        fused C++ pass reading only the lower-triangle bytes; otherwise
        it streams a numpy pack over a memory map. Symmetry is trusted
        by default (CG's contract). pack_cache=True publishes/reuses
        the packed planes beside the file (solver/pack_cache.py)."""
        return DenseOperator._from_file_packed(
            path, "fq", check_symmetric, pack_cache)

    @staticmethod
    def from_file_fq_q1(path, pack_cache=True):
        """q1-ONLY fq operator for HOST-OUTER refinement
        (solver/host_outer.cg_solve_ir_host): upload just the buffers
        the irfq INNER matvec reads — the 2 B/element q1 plane, its
        scales, and the df64 diagonal pair (4.9 of the 14.7 GB at
        N=70000) — with q2/q3 riding as broadcast zero tiles (the
        from_gen_fq representation). On a transfer-bound link the
        operator is resident ~3x sooner; the outer residual is the
        host's job against the exact f64 source.

        The returned operator can ONLY serve as the inner engine
        (`.as_f32()` — reads operand[0, 3, 6]); its accurate matvec
        raises, because q2/q3 are zero and it would silently apply the
        ~2^-16-coarse q1 reconstruction as if it were the cascade.

        Warm path: partial read of the fq pack cache, seeking past
        q2/q3/s2/s3 (pack_cache.load_device_fq_q1). Cold path: native
        full pack (published back to the cache when pack_cache=True so
        the NEXT load is the partial read), then upload of the q1
        subset only."""
        from lam_tpu import _native_io
        from lam_tpu.ops import transfer
        from lam_tpu.solver import pack_cache as pc

        path = str(path)
        src_stat = os.stat(path)
        if pack_cache:
            hit = pc.load_device_fq_q1(path)
            if hit is not None:
                n, n_p, tb, (q1, s1, dh, dl) = hit
                return DenseOperator._q1_only_operator(
                    q1, s1, dh, dl, n, n_p, tb)
        a, data_off = _open_matrix_memmap(path)
        n = a.shape[0]
        tb = gemv.SYMM_TB
        n_p = padded_size(n, tb)
        if _native_io.available() and _native_io.has_pack("fq"):
            bufs = _native_io.pack_fq(path, data_off, n, n_p, tb)
        else:
            bufs = DenseOperator._host_pack_tri(a, "fq", tb)
        if pack_cache:
            pc.save(path, "fq", n, n_p, tb, bufs, src_stat=src_stat)
        q1, s1, dh, dl = (transfer.to_device(bufs[i])
                          for i in (0, 3, 6, 7))
        return DenseOperator._q1_only_operator(q1, s1, dh, dl, n, n_p, tb)

    @staticmethod
    def _q1_only_operator(q1, s1, dh, dl, n, n_p, tb):
        import jax.numpy as jnp
        zero_tile = jnp.zeros((tb, tb), jnp.int16)
        zero_sc = jnp.zeros(s1.shape, jnp.float32)
        operand = (q1, zero_tile, zero_tile, s1, zero_sc, zero_sc,
                   dh, dl)

        def _no_accurate_matvec(operand, p):
            raise NotImplementedError(
                "q1-only fq operator: the accurate cascade matvec is "
                "unavailable (q2/q3 were never loaded). Use .as_f32() "
                "as the inner engine of solver/host_outer."
                "cg_solve_ir_host, or load the full operator with "
                "DenseOperator.from_file_fq")

        out = DenseOperator(_no_accurate_matvec, operand, n, n_p,
                            jnp.float64, "fq", "pallas_symm_packed")
        return out

    @staticmethod
    def from_file_f32(path, check_symmetric=False, pack_cache=False):
        """f32 packed-triangle operator straight from a matrix FILE —
        the unquantized sibling of from_file_dfq/from_file_fq, for
        precision='f32'. Fused native convert (ln_pack_planes) reads
        only the lower-triangle bytes (~half the disk traffic, never
        the 8 B/element square in host RAM); pack_cache=True
        publishes/reuses the 4x-smaller f32 plane beside the file, so
        reloads are a raw sequential read that skips the f64->f32
        conversion. Symmetry is trusted by default (CG's contract;
        the check is two full passes over a multi-GB file)."""
        return DenseOperator._from_file_packed(
            path, "f32", check_symmetric, pack_cache)

    @staticmethod
    def from_file_df64(path, check_symmetric=False, pack_cache=False):
        """df64 (hi, lo) packed-triangle operator straight from a
        matrix FILE — the f64-parity storage of from_dense with
        engine='pallas_symm_packed', for precision='df64'/'ir'. Fused
        native split (ln_pack_planes) reads only the lower-triangle
        bytes; pack_cache=True publishes/reuses the plane pair beside
        the file (2x smaller than the source), so reloads skip the
        f64->(hi, lo) split. Symmetry is trusted by default (CG's
        contract)."""
        return DenseOperator._from_file_packed(
            path, "df64", check_symmetric, pack_cache)

    @staticmethod
    def from_packed_f32(a_packed, n, n_padded):
        """f32 operator from a PRE-PACKED walk-order triangle plane —
        the gen-mode device-build path for precision='f32' (entries
        {0,1,2} are exact in f32; the hi plane IS the matrix)."""
        fn = _MATVEC_DOT[("f32", "pallas_symm_packed")]
        out = DenseOperator(fn, jnp.asarray(a_packed, jnp.float32), n,
                            n_padded, jnp.float32, "f32",
                            "pallas_symm_packed")
        out._mv_block = _MV_BLOCK_PACKED["f32"]
        return out

    @staticmethod
    def from_gen_fq(q1, n, n_padded, diag_value=2.0):
        """fq operator from a PRE-PACKED walk-order int16 q1 plane whose
        quantization is EXACT (gen-mode tridiagonal: entries {0, 1}
        against the 2^-14 scale, diagonal extracted; see
        generate._tridiag_q1_packed_impl). The residual q2/q3 planes
        are exactly zero, represented as ONE broadcast (tb, tb) tile
        each — so gen-mode fq stores 2 B/element (vs 4 for the packed
        f32 gen pair) and `irfq` gen probes run beyond the f32 gen
        frontier on one chip. The diagonal rides as an exact df64 pair
        (constant `diag_value` on the first n entries)."""
        tb = gemv.SYMM_TB
        T = q1.shape[0] // tb
        dv = np.float32(diag_value)
        if float(dv) != float(diag_value):
            raise ValueError(f"diag_value {diag_value} is not exact "
                             "in f32 (the gen pair carries dl == 0)")
        idx = jnp.arange(n_padded)
        dh = jnp.where(idx < n, dv, np.float32(0.0)).astype(jnp.float32)
        dl = jnp.zeros((n_padded,), jnp.float32)
        zero_tile = jnp.zeros((tb, tb), jnp.int16)
        zero_sc = jnp.zeros((T,), jnp.float32)
        from lam_tpu import generate as gen
        s1 = jnp.full((T,), gen.TRIDIAG_Q1_SCALE, jnp.float32)
        operand = (jnp.asarray(q1), zero_tile, zero_tile,
                   s1, zero_sc, zero_sc, dh, dl)
        fn = _MATVEC_DOT[("fq", "pallas_symm_packed")]
        out = DenseOperator(fn, operand, n, n_padded, jnp.float64, "fq",
                            "pallas_symm_packed")
        out._mv_block = _MV_BLOCK_PACKED["fq"]
        return out

    @staticmethod
    def from_packed_planes(hi, lo, n, n_padded):
        """df64 operator from PRE-PACKED walk-order triangle planes
        ((T*tb, tb), ops/gemv.py pack_tri_host layout). `lo` may be a
        single (tb, tb) zero tile — the broadcast form for matrices
        whose entries are exact in f32 (gen-mode tridiagonal), which
        halves the pair's HBM footprint again. The caller asserts the
        planes represent a symmetric f64 matrix."""
        operand = (jnp.asarray(hi, jnp.float32),
                   jnp.asarray(lo, jnp.float32))
        fn = _MATVEC_DOT[("df64", "pallas_symm_packed")]
        out = DenseOperator(fn, operand, n, n_padded, jnp.float64,
                            "df64", "pallas_symm_packed")
        out._mv_block = _MV_BLOCK_PACKED["df64"]
        return out

    @staticmethod
    def from_df64_planes(hi, lo, n, engine):
        """Build a df64 operator from PRE-SPLIT, PRE-PADDED f32 planes.

        Fast-construction path for generators whose entries are exact
        in f32 (gen-mode tridiagonal: lo == 0, creatable device-side) —
        skips the f64 intermediate, symmetry check, pad copy, and host
        split of `from_dense`. The caller asserts the planes really
        represent the intended f64 matrix and (for engine='pallas_symm')
        that it is symmetric."""
        n_p = hi.shape[0]
        if hi.shape != (n_p, n_p) or lo.shape != (n_p, n_p):
            raise ValueError("planes must be square and equal-shaped")
        operand = (jnp.asarray(hi, jnp.float32),
                   jnp.asarray(lo, jnp.float32))
        fn = _MATVEC_DOT[("df64", engine)]
        out = DenseOperator(fn, operand, n, n_p, jnp.float64, "df64",
                            engine)
        out._mv_block = MATVEC[("df64", "xla")]
        return out

    def diagonal(self):
        if self.precision in ("dfq", "fq"):
            dh, dl = self.operand[-2], self.operand[-1]
            return dh.astype(jnp.float64) + dl.astype(jnp.float64)
        if self.engine == "pallas_symm_packed":
            if self.precision == "df64":
                hi, lo = self.operand
                return (_packed_diagonal(hi).astype(jnp.float64)
                        + _packed_diagonal(lo, like=hi)
                        .astype(jnp.float64))
            return _packed_diagonal(self.operand)
        if self.precision == "df64":
            hi, lo = self.operand
            return (jnp.diagonal(hi).astype(jnp.float64)
                    + jnp.diagonal(lo).astype(jnp.float64))
        return jnp.diagonal(self.operand)

    def as_f32(self):
        """Sibling f32-view operator SHARING this operator's device
        buffers (operand identity, not a cast copy) — required so the
        mixed-precision solver's jit program holds one set of matrix
        buffers. Used to pair with a df64/f64 operator for cg_solve_ir.
        """
        if self.precision == "f32":
            return self
        if self.precision == "df64":
            key = ("f32@df64", self.engine)
        elif self.precision in ("dfq", "fq"):
            key = (f"f32@{self.precision}", self.engine)
        else:
            key = ("f32@f64", "xla")
        out = DenseOperator(_MATVEC_DOT[key], self.operand, self.n,
                            self.n_padded, jnp.float32, "f32", self.engine)
        out._mv_local_key = key
        return out
