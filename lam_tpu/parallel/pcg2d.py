"""2-D (SUMMA-style) sharded CG — beyond the reference's 1-D decomposition.

Every reference backend splits A by block-ROWS only (SURVEY.md §2.3), so
the operand-vector exchange per matvec moves O(N) values per device
(Allgatherv of p / broadcast from rank 0), independent of device count.
On a 2-D R×R process grid with A in (N/R, N/R) blocks the exchange is a
single transpose ppermute of an N/R block plus a psum of an N/R block —
O(N/R) = O(N/sqrt(G)) per chip per iteration. That asymptotic is what
makes big meshes scale; the reference corpus's stress test
(N=560000 on 64 GPUs) is exactly the regime where 1-D row sharding's
O(N) exchange dominates.

Layout:
  * mesh: Mesh(devices[:R*R].reshape(R, R), ('rows', 'cols'))
  * A: P('rows', 'cols') — chip (i, j) holds block A_ij of (n/R, n/R)
  * vectors: P('rows') — sharded over rows, REPLICATED over cols, so all
    vector algebra is local and dots psum over 'rows' only
  * matvec: chip (i, j) needs p-block j but holds block i — ONE
    transpose ppermute (i, j) <- (j, i) delivers it; local gemv with the
    resident Pallas kernels; psum over 'cols' re-replicates y
  * whole CG loop (and the mixed-precision refinement twin) inside one
    shard_map program, reusing the 1-D module's local loop builders
    (lam_tpu/parallel/pcg.py) with apply = the 2-D matvec.

Square grids only (R = isqrt(G)): the transpose exchange needs
n/R == n/C. Non-square device counts fall back to the 1-D program.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lam_tpu.parallel.pcg import (
    ShardedDenseOperator,
    _make_local_cg,
    _make_local_ir,
    _make_local_pcg,
    shard_map,
)
from lam_tpu.solver.cg import CGResult
from lam_tpu.solver.operators import (
    MATVEC,
    LinearOperator,
    padded_size,
    df64_plane_provider,
)

ROWS, COLS = "rows", "cols"
AXES = (ROWS, COLS)


def make_mesh2d(r=None):
    """R x R mesh over the first R^2 devices (default: largest square).

    The grid is square by construction — the per-iteration transpose
    exchange is the permutation chip (i, j) <- (j, i), which only
    exists on a square grid. When the default drops devices (e.g. 8
    devices -> 2x2 grid, 4 idle) that is said OUT LOUD on stderr so a
    user who meant to use all chips picks the 1-D backend instead."""
    import sys

    devices = jax.devices()
    if r is None:
        r = math.isqrt(len(devices))
        if r * r < len(devices):
            print(f"lam-cg: 2-D grid uses the largest square: "
                  f"{r}x{r} = {r * r} of {len(devices)} devices "
                  f"({len(devices) - r * r} idle; the 1-D sharded "
                  f"backend uses all devices)", file=sys.stderr)
    if r * r > len(devices):
        raise ValueError(f"need {r * r} devices for a {r}x{r} grid, "
                         f"have {len(devices)}")
    return Mesh(np.array(devices[: r * r]).reshape(r, r), AXES)


def _transpose_perm(r):
    # chip (i, j) receives from (j, i); linear index = i * r + j
    return [(i * r + j, j * r + i) for i in range(r) for j in range(r)]


def _make_apply2d(matvec_local, r):
    perm = _transpose_perm(r)

    def apply(operand, p_blk):
        # p is P('rows'): chip (i, j) holds block i; the local gemv
        # against A_ij needs block j -> one transpose exchange
        pj = jax.lax.ppermute(p_blk, AXES, perm)
        y = matvec_local(operand, pj)
        return jax.lax.psum(y, COLS)

    return apply


def _operand_spec2d(is_pair):
    spec = P(ROWS, COLS)
    return (spec, spec) if is_pair else spec


@functools.lru_cache(maxsize=None)
def _build_2d_cg(matvec_local, mesh, is_pair):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply2d(matvec_local, r)
    mapped = shard_map(
        _make_local_cg(apply_fn, ROWS),
        mesh=mesh,
        in_specs=(_operand_spec2d(is_pair), P(ROWS), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_2d_cg_ir(mv32, mv_acc, mesh, acc_is_pair, max_cycles,
                    precond=False):
    r = mesh.shape[ROWS]
    apply32 = _make_apply2d(mv32, r)
    apply_acc = _make_apply2d(mv_acc, r)
    vec_specs = ((P(ROWS), P(ROWS)) if precond else (P(ROWS),))
    mapped = shard_map(
        _make_local_ir(apply32, apply_acc, ROWS, max_cycles,
                       precond=precond),
        mesh=mesh,
        in_specs=(_operand_spec2d(acc_is_pair),) + vec_specs
                 + (P(), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_2d_pcg(matvec_local, mesh, is_pair):
    r = mesh.shape[ROWS]
    apply_fn = _make_apply2d(matvec_local, r)
    mapped = shard_map(
        _make_local_pcg(apply_fn, ROWS),
        mesh=mesh,
        in_specs=(_operand_spec2d(is_pair), P(ROWS), P(ROWS), P(), P()),
        out_specs=CGResult(x=P(ROWS), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_2d_matvec(matvec_local, mesh, is_pair):
    apply_fn = _make_apply2d(matvec_local, mesh.shape[ROWS])
    mapped = shard_map(apply_fn, mesh=mesh,
                       in_specs=(_operand_spec2d(is_pair), P(ROWS)),
                       out_specs=P(ROWS), check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_2d_chain(matvec_local, mesh, is_pair, repeats):
    """`repeats` back-to-back transpose-ppermute matvecs in ONE device
    program — the 2-D twin of LinearOperator.matvec_chain, so the CSV
    avg_gemv column times the REAL solve matvec (ppermute + local gemv
    + psum), not the generic GSPMD matmul the base class would time."""
    r = mesh.shape[ROWS]
    apply_fn = _make_apply2d(matvec_local, r)

    def local(operand, p):
        def body(_, v):
            w = apply_fn(operand, v)
            nrm = jnp.sqrt(jax.lax.psum(jnp.vdot(w, w), ROWS))
            return w / nrm

        return jax.lax.fori_loop(0, repeats, body, p)

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(_operand_spec2d(is_pair), P(ROWS)),
                       out_specs=P(ROWS), check_vma=False)
    return jax.jit(mapped)


class Sharded2DOperator(LinearOperator):
    """Dense SPD matrix in (n/R, n/R) blocks over an R x R mesh."""

    def __init__(self, operand, n, n_padded, vector_dtype, precision,
                 engine, mesh):
        from lam_tpu.solver.operators import _MATVEC_DOT
        super().__init__(_MATVEC_DOT[(precision, "xla")], operand, n,
                         n_padded, vector_dtype)
        self.precision = precision
        self.engine = engine
        self.mesh = mesh
        self._mv_local = MATVEC[(precision, engine)]
        self._b_sharding = NamedSharding(mesh, P(ROWS))
        # multi-RHS block matvec under GSPMD (see 1-D operator note)
        self._mv_block = MATVEC[(precision, "xla")]

    @staticmethod
    def block_padded_size(n, mesh):
        return padded_size(n, mesh.shape[ROWS])

    @staticmethod
    def from_block_fn(block_fn, n, mesh=None, precision="auto",
                      engine="auto"):
        """block_fn(row_start, col_start, rows, cols) -> f64 block of the
        UNPADDED matrix (the 2-D analog of the per-rank MPI-IO read)."""
        if mesh is None:
            mesh = make_mesh2d()
        precision, engine = ShardedDenseOperator._resolve(precision, engine)

        n_p = Sharded2DOperator.block_padded_size(n, mesh)
        a_sharding = NamedSharding(mesh, P(ROWS, COLS))

        def padded_block(r0, c0, h, w):
            src_h = max(0, min(n - r0, h))
            src_w = max(0, min(n - c0, w))
            block = np.zeros((h, w), dtype=np.float64)
            if src_h > 0 and src_w > 0:
                block[:src_h, :src_w] = block_fn(r0, c0, src_h, src_w)
            return block

        def make(transform):
            def cb(idx):
                r0 = idx[0].start or 0
                c0 = idx[1].start or 0
                h = (idx[0].stop or n_p) - r0
                w = (idx[1].stop or n_p) - c0
                return transform(padded_block(r0, c0, h, w))

            return jax.make_array_from_callback((n_p, n_p), a_sharding,
                                                cb)

        if precision == "f64":
            operand = make(lambda b: b)
            vdtype = jnp.float64
        elif precision == "f32":
            operand = make(lambda b: b.astype(np.float32))
            vdtype = jnp.float32
        elif precision == "df64":
            def block_for(key):
                r0, c0, h, w = key
                return padded_block(r0, c0, h, w)

            plane = df64_plane_provider(block_for)

            def mk(idx):
                def cb(slices):
                    r0 = slices[0].start or 0
                    c0 = slices[1].start or 0
                    h = (slices[0].stop or n_p) - r0
                    w = (slices[1].stop or n_p) - c0
                    return plane((r0, c0, h, w), idx)

                return jax.make_array_from_callback((n_p, n_p),
                                                    a_sharding, cb)

            operand = (mk(0), mk(1))
            vdtype = jnp.float64
        else:
            raise ValueError(f"unknown precision {precision!r}")

        return Sharded2DOperator(operand, n, n_p, vdtype, precision,
                                 engine, mesh)

    @staticmethod
    def from_dense(a, mesh=None, precision="auto", engine="auto"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        return Sharded2DOperator.from_block_fn(
            lambda r0, c0, h, w: a[r0:r0 + h, c0:c0 + w], n, mesh=mesh,
            precision=precision, engine=engine)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, precision="auto",
                             engine="auto"):
        """Gen-mode tridiagonal built ON DEVICE for the 2-D grid: the
        (n_p, n_p) hi plane is one fused elementwise program that XLA
        writes shard-by-shard into each owner's memory (out_shardings),
        in the storage precision (the df64 pair's lo plane is exact
        zeros) — no host build or transfer."""
        from lam_tpu import generate as gen
        if mesh is None:
            mesh = make_mesh2d()
        precision, engine = ShardedDenseOperator._resolve(precision, engine)
        n_p = Sharded2DOperator.block_padded_size(n, mesh)
        a_sharding = NamedSharding(mesh, P(ROWS, COLS))
        dtype = "float64" if precision == "f64" else "float32"
        hi = jax.jit(gen._tridiag_hi_device_impl, static_argnums=(0, 1, 2),
                     out_shardings=a_sharding)(n, n_p, dtype)
        if precision in ("f32", "f64"):
            return Sharded2DOperator(hi, n, n_p, hi.dtype, precision,
                                     engine, mesh)
        lo = jax.jit(lambda: jnp.zeros((n_p, n_p), jnp.float32),
                     out_shardings=a_sharding)()
        return Sharded2DOperator((hi, lo), n, n_p, jnp.float64, "df64",
                                 engine, mesh)

    @staticmethod
    def from_file(path, mesh=None, precision="auto", engine="auto"):
        from lam_tpu import io as lio
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")

        def block(r0, c0, h, w):
            # column-windowed read: only the block's bytes touch disk
            return lio.read_matrix_block(path, r0, c0, h, w)

        return Sharded2DOperator.from_block_fn(
            block, rows, mesh=mesh, precision=precision, engine=engine)

    # -- solve path ----------------------------------------------------------

    def prepare_b(self, b):
        b = np.asarray(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, expected "
                             f"({self.n},)")
        if self.n_padded != self.n:
            b = np.pad(b, (0, self.n_padded - self.n))
        # callback placement: multi-process-safe (see 1-D operator note)
        return jax.make_array_from_callback(
            b.shape, self._b_sharding, lambda idx: b[idx])

    def matvec(self, p_padded):
        fn = _build_2d_matvec(self._mv_local, self.mesh,
                              self.precision == "df64")
        return fn(self.operand, p_padded)

    def matvec_chain(self, p_padded, repeats):
        fn = _build_2d_chain(self._mv_local, self.mesh,
                             self.precision == "df64", repeats)
        return fn(self.operand, p_padded)

    def prepare_b_block(self, b_block):
        b = np.asarray(b_block, dtype=self.vector_dtype)
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(f"rhs block must be ({self.n}, k), "
                             f"got {b.shape}")
        if self.n_padded != self.n:
            b = np.pad(b, ((0, self.n_padded - self.n), (0, 0)))
        return jax.make_array_from_callback(
            b.shape, NamedSharding(self.mesh, P(ROWS, None)),
            lambda idx: b[idx])

    def diagonal(self):
        """Shard-local diagonal: chip (i, j) holds block A_ij, so only
        the diagonal chips (i == j) contribute; a psum over COLS
        re-replicates each row-shard's piece across its grid row."""
        is_pair = self.precision == "df64"
        vdtype = self.vector_dtype

        def local_diag(operand):
            i = jax.lax.axis_index(ROWS)
            j = jax.lax.axis_index(COLS)

            def diag_of(a):
                if is_pair:
                    hi, lo = a
                    d = (jnp.diagonal(hi).astype(jnp.float64)
                         + jnp.diagonal(lo).astype(jnp.float64))
                else:
                    d = jnp.diagonal(a).astype(vdtype)
                return jnp.where(i == j, d, jnp.zeros_like(d))

            return jax.lax.psum(diag_of(operand), COLS)

        mapped = shard_map(
            local_diag, mesh=self.mesh,
            in_specs=(_operand_spec2d(is_pair),),
            out_specs=P(ROWS), check_vma=False)
        return jax.jit(mapped)(self.operand)

    def run_pcg(self, b_padded, max_iters, rel_error):
        d = self.diagonal()
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
        solver = _build_2d_pcg(self._mv_local, self.mesh,
                               self.precision == "df64")
        return solver(self.operand, b_padded, inv_d, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        del loop_fn
        solver = _build_2d_cg(self._mv_local, self.mesh,
                              self.precision == "df64")
        return solver(self.operand, b_padded, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32())")
        solver = _build_2d_cg_ir(op32._mv_local, self._mv_local,
                                 self.mesh, self.precision == "df64",
                                 max_cycles,
                                 precond=inv_diag32 is not None)
        vec_args = ((b_padded, inv_diag32) if inv_diag32 is not None
                    else (b_padded,))
        return solver(self.operand, *vec_args, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype),
                      jnp.asarray(inner_floor, b_padded.dtype))

    def as_f32(self):
        if self.precision == "f32":
            return self
        key = (f"f32@{self.precision}", "xla")
        out = Sharded2DOperator(self.operand, self.n, self.n_padded,
                                jnp.float32, "f32", self.engine,
                                self.mesh)
        out._mv_local = MATVEC[key]
        from lam_tpu.solver.operators import _MATVEC_DOT
        out._matvec_dot_fn = _MATVEC_DOT[key]
        return out
