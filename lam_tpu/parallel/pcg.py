"""Sharded CG: one mesh program replacing four reference backends.

The reference implements distributed CG four times (single-node multi-GPU
P2P, CUDA-aware MPI, NCCL, CPU MPI+OpenMP — SURVEY.md §2.3), all with the
same 1-D row decomposition and, on the GPU paths, a rank-0 bottleneck:
every iteration broadcasts p from rank 0, gathers partial Ap back to rank
0, and runs ALL vector algebra on rank 0's device alone
(ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:355-396).

Here the entire solve is ONE `shard_map` program over a 1-D mesh:

  * A row-sharded P('rows', None); x/r/p/b row-sharded P('rows').
  * matvec: all_gather(p) (the dual of the reference's Allgatherv on
    Ap, ConjugateGradient_CPU_MPI_OMP.hpp:505) then the local XLA
    matvec on the shard's row-block.
  * dot products: local partial + lax.psum — replacing MPI_Allreduce
    (CPU_MPI_OMP.hpp:464) and the NCCL send/recv gather (..._NCCL.cu:365-372).
  * vector updates: local on every shard. No rank-0 serialization; every
    chip computes 1/G of everything.
  * the whole while_loop lives on-device: no per-iteration host sync, no
    MPI_Bcast(stop) control plane (..._NCCL.cu:407).

Per-iteration communication: 1 all-gather of p (N values) + 2 scalar
psums, vs. the reference GPU backends' broadcast(N) + gather(N) + bcast(1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from lam_tpu.parallel.mesh import ROWS_AXIS, make_mesh
from lam_tpu.solver.cg import CGResult
from lam_tpu.solver.operators import (
    MATVEC,
    MATVEC_COLS,
    LinearOperator,
    padded_size,
    df64_plane_provider,
    resolve,
)

shard_map = jax.shard_map


def _operand_spec(axis, is_pair):
    spec = P(axis, None)
    return (spec, spec) if is_pair else spec


def _make_apply(matvec_local, matvec_cols, axis, comm, g):
    """Per-shard distributed matvec: LOCAL p row-block -> LOCAL Ap block.

    comm='gather': all_gather(p), then one local gemv over the
      full row-stripe — the simple program; XLA must finish the gather
      before any multiply starts.
    comm='ring': G steps of (partial gemv on the currently-held p block
      against the matching COLUMN stripe of the local A) interleaved with
      ppermute of the p block to the ring neighbor — compute hides the
      transfer (SURVEY.md §7 stage 6; the same pipelining shape as ring
      attention). Same total comm volume ((G-1)/G of p per chip), but no
      serialization of gather before gemv. The column stripe is a
      dynamic slice of the local row block.
    """
    if comm == "gather" or g == 1:

        def apply(operand, p_local):
            p_full = jax.lax.all_gather(p_local, axis, tiled=True)
            return matvec_local(operand, p_full)

        return apply

    if comm != "ring":
        raise ValueError(f"unknown comm strategy {comm!r}")
    perm = [(i, (i - 1) % g) for i in range(g)]

    def apply(operand, p_local):
        idx = jax.lax.axis_index(axis)

        def step(s, carry):
            # issue the permute of the block for the NEXT step BEFORE
            # the gemv that consumes the current block: the transfer has
            # no data dependence on the in-flight multiply, so the
            # scheduler can run them concurrently (permute-then-multiply
            # would chain them: g*(t_mv + t_comm) instead of
            # ~g*max(t_mv, t_comm))
            acc, pblk = carry
            nxt = jax.lax.ppermute(pblk, axis, perm)
            src = jax.lax.rem(idx + s, jnp.int32(g))
            return acc + matvec_cols(operand, pblk, src), nxt

        zero = jnp.zeros_like(p_local)  # matvec output dtype == p dtype
        acc, last = jax.lax.fori_loop(0, g - 1, step, (zero, p_local))
        # last block: no further permute needed
        src = jax.lax.rem(idx + jnp.int32(g - 1), jnp.int32(g))
        return acc + matvec_cols(operand, last, src)

    return apply


def _make_local_cg(apply_fn, axis, apply_dot_fn=None):
    """Per-shard CG loop body (runs inside shard_map).

    b, x, r, p are the LOCAL row-blocks; dots are psum'd; the matvec is
    `apply_fn` (gather- or ring-composed, `_make_apply`). Reused by both
    the plain solver and the mixed-precision refinement program.
    apply_dot_fn, when given, returns (ap_local, local p.Ap partial) —
    for matvecs that fuse the dot in-kernel (the heat stencil); the
    loop then psums the partial instead of re-reading p and ap."""

    def local_loop(operand, b, max_iters, rel_error):
        def pdot(u, v):
            return jax.lax.psum(jnp.vdot(u, v), axis)

        dtype = b.dtype
        eps = jnp.asarray(rel_error, dtype)
        bb = pdot(b, b)
        x0 = jnp.zeros_like(b)

        def cond(carry):
            _, _, _, rr, k = carry
            return jnp.logical_and(k < max_iters,
                                   jnp.sqrt(rr / bb) >= eps)

        def body(carry):
            x, r, p, rr, k = carry
            if apply_dot_fn is not None:
                ap, pap_local = apply_dot_fn(operand, p)
                pap = jax.lax.psum(pap_local, axis)
            else:
                ap = apply_fn(operand, p)
                pap = pdot(p, ap)
            alpha = rr / pap
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = pdot(r, r)
            beta = rr_new / rr
            p = r + beta * p
            return (x, r, p, rr_new, k + 1)

        init = (x0, b, b, bb, jnp.int32(0))
        x, _, _, rr, k = jax.lax.while_loop(cond, body, init)
        rel = jnp.sqrt(rr / bb)
        converged = rel < eps
        num_iters = jnp.where(converged, k, max_iters).astype(jnp.int32)
        return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                        converged=converged)

    return local_loop


@functools.lru_cache(maxsize=None)
def _build_sharded_cg(matvec_local, matvec_cols, mesh, axis,
                      operand_is_pair, comm):
    """Compile-once factory for the sharded CG program."""
    g = mesh.shape[axis]
    apply_fn = _make_apply(matvec_local, matvec_cols, axis, comm, g)
    mapped = shard_map(
        _make_local_cg(apply_fn, axis),
        mesh=mesh,
        in_specs=(_operand_spec(axis, operand_is_pair), P(axis), P(), P()),
        out_specs=CGResult(x=P(axis), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _make_local_pcg(apply_fn, axis):
    """Per-shard Jacobi-preconditioned CG loop body (the sharded twin of
    lam_tpu/solver/cg.py:_pcg_loop). inv_diag arrives as the LOCAL
    row-block — preconditioning is elementwise, so it needs no
    communication at all; only the dots psum."""

    def local_loop(operand, b, inv_diag, max_iters, rel_error):
        def pdot(u, v):
            return jax.lax.psum(jnp.vdot(u, v), axis)

        dtype = b.dtype
        eps = jnp.asarray(rel_error, dtype)
        bb = pdot(b, b)
        x0 = jnp.zeros_like(b)
        z0 = inv_diag * b

        def cond(carry):
            _, _, _, _, rr, k = carry
            return jnp.logical_and(k < max_iters,
                                   jnp.sqrt(rr / bb) >= eps)

        def body(carry):
            x, r, p, rz, rr, k = carry
            ap = apply_fn(operand, p)
            alpha = rz / pdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = inv_diag * r
            rz_new = pdot(r, z)
            rr_new = pdot(r, r)
            beta = rz_new / rz
            p = z + beta * p
            return (x, r, p, rz_new, rr_new, k + 1)

        init = (x0, b, z0, pdot(b, z0), bb, jnp.int32(0))
        x, _, _, _, rr, k = jax.lax.while_loop(cond, body, init)
        rel = jnp.sqrt(rr / bb)
        converged = rel < eps
        num_iters = jnp.where(converged, k, max_iters).astype(jnp.int32)
        return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                        converged=converged)

    return local_loop


@functools.lru_cache(maxsize=None)
def _build_sharded_pcg(matvec_local, matvec_cols, mesh, axis,
                       operand_is_pair, comm):
    g = mesh.shape[axis]
    apply_fn = _make_apply(matvec_local, matvec_cols, axis, comm, g)
    mapped = shard_map(
        _make_local_pcg(apply_fn, axis),
        mesh=mesh,
        in_specs=(_operand_spec(axis, operand_is_pair), P(axis), P(axis),
                  P(), P()),
        out_specs=CGResult(x=P(axis), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _make_local_ir(apply32, apply_acc, axis, max_cycles,
                   apply32_dot=None, precond=False):
    """Per-shard mixed-precision refinement program: the sharded twin of
    lam_tpu/solver/cg.py:_cg_ir_loop — outer f64 true-residual loop,
    inner f32 sharded CG. Both matvecs read ONE shared operand (the f32
    view uses the hi plane). `axis` is the axis (or axes) the VECTORS
    are sharded over — dots psum over it; the matvecs' own collectives
    live inside apply32/apply_acc.

    precond=True Jacobi-preconditions the INNER loop: the returned
    program takes an extra inv_diag argument (local row-block, sharded
    like the vectors) right after b; the outer recurrence is unchanged
    (same contract as _cg_ir_loop's inv_diag32)."""

    inner_cg = _make_local_cg(apply32, axis, apply_dot_fn=apply32_dot)
    inner_pcg = _make_local_pcg(apply32, axis) if precond else None

    def ir_body(operand, b, inv_diag, max_iters, rel_error, inner_floor):
        def pdot(u, v):
            return jax.lax.psum(jnp.vdot(u, v), axis)

        dtype = b.dtype
        bb = pdot(b, b)
        eps = jnp.asarray(rel_error, dtype)
        x0 = jnp.zeros_like(b)
        # scalar-or-schedule contract of _cg_ir_loop (solver/cg.py):
        # cycle c uses floors[min(c, len-1)]
        floors = jnp.atleast_1d(jnp.asarray(inner_floor, dtype))

        def rel_of(r):
            return jnp.sqrt(pdot(r, r) / bb)

        def cond(carry):
            _, r, k, cyc = carry
            return jnp.logical_and(
                jnp.logical_and(k < max_iters, cyc < max_cycles),
                rel_of(r) >= eps)

        def body(carry):
            x, r, k, cyc = carry
            rnorm = jnp.sqrt(pdot(r, r))
            rel = rnorm / jnp.sqrt(bb)
            floor = floors[jnp.minimum(cyc, floors.shape[0] - 1)]
            inner_tol = jnp.clip(eps / rel, floor, 0.99)
            r32 = (r / rnorm).astype(jnp.float32)
            if precond:
                inner = inner_pcg(operand, r32, inv_diag, max_iters - k,
                                  inner_tol.astype(jnp.float32))
            else:
                inner = inner_cg(operand, r32, max_iters - k,
                                 inner_tol.astype(jnp.float32))
            x = x + inner.x.astype(dtype) * rnorm
            r = b - apply_acc(operand, x)
            return (x, r, k + inner.num_iters, cyc + 1)

        x, r, k, _ = jax.lax.while_loop(
            cond, body, (x0, b, jnp.int32(0), jnp.int32(0)))
        rel = rel_of(r)
        return CGResult(x=x, num_iters=k, rel_residual=rel,
                        converged=rel < eps)

    if precond:
        def local_ir(operand, b, inv_diag, max_iters, rel_error,
                     inner_floor):
            return ir_body(operand, b, inv_diag, max_iters, rel_error,
                           inner_floor)
    else:
        def local_ir(operand, b, max_iters, rel_error, inner_floor):
            return ir_body(operand, b, None, max_iters, rel_error,
                           inner_floor)

    return local_ir


@functools.lru_cache(maxsize=None)
def _build_sharded_cg_ir(mv32, mv_acc, cols32, cols_acc, mesh, axis,
                         acc_is_pair, comm, max_cycles, precond=False):
    g = mesh.shape[axis]
    apply32 = _make_apply(mv32, cols32, axis, comm, g)
    apply_acc = _make_apply(mv_acc, cols_acc, axis, comm, g)
    vec_specs = ((P(axis), P(axis)) if precond else (P(axis),))
    mapped = shard_map(
        _make_local_ir(apply32, apply_acc, axis, max_cycles,
                       precond=precond),
        mesh=mesh,
        in_specs=(_operand_spec(axis, acc_is_pair),)
                 + vec_specs + (P(), P(), P()),
        out_specs=CGResult(x=P(axis), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sharded_matvec(matvec_local, matvec_cols, mesh, axis,
                          operand_is_pair, comm):
    apply_fn = _make_apply(matvec_local, matvec_cols, axis, comm,
                           mesh.shape[axis])
    mapped = shard_map(apply_fn, mesh=mesh,
                       in_specs=(_operand_spec(axis, operand_is_pair),
                                 P(axis)),
                       out_specs=P(axis), check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_sharded_chain(matvec_local, matvec_cols, mesh, axis,
                         operand_is_pair, comm, repeats):
    apply_fn = _make_apply(matvec_local, matvec_cols, axis, comm,
                           mesh.shape[axis])

    def local(operand, p_local):
        def body(_, v):
            w = apply_fn(operand, v)
            nrm = jnp.sqrt(jax.lax.psum(jnp.vdot(w, w), axis))
            return w / nrm

        return jax.lax.fori_loop(0, repeats, body, p_local)

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(_operand_spec(axis, operand_is_pair),
                                 P(axis)),
                       out_specs=P(axis), check_vma=False)
    return jax.jit(mapped)


class ShardedDenseOperator(LinearOperator):
    """Row-sharded HBM-resident dense matrix over a 1-D mesh.

    Subsumes ConjugateGradient_MultiGPUS_CUDA{,_MPI,_NCCL} and
    ConjugateGradient_CPU_MPI_OMP: the device count of the mesh is the
    only "backend" knob left.
    """

    def __init__(self, operand, n, n_padded, vector_dtype, precision,
                 engine, mesh, axis=ROWS_AXIS, comm="gather"):
        key = (precision, engine)
        # default matvec_dot operates on the GLOBAL sharded arrays and
        # lets GSPMD insert the collectives — used by the generic paths
        # (segmented/checkpoint solves); the hot solve paths below use
        # explicit shard_map programs instead.
        from lam_tpu.solver.operators import _MATVEC_DOT
        super().__init__(_MATVEC_DOT[(precision, "xla")], operand, n,
                         n_padded, vector_dtype)
        self.precision = precision
        self.engine = engine
        self.mesh = mesh
        self.axis = axis
        self.comm = comm
        self._mv_local = MATVEC[key]
        self._mv_cols = MATVEC_COLS[key]
        self._b_sharding = NamedSharding(mesh, P(axis))
        # block matvec (multi-RHS) = matmul on the same sharded operand;
        # the XLA variant handles (n, k) blocks under GSPMD for every
        # precision's storage layout
        self._mv_block = MATVEC[(precision, "xla")]

    # -- construction ------------------------------------------------------

    @staticmethod
    def shard_padded_size(n, mesh):
        """Pad so the rows split evenly over the mesh."""
        return padded_size(n, mesh.devices.size)

    @staticmethod
    def _resolve(precision, engine):
        precision, engine = resolve(precision, engine)
        if engine != "xla":
            raise ValueError(
                f"row-sharded blocks are rectangular: engine={engine!r} "
                "does not apply (use backend='sharded' with "
                "engine='pallas_symm_packed' for the band-pair "
                "triangle walk)")
        return precision, engine

    @staticmethod
    def from_row_block_fn(row_block_fn, n, mesh=None, precision="auto",
                          engine="auto", axis=ROWS_AXIS, comm="gather"):
        """Build from a function row_block_fn(row_start, num_rows) -> f64
        ndarray of shape (num_rows, n_padded_cols... ) — actually (num_rows,
        n) source rows; padding is applied here.

        This is the device-side analog of the reference's per-rank MPI-IO reads /
        per-rank generation (ConjugateGradient_CPU_MPI_OMP.hpp:325-363,
        :237-247): each shard's rows are produced independently, so no
        host ever materializes the full matrix.
        """
        if mesh is None:
            mesh = make_mesh()
        precision, engine = ShardedDenseOperator._resolve(precision, engine)
        n_p = ShardedDenseOperator.shard_padded_size(n, mesh)
        a_sharding = NamedSharding(mesh, P(axis, None))

        def padded_block(row_start, num_rows):
            src_rows = max(0, min(n - row_start, num_rows))
            block = np.zeros((num_rows, n_p), dtype=np.float64)
            if src_rows > 0:
                block[:src_rows, :n] = row_block_fn(row_start, src_rows)
            return block

        def make(cb):
            return jax.make_array_from_callback(
                (n_p, n_p), a_sharding,
                lambda idx: cb(idx[0].start or 0,
                               (idx[0].stop or n_p) - (idx[0].start or 0)))

        if precision == "f64":
            operand = make(lambda s, m: padded_block(s, m))
            vdtype = jnp.float64
        elif precision == "f32":
            operand = make(
                lambda s, m: padded_block(s, m).astype(np.float32))
            vdtype = jnp.float32
        elif precision == "df64":
            plane = df64_plane_provider(
                lambda key: padded_block(*key))

            operand = (make(lambda s, m: plane((s, m), 0)),
                       make(lambda s, m: plane((s, m), 1)))
            vdtype = jnp.float64
        else:
            raise ValueError(f"unknown precision {precision!r}")

        return ShardedDenseOperator(operand, n, n_p, vdtype, precision,
                                    engine, mesh, axis, comm)

    @staticmethod
    def from_gen_tridiagonal(n, mesh=None, precision="auto", engine="auto",
                             axis=ROWS_AXIS, comm="gather"):
        """Gen-mode dense tridiagonal built ON DEVICE, shard-local.

        The matrix is a closed-form function of (i, j) whose {0,1,2}
        entries are exact in every storage precision (the df64 pair is
        (hi, 0)), so XLA writes each shard directly into its owner's
        memory (jit with out_shardings) — no host build, no
        host->device transfer. The device-side answer to the
        reference's per-rank OpenMP fill
        (ConjugateGradient_CPU_MPI_OMP.hpp:237-247)."""
        from lam_tpu import generate as gen
        if mesh is None:
            mesh = make_mesh()
        precision, engine = ShardedDenseOperator._resolve(precision, engine)
        n_p = ShardedDenseOperator.shard_padded_size(n, mesh)
        a_sharding = NamedSharding(mesh, P(axis, None))

        def build(dtype):
            return jax.jit(gen._tridiag_hi_device_impl,
                           static_argnums=(0, 1, 2),
                           out_shardings=a_sharding)(n, n_p, dtype)

        if precision in ("f64", "f32"):
            operand = build("float64" if precision == "f64" else "float32")
            vdtype = operand.dtype
        elif precision == "df64":
            lo = jax.jit(lambda: jnp.zeros((n_p, n_p), jnp.float32),
                         out_shardings=a_sharding)()
            operand = (build("float32"), lo)
            vdtype = jnp.float64
        else:
            raise ValueError(f"unknown precision {precision!r}")
        return ShardedDenseOperator(operand, n, n_p, vdtype, precision,
                                    engine, mesh, axis, comm)

    @staticmethod
    def from_dense(a, mesh=None, precision="auto", engine="auto",
                   axis=ROWS_AXIS, comm="gather"):
        a = np.asarray(a, dtype=np.float64)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"matrix must be square, got {a.shape}")
        return ShardedDenseOperator.from_row_block_fn(
            lambda s, m: a[s:s + m, :], n, mesh=mesh, precision=precision,
            engine=engine, axis=axis, comm=comm)

    @staticmethod
    def from_file(path, mesh=None, precision="auto", engine="auto",
                  axis=ROWS_AXIS, comm="gather"):
        """Shard-wise file load: each shard reads only its row block,
        like the reference's MPI-IO seek+read per rank."""
        from lam_tpu import io as lio
        rows, cols = lio.read_header(path)
        if rows != cols:
            raise ValueError(f"{path}: matrix must be square "
                             f"({rows}x{cols})")
        return ShardedDenseOperator.from_row_block_fn(
            lambda s, m: lio.read_matrix_rows(path, s, m), rows,
            mesh=mesh, precision=precision, engine=engine, axis=axis,
            comm=comm)

    # -- solve path --------------------------------------------------------

    def prepare_b(self, b):
        b = np.asarray(b, dtype=self.vector_dtype)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, expected ({self.n},)")
        if self.n_padded != self.n:
            b = np.pad(b, (0, self.n_padded - self.n))
        # callback placement: works identically in single- and
        # multi-process runs (only ADDRESSABLE shards are materialized;
        # a plain device_put of host data cannot target a sharding that
        # spans other processes' devices)
        return jax.make_array_from_callback(
            b.shape, self._b_sharding, lambda idx: b[idx])

    def matvec(self, p_padded):
        fn = _build_sharded_matvec(self._mv_local, self._mv_cols,
                                   self.mesh, self.axis,
                                   self.precision == "df64", self.comm)
        return fn(self.operand, p_padded)

    def matvec_chain(self, p_padded, repeats):
        fn = _build_sharded_chain(self._mv_local, self._mv_cols,
                                  self.mesh, self.axis,
                                  self.precision == "df64", self.comm,
                                  repeats)
        return fn(self.operand, p_padded)

    def run_cg(self, loop_fn, b_padded, max_iters, rel_error):
        del loop_fn  # the sharded program is the loop
        solver = _build_sharded_cg(self._mv_local, self._mv_cols,
                                   self.mesh, self.axis,
                                   self.precision == "df64", self.comm)
        return solver(self.operand, b_padded, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        if op32.operand is not self.operand:
            raise ValueError(
                "cg_solve_ir requires the f32 operator to be a VIEW of "
                "the accurate operator (use op_acc.as_f32())")
        solver = _build_sharded_cg_ir(op32._mv_local, self._mv_local,
                                      op32._mv_cols, self._mv_cols,
                                      self.mesh, self.axis,
                                      self.precision == "df64", self.comm,
                                      max_cycles,
                                      precond=inv_diag32 is not None)
        vec_args = ((b_padded, inv_diag32) if inv_diag32 is not None
                    else (b_padded,))
        return solver(self.operand, *vec_args, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype),
                      jnp.asarray(inner_floor, b_padded.dtype))

    def prepare_b_block(self, b_block):
        b = np.asarray(b_block, dtype=self.vector_dtype)
        if b.ndim != 2 or b.shape[0] != self.n:
            raise ValueError(f"rhs block must be ({self.n}, k), "
                             f"got {b.shape}")
        if self.n_padded != self.n:
            b = np.pad(b, ((0, self.n_padded - self.n), (0, 0)))
        return jax.make_array_from_callback(
            b.shape, NamedSharding(self.mesh, P(self.axis, None)),
            lambda idx: b[idx])

    def diagonal(self):
        """Shard-local diagonal extraction: shard i holds rows
        [i*m, (i+1)*m) and ALL columns, so its piece of diag(A) is the
        diagonal of local_block[:, i*m:(i+1)*m] — zero communication."""
        m = self.n_padded // self.mesh.shape[self.axis]
        axis = self.axis
        is_pair = self.precision == "df64"

        def local_diag(operand):
            i = jax.lax.axis_index(axis)

            def diag_of(a):
                blk = jax.lax.dynamic_slice_in_dim(a, i * m, m, axis=1)
                return jnp.diagonal(blk)

            if is_pair:
                hi, lo = operand
                return (diag_of(hi).astype(jnp.float64)
                        + diag_of(lo).astype(jnp.float64))
            return diag_of(operand).astype(self.vector_dtype)

        mapped = shard_map(
            local_diag, mesh=self.mesh,
            in_specs=(_operand_spec(axis, is_pair),),
            out_specs=P(axis), check_vma=False)
        return jax.jit(mapped)(self.operand)

    def run_pcg(self, b_padded, max_iters, rel_error):
        d = self.diagonal()
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
        solver = _build_sharded_pcg(self._mv_local, self._mv_cols,
                                    self.mesh, self.axis,
                                    self.precision == "df64", self.comm)
        return solver(self.operand, b_padded, inv_d, max_iters,
                      jnp.asarray(rel_error, b_padded.dtype))

    def as_f32(self):
        """f32-view operator SHARING this operator's sharded buffers
        (the inner engine of the mixed-precision solver)."""
        if self.precision == "f32":
            return self
        key = (f"f32@{self.precision}", "xla")
        out = ShardedDenseOperator(self.operand, self.n, self.n_padded,
                                   jnp.float32, "f32", self.engine,
                                   self.mesh, self.axis, self.comm)
        out._mv_local = MATVEC[key]
        out._mv_cols = MATVEC_COLS[key]
        # the GSPMD fallback path must read the same layout
        from lam_tpu.solver.operators import _MATVEC_DOT
        out._matvec_dot_fn = _MATVEC_DOT[key]
        return out
