"""The four-method solver facade, interface-compatible with the reference.

The reference's abstract base (challenge/main/LAM/src/ConjugateGradient.hpp:9-28)
defines: solve(max_iters, rel_error), load_matrix_from_file,
load_rhs_from_file, save_result_to_file; the distributed backends add
generate_matrix / generate_rhs (ConjugateGradient_CPU_MPI_OMP.hpp:145-256).
This class implements all six with the backend collapsed to a config:

    backend:   'local'   one device (reference CPU_OMP / GPU_CUDA)
               'sharded' row-sharded mesh (reference MultiGPUS_*/CPU_MPI)
               'auto'    sharded iff >1 device visible
    precision: 'f64' | 'f32' | 'df64' | 'ir' | 'irq' | 'irfq' | 'auto'
               (see lam_tpu/solver/operators.py; 'ir' = f32 iterations +
               f64 iterative refinement)
    engine:    'xla' (full square) | 'pallas_symm_packed' (packed
               lower triangle) | 'auto'
'auto' resolves through the platform table (lam_tpu/platform.py).
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from lam_tpu import generate as gen
from lam_tpu import io as lio
from lam_tpu import platform
from lam_tpu.solver.cg import cg_solve, cg_solve_ir, default_inner_floor
from lam_tpu.solver.operators import DenseOperator, check_engine, resolve

PACKED = "pallas_symm_packed"


class ConjugateGradient:
    def __init__(self, backend="auto", precision="auto", engine="auto",
                 n_devices=None, mesh=None, comm="gather",
                 pack_cache=False, check_symmetric=False,
                 outer="device"):
        check_engine(engine)
        if backend == "auto":
            n = n_devices or len(jax.devices())
            backend = "sharded" if n > 1 else "local"
        if outer not in ("device", "host"):
            raise ValueError(f"outer must be 'device' or 'host', "
                             f"got {outer!r}")
        if outer == "host" and (precision != "irfq"
                                or backend != "local"):
            # host-exact outer residuals exist to cut the q2/q3 upload
            # + read the f64 source the host already holds — only the
            # local irfq file path has both (solver/host_outer.py)
            raise ValueError(
                "outer='host' requires precision='irfq' and "
                "backend='local' (file mode): the host computes "
                "r = b - A x against the f64 source file while the "
                "device holds only the q1 inner plane")
        self.outer = outer
        self._host_a = None
        self.backend = backend
        self.precision = precision
        self.engine = engine
        self.n_devices = n_devices
        self.comm = comm
        # pack_cache: publish/reuse packed quantized planes beside the
        # matrix file (solver/pack_cache.py) so dfq/fq RELOADS skip the
        # CPU-bound quantization pass
        self.pack_cache = pack_cache
        # check_symmetric: verify A v == A^T v on the file's memory map
        # before building any lower-triangle operator. The file fast
        # paths TRUST symmetry by default (CG's contract — the check
        # costs two streamed passes over a multi-GB file); this opt-in
        # restores the loud failure engine='auto' gives in-RAM matrices
        # (operators._verifies_symmetric), for every backend/precision.
        self.check_symmetric = check_symmetric
        self._mesh = mesh
        self.op = None
        self.rhs = None
        self.result = None
        self.timings = {}
        self.n = None

    # -- internal ----------------------------------------------------------

    def _base_precision(self):
        # 'ir' refines f32 inner iterations against the platform's
        # accurate precision (native f64). Packed triangle storage keeps
        # that matrix as an f32 (hi, lo) pair instead (also for 'auto'),
        # so the inner walk reads the hi plane; its accurate matvec
        # still runs in f64.
        # 'irq' is the same refinement loop on the 6-byte quantized-lo
        # storage ("dfq", lam_tpu/solver/operators.py).
        if self.precision in ("ir", "auto") and self.engine == PACKED:
            return "df64"
        if self.precision == "ir":
            return platform.current().precision
        if self.precision == "irq":
            return "dfq"
        # 'irfq' refines on the fully-quantized storage ("fq"): same
        # 6 B/element capacity, but the inner loop reads only the
        # 2-byte q1 plane — half the irq inner bytes.
        if self.precision == "irfq":
            return "fq"
        return self.precision

    def _mesh_or_make(self):
        if self._mesh is None:
            from lam_tpu.parallel.mesh import make_mesh
            self._mesh = make_mesh(self.n_devices)
        return self._mesh

    def _mesh2d_or_make(self):
        if self._mesh is None:
            import math

            from lam_tpu.parallel.pcg2d import make_mesh2d
            r = math.isqrt(self.n_devices or len(jax.devices()))
            self._mesh = make_mesh2d(r)
        return self._mesh

    def _build_operator(self, row_block_fn, n, full_matrix=None,
                        block_fn=None, pack_cache_src=None):
        # pack_cache_src: source matrix file path; the sharded dfq/fq
        # builders use it for the PER-SHARD pack cache (round 4 —
        # solver/pack_cache.py save_shard/load_shard)
        if self.backend == "sharded2d":
            self._mesh2d_or_make()
            if block_fn is None:
                def block_fn(r0, c0, h, w):
                    return row_block_fn(r0, h)[:, c0:c0 + w]
            base2d = self._base_precision()
            engine2d = self.engine
            if base2d in ("dfq", "fq") and engine2d == "auto":
                engine2d = PACKED
            if engine2d == PACKED:
                # symmetric 2-D grid: each element stored ONCE across
                # the mesh (packed triangle diagonal + half-slab
                # mirrors) AND O(N/R) per-iteration exchange
                # (lam_tpu/parallel/pcg2d_symm.py); dfq/irq quantizes
                # the lo plane (6 B/element stored once mesh-wide)
                if base2d not in ("df64", "dfq", "fq"):
                    raise ValueError(
                        f"--backend sharded2d --engine {engine2d} "
                        "supports precision df64/ir/dfq/irq/fq/irfq "
                        "(the df64 pair or a quantized form is the "
                        "storage layout)")
                from lam_tpu.parallel.pcg2d_symm import Symm2DOperator
                return Symm2DOperator.from_block_fn(
                    block_fn, n, mesh=self._mesh,
                    precision=(base2d if base2d in ("dfq", "fq")
                               else "df64"),
                    pack_cache_src=pack_cache_src)
            if base2d in ("dfq", "fq"):
                raise ValueError(
                    f"--backend sharded2d --engine {engine2d} supports "
                    "precision f64/f32/df64/ir; the quantized storages "
                    "(dfq/irq/fq/irfq) exist only on the symmetric "
                    "grid (engine pallas_symm_packed or auto)")
            from lam_tpu.parallel.pcg2d import Sharded2DOperator
            return Sharded2DOperator.from_block_fn(
                block_fn, n, mesh=self._mesh,
                precision=self._base_precision(), engine=self.engine)
        if self.backend == "sharded":
            base = self._base_precision()
            engine = self.engine
            if base in ("dfq", "fq") and engine == "auto":
                # quantized storage exists only as packed triangle
                # tiles — route to the band-pair symmetric operator
                engine = PACKED
            if base in ("dfq", "fq") and engine != PACKED:
                raise ValueError(
                    "precision='dfq'/'irq'/'fq'/'irfq' implies packed "
                    "storage; use engine='pallas_symm_packed' (or "
                    "'auto')")
            if engine == PACKED:
                # band-pair triangle-walk operator: each device stores
                # only its lower-triangle tiles, and every matrix byte
                # is read once per matvec across the mesh
                # (lam_tpu/parallel/pcg_symm.py); the f32 inner walk
                # (ir/irfq) runs the kernel
                if base not in ("df64", "dfq", "fq"):
                    raise ValueError(
                        f"--backend sharded --engine {engine} "
                        "supports precision df64/ir/dfq/irq/fq/irfq "
                        "(the df64 pair or a quantized form is the "
                        "storage layout)")
                from lam_tpu.parallel.pcg_symm import SymmShardedOperator
                return SymmShardedOperator.from_row_block_fn(
                    row_block_fn, n, mesh=self._mesh_or_make(),
                    packed=True, precision=base,
                    pack_cache_src=pack_cache_src)
            from lam_tpu.parallel.pcg import ShardedDenseOperator
            return ShardedDenseOperator.from_row_block_fn(
                row_block_fn, n, mesh=self._mesh_or_make(),
                precision=self._base_precision(), engine=self.engine,
                comm=self.comm)
        a = full_matrix if full_matrix is not None else row_block_fn(0, n)
        return DenseOperator.from_dense(
            a, precision=self._base_precision(), engine=self.engine)

    # -- reference interface -------------------------------------------------

    def load_matrix_from_file(self, filename):
        """Sharded per-row-block read (the MPI-IO analog); times the load
        like the reference drivers (test_CG_CPU_MPI_OMP.cpp:50-53)."""
        t0 = time.perf_counter()
        rows, cols = lio.read_header(filename)
        if rows != cols:
            raise ValueError(f"{filename}: matrix must be square")
        self.n = rows
        if self.check_symmetric:
            # one up-front check covers every path below (the
            # constructors then skip their own, avoiding double passes)
            from lam_tpu.solver.operators import (_open_matrix_memmap,
                                                  _verifies_symmetric)
            a_map, _ = _open_matrix_memmap(filename)
            if not _verifies_symmetric(a_map):
                raise ValueError(
                    f"{filename}: matrix is not symmetric (A v != A^T v "
                    "on a random vector) — the lower-triangle engines "
                    "would silently solve with its mirrored lower half; "
                    "use --engine xla with a full-square precision "
                    "(f64/f32/df64) for non-symmetric input")
            del a_map
        if (self.backend == "local" and self._base_precision() == "dfq"
                and self.engine in ("auto", "pallas_symm_packed")):
            # fused file->quantized-triangle pack (native when built):
            # reads only the lower-triangle bytes, never materializes
            # the full f64 matrix in host RAM
            self.op = DenseOperator.from_file_dfq(
                filename, pack_cache=self.pack_cache)
        elif (self.backend == "local" and self._base_precision() == "fq"
                and self.engine in ("auto", "pallas_symm_packed")):
            if self.outer == "host":
                # q1-only upload (4.9 of 14.7 GB at N=70000); the f64
                # source stays memmapped host-side for the exact outer
                # residuals (solver/host_outer.py)
                from lam_tpu.solver.operators import _open_matrix_memmap
                self.op = DenseOperator.from_file_fq_q1(
                    filename, pack_cache=self.pack_cache)
                self._host_a, _ = _open_matrix_memmap(filename)
            else:
                self.op = DenseOperator.from_file_fq(
                    filename, pack_cache=self.pack_cache)
        elif (self.backend == "local"
                and self._base_precision() in ("f32", "df64")
                and self.engine == PACKED):
            # unquantized packed-triangle fast path: fused
            # lower-triangle read + f32/(hi,lo) convert, cacheable.
            # Symmetry is trusted (CG's contract) instead of verified —
            # the check costs two streaming passes over a multi-GB file
            ctor = (DenseOperator.from_file_f32
                    if self._base_precision() == "f32"
                    else DenseOperator.from_file_df64)
            self.op = ctor(filename, pack_cache=self.pack_cache)
        else:
            # the sharded/2-D quantized builds serve --pack-cache with
            # PER-SHARD cache files keyed on the mesh placement
            # (solver/pack_cache.py save_shard — the per-rank analog of
            # the reference's MPI-IO reads); everything else still
            # ignores the flag with a notice.
            shard_cached = (
                self.backend in ("sharded", "sharded2d")
                and self._base_precision() in ("dfq", "fq")
                and self.engine in ("auto", "pallas_symm_packed"))
            if self.pack_cache and not shard_cached:
                print("lam-cg: --pack-cache only accelerates "
                      "backend=local f32/df64/ir/dfq/irq/fq/irfq and "
                      "sharded/sharded2d dfq/irq/fq/irfq file loads; "
                      "ignored for this backend/precision",
                      file=sys.stderr)
            self.op = self._build_operator(
                lambda s, m: lio.read_matrix_rows(filename, s, m), rows,
                block_fn=lambda r0, c0, h, w: lio.read_matrix_block(
                    filename, r0, c0, h, w),
                pack_cache_src=(filename if self.pack_cache
                                and shard_cached else None))
        jax.block_until_ready(self.op.operand)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    def load_rhs_from_file(self, filename):
        b = lio.read_vector(filename)
        if self.n is not None and b.shape[0] != self.n:
            raise ValueError(
                "Size of right hand side does not match the matrix")
        self.rhs = b
        return True

    def generate_matrix(self, rows, cols=None):
        """Gen-mode dense tridiagonal (ConjugateGradient_CPU_MPI_OMP.hpp:237-247),
        built shard-by-shard."""
        if cols is not None and cols != rows:
            raise ValueError("generated matrix must be square")
        if self.pack_cache:
            # gen mode has no source file to key a cache on; say so
            # (the CLI help promises non-applicable configs warn)
            print("lam-cg: --pack-cache only accelerates file-mode "
                  "loads; ignored in generate mode", file=sys.stderr)
        t0 = time.perf_counter()
        self.n = rows
        self.op = (self._generate_fast(rows)
                   or self._build_operator(
                       lambda s, m: gen.tridiagonal_rows(s, m, rows),
                       rows))
        jax.block_until_ready(self.op.operand)
        self.timings["load_s"] = time.perf_counter() - t0
        return True

    @staticmethod
    def _packed_gen_plane(rows, impl, padded=False):
        """Device-build ONE packed triangle gen plane (the f32 hi or
        int16 q1 tridiagonal) — the shared body of the three local
        gen fast paths below, so a padding or static_argnums change
        cannot drift between precisions. Returns (plane, tb, n_p).
        padded=True builds over the Q16_P-padded walk tables (the fq
        layout): the inert (0, 1) pad entries match nothing in the
        tridiagonal scatter, so the pad tiles come out all-zero."""
        from lam_tpu.ops.gemv import (SYMM_TB, _symm_tables,
                                      _symm_tables_padded)
        from lam_tpu.solver.operators import padded_size
        tb = SYMM_TB
        n_p = padded_size(rows, tb)
        nblk = n_p // tb
        tables = (_symm_tables_padded if padded and nblk >= 2
                  else _symm_tables)
        it, kt = tables(nblk)
        plane = jax.jit(impl, static_argnums=(0, 1, 4))(
            rows, tb, jnp.asarray(it), jnp.asarray(kt), nblk)
        return plane, tb, n_p

    def _generate_fast(self, rows):
        """Gen-mode tridiagonal built ON DEVICE in its storage layout:
        entries {0,1,2} are exact in every storage precision (the df64
        pair is (hi, 0); the fq q1 plane is quantization-exact), so no
        host build and no host->device matrix transfer. For the
        sharded backends XLA writes each shard directly into its
        owner's memory (out_shardings) — the generation analog of the
        reference's per-rank fill
        (ConjugateGradient_CPU_MPI_OMP.hpp:237-247). Returns None where
        the matrix is built on the host instead."""
        from lam_tpu.parallel.pcg import ShardedDenseOperator
        from lam_tpu.parallel.pcg2d import Sharded2DOperator
        from lam_tpu.parallel.pcg2d_symm import Symm2DOperator
        from lam_tpu.parallel.pcg_symm import SymmShardedOperator

        base, engine = resolve(self._base_precision(), self.engine)
        if base in ("dfq", "fq") and self.engine == "auto":
            engine = PACKED
        if base == "fq" and engine == PACKED:
            # device-built quantization-EXACT q1 plane + broadcast zero
            # residual planes: 2 B/element
            if self.backend == "local":
                q1, _, n_p = self._packed_gen_plane(
                    rows, gen._tridiag_q1_packed_impl, padded=True)
                return DenseOperator.from_gen_fq(q1, rows, n_p)
            if self.backend == "sharded":
                return SymmShardedOperator.from_gen_fq(
                    rows, mesh=self._mesh_or_make())
            return Symm2DOperator.from_gen_fq(
                rows, mesh=self._mesh2d_or_make())
        if base not in ("f64", "f32", "df64"):
            return None
        if engine == PACKED:
            if self.backend == "local" and base == "f32":
                # the packed f32 plane IS the matrix
                hi, _, n_p = self._packed_gen_plane(
                    rows, gen._tridiag_hi_packed_impl)
                return DenseOperator.from_packed_f32(hi, rows, n_p)
            if base != "df64":
                return None   # the host build raises the usual error
            if self.backend == "local":
                # triangle tiles + ONE broadcast zero lo tile
                hi, tb, n_p = self._packed_gen_plane(
                    rows, gen._tridiag_hi_packed_impl)
                lo = jnp.zeros((tb, tb), jnp.float32)
                return DenseOperator.from_packed_planes(hi, lo, rows, n_p)
            if self.backend == "sharded":
                return SymmShardedOperator.from_gen_tridiagonal(
                    rows, mesh=self._mesh_or_make(), packed=True)
            return Symm2DOperator.from_gen_tridiagonal(
                rows, mesh=self._mesh2d_or_make())
        if self.backend == "sharded2d":
            return Sharded2DOperator.from_gen_tridiagonal(
                rows, mesh=self._mesh2d_or_make(), precision=base,
                engine=engine)
        if self.backend == "sharded":
            return ShardedDenseOperator.from_gen_tridiagonal(
                rows, mesh=self._mesh_or_make(), precision=base,
                engine=engine, comm=self.comm)
        if base == "df64":
            hi = gen.tridiagonal_hi_plane_device(rows)
            lo = jnp.zeros((rows, rows), jnp.float32)  # exact: no f32 error
            return DenseOperator.from_df64_planes(hi, lo, rows,
                                                  engine=engine)
        return DenseOperator.from_device(gen.tridiagonal_hi_plane_device(
            rows, dtype="float64" if base == "f64" else "float32"), rows)

    def generate_rhs(self):
        """Gen-mode rhs of ones (ConjugateGradient_CPU_MPI_OMP.hpp:159-164)."""
        if self.n is None:
            raise RuntimeError("generate_matrix first")
        self.rhs = gen.ones_rhs(self.n)
        return True

    def solve(self, max_iters=1000, rel_error=1e-9, warmup=True,
              preconditioner=None):
        """Run CG; returns True iff converged (ConjugateGradient.hpp:14).

        warmup pre-compiles the solve program with max_iters=0 so the
        reported time is execution, not XLA compilation (the reference has
        no JIT; its timed region is pure execution).
        preconditioner="jacobi" runs diagonal-scaled PCG (surplus; any
        backend). With precision="ir"/"irq"/"irfq" it preconditions the
        INNER f32 loop; the outer refinement recurrence is unchanged.
        """
        if self.op is None or self.rhs is None:
            raise RuntimeError("load/generate a system first")

        def solver(iters, tol):
            return self._solve_once(iters, tol, preconditioner)
        if warmup:
            # timed as init_s: the compiled-program analog of the reference's
            # NCCL communicator init (ncclCommInitRank, measured and
            # printed as the nccl_init_s CSV column,
            # ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:306-334) is XLA
            # compilation of the solve program
            t_init = time.perf_counter()
            w = solver(0, rel_error)
            float(w.rel_residual)  # force full execution (readback)
            self.timings["init_s"] = time.perf_counter() - t_init
        t0 = time.perf_counter()
        result = solver(max_iters, rel_error)
        # scalar readback: the timed region ends when the result is on
        # the host
        float(result.rel_residual)
        return self.record_result(result, time.perf_counter() - t0)

    def record_result(self, result, solve_s):
        """Store a CGResult + wall time into the timings dict (shared
        by solve() and external drivers like the checkpoint CLI path, so
        the CSV bookkeeping — including the num_iter parity rule below —
        lives in exactly one place)."""
        self.result = result
        iters = max(int(result.num_iters), 1)
        self.timings["solve_s"] = solve_s
        self.timings["avg_iter_s"] = solve_s / iters
        self.timings["num_iters"] = int(result.num_iters)
        # CSV parity: the reference's for-loop exits with num_iters ==
        # max_iters + 1 when unconverged and the CSV prints THAT value
        # (16 for the gen-mode -i 15 probes, BEST_RESULTS:173-236),
        # while its verbose print says max_iters
        # (ConjugateGradient_CPU_MPI_OMP.hpp:98,125,138)
        self.timings["csv_num_iters"] = int(result.num_iters) + (
            0 if bool(result.converged) else 1)
        self.timings["rel_residual"] = float(result.rel_residual)
        return bool(result.converged)

    def used_devices(self):
        """Devices the configured backend actually uses (the CSV procs
        column counts these, not the visible device count)."""
        import math

        n = self.n_devices or len(jax.devices())
        if self.backend == "local":
            return 1
        if self.backend == "sharded2d":
            return math.isqrt(n) ** 2  # R x R grid uses R^2
        return n

    def _solve_once(self, max_iters, rel_error, preconditioner=None):
        if self.outer == "host":
            if self._host_a is None:
                raise RuntimeError(
                    "outer='host' solves against the f64 source file: "
                    "call load_matrix_from_file first (generate mode "
                    "has no file to stream the outer residuals from)")
            if preconditioner is not None:
                raise ValueError(
                    "outer='host' does not compose with a "
                    "preconditioner yet; drop one of the two")
            from lam_tpu.solver.host_outer import cg_solve_ir_host
            return cg_solve_ir_host(
                self._host_a, self.op, self.rhs, max_iters=max_iters,
                rel_error=rel_error,
                inner_floor=default_inner_floor("irfq"))
        if self.precision in ("ir", "irq", "irfq"):
            # irfq's inner operator carries ~2^-16 tile-relative error:
            # its floor is a loose-early/tight-late SCHEDULE, ir/irq get
            # the flat f32-stagnation floor (cg.default_inner_floor doc)
            floor = default_inner_floor(self.precision)
            return cg_solve_ir(self.op.as_f32(), self.op, self.rhs,
                               max_iters=max_iters, rel_error=rel_error,
                               inner_floor=floor,
                               preconditioner=preconditioner)
        return cg_solve(self.op, self.rhs, max_iters=max_iters,
                        rel_error=rel_error,
                        preconditioner=preconditioner)

    def save_result_to_file(self, filename):
        """Writes the SOLUTION with the full row count — deliberately
        fixing the reference bugs of writing the rhs and rank-0's local
        row count (ConjugateGradient_CPU_MPI_OMP.hpp:436-439, SURVEY §8.3).

        Multi-process: every process participates in the gather (it is a
        collective), process 0 writes — the reference's rank-0-only save
        (CPU_MPI_OMP.hpp:427) without its bugs."""
        if self.result is None:
            raise RuntimeError("solve first")
        x = _host_array(self.result.x)
        if jax.process_index() == 0:
            lio.write_matrix(filename, x)
        return True

    # -- extras ---------------------------------------------------------------

    def measure_gemv(self, repeats=20):
        """Average matvec wall time — the avg_gemv CSV column. The
        reference times gemv inside its hot loop (CPU_MPI_OMP.hpp:95-120);
        with the whole loop fused on-device we time `repeats` chained
        matvecs in one device program (no per-call dispatch latency).

        For precision='ir' the HOT matvec is the inner f32 one (~99% of a
        solve's matvecs are inner-CG iterations; the accurate df64 matvec
        runs only once per refinement cycle), so that is what the CSV
        column times — avg_gemv_s x num_iters then tracks total_cg_s.
        The accurate matvec is reported separately as avg_gemv_acc_s."""
        if self.outer == "host":
            # the accurate matvec lives host-side (and the q1-only
            # operator's device cascade correctly refuses); the hot
            # gemv — what this CSV column exists to track — is still
            # the inner q1 matvec
            dt = self._time_matvec(self.op.as_f32(), repeats)
            self.timings["avg_gemv_s"] = dt
            return dt
        dt = self._time_matvec(self.op, repeats)
        if self.precision in ("ir", "irq", "irfq"):
            self.timings["avg_gemv_acc_s"] = dt
            dt = self._time_matvec(self.op.as_f32(), repeats)
        self.timings["avg_gemv_s"] = dt
        return dt

    def _time_matvec(self, op, repeats):
        # the readback scalar is a vdot (replicated across processes and
        # shards) so it is readable in multi-process runs, where an
        # element of a row-sharded vector may live on another host
        def run():
            out = op.matvec_chain(p, repeats)
            return float(jnp.vdot(out, out))  # forces full execution

        p = op.prepare_b(self.rhs)  # prepare_b casts to op's vector dtype
        run()  # compile + execute
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) / repeats

    @property
    def x(self):
        return None if self.result is None else _host_array(self.result.x)


def _host_array(arr):
    """Device array -> host numpy, gathering across processes when the
    array's shards live on other hosts (np.asarray would raise on a
    non-fully-addressable jax.Array)."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(arr,
                                                            tiled=True))
    return np.asarray(arr)
