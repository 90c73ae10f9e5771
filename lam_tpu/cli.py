"""`lam-cg` — the solver CLI, flag- and CSV-compatible with the reference.

One binary replaces the reference's six `test_*` executables
(challenge/main/test/, SURVEY.md §2.2): the parallelization strategy is a
`--backend/--precision/--devices` config, not a build target.

Flag surface (getopt `"hvA:b:o:i:e:s:"`, test_CG_CPU_MPI_OMP.cpp:216-280):
  -A <file>   read matrix (file mode)        -b <file>  read rhs
  -s <int>    generate NxN tridiagonal (gen mode; excludes -A/-b)
  -o <file>   write solution                 -i <int>   max iterations
  -e <float>  relative error                 -v         verbose
  -h          help
Defaults: io/matrix.bin io/rhs.bin io/sol.bin, -i 10000, -e 1e-9
(test_CG_CPU_MPI_OMP.cpp:19-23).

Legacy positional form (the three older reference drivers,
test_CG_CPU_OMP.cpp:17-27):
  lam-cg [matrix.bin [rhs.bin [sol.bin [max_iters [rel_err]]]]]
with the positional drivers' defaults (max_iters 1000). Explicit flags
override positionals.

Default (non-verbose) output is the reference CSV contract consumed by
TESTS/results/clean.sh:
  N,procs,threads,load_s,avg_gemv_s,avg_iter_s,num_iter,err,total_cg_s
(column legend: test_CG_CPU_MPI_OMP.cpp:201-204 and
TESTS/results/STRONG_SCALABILITY_GPU_MPI.txt:1-10). Here `procs` is the
device count and `threads` is 1 (XLA owns intra-chip parallelism).
Deliberate fixes vs the reference: the CPU backends' avg_gemv/avg_iter
double-division bug (CPU_MPI_OMP.hpp:119-124) is not reproduced, and
gen-mode total time prints as float seconds, not integer-divided.
Deliberately REPRODUCED: for unconverged runs the CSV num_iter column
records the reference's loop-exit value max_iters+1 (its for-loop exits
with num_iters == max_iters + 1 and the CSV prints that,
CPU_MPI_OMP.hpp:98,125 — e.g. 16 for the gen-mode -i 15 probes,
BEST_RESULTS:173-236), while verbose mode reports max_iters like the
reference's printf (:138).

Extensions beyond the reference surface:
  --backend local|sharded|sharded2d|auto   --precision f64|f32|df64|ir|...
  --engine xla|pallas_symm_packed|auto     --devices N
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="lam-cg", add_help=False,
        description="Dense CG solver in JAX "
                    "(LAM reference CLI parity)")
    p.add_argument("-A", dest="matrix", metavar="<file>",
                   help="Read matrix from file")
    p.add_argument("-b", dest="rhs", metavar="<file>",
                   help="Read right hand side from file")
    p.add_argument("-o", dest="output", metavar="<file>",
                   default=None, help="Write solution to file")
    p.add_argument("-i", dest="max_iters", type=int, default=None,
                   metavar="<int>", help="Maximum number of iterations "
                   "(default 10000; 1000 in positional form)")
    p.add_argument("-e", dest="rel_error", type=float, default=None,
                   metavar="<float>", help="Relative error")
    p.add_argument("pos", nargs="*", metavar="matrix rhs sol iters err",
                   help="Legacy positional form "
                        "(test_CG_CPU_OMP.cpp:17-27)")
    p.add_argument("-s", dest="size", type=int, metavar="<int>",
                   help="Generate matrix of size n x n")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="Verbose mode")
    p.add_argument("-h", dest="help", action="store_true",
                   help="Show this help message")
    p.add_argument("--backend", default="auto",
                   choices=["local", "sharded", "sharded2d", "auto"],
                   help="sharded2d = SUMMA-style R x R block grid "
                        "(O(N/sqrt(G)) exchange per chip vs 1-D's "
                        "O(N)); with --engine pallas_symm_packed the "
                        "grid also stores each symmetric element ONCE "
                        "(half the memory, dual-product half-slab "
                        "walk)")
    p.add_argument("--precision", default="auto",
                   choices=["f64", "f32", "df64", "ir", "dfq", "irq",
                            "fq", "irfq", "auto"],
                   help="auto = the platform's default (f64); ir = f32 "
                        "inner iterations refined against the f64 "
                        "matrix; dfq = packed symmetric storage with "
                        "the lo plane quantized to int16 (6 B/element); "
                        "irq = mixed-precision refinement on dfq "
                        "storage; fq = "
                        "fully-quantized cascade of three int16 planes "
                        "(same 6 B/element, ~2^-48 accuracy); irfq = "
                        "refinement on fq — the inner loop reads only "
                        "the 2-byte first plane (local backend)")
    p.add_argument("--engine", default="auto",
                   choices=["pallas_symm_packed", "xla", "auto"],
                   help="xla = the full square, XLA's matvec (the "
                        "default); pallas_symm_packed = STORE only the "
                        "lower-triangle tiles (half the memory; "
                        "requires symmetric A, which CG assumes "
                        "anyway), whose f32 inner walk is the Pallas "
                        "kernel")
    p.add_argument("--devices", type=int, default=None,
                   help="Number of mesh devices (default: all)")
    p.add_argument("--comm", default="gather",
                   choices=["gather", "ring"],
                   help="Sharded matvec communication: all_gather of p, "
                        "or a ppermute ring overlapping transfer with "
                        "column-stripe compute")
    p.add_argument("--coordinator", metavar="<host:port>", default=None,
                   help="Multi-process mode: coordinator address for "
                        "jax.distributed.initialize (the srun/mpirun "
                        "analog of the reference's MPI+NCCL bootstrap, "
                        "ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:309-327"
                        "). Launch one lam-cg per process/host.")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="<int>", help="Total process count "
                   "(multi-process mode)")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="<int>", help="This process's rank "
                   "(multi-process mode)")
    p.add_argument("--local-devices", type=int, default=None,
                   metavar="<int>",
                   help="Virtual CPU devices per process (simulation of "
                        "a multi-host mesh on one machine; sets "
                        "xla_force_host_platform_device_count)")
    p.add_argument("--platform", default=None,
                   choices=["cpu", "gpu"],
                   help="Force the JAX platform (e.g. cpu for the "
                        "virtual-mesh simulation)")
    p.add_argument("--preconditioner", default=None,
                   choices=["jacobi"],
                   help="Preconditioned CG (surplus over the reference; "
                        "works on every backend and composes with "
                        "--precision ir/irq/irfq — there it scales the "
                        "inner f32 loop — and with --checkpoint)")
    p.add_argument("--pack-cache", action="store_true",
                   help="File mode: publish/reuse packed planes beside "
                        "the matrix file so reloads skip the pack pass "
                        "(~7x faster at N=70000). backend=local "
                        "f32/df64/ir/dfq/irq/fq/irfq uses one "
                        "whole-matrix cache (<file>.dfqpack/.fqpack/"
                        "...); backend=sharded/sharded2d dfq/irq/fq/"
                        "irfq uses per-shard files keyed on the mesh "
                        "placement (<file>.shardpack/). Non-applicable "
                        "configurations ignore the flag with a notice")
    p.add_argument("--outer", default="device",
                   choices=["device", "host"],
                   help="Where --precision irfq computes its outer "
                        "refinement residuals. 'device' (default): the "
                        "full 6 B/element fq cascade is uploaded and "
                        "r = b - A x runs on-device — fastest once "
                        "resident. 'host' (file mode, backend=local): "
                        "only the 2 B/element q1 inner plane is "
                        "uploaded and the host streams the exact f64 "
                        "source for each outer residual — ~3x less "
                        "link traffic, the fastest time-to-answer from "
                        "cold storage on transfer-bound links "
                        "(solver/host_outer.py)")
    p.add_argument("--check-symmetric", action="store_true",
                   help="File mode: verify A v == A^T v on the matrix "
                        "file before building the operator (two "
                        "streamed passes over the file). The "
                        "lower-triangle engines otherwise TRUST "
                        "symmetry (CG's contract) and would silently "
                        "solve with the mirrored lower half of a "
                        "non-symmetric input")
    p.add_argument("--no-warmup", action="store_true",
                   help="Include XLA compile time in the solve timing")
    p.add_argument("--init-col", action="store_true",
                   help="Emit an init-time CSV column after load_s (the "
                        "nccl_init_s slot of the reference NCCL driver, "
                        "ConjugateGradient_MultiGPUS_CUDA_NCCL.cu:332-334"
                        "; here it is XLA compile/warmup seconds)")
    p.add_argument("--checkpoint", metavar="<dir>", default=None,
                   help="Persist solver state every --checkpoint-every "
                        "iterations (resumable with --resume)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="Resume from --checkpoint state")
    p.add_argument("--profile", metavar="<dir>", default=None,
                   help="Capture a jax.profiler trace of the solve "
                        "(the reference's chrono spans, but a real "
                        "timeline: CPU_MPI_OMP.hpp:95-120 analog)")
    return p


def main(argv=None):
    """Entry point: converts I/O and argument errors into the
    reference's clean print-to-stderr-and-exit behavior
    (ConjugateGradient_CPU_MPI_OMP.hpp:325-329; the reference never
    shows a backtrace on a missing or corrupt file)."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError) as e:
        print(f"lam-cg: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    args = build_parser().parse_args(argv)
    if args.help:
        print("Usage: lam-cg [ (-A -b | -s) -o -e -i -h -v]")
        print("Options:")
        print("  -A <file>       Read matrix from file")
        print("  -b <file>       Read right hand side from file")
        print("  -o <file>       Write solution to file")
        print("  -i <int>        Maximum number of iterations")
        print("  -e <float>      Relative error")
        print("  -s <int>        Generate matrix of size n x n")
        print("  -v              Verbose mode")
        print("  -h              Show this help message")
        print("  [--backend --precision --engine --devices: "
              "device placement config]")
        return 0

    # Legacy positional form (test_CG_CPU_OMP.cpp:17-27): explicit flags
    # win; unset slots take the positional drivers' defaults (-i 1000).
    positional = bool(args.pos)
    if positional:
        if len(args.pos) > 5:
            print("Too many positional arguments.", file=sys.stderr)
            return 1
        slots = args.pos + [None] * (5 - len(args.pos))
        args.matrix = args.matrix or slots[0]
        args.rhs = args.rhs or slots[1]
        args.output = args.output or slots[2]
        if args.max_iters is None and slots[3] is not None:
            args.max_iters = int(slots[3])
        if args.rel_error is None and slots[4] is not None:
            args.rel_error = float(slots[4])
    if args.max_iters is None:
        args.max_iters = 1000 if positional else 10000
    if args.rel_error is None:
        args.rel_error = 1e-9
    if args.output is None:
        args.output = "io/sol.bin"

    mode_generate = args.size is not None
    mode_load = args.matrix is not None or args.rhs is not None
    if mode_generate and mode_load:
        print("Option -A and -b cannot be used with -s.", file=sys.stderr)
        return 1
    if not mode_generate and not mode_load:
        # reference defaults to file mode paths when nothing is given
        mode_load = True

    import os
    import time

    if args.local_devices:
        # effective only if the backend client is not yet created (true
        # for a fresh `python -m lam_tpu.cli` process); our count must
        # win over any inherited flag
        import re
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                       "", os.environ.get("XLA_FLAGS", ""))
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count="
            f"{args.local_devices}")

    import jax

    if args.platform:
        import lam_tpu
        lam_tpu.force_platform(args.platform)
    if args.coordinator:
        from lam_tpu.parallel.mesh import distributed_init
        distributed_init(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    from lam_tpu.solver.api import ConjugateGradient

    # rank-0-only output, like the reference's PRINT_RANK0 macros
    # (ConjugateGradient_CPU_MPI_OMP.hpp:11-12)
    rank0 = jax.process_index() == 0
    verbose = args.verbose
    n_devices = args.devices or len(jax.devices())

    def vprint(*a):
        if verbose and rank0:
            print(*a)

    cg = ConjugateGradient(backend=args.backend, precision=args.precision,
                           engine=args.engine, n_devices=args.devices,
                           comm=args.comm, pack_cache=args.pack_cache,
                           check_symmetric=args.check_symmetric,
                           outer=args.outer)
    # the CSV procs column counts devices actually USED
    n_devices = cg.used_devices()

    vprint("Command line arguments:")
    if mode_generate:
        vprint(f"  rows/cols:         {args.size}")
        size_gb = args.size * args.size * 8 / 1024**3
        vprint(f"  size of the problem: {size_gb:f} GB")
    else:
        vprint(f"  input_file_matrix: {args.matrix or 'io/matrix.bin'}")
        vprint(f"  input_file_rhs:    {args.rhs or 'io/rhs.bin'}")
    vprint(f"  output_file_sol:   {args.output}")
    vprint(f"  max_iters:         {args.max_iters}")
    vprint(f"  rel_error:         {args.rel_error:e}")
    vprint(f"  Number of devices: {n_devices}")
    vprint(f"  backend={cg.backend} precision={cg.precision} "
           f"engine={cg.engine}")
    vprint("")

    t0 = time.perf_counter()
    if mode_generate:
        vprint("Generating the system ...")
        cg.generate_matrix(args.size)
        cg.generate_rhs()
    else:
        vprint("Reading matrix from file ...")
        cg.load_matrix_from_file(args.matrix or "io/matrix.bin")
        vprint("Reading right hand side from file ...")
        cg.load_rhs_from_file(args.rhs or "io/rhs.bin")
    load_s = time.perf_counter() - t0
    vprint("Done\n")

    vprint("Solving the system ...")
    import contextlib
    if args.profile:
        import jax.profiler
        profile_cm = jax.profiler.trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()
    with profile_cm:
        if args.checkpoint:
            import time as _time

            from lam_tpu.solver import checkpoint as ckpt
            from lam_tpu.solver.cg import default_inner_floor
            t0 = _time.perf_counter()
            if cg.precision in ("ir", "irq", "irfq"):
                # round 3: ir checkpoints at refinement-CYCLE
                # boundaries (the natural restart points;
                # --checkpoint-every does not apply)
                result, _ = ckpt.cg_solve_ir_resumable(
                    cg.op.as_f32(), cg.op, cg.rhs,
                    max_iters=args.max_iters, rel_error=args.rel_error,
                    inner_floor=default_inner_floor(cg.precision),
                    checkpoint_path=args.checkpoint, resume=args.resume,
                    preconditioner=args.preconditioner)
            else:
                result, _ = ckpt.cg_solve_resumable(
                    cg.op, cg.rhs, max_iters=args.max_iters,
                    rel_error=args.rel_error,
                    segment=args.checkpoint_every,
                    checkpoint_path=args.checkpoint, resume=args.resume,
                    preconditioner=args.preconditioner)
            dt = _time.perf_counter() - t0
            converged = cg.record_result(result, dt)
        else:
            converged = cg.solve(args.max_iters, args.rel_error,
                                 warmup=not args.no_warmup,
                                 preconditioner=args.preconditioner)
    avg_gemv = cg.measure_gemv()
    t = cg.timings
    if not rank0:
        pass  # collectives above ran on every process; rank 0 reports
    elif verbose:
        if converged:
            print(f"Converged in {t['num_iters']} iterations, "
                  f"relative error is {t['rel_residual']:e}")
        else:
            print(f"Did not converge in {t['num_iters']} iterations, "
                  f"relative error is {t['rel_residual']:e}")
        print(f"Time elapsed: {t['solve_s']:f} s "
              f"(avg iteration {t['avg_iter_s']:e} s, "
              f"avg gemv {avg_gemv:e} s)")
        print("")
        print("Writing solution to file ...")
    else:
        # CSV contract (see module docstring); --init-col inserts the
        # reference NCCL driver's extra nccl_init_s column after load_s
        init_col = (f"{t.get('init_s', 0.0):g}," if args.init_col else "")
        print(f"{cg.n},{n_devices},1,{load_s:g},{init_col}{avg_gemv:g},"
              f"{t['avg_iter_s']:g},"
              f"{t.get('csv_num_iters', t['num_iters'])},"
              f"{t['rel_residual']:g},{t['solve_s']:g}")

    cg.save_result_to_file(args.output)
    vprint("Done\n")
    vprint("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
