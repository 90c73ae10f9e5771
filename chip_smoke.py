#!/usr/bin/env python3
"""Smoke test of the solver's main path on NVIDIA GPUs.

    python3 chip_smoke.py            # one card: phases 1-6 below
    python3 chip_smoke.py --multi    # four cards: the sharded paths only

Phases on one card, all in this process and through the entry points a
user calls (lam_tpu.cli.main, lam_tpu.tools.spd_gen.main,
lam_tpu.apps.heat.solve_heat_cg):

  1. gen   — `lam-cg -s 70000 -i 15`: f64 tridiagonal built on the card
             (39.2 GB), 15 iterations; the CSV line is printed.
  2. file  — `lam-spd-gen 20000` (reference spectrum, seed 42) then
             `lam-cg -A -b -o` at the default precision; the TRUE
             residual is recomputed in f64 on the host from the
             solution file and must be <= 2e-9.
  3. ir    — the same system with --precision ir (full square, and on
             packed storage) and --precision irfq; same bound.
  4. walk  — the Pallas triangle-walk kernel (f32 and int16 tiles) at
             N=20000 and 70000 against the f64 product of the same
             stored values (relative 2-norm error <= 1e-5), timed
             against XLA's plain walk (median of 20 matvecs).
  5. heat  — the heat demo at 1200x1000 with precision auto and ir to a
             relative residual of 1e-10. Each solution's TRUE residual,
             recomputed in f64 on the host, is <= 2e-10, and its error
             against the exact solution (the 5-point Laplacian is
             diagonal in the 2-D sine basis) is within the bound its
             residual implies, ||b - A x|| / lambda_min(A).
  6. tests — `pytest -m gpu`, in this process.

--multi (four cards): an N=40000 reference-spectrum system through
backend=sharded with comm=gather and comm=ring, backend=sharded2d on a
2x2 grid, and backend=sharded with --precision irfq (band-pair packed
walk); each against the one-card solve at the same precision: iteration
counts within 3, true residuals <= 2e-9.

Exits non-zero without a GPU or when any phase fails. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import time

import numpy as np

TRUE_REL_BOUND = 2e-9      # bench.py's validity bound
WALK_REL_BOUND = 1e-5      # f32 accumulation over N terms
HEAT_TRUE_REL_BOUND = 2e-10  # twice the heat solves' 1e-10 target
MULTI_DEVICES = 4
WORK = os.path.join("io", "smoke")


def log(msg):
    print(msg, flush=True)


def run_cli(argv):
    """lam-cg in this process; returns the CSV fields of its last line."""
    from lam_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue().strip()
    log(f"  lam-cg {' '.join(argv)}\n    -> {out.splitlines()[-1]}")
    if rc != 0:
        raise RuntimeError(f"lam-cg exited {rc}: {argv}")
    return out.splitlines()[-1].split(",")


def true_rel(a_path, b_path, x_path):
    """||b - A x|| / ||b|| in f64 on the host, from the files."""
    from lam_tpu import io as lio
    a = lio.read_matrix(a_path)
    b = lio.read_vector(b_path)
    x = lio.read_vector(x_path)
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


# -- phases --------------------------------------------------------------------


def phase_gen(n=70000, iters=15):
    row = run_cli(["-s", str(n), "-i", str(iters), "--backend", "local",
                   "-o", os.path.join(WORK, "gen_sol.bin")])
    if int(row[0]) != n or int(row[6]) != iters + 1:
        raise RuntimeError(f"gen CSV {row}: expected N={n} and "
                           f"num_iter={iters + 1}")
    if not np.isfinite(float(row[7])):
        raise RuntimeError(f"gen residual not finite: {row}")
    return {"csv": ",".join(row)}


def make_system(n=20000, seed=42):
    from lam_tpu.tools import spd_gen
    os.makedirs(WORK, exist_ok=True)
    a = os.path.join(WORK, f"spd_{n}.bin")
    b = os.path.join(WORK, f"rhs_{n}.bin")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = spd_gen.main([str(n), a, b, str(seed)])
    if rc != 0:
        raise RuntimeError(f"lam-spd-gen exited {rc}")
    return a, b


def solve_file(a, b, extra, label):
    x = os.path.join(WORK, f"sol_{label}.bin")
    row = run_cli(["-A", a, "-b", b, "-o", x, "--backend", "local"]
                  + extra)
    rel = true_rel(a, b, x)
    log(f"    {label}: {row[6]} iterations, true residual {rel:.3e}")
    if rel > TRUE_REL_BOUND:
        raise RuntimeError(f"{label}: true residual {rel:.3e} > "
                           f"{TRUE_REL_BOUND}")
    return {"iters": int(row[6]), "true_rel": rel, "solve_s": float(row[8])}


def phase_file(system):
    """The default precision — native f64 on the full square."""
    return {"f64": solve_file(*system, [], "f64")}


def phase_ir(system):
    return {
        "ir": solve_file(*system, ["--precision", "ir"], "ir"),
        "ir_packed": solve_file(*system, ["--precision", "ir", "--engine",
                                          "pallas_symm_packed"],
                                "ir_packed"),
        "irfq": solve_file(*system, ["--precision", "irfq"], "irfq"),
    }


def _median_time(fn, args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def walk_case(n, storage, seed=0):
    """Kernel vs f64 reference and vs XLA's plain walk on random packed
    tiles built on the device (f32, or int16 with power-of-two
    scales)."""
    import jax
    import jax.numpy as jnp

    from lam_tpu.ops import gemv
    from lam_tpu.solver.operators import padded_size

    tb = gemv.SYMM_TB
    n_p = padded_size(n, tb)
    nblk = n_p // tb
    T = gemv.tri_tile_count(nblk)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    if storage == "f32":
        buf = jax.random.uniform(k1, (T * tb, tb), jnp.float32, -1, 1)
        scales = None
    else:
        buf = jax.random.randint(k1, (T * tb, tb), -32767, 32768,
                                 jnp.int32).astype(jnp.int16)
        scales = 2.0 ** jax.random.randint(k3, (T,), -24, -8).astype(
            jnp.float32)
    p = jax.random.uniform(k2, (n_p,), jnp.float32, -1, 1)
    nbytes = buf.size * buf.dtype.itemsize

    ref = np.asarray(jax.jit(
        lambda b, v, s: gemv.tri_walk(b, v.astype(jnp.float64), s,
                                      kernel=False))(buf, p, scales))
    xla = jax.jit(lambda b, v, s: gemv.tri_walk(b, v, s, kernel=False))
    kern = jax.jit(gemv.tri_walk)
    y = np.asarray(kern(buf, p, scales), np.float64)
    err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    if not err <= WALK_REL_BOUND:
        raise RuntimeError(f"walk {storage} N={n}: relative error "
                           f"{err:.3e} > {WALK_REL_BOUND}")
    out = {"n": n, "storage": storage, "tiles": T,
           "bytes_per_matvec": nbytes, "rel_err": err,
           "kernel_s": _median_time(kern, (buf, p, scales)),
           "xla_s": _median_time(xla, (buf, p, scales))}
    log(f"    {storage} N={n}: kernel {out['kernel_s'] * 1e3:.3f} ms "
        f"({nbytes / out['kernel_s'] / 1e9:.0f} GB/s) vs XLA walk "
        f"{out['xla_s'] * 1e3:.3f} ms; {nbytes / 1e9:.2f} GB per matvec, "
        f"rel err {err:.2e}")
    return out


def phase_walk(sizes=(20000, 70000)):
    return [walk_case(n, storage)
            for n in sizes for storage in ("f32", "q16")]


def laplace_host(u):
    """The heat demo's 5-point Laplacian on an interior grid, in numpy."""
    out = 4.0 * u
    out[1:] -= u[:-1]
    out[:-1] -= u[1:]
    out[:, 1:] -= u[:, :-1]
    out[:, :-1] -= u[:, 1:]
    return out


def laplace_eigenvalues(nyi, nxi):
    """Eigenvalues of that Laplacian, one per 2-D sine mode, (nyi, nxi)."""
    def axis(m):
        return 4.0 * np.sin(np.pi * np.arange(1, m + 1) / (2 * (m + 1))) ** 2
    return axis(nyi)[:, None] + axis(nxi)[None, :]


def heat_exact(b):
    """The interior solution of laplace_host(u) = b, by the 2-D DST-I
    that diagonalizes it."""
    from scipy import fft
    return fft.idstn(fft.dstn(b, type=1) / laplace_eigenvalues(*b.shape),
                     type=1)


def phase_heat(nx=1200, ny=1000, rel_error=1e-10):
    """Both solutions against the exact one. For any x,
    ||x - x*|| <= ||b - A x|| / lambda_min, so each error is checked
    against the bound its own residual implies (plus the exact
    solution's own, from its rounding)."""
    from lam_tpu.apps import heat
    grid = heat.initial_grid(nx, ny)
    b = heat.boundary_rhs(grid)
    bnorm = np.linalg.norm(b)
    lam_min = laplace_eigenvalues(*b.shape)[0, 0]
    exact = heat_exact(b)
    xnorm = np.linalg.norm(exact)
    exact_bound = np.linalg.norm(b - laplace_host(exact)) / lam_min
    out = {"lambda_min": lam_min}
    sols = {}
    for precision in ("auto", "ir"):
        t0 = time.perf_counter()
        sol, iters, rel = heat.solve_heat_cg(grid, precision=precision,
                                             rel_error=rel_error)
        dt = time.perf_counter() - t0
        x = sol[1:-1, 1:-1]
        r = np.linalg.norm(b - laplace_host(x))
        true_rel = r / bnorm
        err = np.linalg.norm(x - exact) / xnorm
        bound = (r / lam_min + exact_bound) / xnorm
        log(f"    heat {precision}: {iters} iterations, residual "
            f"{rel:.2e} (true {true_rel:.2e}), error {err:.2e} against "
            f"the exact solution (bound {bound:.2e}), {dt:.2f} s "
            f"(compile included)")
        if not (rel < rel_error and true_rel <= HEAT_TRUE_REL_BOUND):
            raise RuntimeError(f"heat {precision}: residual {rel:.2e}, "
                               f"true {true_rel:.2e}")
        if not err <= bound:
            raise RuntimeError(f"heat {precision}: error {err:.2e} > "
                               f"{bound:.2e}")
        sols[precision] = x
        out[precision] = {"iters": iters, "rel_residual": rel,
                          "true_rel": true_rel, "rel_err": err,
                          "rel_err_bound": bound}
    diff = float(np.linalg.norm(sols["auto"] - sols["ir"]) / xnorm)
    log(f"    heat auto vs ir: relative 2-norm difference {diff:.2e}")
    out["rel_diff"] = diff
    return out


def phase_tests():
    import pytest
    os.environ["LAM_TPU_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests"])
    if rc != 0:
        raise RuntimeError(f"pytest -m gpu exited {int(rc)}")
    return {"rc": int(rc)}


def phase_multi(n=40000, seed=42, n_devices=4):
    """The sharded paths across n_devices cards, each against the
    one-card solve at the same precision (f64 for the full-square
    paths, irfq for the band-pair walk: inner iteration counts are not
    comparable across precisions)."""
    import jax

    from lam_tpu.solver.api import ConjugateGradient
    from lam_tpu import io as lio

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"--multi needs {n_devices} devices, have "
                           f"{len(jax.devices())}")
    a_path, b_path = make_system(n, seed)
    a = lio.read_matrix(a_path)
    b = lio.read_vector(b_path)
    bnorm = np.linalg.norm(b)

    def solve(label, **cfg):
        cg = ConjugateGradient(n_devices=cfg.pop("n_devices", n_devices),
                               **cfg)
        cg.load_matrix_from_file(a_path)
        cg.load_rhs_from_file(b_path)
        cg.solve(max_iters=10000, rel_error=1e-9)
        rel = float(np.linalg.norm(b - a @ cg.x) / bnorm)
        iters = cg.timings["num_iters"]
        log(f"    {label}: {iters} iterations, true residual {rel:.3e}, "
            f"solve {cg.timings['solve_s']:.4f} s")
        if rel > TRUE_REL_BOUND:
            raise RuntimeError(f"{label}: true residual {rel:.3e}")
        return {"iters": iters, "true_rel": rel,
                "solve_s": cg.timings["solve_s"]}

    ref = {"f64": solve("1 card f64", backend="local", n_devices=1),
           "irfq": solve("1 card irfq", backend="local", n_devices=1,
                         precision="irfq")}
    paths = {
        "gather": ("f64", dict(backend="sharded", comm="gather")),
        "ring": ("f64", dict(backend="sharded", comm="ring")),
        "sharded2d": ("f64", dict(backend="sharded2d")),
        "irfq_band_pair": ("irfq", dict(backend="sharded",
                                        precision="irfq")),
    }
    out = {"reference": ref}
    for label, (base, cfg) in paths.items():
        res = solve(f"{n_devices} cards {label}", **cfg)
        if abs(res["iters"] - ref[base]["iters"]) > 3:
            raise RuntimeError(f"{label}: {res['iters']} iterations vs "
                               f"{ref[base]['iters']} on one card")
        out[label] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths only")
    ap.add_argument("--only", nargs="+", default=None,
                    choices=["gen", "file", "ir", "walk", "heat", "tests"],
                    help="run these one-card phases only")
    args = ap.parse_args(argv)

    import jax

    from lam_tpu import platform   # x64 on
    device = platform.require_gpu()

    log(f"card: {device['card']}")
    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    os.makedirs(WORK, exist_ok=True)

    results = {}
    if args.multi:
        phases = [("multi", lambda: phase_multi(n_devices=MULTI_DEVICES))]
    else:
        system = []

        def ensure_system():
            if not system:
                system.extend(make_system())
            return system

        phases = [
            ("gen", phase_gen),
            ("file", lambda: phase_file(ensure_system())),
            ("ir", lambda: phase_ir(ensure_system())),
            ("walk", phase_walk),
            ("heat", phase_heat),
            ("tests", phase_tests),
        ]
        if args.only:
            phases = [ph for ph in phases if ph[0] in args.only]
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        results[name] = fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1, default=str)
    count = MULTI_DEVICES if args.multi else 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["device_kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
