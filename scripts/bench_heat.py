"""Heat-equation demo benchmark on the default JAX device.

Runs the reference demo config (`heat_equation 1200 1000`,
heat_equation.cpp:160-168 defaults) plus the BASELINE.md 120x100 anchor
with BOTH solvers:

  * jacobi — numerics-parity port of the reference hot loop
    (heat_equation.cpp:75-131), whole sweep loop in one lax.while_loop.
  * cg     — the BASELINE config-#5 reformulation: CG on the 5-point
    Laplacian at the platform's default precision (lam_tpu/platform.py).

Compile (init) time is reported separately from solve time — the
reference has no JIT, so its timed region is pure execution; ours is
too once the program is compiled (and the persistent compilation cache
makes repeat runs skip XLA entirely). Each solve is timed best-of-2
inside one process.

    python scripts/bench_heat.py [nx ny]

Convergence targets: jacobi eps=1e-3 (reference default,
heat_equation.cpp:164); CG rel_error=1e-10 (config #5: far beyond the
Jacobi stop, in ~100x fewer iterations).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _best_of(fn, k=2):
    best = None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, out)
    return best


def run_config(nx, ny):
    from lam_tpu.apps import heat

    g0 = heat.initial_grid(nx, ny)
    rows = []

    # --- Jacobi (reference parity) ---
    t0 = time.perf_counter()
    heat.solve_heat_jacobi(g0, max_iters=0, epsilon=1e-3)  # compile
    init_j = time.perf_counter() - t0
    dt, (gj, it_j, diff_j) = _best_of(
        lambda: heat.solve_heat_jacobi(g0, max_iters=1_000_000,
                                       epsilon=1e-3))
    rows.append(("jacobi", nx, ny, init_j, dt, int(it_j), float(diff_j)))

    # --- CG (config #5) ---
    t0 = time.perf_counter()
    heat.solve_heat_cg(g0, max_iters=0, rel_error=1e-10)   # compile
    init_c = time.perf_counter() - t0
    dt, (gc, it_c, rel_c) = _best_of(
        lambda: heat.solve_heat_cg(g0, max_iters=200_000,
                                   rel_error=1e-10))
    rows.append(("cg", nx, ny, init_c, dt, int(it_c), float(rel_c)))

    # cross-check: both solvers agree on the steady state (the Jacobi
    # stop eps=1e-3 leaves ~O(eps/(1-rho)) error, so loose tolerance)
    dmax = float(np.abs(np.asarray(gj) - np.asarray(gc)).max())
    return rows, dmax


def main():
    import jax

    import lam_tpu  # noqa: F401

    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 1200
    ny = int(sys.argv[2]) if len(sys.argv) > 2 else 1000

    print(f"# heat benchmark on {jax.devices()[0].platform} "
          f"({jax.devices()[0].device_kind})")
    print("# solver,nx,ny,init_s,solve_s,iters,final_metric")
    for cfg in [(120, 100), (nx, ny)]:
        rows, dmax = run_config(*cfg)
        for r in rows:
            print(f"{r[0]},{r[1]},{r[2]},{r[3]:.3f},{r[4]:.4f},"
                  f"{r[5]},{r[6]:.3e}")
        print(f"# cross-check max|jacobi-cg| at {cfg[0]}x{cfg[1]}: "
              f"{dmax:.3e}")


if __name__ == "__main__":
    main()
