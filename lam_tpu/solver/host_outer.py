"""Iterative refinement with HOST-EXACT outer residuals.

The irfq engine's on-device refinement (solver/cg.py _cg_ir_loop)
reads the full 6 B/element fq cascade, but only the ~6 OUTER residual
computations touch q2/q3 — the inner CG reads the 2 B/element q1 plane
alone. When the host->device link is the bottleneck and the host still
holds the exact f64 source it just packed (page cache / memmap), moving
the outer residual HOST-side can win on time-to-answer:

  * only the q1 plane + scales + diagonal cross the link (4.9 of
    14.7 GB at N=70000), and
  * the outer operator becomes EXACT f64 instead of the ~2^-48
    reconstructed cascade.

The trade: each refinement cycle pays one host matvec (N^2 f64 reads),
so the solve itself gets slower while the load gets shorter. Whether
it wins anywhere on a GPU host has not been measured. The reference
has no analog of either regime — its GPU
backends re-upload the fp64 matrix every run
(MultiGPUS_CUDA_NCCL.cu load path) and round-trip scalars every
iteration; here the host<->device traffic per cycle is two
n-vectors (~1 MB).

This outer loop is a Python driver by DESIGN (about 6 iterations, each
a host matvec long — dispatch is noise), unlike the jitted _cg_ir_loop,
which must not sync with the host every inner iteration.
"""

import numpy as np

from lam_tpu.solver.cg import CGResult, default_inner_floor


def host_matvec(a):
    """x -> A @ x streaming ONE triangle when BLAS symv applies.

    `a` may be an (n, n) np.ndarray or np.memmap (C-order). A
    C-contiguous symmetric matrix transposed is F-contiguous and equal
    to itself, so scipy's dsymv accepts the `a.T` view zero-copy and
    reads half the bytes a full gemv streams. Falls back to `a @ x`."""
    try:
        from scipy.linalg.blas import dsymv
        at = a.T
        if not at.flags.f_contiguous:
            raise ValueError
        return lambda x: dsymv(1.0, at, x, lower=1)
    except (ImportError, ValueError):
        return lambda x: a @ x


def cg_solve_ir_host(a_host, op_q1, b, *, max_iters=10000,
                     rel_error=1e-9, inner_floor=None, max_cycles=20):
    """Mixed-precision CG: q1-plane inner solves on device, exact f64
    outer residuals on host.

    a_host: the exact operator — an (n, n) f64 array/memmap, or a
        callable x -> A x (matrix-free / file-streaming callers).
    op_q1: a DenseOperator whose `.as_f32()` view is the quantized
        inner engine — `DenseOperator.from_file_fq_q1(path)` (q1-only
        upload) or a full fq operator (shares buffers either way).
    Returns a host-side CGResult: x is an (n,) f64 numpy vector,
    num_iters counts TOTAL inner iterations, rel_residual is the TRUE
    relative residual b - A x under `a_host` (not a recurrence).
    """
    import jax.numpy as jnp

    from lam_tpu.solver.cg import _cg_loop

    op32 = op_q1.as_f32()
    n = op_q1.n
    b = np.asarray(b, dtype=np.float64)
    if b.shape != (n,):
        raise ValueError(f"rhs has shape {b.shape}, expected ({n},)")
    matvec = a_host if callable(a_host) else host_matvec(a_host)
    floors = np.atleast_1d(
        default_inner_floor("irfq") if inner_floor is None
        else inner_floor).astype(np.float64)

    bb = float(b @ b)
    if bb == 0.0:
        return CGResult(x=np.zeros(n), num_iters=0, rel_residual=0.0,
                        converged=True)
    if max_iters == 0:
        # warmup contract (api.solve): compile the inner device program
        # without iterating, so the timed solve is execution only
        inner = _cg_loop(op32._matvec_dot_fn, op32.operand,
                         op32.prepare_b(np.zeros(n, np.float32)),
                         jnp.int32(0), jnp.float32(0.5))
        float(inner.rel_residual)
        return CGResult(x=np.zeros(n), num_iters=0, rel_residual=1.0,
                        converged=False)
    x = np.zeros(n, dtype=np.float64)
    r = b.copy()
    total = 0
    rel = 1.0
    for cyc in range(max_cycles):
        rel = float(np.sqrt(float(r @ r) / bb))
        if rel < rel_error or total >= max_iters:
            break
        floor = float(floors[min(cyc, len(floors) - 1)])
        tol = float(np.clip(rel_error / rel, floor, 0.99))
        rnorm = float(np.sqrt(float(r @ r)))
        r32 = op32.prepare_b((r / rnorm).astype(np.float32))
        inner = _cg_loop(op32._matvec_dot_fn, op32.operand, r32,
                         jnp.int32(max_iters - total),
                         jnp.float32(tol))
        d = np.asarray(op32.extract_x(inner.x), dtype=np.float64)
        x += d * rnorm
        total += int(inner.num_iters)
        r = b - matvec(x)
    else:
        rel = float(np.sqrt(float(r @ r) / bb))
    return CGResult(x=x, num_iters=total, rel_residual=rel,
                    converged=rel < rel_error)
