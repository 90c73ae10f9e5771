"""The conjugate-gradient engine.

ONE solver loop replaces the reference's six per-backend copies of the CG
recurrence (the algorithm at ConjugateGradient_CPU_OMP.hpp:50-91 is
repeated, kernel set and all, in every CUDA backend, e.g.
ConjugateGradient_GPU_CUDA.cu:226-325). Placement — single device vs. a
sharded mesh — is the *operator's* concern (lam_tpu/solver/operators.py,
lam_tpu/parallel/), not the loop's.

Device-resident structure: the entire iteration runs inside `lax.while_loop`
under `jit`, so there are ZERO host round-trips until convergence — unlike
the reference, which copies rr/bb device->host and re-launches kernels
every iteration (ConjugateGradient_GPU_CUDA.cu:285-287).

Semantics parity (required for iteration-count parity with the reference
corpus, see SURVEY.md §8.7):
  * update order: gemv; alpha = rr / p.Ap; x += alpha p; r -= alpha Ap;
    rr_new = r.r; beta = rr_new / rr; CONVERGENCE TEST; p = r + beta p
    (ConjugateGradient_CPU_OMP.hpp:68-79). The test precedes the p-update,
    so we run the p-update unconditionally (it cannot affect x, r, or rr
    once converged) and let the loop condition exit.
  * stopping rule: sqrt(rr / bb) < rel_error, with bb = b.b computed once
    up front (ConjugateGradient_CPU_OMP.hpp:65,77).
  * iteration counting: `num_iters` is the number of completed iterations;
    convergence at iteration k reports k; non-convergence reports
    max_iters (ConjugateGradient_CPU_OMP.hpp:81-90).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    """Solve outcome. Fields are device scalars/arrays until read."""

    x: jax.Array
    num_iters: jax.Array      # int32: completed iterations (see module doc)
    rel_residual: jax.Array   # sqrt(rr / bb) at exit
    converged: jax.Array      # bool


# Production inner-tolerance floors for the refinement loop, one per
# inner-operator class (iteration counts on the reference spectrum,
# N=4096):
#  * exact-f32 inner (ir/irq): flat 1e-5 — the recurrence stagnates
#    near kappa*eps_f32 (~7e-5) anyway, tighter just burns iterations.
#  * quantized inner (irfq): loose-early/tight-late SCHEDULE
#    (cycle c uses entry min(c, len-1)). (3e-2, 1e-2) recovers 8 of
#    the +21 inner iterations a flat 1e-2 pays vs ir, with one fewer
#    refinement cycle and the same 1e-9 true residual; floors tighter
#    than 1e-2 are below the 2^-16 inner operator's error floor and
#    COST iterations.
IR_INNER_FLOOR = 1e-5
IRFQ_INNER_FLOOR = (3e-2, 1e-2)


def default_inner_floor(precision):
    """The measured-best inner_floor (scalar or per-cycle schedule)
    for a refinement precision mode ("ir", "irq", "irfq")."""
    return IRFQ_INNER_FLOOR if precision == "irfq" else IR_INNER_FLOOR


@functools.partial(jax.jit, static_argnums=(0,))
def _cg_loop(matvec_dot, operand, b, max_iters, rel_error):
    """Jitted CG on (possibly padded) vectors.

    matvec_dot(operand, p) -> (Ap, p.Ap) — fusing the first dot product
    into the matvec lets the dense kernels produce it in the same pass
    over the matrix.
    """
    dtype = b.dtype
    bb = jnp.vdot(b, b)
    x0 = jnp.zeros_like(b)
    # x = 0, r = p = b (ConjugateGradient_CPU_OMP.hpp:56-63).
    eps = jnp.asarray(rel_error, dtype)

    def cond(carry):
        _, _, _, rr, k = carry
        unconverged = jnp.sqrt(rr / bb) >= eps
        return jnp.logical_and(k < max_iters, unconverged)

    def body(carry):
        x, r, p, rr, k = carry
        ap, p_ap = matvec_dot(operand, p)
        alpha = rr / p_ap
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = jnp.vdot(r, r)
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


@functools.partial(jax.jit, static_argnums=(0,))
def _pcg_loop(matvec_dot, operand, b, inv_diag, max_iters, rel_error):
    """Jacobi-preconditioned CG (surplus over the reference, which has no
    preconditioning). Same stopping contract as _cg_loop: the convergence
    test stays on the UNpreconditioned relative residual sqrt(rr/bb)."""
    dtype = b.dtype
    bb = jnp.vdot(b, b)
    eps = jnp.asarray(rel_error, dtype)
    x0 = jnp.zeros_like(b)
    z0 = inv_diag * b

    def cond(carry):
        _, _, _, _, rr, k = carry
        return jnp.logical_and(k < max_iters, jnp.sqrt(rr / bb) >= eps)

    def body(carry):
        x, r, p, rz, rr, k = carry
        ap, p_ap = matvec_dot(operand, p)
        alpha = rz / p_ap
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = jnp.vdot(r, z)
        rr_new = jnp.vdot(r, r)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, rr_new, k + 1)

    init = (x0, b, z0, jnp.vdot(b, z0), bb, jnp.int32(0))
    x, _, _, _, rr, k = jax.lax.while_loop(cond, body, init)
    rel = jnp.sqrt(rr / bb)
    converged = rel < eps
    num_iters = jnp.where(converged, k, max_iters).astype(jnp.int32)
    return CGResult(x=x, num_iters=num_iters, rel_residual=rel,
                    converged=converged)


def cg_solve(op, b, *, max_iters=1000, rel_error=1e-9,
             preconditioner=None):
    """Solve A x = b with CG for a LinearOperator `op`.

    `b` may be numpy or jax, length op.n; the result's x has length op.n
    (padding, sharding, and precision are handled by the operator).
    preconditioner="jacobi" uses diagonal scaling (requires the operator
    to expose a diagonal; surplus over the reference).
    """
    b_dev = op.prepare_b(b)
    if preconditioner is None:
        res = op.run_cg(_cg_loop, b_dev, jnp.int32(max_iters), rel_error)
    elif preconditioner == "jacobi":
        res = op.run_pcg(b_dev, jnp.int32(max_iters), rel_error)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    return res._replace(x=op.extract_x(res.x))


@functools.partial(jax.jit, static_argnums=(0,))
def _cg_block_loop(matvec, operand, b, max_iters, rel_error):
    """Block CG: k independent vectorized recurrences sharing each A read.

    Solves A X = B for an (n, k) block of right-hand sides with ONE
    matrix pass per iteration — the matvec becomes an (n,n)@(n,k) matmul
    that the tensor cores take well, and matrix traffic per system drops
    by k.
    Columns converge independently: converged columns freeze (alpha,
    beta masked to 0) while the rest continue. Surplus capability — the
    reference is strictly single-RHS.
    """
    dtype = b.dtype
    bb = jnp.sum(b * b, axis=0)                       # (k,)
    eps = jnp.asarray(rel_error, dtype)
    x0 = jnp.zeros_like(b)

    def active_mask(rr):
        return jnp.sqrt(rr / bb) >= eps

    def cond(carry):
        _, _, _, rr, _, k = carry
        return jnp.logical_and(k < max_iters, jnp.any(active_mask(rr)))

    def body(carry):
        x, r, p, rr, iters, k = carry
        ap = matvec(operand, p)
        pap = jnp.sum(p * ap, axis=0)
        active = active_mask(rr)
        alpha = jnp.where(active, rr / pap, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = jnp.sum(r * r, axis=0)
        beta = jnp.where(active, rr_new / rr, 0.0)
        rr = jnp.where(active, rr_new, rr)
        p = jnp.where(active, r + beta * p, p)
        iters = jnp.where(active, k + 1, iters)
        return (x, r, p, rr, iters, k + 1)

    init = (x0, b, b, bb, jnp.zeros(b.shape[1], jnp.int32), jnp.int32(0))
    x, _, _, rr, iters, _ = jax.lax.while_loop(cond, body, init)
    rel = jnp.sqrt(rr / bb)
    converged = rel < eps
    return CGResult(x=x, num_iters=iters, rel_residual=rel,
                    converged=converged)


def cg_solve_block(op, b_block, *, max_iters=1000, rel_error=1e-9):
    """Solve A X = B for an (n, k) block of right-hand sides.

    Per-column CGResult fields (num_iters/rel_residual/converged are
    (k,) arrays). Uses the operator's XLA matvec on the same operand (a
    block matvec is a matmul; the single-RHS Pallas kernels don't apply).
    """
    b_dev = op.prepare_b_block(b_block)
    res = op.run_cg_block(b_dev, jnp.int32(max_iters), rel_error)
    return res._replace(x=res.x[: op.n])


@functools.partial(jax.jit, static_argnums=(0, 1, 6))
def _cg_ir_loop(matvec_dot32, matvec_dot_acc, operand, b,
                max_iters, rel_error, max_cycles, inner_floor,
                inv_diag32=None):
    """Fully on-device mixed-precision CG with iterative refinement.

    Outer loop (f64): compute the true residual r = b - A x with the
    accurate operator, normalize it, and hand it to an inner f32 CG
    (`_cg_loop` with an f32-view matvec — half the HBM bytes per
    iteration). Both matvecs read the SAME operand buffers (the f32 view
    uses the hi plane of a df64 pair), so the program holds one copy of
    the matrix; both loops are lax.while_loops inside ONE jit: zero host
    round trips, unlike a Python refinement driver that syncs every cycle.

    inv_diag32 (optional, f32): Jacobi-precondition the INNER loop
    (`_pcg_loop` instead of `_cg_loop`). The outer true-residual
    recurrence is unchanged — preconditioning only reshapes the inner
    Krylov space, so refinement still converges to the accurate
    operator's solution.

    inner_floor may be a scalar or a PER-CYCLE schedule (a 1-D array;
    cycle c uses entry min(c, len-1)). Loose-early/tight-late
    schedules recover a slice of irfq's iteration premium — measured
    -8 of the +21 inner iterations at the N=4096 reference spectrum
    for (3e-2, 1e-2) vs flat 1e-2.
    """
    dtype = b.dtype
    bb = jnp.vdot(b, b)
    eps = jnp.asarray(rel_error, dtype)
    x0 = jnp.zeros_like(b)
    floors = jnp.atleast_1d(jnp.asarray(inner_floor, dtype))

    def rel_of(r):
        return jnp.sqrt(jnp.vdot(r, r) / bb)

    def cond(carry):
        _, r, k, cyc = carry
        return jnp.logical_and(
            jnp.logical_and(k < max_iters, cyc < max_cycles),
            rel_of(r) >= eps)

    def body(carry):
        x, r, k, cyc = carry
        rnorm = jnp.sqrt(jnp.vdot(r, r))
        rel = rnorm / jnp.sqrt(bb)
        # inner tolerance: enough to land under rel_error this cycle,
        # floored at what the inner operator can actually deliver
        floor = floors[jnp.minimum(cyc, floors.shape[0] - 1)]
        inner_tol = jnp.clip(eps / rel, floor, 0.99)
        r32 = (r / rnorm).astype(jnp.float32)
        if inv_diag32 is None:
            inner = _cg_loop(matvec_dot32, operand, r32, max_iters - k,
                             inner_tol.astype(jnp.float32))
        else:
            inner = _pcg_loop(matvec_dot32, operand, r32, inv_diag32,
                              max_iters - k,
                              inner_tol.astype(jnp.float32))
        x = x + inner.x.astype(dtype) * rnorm
        r = b - matvec_dot_acc(operand, x)[0]
        return (x, r, k + inner.num_iters, cyc + 1)

    x, r, k, _ = jax.lax.while_loop(
        cond, body, (x0, b, jnp.int32(0), jnp.int32(0)))
    rel = rel_of(r)
    return CGResult(x=x, num_iters=k, rel_residual=rel,
                    converged=rel < eps)


def _inv_diag_f32(op):
    """f32 inverse diagonal for Jacobi-preconditioning an inner loop.

    Padded entries carry d == 0; their residual is identically 0, so
    any finite inverse works — use 1 to avoid inf*0. Computed from the
    ACCURATE operator's diagonal (the f32 view shares its buffers), and
    inherits its sharding (replicated or P(axis)) so sharded inner
    loops consume it without a reshard."""
    d = op.diagonal()
    return jnp.where(d == 0, jnp.ones_like(d), 1.0 / d).astype(
        jnp.float32)


def cg_solve_ir(op32, op_acc, b, *, max_iters=10000, rel_error=1e-9,
                inner_floor=1e-5, max_cycles=6, preconditioner=None):
    """Mixed-precision CG with iterative refinement.

    Runs the CG iterations in f32 (half the HBM traffic of the
    df64/f64 matrix) and periodically restarts from the TRUE residual
    computed with the accurate operator: solve A d = r in f32, x += d,
    r = b - A x in df64/f64. Converges to full f64-quality residuals while
    streaming a 4-byte matrix through the hot loop. This path has no
    reference analog — it is pure capability surplus; the df64 path is the
    semantics-parity solver.

    op32 and op_acc must represent the same matrix in f32 and in
    accurate (f64/df64) form and share one padded vector space. Returns a
    CGResult on the accurate dtype; num_iters counts TOTAL inner f32
    iterations.

    inner_floor=1e-5: the f32 recurrence stagnates near kappa*eps_f32
    anyway (~7e-5 at the reference spectrum's kappa~e^7), so requesting
    1e-6 from a cycle just burns iterations at the floor — measured
    N=10000: 365 total inner iters at 1e-5 vs 372 at 1e-6, same final
    true residual (9.6e-10 vs 9.5e-10).

    preconditioner="jacobi" diagonal-scales the INNER loop (requires
    op_acc to expose a diagonal); the outer refinement recurrence is
    unchanged.
    """
    if preconditioner not in (None, "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    inv32 = _inv_diag_f32(op_acc) if preconditioner == "jacobi" else None
    b64 = op_acc.prepare_b(b)
    res = op_acc.run_cg_ir(op32, b64, jnp.int32(max_iters), rel_error,
                           max_cycles, inner_floor, inv_diag32=inv32)
    return res._replace(x=op_acc.extract_x(res.x))
