"""Solver-state checkpoint / resume and segmented solving.

The reference has NO mid-solve persistence (SURVEY.md §5: the only state
ever written is the final solution). For production runs at
N=hundreds-of-thousands (the reference stress-tests N=560000 across 64
GPUs) a lost job means restarting a multi-minute solve from scratch —
this module adds the missing capability:

  * the CG state (x, r, p, rr, k) is a well-defined restart point: CG
    continues exactly (same recurrence, same convergence contract);
  * `cg_solve_resumable` runs the on-device loop in segments, optionally
    persisting state every segment (reference binary format per vector +
    a JSON sidecar), and can resume from a checkpoint file — for plain
    CG and (round 3) Jacobi PCG, whose restart point adds the carried
    rz product; the sidecar is kind-tagged so the two recurrences
    cannot be cross-resumed;
  * per-segment wall times give honest in-loop avg-iteration numbers
    (the reference times every iteration on the host; we keep the loop
    on device and sample at segment granularity).
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lam_tpu import io as lio
from lam_tpu.solver.cg import CGResult


class CGState(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rr: jax.Array
    bb: jax.Array
    k: jax.Array  # completed iterations (int32)


class PCGState(NamedTuple):
    """Jacobi-PCG restart point: the plain-CG state plus the carried
    preconditioned inner product rz = <r, M^-1 r>
    (lam_tpu/solver/cg.py:_pcg_loop)."""
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rz: jax.Array
    rr: jax.Array
    bb: jax.Array
    k: jax.Array  # completed iterations (int32)


@functools.partial(jax.jit, static_argnums=(0,))
def _cg_segment(matvec_dot, operand, state, k_stop, rel_error):
    """Continue the reference-order CG recurrence until k_stop or
    convergence, starting from an arbitrary CGState."""
    eps = jnp.asarray(rel_error, state.x.dtype)
    bb = state.bb

    def cond(s):
        return jnp.logical_and(s.k < k_stop,
                               jnp.sqrt(s.rr / bb) >= eps)

    def body(s):
        ap, p_ap = matvec_dot(operand, s.p)
        alpha = s.rr / p_ap
        x = s.x + alpha * s.p
        r = s.r - alpha * ap
        rr_new = jnp.vdot(r, r)
        beta = rr_new / s.rr
        p = r + beta * s.p
        return CGState(x=x, r=r, p=p, rr=rr_new, bb=bb, k=s.k + 1)

    return jax.lax.while_loop(cond, body, state)


@functools.partial(jax.jit, static_argnums=(0,))
def _pcg_segment(matvec_dot, operand, inv_diag, state, k_stop, rel_error):
    """Continue the Jacobi-PCG recurrence (same body as _pcg_loop,
    lam_tpu/solver/cg.py:101-112) until k_stop or convergence, starting
    from an arbitrary PCGState. Convergence stays on the
    UNpreconditioned relative residual sqrt(rr/bb)."""
    eps = jnp.asarray(rel_error, state.x.dtype)
    bb = state.bb

    def cond(s):
        return jnp.logical_and(s.k < k_stop,
                               jnp.sqrt(s.rr / bb) >= eps)

    def body(s):
        ap, p_ap = matvec_dot(operand, s.p)
        alpha = s.rz / p_ap
        x = s.x + alpha * s.p
        r = s.r - alpha * ap
        z = inv_diag * r
        rz_new = jnp.vdot(r, z)
        rr_new = jnp.vdot(r, r)
        beta = rz_new / s.rz
        p = z + beta * s.p
        return PCGState(x=x, r=r, p=p, rz=rz_new, rr=rr_new, bb=bb,
                        k=s.k + 1)

    return jax.lax.while_loop(cond, body, state)


def initial_state(op, b_padded):
    bb = jnp.vdot(b_padded, b_padded)
    return CGState(x=jnp.zeros_like(b_padded), r=b_padded, p=b_padded,
                   rr=bb, bb=bb, k=jnp.int32(0))


def initial_pcg_state(op, b_padded, inv_diag):
    bb = jnp.vdot(b_padded, b_padded)
    z0 = inv_diag * b_padded
    return PCGState(x=jnp.zeros_like(b_padded), r=b_padded, p=z0,
                    rz=jnp.vdot(b_padded, z0), rr=bb, bb=bb,
                    k=jnp.int32(0))


def save_state(path, state, n):
    """Persist a CGState or PCGState: vectors in the reference binary
    format plus a JSON sidecar with the scalars (PCG adds "kind" and
    the carried rz product)."""
    os.makedirs(path, exist_ok=True)
    for name in ("x", "r", "p"):
        lio.write_matrix(os.path.join(path, f"{name}.bin"),
                         np.asarray(getattr(state, name)))
    meta = {"rr": float(state.rr), "bb": float(state.bb),
            "k": int(state.k), "n": int(n),
            "n_padded": int(state.x.shape[0])}
    if isinstance(state, PCGState):
        meta["kind"] = "pcg"
        meta["rz"] = float(state.rz)
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(meta, f)


def load_state(path, op, kind="cg"):
    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    if meta["n"] != op.n or meta["n_padded"] != op.n_padded:
        raise ValueError(
            f"checkpoint is for n={meta['n']}/pad={meta['n_padded']}, "
            f"operator has n={op.n}/pad={op.n_padded}")
    stored = meta.get("kind", "cg")
    if stored != kind:
        raise ValueError(
            f"checkpoint was written by a {stored!r} solve; cannot "
            f"resume it as {kind!r} (the recurrences carry different "
            "state)")
    vecs = {}
    for name in ("x", "r", "p"):
        v = lio.read_vector(os.path.join(path, f"{name}.bin"))
        vecs[name] = jnp.asarray(v, dtype=op.vector_dtype)
    dt = op.vector_dtype
    if kind == "pcg":
        return PCGState(x=vecs["x"], r=vecs["r"], p=vecs["p"],
                        rz=jnp.asarray(meta["rz"], dt),
                        rr=jnp.asarray(meta["rr"], dt),
                        bb=jnp.asarray(meta["bb"], dt),
                        k=jnp.int32(meta["k"]))
    return CGState(x=vecs["x"], r=vecs["r"], p=vecs["p"],
                   rr=jnp.asarray(meta["rr"], dt),
                   bb=jnp.asarray(meta["bb"], dt), k=jnp.int32(meta["k"]))


def cg_solve_resumable(op, b, *, max_iters=1000, rel_error=1e-9,
                       segment=100, checkpoint_path=None, resume=False,
                       on_segment=None, preconditioner=None):
    """Segmented CG with optional checkpointing.

    Runs `segment` iterations per device call; after each segment the
    state may be persisted (`checkpoint_path`) and `on_segment(state,
    seg_seconds)` is invoked (timing hook). `resume=True` restarts from
    the checkpoint. preconditioner="jacobi" runs the diagonal-scaled
    recurrence instead (same trajectory as cg_solve(...,
    preconditioner="jacobi"); the sidecar tags the checkpoint so the
    two recurrences cannot be cross-resumed). Returns the usual
    CGResult plus per-segment timings.
    """
    if preconditioner not in (None, "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    b_padded = op.prepare_b(b)
    inv_d = None
    if preconditioner == "jacobi":
        d = op.diagonal()
        # padded entries have d == 0; their residual is 0 anyway (see
        # LinearOperator.run_pcg) — use 1 to avoid inf*0
        inv_d = jnp.where(d == 0, jnp.ones_like(d), 1.0 / d)
    kind = "cg" if inv_d is None else "pcg"
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        state = load_state(checkpoint_path, op, kind=kind)
    elif inv_d is None:
        state = initial_state(op, b_padded)
    else:
        state = initial_pcg_state(op, b_padded, inv_d)

    seg_times = []
    matvec_dot = op._matvec_dot_fn
    while True:
        k_now = int(state.k)
        if k_now >= max_iters:
            break
        rel_now = float(jnp.sqrt(state.rr / state.bb))
        if rel_now < rel_error:
            break
        k_stop = jnp.int32(min(k_now + segment, max_iters))
        t0 = time.perf_counter()
        if inv_d is None:
            state = _cg_segment(matvec_dot, op.operand, state, k_stop,
                                rel_error)
        else:
            state = _pcg_segment(matvec_dot, op.operand, inv_d, state,
                                 k_stop, rel_error)
        float(state.rr)  # force execution before timing
        dt = time.perf_counter() - t0
        seg_times.append((int(state.k) - k_now, dt))
        if checkpoint_path:
            save_state(checkpoint_path, state, op.n)
        if on_segment is not None:
            on_segment(state, dt)

    rel = jnp.sqrt(state.rr / state.bb)
    converged = rel < rel_error
    num_iters = jnp.where(converged, state.k,
                          jnp.int32(max_iters)).astype(jnp.int32)
    result = CGResult(x=op.extract_x(state.x), num_iters=num_iters,
                      rel_residual=rel, converged=converged)
    return result, seg_times


# --- resumable mixed-precision (ir) solving --------------------------------
#
# Refinement-CYCLE boundaries are
# natural restart points — the outer state is just (x, r, k, cycle) in
# f64, and the f64 binary format round-trips bit-exactly, so a resumed
# solve continues with the same per-cycle arithmetic as an uninterrupted
# one. One cycle below is the same math as one _cg_ir_loop body
# (lam_tpu/solver/cg.py): inner tolerance from the current relative
# residual, normalized f32 inner CG, f64 correction + true residual.


@functools.partial(jax.jit, static_argnums=(0, 1))
def _ir_cycle(matvec_dot32, matvec_dot_acc, operand, b, x, r, k_left,
              rel_error, inner_floor, inv_diag32=None):
    """One refinement cycle from (x, r); returns (x', r', inner_iters).

    Matches _cg_ir_loop's body exactly (same inner-tolerance schedule,
    same update order) so a cycle-checkpointed solve follows the same
    trajectory as the fused on-device loop. inv_diag32
    Jacobi-preconditions the inner loop (same contract as
    _cg_ir_loop)."""
    from lam_tpu.solver.cg import _cg_loop, _pcg_loop
    dtype = b.dtype
    bb = jnp.vdot(b, b)
    eps = jnp.asarray(rel_error, dtype)
    rnorm = jnp.sqrt(jnp.vdot(r, r))
    rel = rnorm / jnp.sqrt(bb)
    inner_tol = jnp.clip(eps / rel, inner_floor, 0.99)
    r32 = (r / rnorm).astype(jnp.float32)
    if inv_diag32 is None:
        inner = _cg_loop(matvec_dot32, operand, r32, k_left,
                         inner_tol.astype(jnp.float32))
    else:
        inner = _pcg_loop(matvec_dot32, operand, r32, inv_diag32,
                          k_left, inner_tol.astype(jnp.float32))
    x = x + inner.x.astype(dtype) * rnorm
    r = b - matvec_dot_acc(operand, x)[0]
    return x, r, inner.num_iters


def save_ir_state(path, x, r, k, cycle, n, preconditioner=None):
    os.makedirs(path, exist_ok=True)
    lio.write_matrix(os.path.join(path, "x.bin"), np.asarray(x))
    lio.write_matrix(os.path.join(path, "r.bin"), np.asarray(r))
    with open(os.path.join(path, "ir_state.json"), "w") as f:
        json.dump({"k": int(k), "cycle": int(cycle), "n": int(n),
                   "n_padded": int(x.shape[0]),
                   "preconditioner": preconditioner}, f)


def load_ir_state(path, op, preconditioner=None):
    with open(os.path.join(path, "ir_state.json")) as f:
        meta = json.load(f)
    if meta["n"] != op.n or meta["n_padded"] != op.n_padded:
        raise ValueError(
            f"ir checkpoint is for n={meta['n']}/pad={meta['n_padded']}, "
            f"operator has n={op.n}/pad={op.n_padded}")
    # older sidecars (pre-preconditioner) lack the key: treat as None
    saved = meta.get("preconditioner")
    if saved != preconditioner:
        raise ValueError(
            f"ir checkpoint was written with "
            f"preconditioner={saved!r}; resuming with "
            f"{preconditioner!r} would follow a different trajectory")
    x = jnp.asarray(lio.read_vector(os.path.join(path, "x.bin")),
                    dtype=op.vector_dtype)
    r = jnp.asarray(lio.read_vector(os.path.join(path, "r.bin")),
                    dtype=op.vector_dtype)
    return x, r, meta["k"], meta["cycle"]


def cg_solve_ir_resumable(op32, op_acc, b, *, max_iters=10000,
                          rel_error=1e-9, inner_floor=1e-5, max_cycles=6,
                          checkpoint_path=None, resume=False,
                          on_cycle=None, preconditioner=None):
    """Mixed-precision refinement with per-cycle checkpointing.

    Same contract as cg_solve_ir (lam_tpu/solver/cg.py) plus: after
    every refinement cycle the outer state persists to
    `checkpoint_path` (f64 vectors in the reference binary format + a
    JSON sidecar), and `resume=True` continues from it bit-exactly.
    The sidecar records the preconditioner so a resume with a different
    one is rejected (it would follow a different inner trajectory).
    Returns (CGResult, [(inner_iters, cycle_seconds), ...])."""
    from lam_tpu.solver.cg import _inv_diag_f32
    if op32.operand is not op_acc.operand:
        raise ValueError(
            "cg_solve_ir requires the f32 operator to be a VIEW of the "
            "accurate operator (use op_acc.as_f32())")
    if preconditioner not in (None, "jacobi"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    inv32 = (_inv_diag_f32(op_acc) if preconditioner == "jacobi"
             else None)
    b_p = op_acc.prepare_b(b)
    if resume:
        if not checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        x, r, k, cycle = load_ir_state(checkpoint_path, op_acc,
                                       preconditioner)
    else:
        x, r, k, cycle = jnp.zeros_like(b_p), b_p, 0, 0

    bb = float(jnp.vdot(b_p, b_p))
    cyc_times = []
    mv32 = op32._matvec_dot_fn
    mv_acc = op_acc._matvec_dot_fn
    while True:
        rel_now = float(jnp.sqrt(jnp.vdot(r, r))) / np.sqrt(bb)
        if rel_now < rel_error or k >= max_iters or cycle >= max_cycles:
            break
        t0 = time.perf_counter()
        # scalar-or-schedule contract of _cg_ir_loop: cycle c uses
        # floors[min(c, len-1)] — indexed HERE (the Python driver owns
        # the cycle counter), so a resumed solve picks up the same
        # schedule position the fused loop would be at
        floors = np.atleast_1d(np.asarray(inner_floor, np.float64))
        floor = float(floors[min(cycle, len(floors) - 1)])
        x, r, inner_iters = _ir_cycle(mv32, mv_acc, op_acc.operand, b_p,
                                      x, r, jnp.int32(max_iters - k),
                                      rel_error,
                                      jnp.asarray(floor, b_p.dtype),
                                      inv_diag32=inv32)
        k += int(inner_iters)  # device sync bounds the cycle timing too
        cycle += 1
        cyc_times.append((int(inner_iters), time.perf_counter() - t0))
        if checkpoint_path:
            save_ir_state(checkpoint_path, np.asarray(x), np.asarray(r),
                          k, cycle, op_acc.n,
                          preconditioner=preconditioner)
        if on_cycle is not None:
            on_cycle(x, r, k, cycle)

    rel = jnp.sqrt(jnp.vdot(r, r) / bb)
    converged = rel < rel_error
    result = CGResult(x=op_acc.extract_x(x),
                      num_iters=jnp.int32(k), rel_residual=rel,
                      converged=converged)
    return result, cyc_times
