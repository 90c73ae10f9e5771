"""Headline benchmark: dense-CG time-to-1e-9 on one NVIDIA GPU.

BASELINE.json names the metric "time-to-1e-9 residual at N=10k and
N=70k". The headline line is N=10000 against the reference's
single-A100 anchor (0.261 s, TESTS/BEST_RESULTS:362); the north-star
leg is N=70000 on ONE card (39.2 GB in f64 — the reference needed
8x A100-40GB there, 1.672 s, TESTS/BEST_RESULTS:378). The N=70000 leg
needs a cached system (scripts/gen_bench_caches.py) and the native
pack, so the bench window is not spent generating it; progress goes to
stderr, the one JSON line to stdout.

Every size is scored against EVERY applicable reference anchor: `vs_*`
= absolute wall-clock ratio, `per_chip_*` = (anchor_s x anchor_chips) /
our_s. The 4x A100 NCCL anchor includes ~7.8 s of NCCL init (the
reference pays it every run); the 8x A100 MPI anchor is the harder row
— both are emitted so neither can be mistaken for the whole story.

Systems use the reference construction (eigenvalues exp(3.5*U(-1,1)),
random orthogonal similarity, random U(-1,1) rhs); every solve's TRUE
residual is validated host-side in f64. Precisions, in every size:
f64 = native f64 on the full square (the platform default), ir = f32
iterations refined against it, irfq = refinement on fully-quantized
packed storage (2-byte inner plane, walked by the triangle-walk
kernel). Each is timed best-of-3 with scalar readbacks.

Without a GPU the bench exits non-zero: its numbers are device numbers.
Prints exactly one JSON line:
  {"metric": ..., "value": s, "unit": "s", "vs_baseline": speedup,
   "device": {"platform", "device_kind", "device_count", "card"}, ...}
vs_baseline > 1 means faster than the reference A100.
"""

import json
import os
import sys
import time

import numpy as np

# Reference anchors (BASELINE.md / TESTS/BEST_RESULTS): per size, a
# tuple of (name, chips, seconds). The FIRST anchor is the primary one
# for that size's vs_A100 field; all are emitted as vs_<name> +
# per_chip_<name>.
#   N=10000: 1x A100 0.261 s (:362); 8x A100 MPI 0.194 s (:365)
#   N=20000: 1x A100 0.866 s (:366)
#   N=40000: 4x A100 NCCL 8.782 s incl ~7.8 s init (:439);
#            8x A100 MPI 0.651 s (:374)
#   N=70000: 8x A100 MPI 1.672 s (:378) — the north star; no smaller
#            reference config ever ran this size (39 GB fp64)
ANCHORS = {
    10000: (("A100x1", 1, 0.261), ("A100x8_mpi", 8, 0.194)),
    20000: (("A100x1", 1, 0.866),),
    40000: (("A100x4_nccl", 4, 8.782), ("A100x8_mpi", 8, 0.651)),
    70000: (("A100x8_mpi", 8, 1.672),),
}
DEFAULT_SIZES = (10000, 20000, 40000, 70000)
SIZES = tuple(int(s) for s in os.environ.get(
    "LAM_BENCH_SIZES", ",".join(map(str, DEFAULT_SIZES))).split(","))
HEADLINE_N = SIZES[0]
NORTH_STAR_N = 70000
# above this the system is read from its cache as a memory map and the
# legs run one at a time, each operator freed before the next loads
BIG_FIT_N = 60000
TOL = 1e-9
SEED = 2024


def _progress(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _try_remove(path):
    try:
        os.remove(path)
    except OSError:
        pass


def _cache_paths(n):
    # io/ is gitignored; generation costs minutes at N=20000 and over
    # an hour at N=70000 on one core, so a bench run should find a
    # cache (scripts/gen_bench_caches.py builds them).
    here = os.path.dirname(os.path.abspath(__file__))
    name = f"lam_bench_spd_N{n}_s{SEED}.npy"
    return [os.path.join(here, "io", "bench", name),
            os.path.join("/tmp", name)]


def _system(n):
    from lam_tpu import generate as gen
    t0 = time.perf_counter()
    paths = _cache_paths(n)
    a = None
    for p in paths:
        if os.path.exists(p):
            a = np.load(p)
            break
    if a is None:
        _progress(f"N={n}: no cached system, generating (~minutes)")
        a = gen.random_spd_matrix_fast(n, seed=SEED)
        for p in paths:
            # atomic publish: a partial write (disk full, Ctrl-C) must
            # not leave a truncated .npy at the cache path — it persists
            # (io/bench survives sessions) and would break every later
            # run at np.load
            tmp = p + ".tmp"
            try:
                os.makedirs(os.path.dirname(p), exist_ok=True)
                with open(tmp, "wb") as fh:
                    np.save(fh, a)
                os.replace(tmp, p)
                break
            except OSError:
                _try_remove(tmp)
                continue  # fall through to the next cache location
            except BaseException:
                _try_remove(tmp)  # e.g. Ctrl-C mid-write
                raise
    b = gen.random_rhs(n, seed=SEED + 10)
    cached = next((pp for pp in paths if os.path.exists(pp)), None)
    return a, b, cached, time.perf_counter() - t0


def _true_rel(a, b, x, blk=4096):
    """||b - A x|| / ||b|| in f64 on the host, streaming A by row blocks
    (a may be a memory map of a system larger than host RAM twice)."""
    x = np.asarray(x, np.float64)
    r = np.array(b, dtype=np.float64)
    for s in range(0, a.shape[0], blk):
        r[s:s + blk] -= a[s:s + blk] @ x
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _timed(fn):
    best, best_res = None, None
    for _ in range(3):
        t0 = time.perf_counter()
        r = fn()
        float(r.rel_residual)  # scalar readback forces execution
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, best_res = dt, r
    return best, best_res


def _leg(dt, res, a, b):
    return {"s": round(dt, 4), "iters": int(res.num_iters),
            "true_rel": _true_rel(a, b, res.x),
            "converged": bool(res.converged)}


def _f64_legs(a, b):
    """f64 and ir on the full f64 square: ir's inner loop is the f32
    view of the same operator."""
    import jax

    from lam_tpu import DenseOperator, cg_solve, cg_solve_ir

    op = DenseOperator.from_dense(a, precision="f64")
    op32 = op.as_f32()
    jax.block_until_ready(op.operand)
    out = {}
    r0 = cg_solve(op, b, max_iters=0, rel_error=TOL)  # compile
    float(r0.rel_residual)
    out["f64"] = _leg(*_timed(lambda: cg_solve(
        op, b, max_iters=10000, rel_error=TOL)), a, b)
    _ = cg_solve_ir(op32, op, b, max_iters=30, rel_error=1e-2)  # compile
    out["ir"] = _leg(*_timed(lambda: cg_solve_ir(
        op32, op, b, max_iters=10000, rel_error=TOL)), a, b)
    return out


def _irfq_leg(cache_path, a, b):
    """irfq on fully-quantized packed storage. pack_cache: the first run
    publishes the packed planes beside the .npy (3.2x smaller than the
    source); later runs reload them at raw disk speed."""
    import jax

    from lam_tpu import DenseOperator, cg_solve_ir
    from lam_tpu.solver.cg import default_inner_floor

    t0 = time.perf_counter()
    opq = DenseOperator.from_file_fq(cache_path, pack_cache=True)
    opq32 = opq.as_f32()
    jax.block_until_ready(opq.operand)
    load_s = time.perf_counter() - t0
    floor = default_inner_floor("irfq")
    _ = cg_solve_ir(opq32, opq, b, max_iters=30, rel_error=1e-2,
                    inner_floor=floor)  # compile
    leg = _leg(*_timed(lambda: cg_solve_ir(
        opq32, opq, b, max_iters=10000, rel_error=TOL,
        inner_floor=floor)), a, b)
    return leg, load_s


def _measure_big(n):
    """North-star leg (N > BIG_FIT_N), from the cached system only: the
    answer-from-cold irfq leg (outer='host'), f64 and ir on the 39.2 GB
    square, then irfq with the full cascade resident."""
    import jax

    from lam_tpu import DenseOperator, cg_solve_ir_host
    from lam_tpu import generate as gen
    from lam_tpu.solver.host_outer import host_matvec

    cache_path = next((p for p in _cache_paths(n) if os.path.exists(p)),
                      None)
    if cache_path is None:
        raise SystemExit(f"N={n}: no cached system; build it first with "
                         "scripts/gen_bench_caches.py")

    b = gen.random_rhs(n, seed=SEED + 10)
    a = np.load(cache_path, mmap_mode="r")

    # answer-from-cold leg FIRST (outer='host'): only the q1 plane goes
    # to the device, outer residuals stream the f64 source host-side
    _progress(f"N={n}: outer=host leg — q1-only load")
    t0 = time.perf_counter()
    op_q1 = DenseOperator.from_file_fq_q1(cache_path, pack_cache=True)
    jax.block_until_ready(op_q1.operand)
    ho_load = time.perf_counter() - t0
    mv = host_matvec(a)
    cg_solve_ir_host(mv, op_q1, b, max_iters=0)  # compile
    ho_dt, ho_res = _timed(lambda: cg_solve_ir_host(
        mv, op_q1, b, max_iters=10000, rel_error=TOL))
    # validated by its own pass over the source, not by the dsymv the
    # solver's outer residuals used
    host_outer = {
        "load_s": round(ho_load, 1), "s": round(ho_dt, 3),
        "load_plus_solve_s": round(ho_load + ho_dt, 1),
        "iters": int(ho_res.num_iters),
        "true_rel": _true_rel(a, b, ho_res.x),
        "converged": bool(ho_res.converged)}
    del op_q1, ho_res, mv  # free the device before the next leg

    _progress(f"N={n}: f64 and ir on the full square")
    out = _f64_legs(a, b)
    _progress(f"N={n}: irfq, full cascade resident")
    out["irfq"], load_s = _irfq_leg(cache_path, a, b)
    # end-to-end time-to-answer: the reference's honest comparator is
    # its own load+solve (13.3 s MPI-IO + 1.672 s on 8x A100,
    # MERGE_GPU_MPI.txt 70000,8 row)
    out.update(load_s=round(load_s, 1),
               load_plus_solve_s=round(load_s + out["irfq"]["s"], 1),
               host_outer=host_outer)
    return out


def _measure(n):
    if n > BIG_FIT_N:
        return _measure_big(n)
    a, b, cache_path, gen_s = _system(n)
    if cache_path is None:
        raise SystemExit(f"N={n}: could not publish the system cache the "
                         "irfq leg loads")
    out = {"gen_s": round(gen_s, 2)}
    out.update(_f64_legs(a, b))
    out["irfq"], _ = _irfq_leg(cache_path, a, b)
    return out


def _anchor_fields(n, our_s):
    """vs_<anchor> (absolute wall-clock ratio) and per_chip_<anchor>
    (anchor chip-seconds per card-second) for every anchor at size n."""
    fields = {}
    for name, chips, anchor_s in ANCHORS.get(n, ()):
        fields[f"vs_{name}"] = round(anchor_s / our_s, 3)
        if chips > 1:
            fields[f"per_chip_{name}"] = round(anchor_s * chips / our_s,
                                               3)
    return fields


def main():
    import lam_tpu  # noqa: F401  (x64 on)
    from lam_tpu import platform

    device = platform.require_gpu()
    _progress(f"card: {device['card']}")

    all_results = {}
    for n in sorted(SIZES):
        _progress(f"measuring N={n}")
        all_results[n] = _measure(n)

    def best_valid(res):
        valid = {k: v for k, v in res.items()
                 if isinstance(v, dict) and v.get("converged")
                 and v.get("true_rel", 1.0) <= 2e-9}
        if not valid:
            return None, None
        k = min(valid, key=lambda k: valid[k]["s"])
        return k, valid[k]

    engine, head = best_valid(all_results[HEADLINE_N])
    if head is None:
        print(json.dumps({"metric": f"time_to_1e-9_N{HEADLINE_N}_1chip",
                          "value": None, "unit": "s", "vs_baseline": 0.0,
                          "error": "no engine reached a validated 1e-9 "
                                   "true residual",
                          "detail": all_results, "device": device}))
        return 1

    secondary = {}
    for n, res in all_results.items():
        eng, v = best_valid(res)
        if v is not None:
            entry = {"s": v["s"], "engine": eng, "iters": v["iters"],
                     "true_rel": v["true_rel"]}
            # every precision's leg beside the best one
            entry["legs"] = {k: {f: res[k][f] for f in ("s", "iters",
                                                       "true_rel")}
                             for k in ("f64", "ir", "irfq") if k in res}
            if "load_s" in res:
                entry["load_s"] = res["load_s"]
            if "load_plus_solve_s" in res:
                entry["load_plus_solve_s"] = res["load_plus_solve_s"]
            if "host_outer" in res:
                entry["host_outer"] = res["host_outer"]
            entry.update(_anchor_fields(n, v["s"]))
            secondary[f"N{n}"] = entry

    # a headline size outside ANCHORS (e.g. the documented 57344 opt-in
    # via LAM_BENCH_SIZES) has no reference row: vs_baseline degrades
    # to 0.0 instead of crashing after the full measurement run
    head_anchors = ANCHORS.get(HEADLINE_N)
    out = {
        "metric": f"time_to_1e-9_N{HEADLINE_N}_1chip",
        "value": head["s"],
        "unit": "s",
        "vs_baseline": (secondary[f"N{HEADLINE_N}"].get(
            f"vs_{head_anchors[0][0]}", 0.0) if head_anchors else 0.0),
        "engine": engine,
        "iters": head["iters"],
        "true_rel_residual": head["true_rel"],
        "sizes": secondary,
        "device": device,
    }

    # the north star BASELINE.json names: time-to-1e-9 at N=70000.
    # 39.2 GB fp64 — the reference needed 8x A100-40GB (1.672 s).
    ns = all_results.get(NORTH_STAR_N)
    if ns is not None and "irfq" in ns and ns["irfq"].get("converged") \
            and ns["irfq"].get("true_rel", 1.0) <= 2e-9:
        v = ns["irfq"]
        out["north_star"] = {
            "metric": f"time_to_1e-9_N{NORTH_STAR_N}_1chip",
            "value": v["s"], "unit": "s",
            "iters": v["iters"], "true_rel_residual": v["true_rel"],
            "load_s": ns["load_s"],
            # end-to-end time-to-answer vs the reference's own
            # load+solve: 13.3 s MPI-IO read + 1.672 s solve on
            # 8x A100 across 2 nodes (MERGE_GPU_MPI.txt row 70000,8)
            "load_plus_solve_s": ns["load_plus_solve_s"],
            "ref_load_plus_solve_s_8xA100": 13.3 + 1.672,
            **_anchor_fields(NORTH_STAR_N, v["s"]),
        }
        if "host_outer" in ns and ns["host_outer"].get("converged") \
                and ns["host_outer"].get("true_rel", 1.0) <= 2e-9:
            # answer-from-cold configuration (outer='host'): q1-only
            # upload + host-exact outer residuals — the honest
            # time-to-answer comparator against the reference's 15.0 s
            out["north_star"]["host_outer"] = ns["host_outer"]

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
