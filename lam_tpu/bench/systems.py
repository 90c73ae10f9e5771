"""Shared on-disk cache of benchmark SPD systems (.npy).

The reference pre-generates its benchmark matrices ONCE with
random_spd_system and every SLURM sweep re-reads the files
(TESTS/GPU_SCRIPTS/GPU_2_NODE.sh:13,33-39 point at a shared project
dir). Here: spectrum-law systems cached as .npy under io/bench/
(gitignored, persists with the checkout) so neither bench.py nor
`lam-bench --mode spd --pack-cache` pays the Householder generation
again (tens of minutes on one core at N=40000, over an hour at 70000).

Path scheme matches bench.py's caches (lam_bench_spd_N{n}_s{seed}
.npy) so the two tools share one corpus: search order is
$LAM_BENCH_CACHE_DIR, <repo-root>/io/bench (repo root derived from this
file: tools may run from any cwd), <cwd>/io/bench, /tmp.
"""

from __future__ import annotations

import os

import numpy as np

SEED = 2024


def cache_dirs():
    env = os.environ.get("LAM_BENCH_CACHE_DIR")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dirs = [env] if env else []
    dirs.append(os.path.join(repo_root, "io", "bench"))
    dirs.append(os.path.join(os.getcwd(), "io", "bench"))
    dirs.append("/tmp")
    # dedupe, order-preserving (cwd may BE the repo root)
    seen = set()
    return [d for d in dirs if not (d in seen or seen.add(d))]


def cache_paths(n, seed=SEED):
    name = f"lam_bench_spd_N{n}_s{seed}.npy"
    return [os.path.join(d, name) for d in cache_dirs()]


def find_cached(n, seed=SEED):
    """Path of a cached N x N system, or None."""
    return next((p for p in cache_paths(n, seed) if os.path.exists(p)),
                None)


def publish(a, n, seed=SEED):
    """Atomically publish a generated system to the first writable
    cache location; returns its path or None (best-effort — a full
    disk must not fail the run that generated the system)."""
    for p in cache_paths(n, seed):
        tmp = p + ".tmp"
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(tmp, "wb") as fh:
                np.save(fh, a)
            os.replace(tmp, p)
            return p
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            continue
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    return None
