"""Build the bench.py system caches (io/bench/*.npy).

io/ is gitignored, and bench.py needs the cached SPD systems: cold
generation is single-core Householder work whose cost grows as N^2
(minutes at N=20000, over an hour at N=70000). Run this ahead of the
bench, in the background:

    LAM_GEN_PREPACK=1 python scripts/gen_bench_caches.py &

Sizes via LAM_GEN_SIZES (comma list; default = bench.py's sizes,
LARGEST FIRST: an interrupted run then leaves the most expensive
artifact cached). LAM_GEN_PREPACK=1 additionally publishes each size's
fq pack cache right after its .npy lands
(scripts/prepack_bench_caches.py). Skips sizes already cached.
Publishes atomically (bench.py contract).
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SEED = 2024
SIZES = tuple(int(s) for s in os.environ.get(
    "LAM_GEN_SIZES", "70000,40000,20000,10000").split(","))
PREPACK = bool(os.environ.get("LAM_GEN_PREPACK"))


def main():
    from lam_tpu import generate as gen
    if PREPACK:
        from prepack_bench_caches import prepack
    for n in SIZES:
        path = os.path.join(HERE, "io", "bench",
                            f"lam_bench_spd_N{n}_s{SEED}.npy")
        if os.path.exists(path):
            print(f"N={n}: already cached", flush=True)
        else:
            t0 = time.time()
            print(f"N={n}: generating...", flush=True)
            a = gen.random_spd_matrix_fast(n, seed=SEED)
            print(f"N={n}: generated in {time.time() - t0:.0f}s; writing "
                  f"{8 * n * n / 1e9:.1f} GB...", flush=True)
            tmp = path + ".tmp"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(tmp, "wb") as fh:
                    np.save(fh, a)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            del a  # 8*N^2 bytes; drop before the pack allocates its planes
            print(f"N={n}: published in {time.time() - t0:.0f}s total",
                  flush=True)
        if PREPACK:
            prepack(path)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
