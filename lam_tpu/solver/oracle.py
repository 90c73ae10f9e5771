"""Numpy float64 reference CG: the correctness oracle.

Library home of the single canonical oracle — consumed by the test
suite and __graft_entry__.dryrun_multichip (one copy, so stopping-rule
fixes cannot drift between checkers).

Implements exactly the reference algorithm and stopping rule
(ConjugateGradient_CPU_OMP.hpp:50-91): update order, convergence test
before the p-update, iteration counting. Cross-implementation agreement
on (num_iters, rel_residual) is the reference project's own de-facto
oracle (identical columns across backends in TESTS/results/MERGE_*.txt).
"""

import numpy as np


def oracle_cg(a, b, max_iters=1000, rel_error=1e-9):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    p = b.copy()
    bb = float(b @ b)
    rr = bb
    for k in range(1, max_iters + 1):
        ap = a @ p
        alpha = rr / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = float(r @ r)
        beta = rr_new / rr
        rr = rr_new
        if np.sqrt(rr / bb) < rel_error:
            return x, k, float(np.sqrt(rr / bb)), True
        p = r + beta * p
    return x, max_iters, float(np.sqrt(rr / bb)), False
