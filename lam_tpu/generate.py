"""Problem generators: tridiagonal benchmark systems and random SPD systems.

Covers both reference generators:
  * the built-in "gen mode" dense tridiagonal (2 on the diagonal, 1 on the
    off-diagonals) with an all-ones rhs — the fixture-free benchmark mode
    (ConjugateGradient_CPU_MPI_OMP.hpp:237-247 and :159-164);
  * the offline MKL random-SPD-system tool (random_spd_system.cpp): random
    orthogonal Q via Gram-Schmidt, eigenvalues D = exp(3.5 * U(-1, 1)),
    A = (Q sqrt(D)) (Q sqrt(D))^T, random U(-1,1) rhs.

The MKL recursive blocked Gram-Schmidt (random_spd_system.cpp:41-62) is an
orthonormalization of a random square matrix; here numpy's Householder QR
produces the same distribution class (Haar-like orthogonal factor) without
MKL. A Householder-product variant generates the identical *spectrum*
(which is what controls CG iteration counts) in O(k N^2) for large N where
the O(N^3) orthonormalization would be prohibitive.
"""

from __future__ import annotations

import numpy as np


def tridiagonal_rows(row_start, num_rows, n, dtype=np.float64):
    """Dense row-block of the gen-mode tridiagonal matrix.

    Entry (i, j) = 2 if i == j, 1 if |i - j| == 1, else 0 — exactly the
    generator at ConjugateGradient_CPU_MPI_OMP.hpp:237-247. Producing an
    arbitrary row block makes this directly usable for sharded/multi-host
    construction (each host builds only its shard).
    """
    if dtype == np.float64:
        try:
            from lam_tpu import _native_io
            if _native_io.available():
                return _native_io.tridiagonal_rows(row_start, num_rows, n)
        except Exception:
            pass
    block = np.zeros((num_rows, n), dtype=dtype)
    local = np.arange(num_rows)
    i = row_start + local
    block[local, i] = 2
    sub = i > 0
    block[local[sub], i[sub] - 1] = 1
    sup = i + 1 < n
    block[local[sup], i[sup] + 1] = 1
    return block


def tridiagonal_matrix(n, dtype=np.float64):
    """Full dense gen-mode tridiagonal matrix."""
    return tridiagonal_rows(0, n, n, dtype=dtype)


def tridiagonal_hi_plane(n, n_padded=None):
    """Zero-padded f32 hi plane of the gen-mode tridiagonal.

    The entries {0, 1, 2} are exactly representable in f32, so the df64
    pair of this matrix is (hi, 0) — the lo plane is identically zero
    and can be created device-side. Generating the hi plane directly in
    f32 skips the f64 intermediate, the symmetry check, the pad copy,
    and the hi/lo split that dominated gen-mode load_s (the device
    upload is then the only remaining cost)."""
    n_padded = n_padded or n
    hi = np.zeros((n_padded, n_padded), dtype=np.float32)
    i = np.arange(n)
    hi[i, i] = 2
    hi[i[1:], i[1:] - 1] = 1
    hi[i[:-1], i[:-1] + 1] = 1
    return hi


def tridiagonal_hi_plane_device(n, n_padded=None, dtype="float32"):
    """`tridiagonal_hi_plane` built ON DEVICE (jit iota + where), in
    `dtype` ('float64' gives the f64 matrix itself).

    The gen-mode matrix is a closed-form function of (i, j), so there is
    no reason to build it on the host and ship N^2 values over PCIe: one
    fused XLA program writes it at device-memory speed. This is the
    device-side answer to the reference's OpenMP-parallel host
    generation loop (ConjugateGradient_CPU_MPI_OMP.hpp:237-247)."""
    import jax

    return jax.jit(_tridiag_hi_device_impl, static_argnums=(0, 1, 2))(
        int(n), int(n_padded or n), dtype)


def _tridiag_hi_device_impl(n, n_padded, dtype="float32"):
    import jax
    import jax.numpy as jnp

    i = jax.lax.broadcasted_iota(jnp.int32, (n_padded, n_padded), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n_padded, n_padded), 1)
    in_range = (i < n) & (j < n)
    d = i - j
    vals = jnp.where(d == 0, 2.0, jnp.where((d == 1) | (d == -1), 1.0, 0.0))
    return jnp.where(in_range, vals, 0.0).astype(dtype)


def _tridiag_hi_slab_impl(n, n_padded, g, m):
    """f32 hi plane of the gen-mode tridiagonal in the BAND-PAIR slab
    row order of lam_tpu/parallel/pcg_symm.py: slab row s holds original
    row `band * m + s % m` with band = c (first half of chip c's pair)
    or 2g-1-c (second half), c = (s // m) // 2. Built on device so each
    mesh shard materializes directly in its own HBM (jit with
    out_shardings) — the generation analog of the reference's per-rank
    tridiagonal fill (ConjugateGradient_CPU_MPI_OMP.hpp:237-247)."""
    import jax
    import jax.numpy as jnp

    s = jax.lax.broadcasted_iota(jnp.int32, (n_padded, n_padded), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n_padded, n_padded), 1)
    blk = s // m
    c = blk // 2
    half = blk % 2
    band = jnp.where(half == 0, c, 2 * g - 1 - c)
    i = band * m + s % m
    in_range = (i < n) & (j < n)
    d = i - j
    vals = jnp.where(d == 0, 2.0, jnp.where((d == 1) | (d == -1), 1.0, 0.0))
    return jnp.where(in_range, vals, 0.0).astype(jnp.float32)


def _tridiag_hi_packed_impl(n, tb, it, kt, nblk):
    """f32 hi plane of the gen-mode tridiagonal in PACKED triangle-walk
    order (ops/gemv.py packed layout): block-row t of the (T*tb, tb)
    output is tile (it[t], kt[t]) of the matrix. Built on device; with
    the packed layout plus a broadcast zero lo tile, gen-mode df64
    storage is a QUARTER of the full-square pair (BASELINE.md).

    SPARSITY-AWARE: a tridiagonal's packed buffer has only two kinds of
    nonzero tile — the nblk diagonal tiles (in-tile tridiagonal) and
    the nblk-1 subdiagonal-neighbor tiles (it == kt+1, a single 1 in
    the top-right corner). Scattering just those into zeros keeps the
    construction's working set at ~n*tb elements; a dense per-element
    gather would materialize several full-buffer int32 temporaries.
    `nblk` (static) = total row-tiles = n_padded // tb."""
    import jax
    import jax.numpy as jnp

    rows = it.shape[0] * tb
    out = jnp.zeros((rows, tb), jnp.float32)

    # diagonal tiles: walk positions where it == kt (each global
    # row-tile has exactly one -> static count nblk across the table)
    dpos = jnp.nonzero(it == kt, size=nblk, fill_value=0)[0]
    i0 = it[dpos]                                     # (nblk,)
    r = jax.lax.broadcasted_iota(jnp.int32, (nblk, tb, tb), 1)
    c = jax.lax.broadcasted_iota(jnp.int32, (nblk, tb, tb), 2)
    gi = i0[:, None, None] * tb + r
    gj = i0[:, None, None] * tb + c
    d = r - c
    vals = jnp.where(d == 0, 2.0,
                     jnp.where((d == 1) | (d == -1), 1.0, 0.0))
    vals = jnp.where((gi < n) & (gj < n), vals, 0.0).astype(jnp.float32)
    ridx = (dpos[:, None] * tb
            + jnp.arange(tb, dtype=jnp.int32)[None, :]).reshape(-1)
    out = out.at[ridx].set(vals.reshape(nblk * tb, tb))

    # subdiagonal-neighbor tiles: A[i*tb, i*tb - 1] = 1 at the tile's
    # top-right corner (row 0, col tb-1); nblk-1 of them globally
    if nblk > 1:
        cpos = jnp.nonzero(it == kt + 1, size=nblk - 1, fill_value=0)[0]
        ic = it[cpos]
        val = jnp.where((ic * tb < n) & (ic > 0), 1.0,
                        0.0).astype(jnp.float32)
        out = out.at[cpos * tb, tb - 1].set(val)
    return out


# gen-mode fq quantization: stored entries are {0, 1} (diagonal
# extracted), and the smallest power of two >= 1/32767 rounds up to
# 2^-14 — exactly what quantize_fq_tiles picks for such a tile, so the
# device-built plane is quantization-EXACT (q in {0, 16384}).
TRIDIAG_Q1_SCALE = 2.0 ** -14


def _tridiag_q1_packed_impl(n, tb, it, kt, nblk):
    """int16 q1 plane of the gen-mode tridiagonal in PACKED walk order
    with the matrix diagonal EXTRACTED (the fq layout,
    DenseOperator.from_gen_fq): diagonal tiles carry only the +-1 band
    quantized against TRIDIAG_Q1_SCALE (q = 16384, exact), the
    subdiagonal-neighbor tiles the single top-right 1; everything else
    0. Same sparsity-aware scatter as _tridiag_hi_packed_impl."""
    import jax
    import jax.numpy as jnp

    qv = jnp.int16(round(1.0 / TRIDIAG_Q1_SCALE))
    rows = it.shape[0] * tb
    out = jnp.zeros((rows, tb), jnp.int16)

    dpos = jnp.nonzero(it == kt, size=nblk, fill_value=0)[0]
    i0 = it[dpos]                                     # (nblk,)
    r = jax.lax.broadcasted_iota(jnp.int32, (nblk, tb, tb), 1)
    c = jax.lax.broadcasted_iota(jnp.int32, (nblk, tb, tb), 2)
    gi = i0[:, None, None] * tb + r
    gj = i0[:, None, None] * tb + c
    d = r - c
    vals = jnp.where((d == 1) | (d == -1), qv, jnp.int16(0))
    vals = jnp.where((gi < n) & (gj < n), vals, jnp.int16(0))
    ridx = (dpos[:, None] * tb
            + jnp.arange(tb, dtype=jnp.int32)[None, :]).reshape(-1)
    out = out.at[ridx].set(vals.reshape(nblk * tb, tb))

    if nblk > 1:
        cpos = jnp.nonzero(it == kt + 1, size=nblk - 1, fill_value=0)[0]
        ic = it[cpos]
        val = jnp.where((ic * tb < n) & (ic > 0), qv, jnp.int16(0))
        out = out.at[cpos * tb, tb - 1].set(val)
    return out


def _gen_diag_slab_impl(n, g, m, value=2.0):
    """Slab-order (band-pair) f32 diagonal of the gen tridiagonal:
    position c*2m + j of the (n_padded,) output is chip c's slab row j,
    whose ORIGINAL row is c*m + j (band c) or (2g-1-c)*m + (j - m)
    (band 2g-1-c); entries past n are padding (0). Device-built — the
    sharded gen-fq operator's diagonal pair (dl == 0 exactly: the gen
    diagonal is 2.0, exact in f32)."""
    import jax.numpy as jnp

    u = jnp.arange(2 * g * m)
    c = u // (2 * m)
    j = u % (2 * m)
    orig = jnp.where(j < m, c * m + j, (2 * g - 1 - c) * m + (j - m))
    return jnp.where(orig < n, jnp.float32(value), jnp.float32(0.0))


def ones_rhs(n, dtype=np.float64):
    """Gen-mode rhs: all ones (ConjugateGradient_CPU_MPI_OMP.hpp:159-164)."""
    return np.ones(n, dtype=dtype)


def random_eigenvalues(n, rng):
    """Reference eigenvalue law: exp(3.5 * U(-1, 1)).

    (random_spd_system.cpp:83-87; gives condition number up to ~e^7.)
    """
    return np.exp(3.5 * rng.uniform(-1.0, 1.0, size=n))


def random_spd_matrix(n, seed=0, dtype=np.float64):
    """Random SPD matrix with the reference's construction.

    A = (Q sqrt(D)) (Q sqrt(D))^T with Q orthogonal from QR of a random
    U(-1,1) matrix and D = exp(3.5 * U(-1,1))
    (random_spd_system.cpp:66-101). O(N^3) — use for N up to a few
    thousand; see random_spd_matrix_fast for benchmark-scale systems.
    """
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1.0, 1.0, size=(n, n))
    q, r = np.linalg.qr(m)
    # Fix the sign ambiguity so Q is Haar-distributed.
    q = q * np.sign(np.diagonal(r))
    d = random_eigenvalues(n, rng)
    qd = q * np.sqrt(d)
    a = qd @ qd.T
    return a.astype(dtype, copy=False)


def random_spd_matrix_fast(n, seed=0, num_reflectors=4, dtype=np.float64):
    """Random SPD matrix with the reference's exact spectrum in O(k N^2).

    Same eigenvalue law D = exp(3.5 * U(-1,1)) as random_spd_system.cpp:83-87
    but the orthogonal similarity uses a product of `num_reflectors`
    Householder reflections H = H_k ... H_1 instead of a full dense Q:
    A = H diag(D) H^T. CG convergence depends only on the spectrum, so this
    reproduces the reference systems' ~320-360-iteration behavior
    (TESTS/BEST_RESULTS) at any N without the O(N^3) orthonormalization.
    """
    rng = np.random.default_rng(seed)
    d = random_eigenvalues(n, rng).astype(dtype)
    a = np.zeros((n, n), dtype=dtype)
    np.fill_diagonal(a, d)
    block = max(1, (1 << 25) // max(n, 1))  # ~256 MB row blocks
    for _ in range(num_reflectors):
        v = rng.standard_normal(n).astype(dtype)
        v /= np.linalg.norm(v)
        # A <- (I - 2 v v^T) A (I - 2 v v^T), applied in O(N^2),
        # row-blocked in place to avoid N^2-sized temporaries.
        w = a @ v
        for s in range(0, n, block):
            e = min(s + block, n)
            a[s:e] -= 2.0 * np.outer(w[s:e], v)
        w = v @ a
        for s in range(0, n, block):
            e = min(s + block, n)
            a[s:e] -= 2.0 * np.outer(v[s:e], w)
    # Symmetrize away rounding asymmetry, by block pairs, in place.
    for s in range(0, n, block):
        e = min(s + block, n)
        for s2 in range(s, n, block):
            e2 = min(s2 + block, n)
            avg = 0.5 * (a[s:e, s2:e2] + a[s2:e2, s:e].T)
            a[s:e, s2:e2] = avg
            a[s2:e2, s:e] = avg.T
    return a


def random_rhs(n, seed=0, dtype=np.float64):
    """Random U(-1, 1) rhs (random_spd_system.cpp:164-167)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=n).astype(dtype)


def random_spd_system(n, seed=0, fast=None, dtype=np.float64):
    """(A, b) pair as produced by the reference random_spd_system tool.

    `fast=None` auto-selects the O(k N^2) spectrum-exact construction
    above N=4096.
    """
    if fast is None:
        fast = n > 4096
    gen = random_spd_matrix_fast if fast else random_spd_matrix
    return gen(n, seed=seed, dtype=dtype), random_rhs(n, seed=seed + 10,
                                                      dtype=dtype)
