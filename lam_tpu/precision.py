"""Float-float ("df64") arithmetic building blocks.

The df64 storage (precision='df64', and the packed f32 pair of 'ir')
represents an f64 matrix as an unevaluated sum of two float32s:
value = hi + lo with hi = fl32(value). Two f32 planes are exactly the
8 bytes/element of f64, and the hi plane alone is the matrix's f32 view
for the mixed-precision solver's inner loop. The matvecs over the pair
run in native f64 (solver/operators.py); this module keeps the split
itself — the JAX reference of the host split (operators.split_f64_host,
native ln_split) — and the standard error-free transforms (Knuth
two_sum, Dekker split/two_prod), which need IEEE round-to-nearest f32
adds and multiplies.
"""

from __future__ import annotations

import jax.numpy as jnp

# Dekker splitter for f32: 2^12 + 1 (f32 has 24 mantissa bits -> split 12/12).
_SPLIT32 = 4097.0


def split_f64(x):
    """Split an f64 array into a (hi, lo) pair of f32 arrays, x == hi + lo."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def join_f64(hi, lo):
    """Recombine a (hi, lo) f32 pair into f64."""
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def two_sum(a, b):
    """Knuth's branch-free exact addition: a + b == s + e exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Dekker's exact addition, valid when |a| >= |b|: a + b == s + e."""
    s = a + b
    e = b - (s - a)
    return s, e


def split32(a):
    """Dekker split of an f32 value into high/low 12-bit-mantissa halves."""
    c = jnp.float32(_SPLIT32) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact f32 multiplication: a * b == p + e exactly (Dekker/Veltkamp)."""
    p = a * b
    ah, al = split32(a)
    bh, bl = split32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """Double-float addition: (xh,xl) + (yh,yl) -> (zh,zl)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_mul(x, y):
    """Double-float multiplication: (xh,xl) * (yh,yl) -> (zh,zl)."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def df_neg(x):
    return (-x[0], -x[1])
