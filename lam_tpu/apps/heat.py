"""Steady-state heat-equation demo: the reference application, CG-powered.

The reference app (heat_equation-main/src/heat_equation.cpp) relaxes the
steady-state temperature of an nx x ny plate with plain Jacobi sweeps
(4-neighbor average, heat_iteration :75-89) until the max pointwise
update falls below epsilon=1e-3 (:115-148) — despite its README calling
it a CG solve (SURVEY.md §8.10). Boundaries: north=0, south/west/east=100
(:160-168); interior initialized to the boundary average (:27-48); grid
written in the shared binary format with (ny, nx) header (:203).

This rebuild provides BOTH:
  * `solve_heat_jacobi` — numerics-parity port of the reference sweep
    (vectorized, whole loop on device in lax.while_loop);
  * `solve_heat_cg` — the BASELINE.json config-#5 reformulation: the
    steady state solves the SPD 5-point-Laplacian system A u = b over the
    interior, driven MATRIX-FREE through the same CG engine as the dense
    solver. Converges in O(grid side) iterations instead of Jacobi's
    O(side^2) — on the reference's 1200x1000 default this is ~100x fewer
    iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lam_tpu import platform
from lam_tpu.solver.cg import cg_solve
from lam_tpu.solver.operators import LinearOperator, MatrixFreeOperator

BC_NORTH = 0.0
BC_SOUTH = 100.0
BC_WEST = 100.0
BC_EAST = 100.0


def initial_grid(nx, ny, bc_north=BC_NORTH, bc_south=BC_SOUTH,
                 bc_west=BC_WEST, bc_east=BC_EAST):
    """Boundary conditions + interior average, exactly as
    set_initial_solution (heat_equation.cpp:27-48). Returns (ny, nx),
    row y=0 = south."""
    grid = np.zeros((ny, nx), dtype=np.float64)
    grid[ny - 1, 1:nx - 1] = bc_north
    grid[0, 1:nx - 1] = bc_south
    grid[1:ny - 1, 0] = bc_west
    grid[1:ny - 1, nx - 1] = bc_east
    grid[0, 0] = (bc_south + bc_west) / 2
    grid[ny - 1, 0] = (bc_north + bc_west) / 2
    # NB: the reference indexes the two east corners with ny-1 as the
    # COLUMN (heat_equation.cpp:36-37) — correct only for square grids.
    # We index with nx-1 (the intended east column).
    grid[0, nx - 1] = (bc_south + bc_east) / 2
    grid[ny - 1, nx - 1] = (bc_north + bc_east) / 2
    initial_val = ((nx - 1) * bc_north + (nx - 1) * bc_south
                   + (ny - 1) * bc_west + (ny - 1) * bc_east) \
        / (2 * nx + 2 * ny - 4)
    grid[1:ny - 1, 1:nx - 1] = initial_val
    return grid


@jax.jit
def _jacobi_loop(grid, max_iters, epsilon):
    def sweep(g):
        interior = (g[2:, 1:-1] + g[:-2, 1:-1]
                    + g[1:-1, :-2] + g[1:-1, 2:]) / 4.0
        return g.at[1:-1, 1:-1].set(interior)

    def cond(carry):
        _, diff, k = carry
        return jnp.logical_and(k < max_iters, diff >= epsilon)

    def body(carry):
        g, _, k = carry
        g_new = sweep(g)
        diff = jnp.max(jnp.abs(g_new[1:-1, 1:-1] - g[1:-1, 1:-1]))
        return (g_new, diff, k + 1)

    g, diff, k = jax.lax.while_loop(cond, body,
                                    (grid, jnp.inf, jnp.int32(0)))
    return g, diff, k


def solve_heat_jacobi(grid, max_iters=1_000_000, epsilon=1e-3):
    """Parity port of solve_heat (heat_equation.cpp:115-148)."""
    g, diff, k = _jacobi_loop(jnp.asarray(grid), jnp.int32(max_iters),
                              epsilon)
    return np.asarray(g), int(k), float(diff)


@functools.lru_cache(maxsize=None)
def _laplace_matvec(nyi, nxi):
    """Matrix-free 5-point Laplacian on an (nyi, nxi) interior.

    A u = 4u - u_N - u_S - u_W - u_E with zero (Dirichlet-absorbed)
    padding: SPD, so CG applies. The operand is unused (shape is baked)."""

    def mv(operand, p):
        del operand
        u = p.reshape(nyi, nxi)
        out = 4.0 * u
        out = out - jnp.pad(u[1:, :], ((0, 1), (0, 0)))   # north neighbor
        out = out - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))  # south neighbor
        out = out - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))   # east
        out = out - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))  # west
        return out.reshape(-1)

    return mv


# -- row-sharded stencil over a device mesh ---------------------------------
#
# The grid's rows are sharded over a 1-D mesh (zero rows pad the last
# shard); each matvec exchanges ONE boundary row with each neighbor
# (jax.lax.ppermute — the halo-exchange pattern the gemv-style operators
# never need) and applies the masked stencil to the shard with the
# received rows as its north/south edges. Vectors stay row-sharded
# end-to-end; the generic per-shard CG/ir loop bodies from
# lam_tpu/parallel/pcg.py run unchanged (dots psum over the axis).


def _sharded_stencil_apply(axis, nyi, nxi, Hs, g):
    """Per-shard masked stencil matvec (inside shard_map), in the dtype
    of p: the f32 inner and the f64 refinement operator alike."""
    fwd = [(i, (i + 1) % g) for i in range(g)]
    bwd = [(i, (i - 1) % g) for i in range(g)]

    def apply(operand, p):
        del operand
        u = p.reshape(Hs, nxi)
        c = jax.lax.axis_index(axis)
        # neighbor edge rows; the ring wrap-around delivers a WRONG row
        # to shard 0's top / shard g-1's bottom, but those sit at the
        # true boundary where the stencil needs zeros — overwrite.
        up = jax.lax.ppermute(u[-1:, :], axis, fwd)    # from c-1
        dn = jax.lax.ppermute(u[:1, :], axis, bwd)     # from c+1
        up = jnp.where(c == 0, jnp.zeros_like(up), up)
        dn = jnp.where(c == g - 1, jnp.zeros_like(dn), dn)
        north = jnp.concatenate([up, u[:-1, :]], axis=0)
        south = jnp.concatenate([u[1:, :], dn], axis=0)
        zc = jnp.zeros((Hs, 1), u.dtype)
        west = jnp.concatenate([zc, u[:, :-1]], axis=1)
        east = jnp.concatenate([u[:, 1:], zc], axis=1)
        # rows past the grid (last shard's padding) stay exactly zero
        rows = c * Hs + jax.lax.broadcasted_iota(jnp.int32, (Hs, nxi), 0)
        y = jnp.where(rows < nyi, 4.0 * u - north - south - west - east,
                      0.0)
        return y.reshape(-1)

    return apply


@functools.lru_cache(maxsize=None)
def _build_sharded_heat_ir(mesh, axis, nyi, nxi, Hs, max_cycles):
    from jax.sharding import PartitionSpec as P

    from lam_tpu.parallel.pcg import _make_local_ir
    from lam_tpu.solver.cg import CGResult

    g = mesh.shape[axis]
    apply = _sharded_stencil_apply(axis, nyi, nxi, Hs, g)
    mapped = jax.shard_map(
        _make_local_ir(apply, apply, axis, max_cycles),
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P(), P()),
        out_specs=CGResult(x=P(axis), num_iters=P(), rel_residual=P(),
                           converged=P()),
        check_vma=False,
    )
    return jax.jit(mapped)


class _ShardedStencilOperator(LinearOperator):
    """Row-sharded grid operator: H = g * Hs rows (zero rows pad the
    last shard) of nxi columns; prepare_b places the row blocks."""

    def __init__(self, nyi, nxi, mesh):
        axis = mesh.axis_names[0]
        g = mesh.shape[axis]
        self._mesh, self._axis = mesh, axis
        self._hs = -(-nyi // g)
        self._dims = (nyi, nxi, g * self._hs)
        super().__init__(None, jnp.zeros(()), nyi * nxi,
                         g * self._hs * nxi, jnp.float64)

    def prepare_b(self, b):
        from jax.sharding import NamedSharding, PartitionSpec as P
        nyi, nxi, H = self._dims
        b = np.asarray(b, dtype=np.float64)
        if b.shape != (self.n,):
            raise ValueError(f"rhs has shape {b.shape}, "
                             f"expected ({self.n},)")
        bp = np.zeros((H, nxi))
        bp[:nyi] = b.reshape(nyi, nxi)
        flat = bp.reshape(-1)
        # make_array_from_callback, not device_put: a plain device_put
        # of host data cannot target a sharding that spans other
        # processes' devices (same pattern as parallel/pcg.py)
        return jax.make_array_from_callback(
            flat.shape, NamedSharding(self._mesh, P(self._axis)),
            lambda idx: flat[idx])

    def extract_x(self, x_padded):
        from lam_tpu.solver.api import _host_array
        nyi, nxi, _ = self._dims
        # _host_array: x is sharded across processes in multi-process
        # runs; np.asarray alone raises on non-addressable shards
        return _host_array(x_padded)[:nyi * nxi]

    def run_cg_ir(self, op32, b_padded, max_iters, rel_error, max_cycles,
                  inner_floor, inv_diag32=None):
        del op32  # the f32 stencil is shape-derived, not an operand view
        if inv_diag32 is not None:
            raise NotImplementedError(
                "the Laplacian stencil has a constant diagonal (4); "
                "Jacobi preconditioning is a no-op — run without it")
        nyi, nxi, _ = self._dims
        solver = _build_sharded_heat_ir(self._mesh, self._axis, nyi, nxi,
                                        self._hs, int(max_cycles))
        return solver(self.operand, b_padded, max_iters, rel_error,
                      inner_floor)


def boundary_rhs(grid):
    """The rhs of the interior system, (ny-2, nx-2): each cell's sum of
    its adjacent boundary temperatures."""
    grid = np.asarray(grid, dtype=np.float64)
    ny, nx = grid.shape
    b = np.zeros((ny - 2, nx - 2), dtype=np.float64)
    b[0, :] += grid[0, 1:nx - 1]           # south boundary row
    b[-1, :] += grid[ny - 1, 1:nx - 1]     # north
    b[:, 0] += grid[1:ny - 1, 0]           # west
    b[:, -1] += grid[1:ny - 1, nx - 1]     # east
    return b


def solve_heat_cg(grid, max_iters=100_000, rel_error=1e-10,
                  precision="auto", devices=None):
    """Steady state via CG on the 5-point Laplacian system.

    Unknowns are the interior cells; the boundary enters as the rhs
    b[i,j] = sum of adjacent boundary temperatures. The fixed point of
    the reference's Jacobi sweep is exactly the solution of this system.

    precision: 'f64' runs the whole loop in f64. 'ir' runs the inner CG
    in f32 with f64 true-residual refinement restarts — the same
    mixed-precision engine as the dense solver; both operators are the
    same XLA stencil, applied in the vector's dtype. 'auto' is the
    platform table's precision (lam_tpu/platform.py).

    devices > 1 row-shards the grid over a 1-D mesh: one boundary-row
    ppermute per neighbor per matvec (halo exchange), replicated
    nothing — vectors stay sharded end-to-end (implies 'ir').
    """
    grid = np.asarray(grid, dtype=np.float64)
    ny, nx = grid.shape
    nyi, nxi = ny - 2, nx - 2
    b = boundary_rhs(grid)

    if devices and devices > 1:
        # reject an EXPLICIT f64 request (the sharded path implements
        # only the mixed-precision ir solver); 'auto' means ir here
        if precision == "f64":
            raise ValueError(
                "the row-sharded heat path implements only the "
                "mixed-precision ir solver; drop --precision f64 or "
                "--devices")
        from lam_tpu.parallel.mesh import make_mesh
        from lam_tpu.solver.cg import cg_solve_ir
        op = _ShardedStencilOperator(nyi, nxi, make_mesh(devices))
        res = cg_solve_ir(op, op, b.reshape(-1), max_iters=max_iters,
                          rel_error=rel_error, max_cycles=40)
        out = grid.copy()
        out[1:ny - 1, 1:nx - 1] = np.asarray(res.x).reshape(nyi, nxi)
        return out, int(res.num_iters), float(res.rel_residual)
    if precision == "auto":
        precision = platform.current().precision
    mv = _laplace_matvec(nyi, nxi)
    if precision == "ir":
        from lam_tpu.solver.cg import cg_solve_ir
        operand = jnp.zeros(())
        op = MatrixFreeOperator(mv, operand, nyi * nxi, jnp.float64)
        op32 = MatrixFreeOperator(mv, operand, nyi * nxi, jnp.float32)
        # the Laplacian's condition number grows as O(side^2), so one
        # f32 inner cycle recovers fewer digits than on the dense SPD
        # spectrum — allow more refinement restarts than the dense
        # default (each costs one f64 stencil apply, negligible)
        res = cg_solve_ir(op32, op, b.reshape(-1), max_iters=max_iters,
                          rel_error=rel_error, max_cycles=40)
    else:
        op = MatrixFreeOperator(mv, jnp.zeros(()), nyi * nxi)
        res = cg_solve(op, b.reshape(-1), max_iters=max_iters,
                       rel_error=rel_error)
    out = grid.copy()
    out[1:ny - 1, 1:nx - 1] = np.asarray(res.x).reshape(nyi, nxi)
    return out, int(res.num_iters), float(res.rel_residual)
