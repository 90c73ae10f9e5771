"""Heat-equation demo: Jacobi parity, CG equivalence, BMP output."""

import numpy as np
import pytest

from lam_tpu.apps import bmp, heat


def _reference_jacobi(grid, max_iters, eps):
    """Literal numpy port of solve_heat (heat_equation.cpp:115-148)."""
    g = grid.copy()
    for k in range(1, max_iters + 1):
        new = g.copy()
        new[1:-1, 1:-1] = (g[2:, 1:-1] + g[:-2, 1:-1]
                           + g[1:-1, :-2] + g[1:-1, 2:]) / 4.0
        diff = np.max(np.abs(new[1:-1, 1:-1] - g[1:-1, 1:-1]))
        g = new
        if diff < eps:
            return g, k, diff
    return g, max_iters, diff


def test_initial_grid_matches_reference():
    g = heat.initial_grid(6, 6)
    assert g[0, 2] == 100.0       # south
    assert g[5, 2] == 0.0         # north
    assert g[2, 0] == 100.0       # west
    assert g[2, 5] == 100.0       # east
    assert g[0, 0] == 100.0       # (south+west)/2
    assert g[5, 0] == 50.0        # (north+west)/2
    expect_init = (5 * 0 + 5 * 100 + 5 * 100 + 5 * 100) / (2*6 + 2*6 - 4)
    assert np.allclose(g[2, 2], expect_init)


def test_jacobi_matches_reference_port():
    g0 = heat.initial_grid(12, 10)
    ours, it1, d1 = heat.solve_heat_jacobi(g0, max_iters=5000, epsilon=1e-3)
    ref, it2, d2 = _reference_jacobi(g0, 5000, 1e-3)
    assert it1 == it2
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_cg_agrees_with_converged_jacobi():
    g0 = heat.initial_grid(16, 14)
    jac, _, _ = heat.solve_heat_jacobi(g0, max_iters=200000, epsilon=1e-10)
    cg, iters, rel = heat.solve_heat_cg(g0, rel_error=1e-12)
    assert rel < 1e-12
    # both converge to the same steady state; CG in FAR fewer iterations
    np.testing.assert_allclose(cg, jac, atol=1e-6)
    assert iters < 200


def _laplace_ref(g):
    ref = 4 * g.copy()
    ref[1:, :] -= g[:-1, :]
    ref[:-1, :] -= g[1:, :]
    ref[:, 1:] -= g[:, :-1]
    ref[:, :-1] -= g[:, 1:]
    return ref


STENCIL_SHAPES = [(98, 118), (7, 5), (300, 250), (256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nyi,nxi", STENCIL_SHAPES)
def test_laplace5_stencil_kernel(nyi, nxi, dtype):
    """The XLA 5-point stencil == dense 5-point action, in the vector's
    dtype (the f32 inner and the f64 refinement operator of 'ir')."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    g = rng.standard_normal((nyi, nxi)).astype(dtype)
    y = heat._laplace_matvec(nyi, nxi)(None, jnp.asarray(g.reshape(-1)))
    assert y.dtype == jnp.dtype(dtype)
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(np.asarray(y, np.float64).reshape(nyi, nxi),
                               _laplace_ref(g.astype(np.float64)),
                               atol=tol)


@pytest.mark.parametrize("g,nyi", [(2, 98), (4, 7), (8, 300)])
def test_sharded_halo_stencil_matches_dense(g, nyi):
    """The row-sharded halo form on a g-device mesh: the last shard's
    pad rows stay exactly zero and the interior matches the dense
    stencil (ppermute'd edge rows at the shard boundaries)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from lam_tpu.parallel.mesh import make_mesh

    nxi = 37
    mesh = make_mesh(g)
    axis = mesh.axis_names[0]
    hs = -(-nyi // g)
    apply = heat._sharded_stencil_apply(axis, nyi, nxi, hs, g)
    rng = np.random.default_rng(g)
    u = np.zeros((g * hs, nxi))
    u[:nyi] = rng.standard_normal((nyi, nxi))
    fn = jax.jit(jax.shard_map(lambda p: apply(None, p), mesh=mesh,
                               in_specs=P(axis), out_specs=P(axis),
                               check_vma=False))
    y = np.asarray(fn(jnp.asarray(u.reshape(-1)))).reshape(g * hs, nxi)
    np.testing.assert_allclose(y[:nyi], _laplace_ref(u[:nyi]), atol=1e-12)
    assert not y[nyi:].any()


def test_cg_ir_matches_f64_path():
    """The mixed-precision heat path converges to the same steady state.

    Both paths run the same dtype-polymorphic stencil; assert they
    agree to the rel_error-implied solution accuracy."""
    g0 = heat.initial_grid(30, 26)
    f64, _, rel64 = heat.solve_heat_cg(g0, precision="f64", rel_error=1e-10)
    ir, _, rel_ir = heat.solve_heat_cg(g0, precision="ir", rel_error=1e-10)
    assert rel64 < 1e-10 and rel_ir < 1e-10
    # kappa ~ O(side^2) amplifies the 1e-10 residual bound into the
    # solution; 1e-6 is comfortably inside that envelope
    np.testing.assert_allclose(ir, f64, atol=1e-6)


def test_cg_sharded_stencil_matches_f64():
    """Row-sharded halo-exchange stencil (ppermute per matvec) agrees
    with the single-device f64 oracle across mesh sizes."""
    import jax
    assert len(jax.devices()) >= 8  # conftest virtual mesh
    g0 = heat.initial_grid(40, 36)
    ref, _, _ = heat.solve_heat_cg(g0, precision="f64", rel_error=1e-11)
    for dev in (2, 8):
        out, _, rel = heat.solve_heat_cg(g0, devices=dev,
                                         rel_error=1e-11)
        assert rel < 1e-11
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_cg_sharded_rejects_explicit_f64():
    import pytest
    g0 = heat.initial_grid(10, 10)
    with pytest.raises(ValueError, match="ir solver"):
        heat.solve_heat_cg(g0, devices=2, precision="f64")


def test_cg_solves_exact_laplace_system():
    g0 = heat.initial_grid(9, 8)
    cg, _, _ = heat.solve_heat_cg(g0, rel_error=1e-13)
    ny, nx = g0.shape
    # assemble the dense 5-point system and solve directly
    nyi, nxi = ny - 2, nx - 2
    n = nyi * nxi
    a = np.zeros((n, n))
    b = np.zeros(n)
    for i in range(nyi):
        for j in range(nxi):
            k = i * nxi + j
            a[k, k] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nyi and 0 <= jj < nxi:
                    a[k, ii * nxi + jj] = -1.0
                else:
                    b[k] += g0[ii + 1, jj + 1]
    u = np.linalg.solve(a, b)
    np.testing.assert_allclose(cg[1:-1, 1:-1].reshape(-1), u, rtol=1e-9)


def test_bmp_roundtrip_and_colormap(tmp_path):
    vals = np.array([[0.0, 25.0], [50.0, 100.0]])
    rgb = bmp.colormap(vals)
    # reference ramp: T=0 -> blue, T=50 -> green, T=100 -> red
    assert tuple(rgb[0, 0]) == (0, 0, 255)
    assert tuple(rgb[1, 0]) == (0, 255, 0)
    assert tuple(rgb[1, 1]) == (255, 0, 0)
    path = tmp_path / "t.bmp"
    bmp.write_bmp(path, rgb)
    back = bmp.read_bmp(path)
    np.testing.assert_array_equal(back, rgb)
    # odd width exercises row padding
    rgb3 = bmp.colormap(np.random.default_rng(0).uniform(0, 100, (5, 3)))
    bmp.write_bmp(tmp_path / "t3.bmp", rgb3)
    np.testing.assert_array_equal(bmp.read_bmp(tmp_path / "t3.bmp"), rgb3)


def test_heat_cli_devices_flag(tmp_path, capsys):
    """lam-heat --devices routes through the sharded halo-exchange path."""
    from lam_tpu.apps import heat_cli
    out_bin = tmp_path / "heat.bin"
    rc = heat_cli.main(["20", "16", str(out_bin), "100000",
                        "--devices", "2"])
    assert rc == 0
    assert "converged" in capsys.readouterr().out


def test_heat_cli_end_to_end(tmp_path, capsys):
    from lam_tpu.apps import bmp_cli, heat_cli
    out_bin = tmp_path / "heat.bin"
    rc = heat_cli.main(["40", "30", str(out_bin), "100000"])
    assert rc == 0
    assert "converged" in capsys.readouterr().out
    from lam_tpu import io as lio
    grid = lio.read_matrix(out_bin)
    assert grid.shape == (30, 40)  # (ny, nx) header like the reference
    out_bmp = tmp_path / "heat.bmp"
    rc = bmp_cli.main([str(out_bin), str(out_bmp)])
    assert rc == 0
    img = bmp.read_bmp(out_bmp)
    assert img.shape == (30, 40, 3)
