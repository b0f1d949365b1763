"""Field-solver unit tests: vacuum plane-wave propagation, energy
conservation, divergence cleaning, ghost/synchronization consistency.
(The reference validates the solver through deck-level physics tests; these
are the equivalent direct checks.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax.grid import PEC, Grid, partition_periodic_box
from vpic_jax.state import FieldState, MaterialCoeffs
from vpic_jax.ops import fields as F
from vpic_jax.ops import interp as I


def make_grid(nx=32, ny=4, nz=4, cfl=0.5):
    g = partition_periodic_box(0, 0, 0, 1.0, 1.0 * ny / nx, 1.0 * nz / nx,
                               nx, ny, nz)
    # dt from Courant
    dt = cfl * g.courant_length()
    return Grid(nx=nx, ny=ny, nz=nz, dt=dt, cvac=1.0, eps0=1.0,
                x0=0, y0=0, z0=0, x1=1.0, y1=1.0 * ny / nx, z1=1.0 * nz / nx,
                field_bc=g.field_bc, particle_bc=g.particle_bc)


def plane_wave_state(g, k_cells=2):
    """Exact Yee-mode plane wave: Ey = E0 cos(kx), cBz staggered half-cell,
    with the discrete (numerical) dispersion amplitude relation."""
    f = FieldState.zeros(g)
    k = 2 * np.pi * k_cells / (g.x1 - g.x0)
    # component positions
    xn = g.x0 + g.dx * (np.arange(g.NX) - 1.0)
    xc = xn + 0.5 * g.dx
    # numerical dispersion: sin(w dt/2)/dt = c sin(k dx/2)/dx
    s = g.cvac * g.dt / g.dx * np.sin(0.5 * k * g.dx)
    w = 2.0 / g.dt * np.arcsin(s)
    ey = np.cos(k * xn)
    # Faraday: dBz/dt = -dEy/dx ... staggered amplitude ratio:
    amp = np.sin(0.5 * k * g.dx) / (0.5 * g.dx) / w  # = k_eff/w
    cbz = amp * np.cos(k * xc + 0.5 * w * g.dt) * g.cvac
    f = f.replace(
        ey=jnp.asarray(np.broadcast_to(ey, g.shape).astype(np.float32)),
        cbz=jnp.asarray(np.broadcast_to(cbz, g.shape).astype(np.float32)))
    return f, w


def test_vacuum_wave_energy_conservation():
    g = make_grid()
    m = MaterialCoeffs.vacuum()
    f, w = plane_wave_state(g)
    f, err0 = F.synchronize_tang_e_norm_b(f, g)

    @jax.jit
    def run(f, n=200):
        def body(_, f):
            f = F.advance_b(f, g, 0.5)
            f = F.advance_e(f, g, m, 0.0)
            f = F.advance_b(f, g, 0.5)
            return f
        return jax.lax.fori_loop(0, n, body, f)

    e0 = np.asarray(F.energy_f(f, g, m))
    f = run(f)
    e1 = np.asarray(F.energy_f(f, g, m))
    # lossless vacuum FDTD: total energy conserved to f32 roundoff
    assert abs(e1.sum() - e0.sum()) < 1e-4 * e0.sum()
    # energy stays in (ey, bz)
    assert e1[1] + e1[5] > 0.99 * e1.sum()


def test_vacuum_wave_phase_advance():
    """After T = 2 pi / w_num steps the wave must return to its start."""
    g = make_grid(nx=64, ny=2, nz=2, cfl=0.5)
    m = MaterialCoeffs.vacuum()
    f, w = plane_wave_state(g, k_cells=1)
    n_period = 2 * np.pi / (w * g.dt)
    n_steps = int(round(n_period))
    ey0 = np.asarray(f.ey[1, 1, :])

    @jax.jit
    def run(f, n):
        def body(_, f):
            f = F.advance_b(f, g, 0.5)
            f = F.advance_e(f, g, m, 0.0)
            f = F.advance_b(f, g, 0.5)
            return f
        return jax.lax.fori_loop(0, n, body, f)

    f = run(f, n_steps)
    ey1 = np.asarray(f.ey[1, 1, :])
    # fractional-step phase error only
    phase_frac = abs(n_period - n_steps) / n_period
    assert np.max(np.abs(ey1 - ey0)) < 2 * np.pi * phase_frac + 2e-2


def test_div_b_stays_zero():
    g = make_grid()
    m = MaterialCoeffs.vacuum()
    f, _ = plane_wave_state(g)
    rng = np.random.RandomState(0)
    # random (divergence-full) E noise; B must stay divergence free
    f = f.replace(ex=jnp.asarray(rng.randn(*g.shape).astype(np.float32)))

    @jax.jit
    def run(f):
        def body(_, f):
            f = F.advance_b(f, g, 0.5)
            f = F.advance_e(f, g, m, 0.0)
            f = F.advance_b(f, g, 0.5)
            return f
        return jax.lax.fori_loop(0, 20, body, f)

    f = run(f)
    f = F.compute_div_b_err(f, g)
    num, den = F.compute_rms_div_b_err(f, g)
    rms = g.eps0 * np.sqrt(float(num) / float(den))
    assert rms < 1e-3


def test_clean_div_b_removes_error():
    g = make_grid()
    rng = np.random.RandomState(1)
    f = FieldState.zeros(g)
    f = f.replace(cbx=jnp.asarray(rng.randn(*g.shape).astype(np.float32)))
    f = F.compute_div_b_err(f, g)
    n0, d0 = F.compute_rms_div_b_err(f, g)

    @jax.jit
    def run(f):
        def body(_, f):
            f = F.clean_div_b(f, g)
            return F.compute_div_b_err(f, g)
        return jax.lax.fori_loop(0, 20, body, f)

    f = run(f)
    n1, d1 = F.compute_rms_div_b_err(f, g)
    assert float(n1) < 0.2 * float(n0)


def test_clean_div_e_removes_error():
    g = make_grid()
    m = MaterialCoeffs.vacuum()
    rng = np.random.RandomState(2)
    f = FieldState.zeros(g)
    f = f.replace(ex=jnp.asarray(rng.randn(*g.shape).astype(np.float32)))
    f = F.compute_div_e_err(f, g, m)
    n0, _ = F.compute_rms_div_e_err(f, g)

    @jax.jit
    def run(f):
        def body(_, f):
            f = F.clean_div_e(f, g, m)
            return F.compute_div_e_err(f, g, m)
        return jax.lax.fori_loop(0, 20, body, f)

    f = run(f)
    n1, _ = F.compute_rms_div_e_err(f, g)
    assert float(n1) < 0.2 * float(n0)


def test_periodic_sync_consistency():
    """After sync, node-centered comps must be identical on planes 1/n+1."""
    g = make_grid()
    rng = np.random.RandomState(3)
    f = FieldState.zeros(g)
    f = f.replace(**{n: jnp.asarray(rng.randn(*g.shape).astype(np.float32))
                     for n in ("ex", "ey", "ez", "cbx", "cby", "cbz",
                               "jfx", "jfy", "jfz", "rhof", "rhob")})
    f, err = F.synchronize_tang_e_norm_b(f, g)
    np.testing.assert_allclose(np.asarray(f.ey[:, :, 1]),
                               np.asarray(f.ey[:, :, g.nx + 1]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f.cbx[:, :, 1]),
                               np.asarray(f.cbx[:, :, g.nx + 1]), rtol=1e-6)
    f2 = F.synchronize_jf(f, g)
    np.testing.assert_allclose(np.asarray(f2.jfy[:, :, 1]),
                               np.asarray(f2.jfy[:, :, g.nx + 1]), rtol=1e-6)


def test_pec_cavity_energy_conserved():
    """PEC box (metal cavity): standing mode, energy conserved, tangential E
    zero on the walls."""
    nx = 16
    g0 = make_grid(nx=nx, ny=4, nz=4, cfl=0.5)
    bc = list(g0.field_bc)
    bc[0] = bc[3] = PEC
    import dataclasses
    g = dataclasses.replace(g0, field_bc=tuple(bc))
    m = MaterialCoeffs.vacuum()
    f = FieldState.zeros(g)
    # Ey standing mode: sin(pi x / L) vanishing at x walls
    xn = g.x0 + g.dx * (np.arange(g.NX) - 1.0)
    ey = np.sin(np.pi * (xn - g.x0) / (g.x1 - g.x0))
    f = f.replace(ey=jnp.asarray(np.broadcast_to(ey, g.shape).astype(np.float32)))
    f, _ = F.synchronize_tang_e_norm_b(f, g)
    e0 = float(np.asarray(F.energy_f(f, g, m)).sum())

    @jax.jit
    def run(f):
        def body(_, f):
            f = F.advance_b(f, g, 0.5)
            f = F.advance_e(f, g, m, 0.0)
            f = F.advance_b(f, g, 0.5)
            return f
        return jax.lax.fori_loop(0, 200, body, f)

    f = run(f)
    e1 = float(np.asarray(F.energy_f(f, g, m)).sum())
    assert abs(e1 - e0) < 1e-3 * e0
    # tangential E on the PEC walls is exactly zero
    assert float(jnp.max(jnp.abs(f.ey[:, :, 1]))) == 0.0
    assert float(jnp.max(jnp.abs(f.ey[:, :, nx + 1]))) == 0.0


def test_interpolator_uniform_field():
    """A uniform E/B field must interpolate to itself everywhere
    (interpe legacy test analogue)."""
    g = make_grid(nx=8, ny=8, nz=8)
    f = FieldState.zeros(g)
    f = f.replace(ex=jnp.full(g.shape, 2.0), ey=jnp.full(g.shape, 3.0),
                  ez=jnp.full(g.shape, 4.0), cbx=jnp.full(g.shape, 5.0),
                  cby=jnp.full(g.shape, 6.0), cbz=jnp.full(g.shape, 7.0))
    fc = I.load_interpolator(f, g)
    fc = np.asarray(fc).reshape(g.NZ, g.NY, g.NX, 18)
    interior = fc[1:-1, 1:-1, 1:-1]
    np.testing.assert_allclose(interior[..., 0], 2.0, atol=1e-6)
    np.testing.assert_allclose(interior[..., 4], 3.0, atol=1e-6)
    np.testing.assert_allclose(interior[..., 8], 4.0, atol=1e-6)
    np.testing.assert_allclose(interior[..., 12], 5.0, atol=1e-6)
    np.testing.assert_allclose(interior[..., 14], 6.0, atol=1e-6)
    np.testing.assert_allclose(interior[..., 16], 7.0, atol=1e-6)
    # slopes vanish
    for c in (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 15, 17):
        np.testing.assert_allclose(interior[..., c], 0.0, atol=1e-6)
