"""Runtime injection hook + collisional 3-D reconnection deck smoke tests."""

import jax
import jax.numpy as jnp
import numpy as np

from vpic_jax import emitter as E
from vpic_jax.deck import Simulation
from vpic_jax.models import reconnection


def test_runtime_injection_hook():
    """user_particle_injection (begin_particle_injection analogue): inject a
    trickle of particles each step through the device-side helper."""
    sim = Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (8, 8, 8))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    spc = sim.define_species("e", -1e-6, 1.0, 2048, -1, 0, 1)

    M = 4

    def injector(species, f, fcoef, acc, rhob, g, step, rng):
        key = jax.random.fold_in(rng, step)
        ks = jax.random.split(key, 7)
        x = jax.random.uniform(ks[0], (M,))
        y = jax.random.uniform(ks[1], (M,))
        z = jax.random.uniform(ks[2], (M,))
        u = 0.1 * jax.random.normal(ks[3], (3, M))
        w = jnp.ones((M,))
        age = jax.random.uniform(ks[4], (M,))
        sp, acc, rhob = E.runtime_inject(
            species[0], g, acc, rhob, ks[5], x, y, z, u[0], u[1], u[2], w,
            -1e-6, age=age, update_rhob=True)
        return [sp] + list(species[1:]), acc, rhob, ks[6]

    sim.user_particle_injection = injector
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    for _ in range(10):
        state = step(state)
    assert int(state.species[0].np) == 10 * M
    assert np.isfinite(np.asarray(sim.energies(state))).all()


def test_collisional_reconnection_3d():
    p = reconnection.ReconnectionParams(nx=8, ny=8, nz=4, Lx=4.0, Ly=4.0,
                                        Lz=2.0, nppc=8,
                                        tau_coll_interval=5, coll_n0=0.02)
    sim = reconnection.build(p)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    e0 = np.asarray(sim.energies(state))
    for _ in range(10):
        state = step(state)
    e1 = np.asarray(sim.energies(state))
    # interspecies pair conflicts make collisions elastic only on average
    # (see collision.py docstring); bound the drift rather than demand
    # exact conservation
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 3e-2
    for st, sp in zip(sim.species, state.species):
        assert int(sp.np) == len(st.rows())


def test_runtime_inject_f64_exact_large_grid():
    """Device-side coordinate conversion matches the host's f64 staging
    (misc.cc:16-100) exactly -- voxel AND offset -- on a >= 4096-cell axis,
    including positions a few ulps either side of cell boundaries where a
    plain f32 conversion lands a voxel off."""
    n = 8192
    sim = Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(1e-5)
    sim.define_periodic_grid((0.1, 0, 0), (1.1, 1.0 / n, 1.0 / n),
                             (n, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.define_species("e", -1e-9, 1.0, 1 << 14, -1, 0, 1)
    g = sim.grid

    rng = np.random.default_rng(3)
    cells = rng.integers(0, n, 2000)
    bnd = 0.1 + cells / n  # exact f64 cell boundaries in x
    xs = np.float32(np.concatenate([
        bnd,
        np.nextafter(bnd, np.float32(2.0), dtype=np.float32),
        np.nextafter(bnd, np.float32(0.0), dtype=np.float32),
        0.1 + rng.uniform(0, 1, 2000),
    ]))
    xs = np.clip(xs, np.float32(0.1), np.float32(1.1))
    M = len(xs)

    # host f64 staging of the SAME f32 values (the reference's conv)
    def host_conv(v):
        s = float(n) * ((float(v) - g.x0) / (g.x1 - g.x0))
        iv = int(s)
        frac = (s - iv) * 2.0 - 1.0
        if iv == n:
            frac, iv = 1.0, n - 1
        return frac, iv + 1

    want = np.array([host_conv(v) for v in xs])

    from vpic_jax.state import SpeciesState
    sp = SpeciesState.empty(M + 8)
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    rhob = jnp.zeros((g.nv,), jnp.float32)
    zeros = jnp.zeros((M,), jnp.float32)
    sp2, _, _ = jax.jit(lambda sp, acc, rhob, x: E.runtime_inject(
        sp, g, acc, rhob, jax.random.PRNGKey(0), x,
        jnp.full((M,), g.y0 + 0.5 * g.dy, jnp.float32),
        jnp.full((M,), g.z0 + 0.5 * g.dz, jnp.float32),
        zeros, zeros, zeros, jnp.ones((M,)), -1e-9))(sp, acc, rhob,
                                                     jnp.asarray(xs))
    got_i = np.asarray(sp2.i[:M])
    got_dx = np.asarray(sp2.dx[:M])
    want_ix = (want[:, 1].astype(np.int64)
               + g.NX * (1 + g.NY * 1))
    np.testing.assert_array_equal(got_i, want_ix)
    np.testing.assert_allclose(got_dx, want[:, 0], atol=3e-5)
