"""Deck-level inject_particle(age=...) performs the aged partial push
(misc.cc:80-99): displacement u*age*cvac*dt/gamma walked through the
exact streak walk at initialize, matching the device-side emission path
(emitter.runtime_inject) for the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np

import vpic_jax as vt
from vpic_jax import emitter as E


def mk(age, x=0.53, capacity=100):
    sim = vt.Simulation(seed=1)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, capacity, -1, 4, 1)
    sim.inject_particle(el, x, 0.5, 0.5, 2.0, 0.5, 0.0, 1.0, age=age)
    return sim


def test_aged_injection_moves_particle():
    g = mk(0).grid
    st0 = mk(0.0).initialize()
    st1 = mk(0.5).initialize()
    sp0, sp1 = st0.species[0], st1.species[0]
    ux, uy = 2.0, 0.5
    gam = np.sqrt(1 + ux * ux + uy * uy)
    aged = 0.5 * g.cvac * g.dt / gam
    assert abs(float(sp1.dx[0])
               - (float(sp0.dx[0]) + 2 * ux * aged * g.rdx)) < 1e-6
    assert abs(float(sp1.dy[0])
               - (float(sp0.dy[0]) + 2 * uy * aged * g.rdy)) < 1e-6
    assert int(sp1.i[0]) == int(sp0.i[0])
    assert float(sp1.ux[0]) == float(sp0.ux[0])     # kick-free


def test_aged_injection_crosses_cell():
    st0 = mk(0.0, x=0.559).initialize()
    st2 = mk(0.99, x=0.559).initialize()
    assert int(st2.species[0].i[0]) == int(st0.species[0].i[0]) + 1
    assert -1.0 <= float(st2.species[0].dx[0]) <= 1.0


def test_aged_injection_matches_runtime_inject():
    """The deck path and the device-side emission path (runtime_inject,
    the reference's misc.cc analogue used by emitters) must place an
    aged particle identically."""
    sim = mk(0.75, x=0.559)
    g = sim.grid
    st = sim.initialize()
    sp_deck = st.species[0]

    sim2 = mk(0.0, x=0.559)
    st2 = sim2.initialize()
    empty = st2.species[0].replace(
        live=jnp.zeros_like(st2.species[0].live),
        w=jnp.zeros_like(st2.species[0].w), np=jnp.int32(0))
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    rhob = jnp.zeros((g.nv,), jnp.float32)
    one = lambda v: jnp.asarray([v], jnp.float32)
    sp_rt, _, _ = E.runtime_inject(
        empty, g, acc, rhob, None, one(0.559), one(0.5), one(0.5),
        one(2.0), one(0.5), one(0.0), one(1.0), -1.0,
        age=one(0.75))
    for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
        a = float(np.asarray(getattr(sp_deck, n))[0])
        b = float(np.asarray(getattr(sp_rt, n))[0])
        assert abs(a - b) <= 2e-6 * max(1.0, abs(a)), (n, a, b)


def test_aged_absorbing_wall_kills():
    """An aged walk into an absorbing wall kills the particle (the walk
    also books the absorb charge into rhob like move_p at injection, but
    initialize() then recomputes rhob from div E -- initialize.cc:40 --
    so only the death is observable here; the rhob path itself is
    covered by test_absorbing)."""
    sim = mk(0.0)
    # rebuild with absorbing x walls and a particle hugging the wall
    sim = vt.Simulation(seed=1)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, 1))
    sim.set_domain_field_bc(vt.BOUNDARY(1, 0, 0), vt.ABSORB_FIELDS)
    sim.set_domain_particle_bc(vt.BOUNDARY(1, 0, 0), vt.ABSORB_PARTICLES)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 100, -1, 4, 1)
    sim.inject_particle(el, 1.0 - 1e-4, 0.5, 0.5, 30.0, 0.0, 0.0, 1.0,
                        age=0.99)
    st = sim.initialize()
    assert int(np.asarray(st.species[0].live).sum()) == 0
