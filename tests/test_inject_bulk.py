"""Host-side particle staging (inject_particle / inject_particles) and the
placement of a decomposed deck's state."""

import jax
import numpy as np
import pytest

import vpic_jax as vt

L = np.array([2.0, 2.0, 1.0])
N = np.array([8, 8, 4])


def _deck(topology):
    sim = vt.Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, *L, *N)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), tuple(L), tuple(N), topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sp = sim.define_species("e", -1.0, 1.0, 512)
    return sim, sp


@pytest.mark.parametrize("topology", [(1, 1, 1), (1, 2, 2)])
def test_inject_particles_stages_exact_positions(topology):
    """The staged (cell, offset) rows give back every injected position to
    double precision (misc.cc:16-100); points on the upper faces land in the
    last cell at offset +1, points outside the domain are skipped, array and
    one-at-a-time calls stage alike, and initialize() bins each particle to
    the shard that owns its cell."""
    rng = np.random.default_rng(5)
    n = 300
    pts = rng.uniform(0, 1, (3, n)) * L[:, None]
    pts[:, :4] = [[2.0, 0.0, 2.5, 1.0], [2.0, 2.0, 1.0, -0.1],
                  [1.0, 0.0, 0.5, 0.5]]           # faces, then outside
    u = rng.normal(0, 0.3, (3, n))
    w = rng.uniform(0.5, 1.5, n)
    sim, sp = _deck(topology)
    sim.inject_particles(sp, *pts[:, :-1], *u[:, :-1], w[:-1])
    sim.inject_particle(sp, *pts[:, -1], *u[:, -1], w[-1])
    rows = sim.species[0].rows()
    keep = np.ones(n, bool)
    keep[2:4] = False
    assert rows.shape == (n - 2, 12)
    off, cell = rows[:, 0:3], rows[:, 3:6]
    assert ((off >= -1) & (off <= 1)).all()
    assert ((cell >= 1) & (cell <= N)).all()
    np.testing.assert_array_equal(cell[0], N)
    np.testing.assert_array_equal(off[0], [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(cell[1], [1, N[1], 1])
    np.testing.assert_array_equal(off[1], [-1.0, 1.0, -1.0])
    back = (cell - 1 + (off + 1) / 2) * (L / N)
    np.testing.assert_allclose(back, pts[:, keep].T, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rows[:, 6:10],
                                  np.c_[u[:, keep].T, w[keep]])

    state = sim.initialize()
    local = N // np.array(topology)
    s = ((cell - 1) // local).astype(int)
    flat = (s[:, 0] * topology[1] + s[:, 1]) * topology[2] + s[:, 2]
    np.testing.assert_array_equal(
        np.asarray(state.species[0].np).reshape(-1),
        np.bincount(flat, minlength=int(np.prod(topology))))
    live = np.asarray(state.species[0].live)
    np.testing.assert_array_equal(
        np.sort(np.asarray(state.species[0].w)[live]),
        np.sort(w[keep].astype(np.float32)))


def test_sharded_state_is_spread_over_the_mesh():
    """A decomposed deck's state has one shard per device from
    initialize() on, and keeps it through a step."""
    sim, sp = _deck((1, 2, 2))
    rng = np.random.default_rng(6)
    sim.inject_particles(sp, *rng.uniform(0, 1, (3, 200)),
                         *rng.normal(0, 0.3, (3, 200)), 1.0)
    state = sim.initialize()
    for s in (state, sim.make_step()(state)):
        for leaf in jax.tree.leaves(s):
            assert len(leaf.sharding.device_set) == 4
            assert not leaf.sharding.is_fully_replicated


def test_former_package_name_aliases_the_package():
    """Decks importing the package under its former name (the other
    vpic_* package at the repository root) get the same module objects,
    submodules included."""
    import importlib
    import pathlib
    root = pathlib.Path(vt.__file__).parents[1]
    (former,) = [p.parent.name for p in root.glob("vpic_*/__init__.py")
                 if p.parent.name != "vpic_jax"]
    old = importlib.import_module(former)
    deck = importlib.import_module(former + ".deck")
    import vpic_jax.deck
    assert old is vt and deck is vpic_jax.deck
    assert deck.__spec__.name == "vpic_jax.deck"
    assert importlib.import_module(old.__name__ + ".ops.push") is \
        importlib.import_module("vpic_jax.ops.push")
