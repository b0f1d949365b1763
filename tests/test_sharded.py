"""Multi-shard tests on the virtual 8-device CPU mesh: the pcomm-analogue
particle-migration test (test/integrated/legacy/pcomm.deck runs on 8 ranks)
and sharded-vs-single-device equivalence of full decks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax.models import harris, weibel
from vpic_jax.parallel import mesh as M


def run(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return state


def total_np(state):
    return int(sum(np.asarray(sp.np).sum() for sp in state.species))


def test_dryrun_multichip():
    M.dryrun(4)


def test_sharded_harris_matches_single_device():
    """Same deck, same staged particles: 8 steps on a (1,2,1) mesh must track
    the single-device run (f32 collective ordering differences only)."""
    kw = dict(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0, seed=3,
              sort_interval=0)
    p1 = harris.HarrisParams(**kw, topology=(1, 1, 1))
    p2 = harris.HarrisParams(**kw, topology=(1, 2, 1))
    sim1, sim2 = harris.build(p1), harris.build(p2)

    s1 = run(sim1, 6)
    s2 = run(sim2, 6)
    e1 = np.asarray(sim1.energies(s1))
    e2 = np.asarray(sim2.energies(s2))
    assert total_np(s1) == total_np(s2)
    np.testing.assert_allclose(e2, e1, rtol=5e-4, atol=1e-7 * e1.sum())


def test_sharded_2d_mesh_weibel():
    """(2,2,1) decomposition of the Weibel deck: energy conservation and
    particle-count conservation across 30 steps with active migration."""
    p = weibel.WeibelParams(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0,
                            topology=(2, 2, 1), sort_interval=0)
    sim = weibel.build(p)
    state = sim.initialize()
    n0 = total_np(state)
    e0 = np.asarray(sim.energies(state))
    step = sim.make_step()
    for _ in range(20):
        state = step(state)
    e1 = np.asarray(sim.energies(state))
    assert total_np(state) == n0
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 5e-3


def test_pcomm_migration_roundtrip():
    """pcomm analogue: ballistic particles crossing shard boundaries on an
    8-device (2,2,2) periodic mesh return to their start after a full
    periodic transit."""
    from vpic_jax.deck import Simulation, everywhere

    n, ns = 8, 2
    sim = Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)  # transit of one cell per ~3 steps
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0),
                             (n * ns, n * ns, n * ns), (ns, ns, ns))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.num_comm_round = 1  # axis-aligned single-hop crossings only
    spc = sim.define_species("test", 1e-30, 1.0, 4096, -1, 0, 1)
    # ballistic particles along each axis (q ~ 0 so fields stay ~0)
    v = 0.5
    gamma = 1 / np.sqrt(1 - v * v)
    u = v * gamma
    starts = [(0.3, 0.4, 0.6), (0.7, 0.2, 0.9), (0.12, 0.55, 0.31)]
    for (x, y, z) in starts:
        sim.inject_particle(spc, x, y, z, u, 0, 0, 1.0)
        sim.inject_particle(spc, x, y, z, 0, -u, 0, 1.0)
        sim.inject_particle(spc, x, y, z, 0, 0, u, 1.0)

    state = sim.initialize()
    step = sim.make_step()
    n0 = total_np(state)

    # Each step moves v*dt = 0.02; a full box transit is 1.0 -> 50 steps.
    for _ in range(50):
        state = step(state)
    assert total_np(state) == n0

    # Gather global positions: voxel + offset -> global coordinate.
    g = sim.grid
    pos = []
    sp = state.species[0]
    arr = {k: np.asarray(getattr(sp, k)) for k in
           ("dx", "dy", "dz", "i", "live")}
    for sx in range(ns):
        for sy in range(ns):
            for sz in range(ns):
                live = arr["live"][sx, sy, sz]
                vox = arr["i"][sx, sy, sz][live]
                zi, r = np.divmod(vox, g.sz)
                yi, xi = np.divmod(r, g.sy)
                x = (g.x0 + (sx * g.nx + xi - 1) * g.dx
                     + (arr["dx"][sx, sy, sz][live] + 1) * 0.5 * g.dx)
                y = (g.y0 + (sy * g.ny + yi - 1) * g.dy
                     + (arr["dy"][sx, sy, sz][live] + 1) * 0.5 * g.dy)
                z = (g.z0 + (sz * g.nz + zi - 1) * g.dz
                     + (arr["dz"][sx, sy, sz][live] + 1) * 0.5 * g.dz)
                pos.extend(zip(x, y, z))
    pos = np.array(sorted(pos))
    expect = np.array(sorted([s for s in starts for _ in range(3)]))
    np.testing.assert_allclose(pos, expect, atol=2e-3)


def test_sharded_local_bc_axis_matches_single_device():
    """pec + reflecting walls on a SHARDED axis: only edge shards apply the
    local BC, interior faces exchange halos -- must track the single-device
    run (harris decomposed along x, its pec axis)."""
    kw = dict(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0, seed=5, sort_interval=0)
    sim1 = harris.build(harris.HarrisParams(**kw, topology=(1, 1, 1)))
    sim2 = harris.build(harris.HarrisParams(**kw, topology=(2, 1, 1)))
    s1 = run(sim1, 6)
    s2 = run(sim2, 6)
    e1 = np.asarray(sim1.energies(s1))
    e2 = np.asarray(sim2.energies(s2))
    assert total_np(s1) == total_np(s2)
    np.testing.assert_allclose(e2, e1, rtol=5e-4, atol=1e-7 * e1.sum())
