"""Irregular domain graphs: join_domain across arbitrary ranks.

The reference splices arbitrary rank graphs by hand-wiring grid ports
(grid/ops.c:119-212 join_grid; sample/interface_deck_2D_decomp hand-wires
per-rank BCs from RANK_TO_INDEX).  Here joins ride per-face partner tables
(Grid.face_partners): halo exchange and particle migration use explicit
flat-rank ppermute pairs instead of whole-axis shifts.

The acid test: a (4,1,1) mesh whose x-links are re-joined into TWO
independent 2-rank rings -- a topology no whole-axis permute can express.
Each ring must evolve exactly like an independent (2,1,1) periodic run.
"""

import numpy as np
import pytest

import jax
import vpic_jax as vt


def _parts(seed, n, Lx):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, Lx, n)
    y = rng.uniform(0, 1.0, n)
    ux = rng.choice([-0.5, 0.5], n) + rng.normal(0, 0.05, n)
    uy = rng.normal(0, 0.1, n)
    return list(zip(x, y, ux, uy))


def _build(gnx, topo, Lx, part_sets):
    """Uniform drifting plasma; part_sets = [(x_offset, parts), ...]."""
    sim = vt.Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, Lx, 1.0, 0.125, gnx, 8, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (Lx, 1.0, 0.125), (gnx, 8, 1),
                             topo)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 1024)
    for off, parts in part_sets:
        for x, y, ux, uy in parts:
            sim.inject_particle(ele, x + off, y, 0.0625, ux, uy, 0.0,
                                w=1.0)
    return sim


def _run(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return state


@pytest.mark.slow
def test_twisted_pairs_match_independent_runs():
    """Two independent 2-rank rings inside one 4-rank mesh: fields and
    energies of each ring must track a standalone (2,1,1) periodic run
    of the same half (migration + halo exchange through the join table
    only; zero cross-ring leakage)."""
    pa = _parts(1, 180, 2.0)
    pb = _parts(2, 180, 2.0)

    simA = _build(32, (4, 1, 1), 4.0, [(0.0, pa), (2.0, pb)])
    # re-splice the periodic x ring 0-1-2-3-0 into 0-1-0 and 2-3-2
    simA.join_domain(3, 1, 0)
    simA.join_domain(3, 0, 1)
    simA.join_domain(3, 3, 2)
    simA.join_domain(3, 2, 3)
    assert simA.grid.face_partners[3] == (1, 0, 3, 2)

    simB1 = _build(16, (2, 1, 1), 2.0, [(0.0, pa)])
    simB2 = _build(16, (2, 1, 1), 2.0, [(0.0, pb)])
    assert abs(simA.grid.dt - simB1.grid.dt) < 1e-12

    # Compare at 4 steps: initialize() is bit-exact between the two
    # programs (measured); per-step differences are f32 associativity of
    # the differently-lowered 4- vs 2-shard XLA programs (~3e-6 relative
    # per step), which the drifting-beam instability then amplifies --
    # so the physics comparison uses a short horizon and a margin above
    # the measured ~2e-5 relative divergence at step 4.
    sA = _run(simA, 1)
    sB1 = _run(simB1, 1)
    sB2 = _run(simB2, 1)

    # tight energy additivity right after the first step (before the
    # beam instability amplifies f32 lowering differences)
    eA1 = np.asarray(simA.energies(sA))
    eB1e = np.asarray(simB1.energies(sB1)) + np.asarray(simB2.energies(sB2))
    np.testing.assert_allclose(eA1, eB1e, rtol=1e-4, atol=1e-6 * eB1e.sum())

    stepA, stepB1, stepB2 = (simA.make_step(), simB1.make_step(),
                             simB2.make_step())
    for _ in range(3):
        sA, sB1, sB2 = stepA(sA), stepB1(sB1), stepB2(sB2)

    # field equivalence, shard block vs shard block
    exA = np.asarray(sA.fields.ex)      # (4,1,1, NZ,NY,NX)
    exB1 = np.asarray(sB1.fields.ex)    # (2,1,1, NZ,NY,NX)
    exB2 = np.asarray(sB2.fields.ex)
    scale = max(np.abs(exB1).max(), 1e-12)
    for r in range(2):
        np.testing.assert_allclose(exA[r, 0, 0], exB1[r, 0, 0],
                                   atol=1e-3 * scale, rtol=1e-2)
        np.testing.assert_allclose(exA[2 + r, 0, 0], exB2[r, 0, 0],
                                   atol=1e-3 * scale, rtol=1e-2)

    # energy additivity across the disconnected components (loose: by
    # step 4 individual boundary-grazing particles can take divergent
    # trajectories at f32, ~1% of the kinetic sum at 360 particles)
    eA = np.asarray(simA.energies(sA))
    eB = np.asarray(simB1.energies(sB1)) + np.asarray(simB2.energies(sB2))
    np.testing.assert_allclose(eA, eB, rtol=5e-2, atol=1e-4 * eB.sum())

    # conservation + isolation hold over a longer run: ring (0,1) holds
    # exactly pa's census, ring (2,3) pb's, nobody lost or leaked
    for _ in range(4):
        sA = stepA(sA)
    np_per_rank = np.asarray(sA.species[0].np).reshape(-1)
    assert np_per_rank.sum() == 360
    assert np_per_rank[:2].sum() == 180
    assert np_per_rank[2:].sum() == 180


def test_join_domain_table_editing():
    """Splice/unsplice bookkeeping: joins are reciprocal and stale links
    are removed so each face table stays a partial permutation."""
    sim = vt.Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 4.0, 1.0, 0.125, 32, 8, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (4.0, 1.0, 0.125), (32, 8, 1),
                             (4, 1, 1))
    sim.join_domain(3, 2, 0)      # 0.+x -> 2 (steals 2's old -x link to 1)
    fp = sim.grid.face_partners
    assert fp[3][0] == 2 and fp[0][2] == 0
    # rank 1's +x pointed at 2 in the cartesian seed; the unsplice cleared
    # it when 2's -x was re-pointed at 0
    assert fp[3][1] == -1
    # every face table is a partial permutation (injective over >=0)
    for f in range(6):
        tgts = [v for v in fp[f] if v >= 0]
        assert len(tgts) == len(set(tgts))
