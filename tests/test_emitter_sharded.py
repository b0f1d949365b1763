"""Sharded emitter rasterization (round-4 VERDICT item 4): component lists
must be scanned per shard with each shard's own global coordinate offsets
(deck/wrapper.h:310-383 region scans run per MPI rank), not shard-0's
geometry replicated everywhere."""

import numpy as np
import pytest

import vpic_jax as vt
from vpic_jax import emitter as E


def _global_faces(g, comps, topology):
    """Map (vox, face[, valid]) component lists to a set of global
    (gx, gy, gz, face) tuples."""
    out = set()
    if len(comps) == 3:
        vox, fac, val = comps
        px, py, pz = topology
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    v = vox[sx, sy, sz][val[sx, sy, sz]]
                    f = fac[sx, sy, sz][val[sx, sy, sz]]
                    z, r = np.divmod(v, g.sz)
                    y, x = np.divmod(r, g.sy)
                    for xi, yi, zi, fi in zip(x, y, z, f):
                        out.add((sx * g.nx + xi - 1, sy * g.ny + yi - 1,
                                 sz * g.nz + zi - 1, int(fi)))
    else:
        vox, fac = comps
        z, r = np.divmod(vox, g.sz)
        y, x = np.divmod(r, g.sy)
        for xi, yi, zi, fi in zip(x, y, z, fac):
            out.add((int(xi) - 1, int(yi) - 1, int(zi) - 1, int(fi)))
    return out


@pytest.mark.parametrize("topo", [(2, 1, 1), (2, 2, 1)])
def test_sharded_surface_components_match_global(topo):
    """A region crossing shard seams must produce the same global surface
    face set under decomposition as on a single domain (including NO
    spurious faces at the seams)."""
    region = lambda x, y, z: (0.3 < x < 0.8) and (0.2 < y < 0.6)
    g1 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 16,
                                   16, 16, 1)
    gs = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 16,
                                   16, 16, 1, *topo)
    ref = _global_faces(g1, E.surface_components(g1, region), (1, 1, 1))
    got = _global_faces(gs, E.surface_components(gs, region), topo)
    assert ref == got


@pytest.mark.parametrize("topo", [(2, 1, 1), (1, 2, 1)])
def test_sharded_volume_components_match_global(topo):
    region = lambda x, y, z: (0.4 < x < 0.7) and (0.3 < y < 0.8)
    g1 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 16,
                                   16, 16, 1)
    gs = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 16,
                                   16, 16, 1, *topo)
    ref = _global_faces(g1, E.volume_components(g1, region), (1, 1, 1))
    got = _global_faces(gs, E.volume_components(gs, region), topo)
    assert ref == got


def test_sharded_emission_deck_matches_single_domain():
    """Emission deck decomposed (2,1,1): the first-step emitted census must
    match the single-domain run exactly (eligibility is deterministic under
    the uniform bias field), and emission must come from the cathode layer
    in GLOBAL coordinates.  Under the round-3 bug, shard 1 reused shard 0's
    component list, so a cathode region local to shard 0 emitted (wrongly)
    from both shards."""
    import jax
    from vpic_jax.models import emission as M

    counts = {}
    for topo in ((1, 1, 1), (2, 1, 1)):
        sim = M.build(M.EmissionParams(topology=topo, nx=32, ny=8))
        state = sim.initialize()
        adv = sim.make_step()
        state = adv(state)
        n = int(np.asarray(
            jax.device_get(state.species[0].live)).sum())
        counts[topo] = n
    assert counts[(2, 1, 1)] == counts[(1, 1, 1)]
    assert counts[(1, 1, 1)] > 0
