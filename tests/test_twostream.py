"""1-D (ny = nz = 1) coverage: two-stream instability on an nx x 1 x 1
periodic box.  The reference supports 1/2/3-D decks (its README.md:3-30);
this pins the degenerate-axis paths."""

import jax
import numpy as np

from vpic_jax.models import twostream


def _run(sim, n):
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    e0 = np.asarray(sim.energies(state))
    for _ in range(n):
        state = step(state)
    return state, e0, np.asarray(sim.energies(state))


def test_twostream_1d():
    p = twostream.TwoStreamParams(nx=64, nppc=48, v0=0.2)
    sim = twostream.build(p)
    # growth rate ~ wpe/2, dt = 0.2/wpe: saturation by step ~50
    state, e0, e_early = _run(sim, 2)
    step = jax.jit(sim.make_advance())
    for _ in range(58):
        state = step(state)
    e1 = np.asarray(sim.energies(state))
    assert np.isfinite(e1).all()
    # total energy conserved through growth + saturation
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 1e-2
    # the electrostatic mode grows out of shot noise to its trapping
    # saturation level (a few percent of the beam kinetic energy)
    assert e1[0] > 8 * max(e_early[0], 1e-12)
    assert e1[0] > 2e-3
    # transverse field components stay at noise level (1-D electrostatic)
    assert e1[1] + e1[2] < 0.1 * e1[0]
    # no particles lost (periodic box)
    for st, sp in zip(sim.species, state.species):
        assert int(sp.np) == len(st.rows())
