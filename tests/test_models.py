"""Physics smoke tests for the remaining sample decks (beam_plas two-stream
growth, LPI laser injection into a slab)."""

import jax
import numpy as np
import pytest

from vpic_jax.models import beam_plas, lpi


def run(sim, n):
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    e0 = np.asarray(sim.energies(state))
    for _ in range(n):
        state = step(state)
    return state, e0, np.asarray(sim.energies(state))


def test_beam_plasma_two_stream():
    p = beam_plas.BeamPlasParams(nx=32, ny=2, Lx=16.0, Ly=1.0, nppc=32,
                                 u_beam=0.4)
    sim = beam_plas.build(p)
    state, e0, e1 = run(sim, 150)
    # total energy conserved
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 5e-3
    # electrostatic (ex) energy grows from noise by orders of magnitude
    assert e1[0] > 20 * max(e0[0], 1e-12)


def test_lpi_laser_propagates_and_heats():
    p = lpi.LPIParams(nx=64, ny=8, Lx=16.0, Ly=2.0, nppc=4, slab_x0=8.0,
                      laser_a0=0.2)
    sim = lpi.build(p)
    state, e0, e1 = run(sim, 120)
    f = state.fields
    ey = np.asarray(f.ey)[1, 1:-1, 1:-1]
    # laser field present in the vacuum region
    assert np.abs(ey[:, : ey.shape[1] // 3]).max() > 0.02
    # fields + particles gained energy from the injected wave
    assert e1.sum() > e0.sum() + 1e-4
    assert np.isfinite(e1).all()
    # particle counts stable (refluxed, not lost)
    for st, sp in zip(sim.species, state.species):
        assert int(sp.np) == len(st.rows())


def test_asymm4sp_runs_and_conserves():
    """Asymmetric 4-species reconnection deck: finite energies, rough
    total-energy conservation, and a genuinely asymmetric field."""
    from vpic_jax.models import asymm4sp

    p = asymm4sp.Asymm4spParams(nx=16, ny=16, nppc_sheet=8, nppc_bg=8,
                                Lx=8.0, Ly=8.0)
    sim = asymm4sp.build(p)
    assert len(sim.species) == 4
    st = sim.initialize()
    bz = np.asarray(st.fields.cbz)
    assert bz.min() < -0.5 * abs(bz.max())      # asymmetric layer
    adv = jax.jit(sim.make_advance())
    e0 = np.asarray(sim.energies(st)).sum()
    for _ in range(20):
        st = adv(st)
    e1 = np.asarray(sim.energies(st))
    assert np.isfinite(e1).all()
    assert abs(e1.sum() - e0) / e0 < 5e-3
