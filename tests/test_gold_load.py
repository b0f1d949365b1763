"""Reference-exact harris particle load (ENERGY_AXIS.md v2): the gold_load
deck replays sample/harris's rng(0) stream bit-for-bit, pinned here against
the step-0 energies of the reference built+run on this host (energies file
row 0: bz 9.955556e+01, electron 1.806303e+01, ion 1.804824e+01 -- the
reference dump lists species in reverse definition order)."""

import numpy as np
import pytest


@pytest.mark.slow
def test_gold_load_step0_energies_match_reference():
    from vpic_jax.models import harris

    sim = harris.build(harris.HarrisParams(gold_load=True))
    state = sim.initialize()
    e = np.asarray(sim.energies(state), np.float64)
    # ex..by exactly zero, bz = tanh^2 profile
    assert np.all(e[:5] == 0.0)
    assert abs(e[5] - 9.955556e+01) < 2e-4
    ion, electron = e[6], e[7]
    assert abs(ion - 1.804824e+01) < 2e-5
    assert abs(electron - 1.806303e+01) < 2e-5
