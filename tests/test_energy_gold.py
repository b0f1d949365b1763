"""Golden energy-history regression (test/unit/energy_comparison analogue):
a deterministic Weibel run compared column-by-column against a committed
gold file with per-quantity relative tolerances (compare_energies.h:20-60).

Regenerate tests/data/weibel_energies_gold.txt only after an intentional
physics-affecting change (see file header for the generation recipe)."""

import os

import jax
import numpy as np

from vpic_jax.models import weibel

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "weibel_energies_gold.txt")

# per-column relative tolerances: growing field modes are seeded by f32
# roundoff so they tolerate more than the dominant kinetic energies
RTOL = dict(ex=2e-2, ey=2e-2, ez=5e-2, bx=5e-2, by=5e-2, bz=5e-2,
            ke_e=1e-3, ke_i=1e-3)
COLS = ("ex", "ey", "ez", "bx", "by", "bz", "ke_e", "ke_i")


def test_weibel_energy_history_matches_gold():
    gold = np.loadtxt(GOLD)
    p = weibel.WeibelParams(nx=16, ny=16, nppc=16, Lx=8.0, Ly=8.0,
                            uth_perp=0.4, uth_par=0.1, seed=7)
    sim = weibel.build(p)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    rows = []
    for k in range(100):
        state = step(state)
        if (k + 1) % 10 == 0:
            rows.append([k + 1] + list(np.asarray(sim.energies(state),
                                                  np.float64)))
    got = np.asarray(rows)
    assert got.shape == gold.shape
    np.testing.assert_array_equal(got[:, 0], gold[:, 0])
    scale = gold[:, 1:].max()   # absolute floor vs the dominant energy
    for c, name in enumerate(COLS):
        g = gold[:, 1 + c]
        v = got[:, 1 + c]
        err = np.abs(v - g) / np.maximum(np.abs(g), 1e-5 * scale)
        assert err.max() < RTOL[name], (
            f"column {name}: max rel err {err.max():.2e} > {RTOL[name]}")
