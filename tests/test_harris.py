"""End-to-end deck tests: harris reconnection and Weibel instability.

The reference validates end-to-end physics with run-to-completion decks and
an energy-history golden comparison (test/unit/energy_comparison); here the
oracles are physics invariants: total-energy conservation, Gauss-law error
bounds, particle-count conservation, and Weibel field growth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax.models import harris, weibel
from vpic_jax.ops import fields as F
from vpic_jax.ops import push as P


def run_deck(sim, n_steps):
    state = sim.initialize()
    adv = jax.jit(sim.make_advance())
    e0 = np.asarray(sim.energies(state))
    state = adv(state)  # compile + step
    for _ in range(n_steps - 1):
        state = adv(state)
    e1 = np.asarray(sim.energies(state))
    return state, e0, e1


@pytest.fixture(scope="module")
def harris_run():
    p = harris.HarrisParams(nx=32, ny=32, nppc=32, Lx=8.0, Ly=8.0)
    sim = harris.build(p)
    state, e0, e1 = run_deck(sim, 100)
    return sim, state, e0, e1


def test_harris_total_energy_conserved(harris_run):
    sim, state, e0, e1 = harris_run
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 2e-3


def test_harris_particles_conserved(harris_run):
    sim, state, e0, e1 = harris_run
    # reflecting + periodic walls: no particle should be lost
    for st, sp in zip(sim.species, state.species):
        assert int(sp.np) == len(st.rows())


def test_harris_gauss_law(harris_run):
    """After div-e cleaning rounds the Gauss-law residual must be small
    relative to the charge scale."""
    sim, state, e0, e1 = harris_run
    g = sim.grid
    m = sim._material_coeffs()
    f = state.fields
    f = F.clear_rhof(f)
    rhof = f.rhof.reshape(-1)
    for st, sp in zip(sim.species, state.species):
        rhof = P.accumulate_rho_p(rhof, sp, g, st.params.q)
    f = f.replace(rhof=rhof.reshape(g.shape))
    f = F.synchronize_rho(f, g)
    f = F.compute_div_e_err(f, g, m)
    num, den = F.compute_rms_div_e_err(f, g)
    rms = g.eps0 * np.sqrt(float(num) / float(den))
    # charge scale: n0 * ec
    assert rms < 0.05 * sim.meta["n0"]


def test_harris_current_sheet_field_structure(harris_run):
    """The tanh(x) Bz profile must persist (linear phase): Bz antisymmetric
    about x=0, magnitude ~ b0 at the walls."""
    sim, state, e0, e1 = harris_run
    g = sim.grid
    b0 = sim.meta["b0"]
    cbz = np.asarray(state.fields.cbz)[1, 1:-1, 1:-1]  # [y, x] plane
    prof = cbz.mean(axis=0)
    nx = prof.size
    assert prof[int(0.9 * nx)] > 0.7 * b0
    assert prof[int(0.1 * nx)] < -0.7 * b0
    # antisymmetry
    assert abs(prof[nx // 4] + prof[3 * nx // 4]) < 0.2 * b0


def test_weibel_growth_and_energy():
    p = weibel.WeibelParams(nx=16, ny=16, nppc=16, Lx=8.0, Ly=8.0,
                            uth_perp=0.45, uth_par=0.05)
    sim = weibel.build(p)
    state, e0, e1 = run_deck(sim, 150)
    # total energy conserved
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 5e-3
    # magnetic energy grows from (near) zero: filamentation
    b_energy0 = e0[3:6].sum()
    b_energy1 = e1[3:6].sum()
    assert b_energy1 > max(10 * b_energy0, 1e-7 * e0.sum())
