"""poynting_flux parity (diagnostics.cc:34-81): low-x boundary-plane flux,
ix==0 domain gating, cvac^2 e0^2 division, global plane-area normalization.
Round-4 VERDICT item 5 (the round-3 version summed interior shard planes and
multiplied by e0^2)."""

import numpy as np
import pytest

import vpic_jax as vt
from vpic_jax import diagnostics as D


def _build(topo, nx=8, ny=8, nz=4, cvac=2.0):
    sim = vt.Simulation(seed=0)
    sim.define_units(cvac, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 0.5, nx, ny, nz)
    sim.define_timestep(0.5 * g0.courant_length() / cvac)
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 0.5), (nx, ny, nz), topo)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    return sim


def _set_plane_wave(sim, state, amp_e, amp_b, xprofile=None):
    """Overwrite ey/cbz with a y,z-uniform profile; xprofile maps GLOBAL
    voxel x-index (ghost-inclusive local index i on shard sx -> gx =
    sx*nx + i) to a value, default constant."""
    g = sim.grid
    ey = np.zeros_like(np.asarray(state.fields.ey))
    cbz = np.zeros_like(np.asarray(state.fields.cbz))
    prof = xprofile or (lambda gx: 1.0)
    if g.sharded:
        px = g.topology[0]
        for sx in range(px):
            for i in range(g.NX):
                val = prof(sx * g.nx + i)
                ey[sx, :, :, :, :, i] = amp_e * val
                cbz[sx, :, :, :, :, i] = amp_b * val
    else:
        for i in range(g.NX):
            val = prof(i)
            ey[:, :, i] = amp_e * val
            cbz[:, :, i] = amp_b * val
    import jax.numpy as jnp
    return state.replace(fields=state.fields.replace(
        ey=jnp.asarray(ey), cbz=jnp.asarray(cbz)))


@pytest.mark.parametrize("topo", [(1, 1, 1), (2, 1, 1), (1, 2, 1)])
def test_poynting_uniform_wave(topo):
    """Uniform ey,cbz: S = ey*cbz/(cvac^2 e0^2) exactly, any topology."""
    cvac, A, B, e0 = 2.0, 0.75, 0.5, 1.5
    sim = _build(topo, cvac=cvac)
    state = sim.initialize()
    state = _set_plane_wave(sim, state, A, B)
    s = float(D.poynting_flux(state.fields, sim.grid, e0=e0))
    expect = A * B / (cvac * cvac * e0 * e0)
    assert abs(s - expect) < 1e-6 * abs(expect)


@pytest.mark.parametrize("topo", [(2, 1, 1), (1, 2, 1)])
def test_poynting_gates_on_low_x_shards(topo):
    """x-varying profile: decomposed flux must equal the single-domain
    value (the reference samples global x-plane 2 on ix==0 domains only;
    the old bug summed EVERY shard's local plane)."""
    prof = lambda gx: float(gx + 1)          # distinct value per x-plane
    vals = {}
    for t in [(1, 1, 1), topo]:
        sim = _build(t)
        state = sim.initialize()
        state = _set_plane_wave(sim, state, 1.0, 1.0, xprofile=prof)
        vals[t] = float(D.poynting_flux(state.fields, sim.grid))
    assert abs(vals[topo] - vals[(1, 1, 1)]) < 1e-6 * abs(vals[(1, 1, 1)])
    # and the sampled plane is global x-index 2: ey=3.0 there, cbz averaged
    # over planes 1,2 = 2.5 -> S = 7.5/cvac^2 = 1.875
    assert abs(vals[(1, 1, 1)] - 7.5 / 4.0) < 1e-6
