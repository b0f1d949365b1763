"""Custom particle BCs (maxwellian_reflux, absorb_tally) and the
child-langmuir surface emitter, exercised through the full deck step
(lpi_2d_F6_test-style usage: absorbing box + reflux wall + emission)."""

import jax
import jax.numpy as jnp
import numpy as np

from vpic_jax import boundary_ops as BO
from vpic_jax import emitter as E
from vpic_jax.deck import Simulation
from vpic_jax.grid import ABSORB_FIELDS, ABSORB_PARTICLES, BOUNDARY


def base_sim(nx=8, pbc_handler=None):
    sim = Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (nx, nx, nx))
    if pbc_handler is not None:
        sim.set_domain_field_bc(BOUNDARY(1, 0, 0), ABSORB_FIELDS)
        sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), pbc_handler)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    return sim


def test_maxwellian_reflux_conserves_particles():
    mr = BO.maxwellian_reflux({"beam": 0.15}, {"beam": 0.05})
    sim = base_sim(pbc_handler=mr)
    spc = sim.define_species("beam", 1e-20, 1.0, 512, -1, 0, 1)
    v = 0.4
    u = v / np.sqrt(1 - v * v)
    for k in range(50):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    n0 = int(state.species[0].np)
    for _ in range(12):   # enough steps to hit the +x wall
        state = step(state)
    sp = state.species[0]
    assert int(sp.np) == n0          # refluxed, not absorbed
    live = np.asarray(sp.live)
    ux = np.asarray(sp.ux)[live]
    assert (ux < 0).any()            # some particles now travel backwards
    # refluxed momenta follow the new thermal scales, not the beam
    assert np.abs(ux[ux < 0]).max() < 1.0


def test_absorb_tally_removes_and_charges():
    # test charge small enough that self-fields don't turn the beam around
    q = 1e-6
    at = BO.absorb_tally()
    sim = base_sim(pbc_handler=at)
    spc = sim.define_species("beam", q, 1.0, 512, -1, 0, 1)
    v = 0.4
    u = v / np.sqrt(1 - v * v)
    n_inj = 30
    for k in range(n_inj):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    for _ in range(12):
        state = step(state)
    sp = state.species[0]
    assert int(sp.np) == 0           # all absorbed at the wall
    # absorbed charge ended up in rhob (pre-doubled at the boundary nodes)
    g = sim.grid
    rhob_tot = float(jnp.sum(state.fields.rhob))
    assert rhob_tot > 0.5 * n_inj * q / g.dV
    # the jit-carried tally counted every absorption exactly once
    face = next(iter(sim.pbc_handlers))
    assert BO.tally_of(state.diag, "beam", face) == n_inj


def test_absorb_tally_survives_scan_multistep():
    """Tally counts ride the lax.scan carry (absorb_tally.c:12-84 tallies,
    functional): a single make_multi_step dispatch must report the same
    count as stepwise advance."""
    at = BO.absorb_tally()
    sim = base_sim(pbc_handler=at)
    spc = sim.define_species("beam", 1e-6, 1.0, 512, -1, 0, 1)
    v = 0.4
    u = v / np.sqrt(1 - v * v)
    n_inj = 30
    for k in range(n_inj):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    state = sim.initialize()
    face = next(iter(sim.pbc_handlers))
    assert BO.tally_of(state.diag, "beam", face) == 0
    state = sim.make_multi_step(12)(state)
    assert int(state.species[0].np) == 0
    assert BO.tally_of(state.diag, "beam", face) == n_inj


def test_link_boundary_records_and_write(tmp_path):
    """link_boundary (link.c:18-74): absorbed-particle records accumulate
    in the diag ring buffer under a jitted scan and write_links dumps them
    to the per-rank file with the particle data intact."""
    prefix = str(tmp_path / "link")
    lb = BO.link_boundary(prefix=prefix, buffer_size=128)
    sim = base_sim(pbc_handler=lb)
    spc = sim.define_species("beam", 1e-6, 1.0, 512, -1, 0, 1)
    v = 0.4
    u = v / np.sqrt(1 - v * v)
    n_inj = 20
    for k in range(n_inj):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    state = sim.initialize()
    state = sim.make_multi_step(12)(state)
    assert int(state.species[0].np) == 0
    diag = lb.write_links(state.diag, rank=0)
    face = next(iter(sim.pbc_handlers))
    lines = open(f"{prefix}.0").read().splitlines()
    assert len(lines) == n_inj
    for ln in lines:
        parts = ln.split()
        assert parts[0] == "beam" and int(parts[1]) == face
        assert float(parts[-1]) == 1.0        # weight preserved
        assert abs(float(parts[6])) > 0.0     # ux recorded
    # write_links resets the counter so records aren't double-dumped
    assert int(np.asarray(diag[f"link/{prefix}/beam/f{face}/n"]).sum()) == 0


def test_child_langmuir_emits():
    sim = base_sim()
    spc = sim.define_species("electron", -1.0, 1.0, 8192, -1, 0, 1)
    # strong uniform E field pointing +x everywhere -> cathode at low-x
    # surface of the region emits electrons
    sim.set_region_field(lambda x, y, z: True, ex=0.5)
    region = lambda x, y, z: x > 0.5   # emit from the x=0.5 surface
    sim.define_surface_emitter(E.child_langmuir, region, spc,
                               n_emit_per_face=2, ut_para=0.02,
                               ut_perp=0.01, thresh_e_norm=1e-6)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    assert int(state.species[0].np) == 0
    state = step(state)
    n1 = int(state.species[0].np)
    assert n1 > 0                    # emission happened
    state = step(state)
    assert int(state.species[0].np) > n1   # and continues
    # emitted charge bookkeeping: rhob got -q contributions
    assert float(jnp.sum(state.fields.rhob)) > 0.0
    en = np.asarray(sim.energies(state))
    assert np.isfinite(en).all()


def test_volume_emitter_emits_everywhere_in_region():
    """define_volume_emitter (deck/wrapper.h:348-383): all 6 faces of every
    in-region cell are components; with a uniform field only the aligned
    faces exceed threshold but emission still happens."""
    sim = base_sim()
    spc = sim.define_species("electron", -1.0, 1.0, 16384, -1, 0, 1)
    sim.set_region_field(lambda x, y, z: True, ex=0.5)
    region = lambda x, y, z: 0.4 < x < 0.8
    sim.define_volume_emitter(E.child_langmuir, region, spc,
                              n_emit_per_face=1, ut_para=0.02,
                              ut_perp=0.01, thresh_e_norm=1e-6)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    state = step(state)
    assert int(state.species[0].np) > 0
    en = np.asarray(sim.energies(state))
    assert np.isfinite(en).all()
