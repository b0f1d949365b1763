"""Particle-engine analytic tests: ports of the reference's legacy
integrated physics tests (test/integrated/legacy/{accel,cyclo,inbndj,
outbndj}.deck) plus charge-conservation and boundary-interaction checks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax.grid import (ABSORB_PARTICLES, REFLECT_PARTICLES,
                           partition_periodic_box)
from vpic_jax.state import FieldState, MaterialCoeffs, SpeciesState
from vpic_jax.ops import fields as F
from vpic_jax.ops import interp as I
from vpic_jax.ops import push as P


def simple_grid(n=8, L=1.0, dt=0.05):
    return dataclasses.replace(
        partition_periodic_box(0, 0, 0, L, L, L, n, n, n), dt=dt)


def put_particles(g, xs, us, ws=None, cap=None):
    """Place particles at offset coords (dx,dy,dz,voxelx,voxely,voxelz)."""
    n = len(xs)
    cap = cap or n
    sp = SpeciesState.empty(cap)
    arr = np.zeros((cap, 3), np.float32)
    vox = np.zeros(cap, np.int32)
    uu = np.zeros((cap, 3), np.float32)
    w = np.zeros(cap, np.float32)
    live = np.zeros(cap, bool)
    for k, ((dx, dy, dz, ix, iy, iz), u) in enumerate(zip(xs, us)):
        arr[k] = (dx, dy, dz)
        vox[k] = g.voxel(ix, iy, iz)
        uu[k] = u
        w[k] = 1.0 if ws is None else ws[k]
    live[:n] = True
    return sp.replace(dx=jnp.asarray(arr[:, 0]), dy=jnp.asarray(arr[:, 1]),
                      dz=jnp.asarray(arr[:, 2]), i=jnp.asarray(vox),
                      ux=jnp.asarray(uu[:, 0]), uy=jnp.asarray(uu[:, 1]),
                      uz=jnp.asarray(uu[:, 2]), w=jnp.asarray(w),
                      live=jnp.asarray(live), np=jnp.int32(n))


def uniform_field_coeffs(g, ex=0.0, ey=0.0, ez=0.0, cbx=0.0, cby=0.0, cbz=0.0):
    f = FieldState.zeros(g)
    f = f.replace(ex=jnp.full(g.shape, ex), ey=jnp.full(g.shape, ey),
                  ez=jnp.full(g.shape, ez), cbx=jnp.full(g.shape, cbx),
                  cby=jnp.full(g.shape, cby), cbz=jnp.full(g.shape, cbz))
    return f, I.load_interpolator(f, g)


def test_accel_uniform_e():
    """accel.deck analogue: particles in a uniform E field gain exactly
    u = n * qdt/mc * E per step (no B, no displacement if we keep q/m tiny
    enough... here we just check momentum; positions follow)."""
    g = simple_grid(n=8, dt=0.01)
    E = (1.0, 2.0, 3.0)
    f, fc = uniform_field_coeffs(g, ex=E[0], ey=E[1], ez=E[2])
    sp = put_particles(g, [(0.1, -0.2, 0.3, 4, 4, 4)], [(0, 0, 0)])
    q, m = 1.0, 1.0
    qdt_mc = q * g.dt / (m * g.cvac)
    rhob = jnp.zeros(g.nv, jnp.float32)
    nstep = 50
    for _ in range(nstep):
        acc = jnp.zeros((g.nv, 12), jnp.float32)
        res = P.advance_p(sp, fc, g, q, m, acc, rhob)
        sp, rhob = res.species, res.rhob_flat
        assert int(res.n_pend) == 0
    u = np.array([float(sp.ux[0]), float(sp.uy[0]), float(sp.uz[0])])
    expect = nstep * qdt_mc * np.array(E)
    np.testing.assert_allclose(u, expect, rtol=1e-5)


def test_cyclo_uniform_b():
    """cyclo analogue: gyration in uniform B conserves |u| and rotates at
    the (discrete Boris) cyclotron frequency."""
    g = simple_grid(n=8, dt=0.02)
    b0 = 2.0
    f, fc = uniform_field_coeffs(g, cbz=b0)
    u0 = 0.1
    sp = put_particles(g, [(0.0, 0.0, 0.0, 4, 4, 4)], [(u0, 0, 0)])
    q, m = 1.0, 1.0
    rhob = jnp.zeros(g.nv, jnp.float32)
    us = []
    for _ in range(200):
        acc = jnp.zeros((g.nv, 12), jnp.float32)
        res = P.advance_p(sp, fc, g, q, m, acc, rhob)
        sp, rhob = res.species, res.rhob_flat
        us.append((float(sp.ux[0]), float(sp.uy[0])))
    us = np.array(us)
    umag = np.hypot(us[:, 0], us[:, 1])
    np.testing.assert_allclose(umag, u0, rtol=1e-4)  # |u| conserved
    # Boris rotation angle per step: ~ -qB dt/(m gamma) (negative charge dir)
    gamma = np.sqrt(1 + u0 ** 2)
    theta = 2 * np.arctan(q * b0 * g.dt / (2 * m * gamma))
    phase = np.unwrap(np.arctan2(us[:, 1], us[:, 0]))
    dphase = np.diff(phase)
    np.testing.assert_allclose(np.abs(dphase).mean(), theta, rtol=1e-3)


def test_inbounds_current_deposition_charge_conservation():
    """inbndj analogue: the quarter-face currents of an in-bounds push
    satisfy discrete charge conservation: div(j) = -d(rho)/dt."""
    g = simple_grid(n=8, dt=0.05)
    f, fc = uniform_field_coeffs(g)
    # several particles with assorted positions/velocities, none crossing
    rng = np.random.RandomState(5)
    xs, us = [], []
    for _ in range(20):
        xs.append((*(rng.uniform(-0.5, 0.5, 3)), 4, 4, 4))
        us.append(rng.uniform(-0.5, 0.5, 3))
    sp = put_particles(g, xs, us)
    q, m = 1.5, 1.0

    rho0 = P.accumulate_rho_p(jnp.zeros(g.nv, jnp.float32), sp, g, q)
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    res = P.advance_p(sp, fc, g, q, m, acc, jnp.zeros(g.nv, jnp.float32))
    assert int(res.n_pend) == 0
    rho1 = P.accumulate_rho_p(jnp.zeros(g.nv, jnp.float32), res.species, g, q)

    ff = F.clear_jf(FieldState.zeros(g))
    ff = I.unload_accumulator(ff, res.acc, g)

    # discrete divergence of jf at nodes (jf on edges; node-centered div)
    jfx = np.asarray(ff.jfx)
    jfy = np.asarray(ff.jfy)
    jfz = np.asarray(ff.jfz)
    rho0 = np.asarray(rho0).reshape(g.shape)
    rho1 = np.asarray(rho1).reshape(g.shape)
    drho_dt = (rho1 - rho0) / g.dt
    # div j at node (x,y,z) = (jfx(x,y,z)-jfx(x-1,y,z))/dx + ...
    div = np.zeros(g.shape, np.float32)
    div[1:-1, 1:-1, 1:-1] = (
        (jfx[1:-1, 1:-1, 1:-1] - jfx[1:-1, 1:-1, 0:-2]) * g.rdx
        + (jfy[1:-1, 1:-1, 1:-1] - jfy[1:-1, 0:-2, 1:-1]) * g.rdy
        + (jfz[1:-1, 1:-1, 1:-1] - jfz[0:-2, 1:-1, 1:-1]) * g.rdz)
    lhs = div[2:-2, 2:-2, 2:-2]
    rhs = -drho_dt[2:-2, 2:-2, 2:-2]
    scale = np.abs(rhs).max()
    np.testing.assert_allclose(lhs, rhs, atol=2e-5 * scale)


def test_outbounds_crossing_charge_conservation():
    """outbndj analogue: charge conservation must hold when particles cross
    voxel faces (the streak-walk multi-deposit path)."""
    g = simple_grid(n=8, dt=0.05)
    f, fc = uniform_field_coeffs(g)
    rng = np.random.RandomState(6)
    xs, us = [], []
    for _ in range(30):
        # near faces, large velocities -> guaranteed crossings
        xs.append((*(rng.choice([-0.95, 0.95], 3)
                     + rng.uniform(-0.04, 0.04, 3)), 4, 4, 4))
        u = rng.uniform(-1, 1, 3) * 8.0
        us.append(u)
    sp = put_particles(g, xs, us)
    q, m = -2.0, 1.0

    rho0 = P.accumulate_rho_p(jnp.zeros(g.nv, jnp.float32), sp, g, q)
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    res = P.advance_p(sp, fc, g, q, m, acc, jnp.zeros(g.nv, jnp.float32))
    assert int(res.n_pend) == 0
    rho1 = P.accumulate_rho_p(jnp.zeros(g.nv, jnp.float32), res.species, g, q)

    ff = F.clear_jf(FieldState.zeros(g))
    ff = I.unload_accumulator(ff, res.acc, g)
    jfx, jfy, jfz = (np.asarray(a) for a in (ff.jfx, ff.jfy, ff.jfz))
    rho0 = np.asarray(rho0).reshape(g.shape)
    rho1 = np.asarray(rho1).reshape(g.shape)
    drho_dt = (rho1 - rho0) / g.dt
    div = np.zeros(g.shape, np.float32)
    div[1:-1, 1:-1, 1:-1] = (
        (jfx[1:-1, 1:-1, 1:-1] - jfx[1:-1, 1:-1, 0:-2]) * g.rdx
        + (jfy[1:-1, 1:-1, 1:-1] - jfy[1:-1, 0:-2, 1:-1]) * g.rdy
        + (jfz[1:-1, 1:-1, 1:-1] - jfz[0:-2, 1:-1, 1:-1]) * g.rdz)
    lhs = div[2:-2, 2:-2, 2:-2]
    rhs = -drho_dt[2:-2, 2:-2, 2:-2]
    scale = np.abs(rhs).max()
    np.testing.assert_allclose(lhs, rhs, atol=5e-5 * scale)


def test_periodic_wrap():
    """A fast particle exits +x and re-enters at -x with flipped offset."""
    g = simple_grid(n=4, dt=0.05)
    f, fc = uniform_field_coeffs(g)
    # at +x face of the last interior voxel, moving +x fast
    sp = put_particles(g, [(0.9, 0.0, 0.0, 4, 2, 2)], [(20.0, 0, 0)])
    res = P.advance_p(sp, fc, g, 1.0, 1.0,
                      jnp.zeros((g.nv, 12), jnp.float32),
                      jnp.zeros(g.nv, jnp.float32))
    assert int(res.n_pend) == 0
    x, y, z = g.decode_voxel(int(res.species.i[0]))
    assert x == 1  # wrapped to first interior voxel
    assert bool(res.species.live[0])


def test_reflect_particles():
    """Reflecting wall: particle bounces back, |u| conserved, stays live."""
    g = simple_grid(n=4, dt=0.05)
    g = g.with_bc(3, pbc=REFLECT_PARTICLES)  # +x face reflects
    f, fc = uniform_field_coeffs(g)
    sp = put_particles(g, [(0.9, 0.0, 0.0, 4, 2, 2)], [(20.0, 0, 0)])
    res = P.advance_p(sp, fc, g, 1.0, 1.0,
                      jnp.zeros((g.nv, 12), jnp.float32),
                      jnp.zeros(g.nv, jnp.float32))
    assert int(res.n_pend) == 0
    assert float(res.species.ux[0]) < 0  # reflected
    x, _, _ = g.decode_voxel(int(res.species.i[0]))
    assert x == 4  # still in the wall voxel
    assert bool(res.species.live[0])


def test_absorb_particles_updates_rhob():
    """Absorbing wall: particle dies; its charge lands in rhob."""
    g = simple_grid(n=4, dt=0.05)
    g = g.with_bc(3, pbc=ABSORB_PARTICLES)
    f, fc = uniform_field_coeffs(g)
    sp = put_particles(g, [(0.9, 0.0, 0.0, 4, 2, 2)], [(20.0, 0, 0)])
    q = 3.0
    res = P.advance_p(sp, fc, g, q, 1.0,
                      jnp.zeros((g.nv, 12), jnp.float32),
                      jnp.zeros(g.nv, jnp.float32))
    assert not bool(res.species.live[0])
    assert int(res.species.np) == 0
    total_rhob = float(jnp.sum(res.rhob_flat))
    # corrected accumulation doubles boundary-node weights so that the
    # fields-side average over the shared/boundary faces recovers q/dV
    assert abs(total_rhob - 2 * q / g.dV) / (2 * q / g.dV) < 1e-5


def test_energy_p_and_center_uncenter_roundtrip():
    g = simple_grid(n=8, dt=0.02)
    f, fc = uniform_field_coeffs(g, ex=0.5, cbz=1.0)
    rng = np.random.RandomState(7)
    xs = [(*(rng.uniform(-0.9, 0.9, 3)), 4, 4, 4) for _ in range(16)]
    us = [rng.uniform(-1, 1, 3) for _ in range(16)]
    sp = put_particles(g, xs, us)
    q, m = -1.0, 2.5
    sp2 = P.uncenter_p(sp, fc, g, q, m)
    sp3 = P.center_p(sp2, fc, g, q, m)
    np.testing.assert_allclose(np.asarray(sp3.ux), np.asarray(sp.ux),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(sp3.uy), np.asarray(sp.uy),
                               rtol=2e-5, atol=2e-6)
    # energy_p of centered-at-t momenta from uncentered state matches direct
    en = float(P.energy_p(sp2, fc, g, q, m))
    gam = np.sqrt(1 + np.sum(np.asarray(us, np.float64) ** 2, axis=1))
    expect = (m * (gam - 1)).sum()
    assert abs(en - expect) / expect < 1e-3


def test_sort_p_groups_by_voxel():
    g = simple_grid(n=4, dt=0.01)
    rng = np.random.RandomState(8)
    xs, us = [], []
    for _ in range(50):
        xs.append((0.0, 0.0, 0.0, rng.randint(1, 5), rng.randint(1, 5),
                   rng.randint(1, 5)))
        us.append((0, 0, 0))
    sp = put_particles(g, xs, us, cap=64)
    sp2 = P.sort_p(sp)
    keys = np.asarray(sp2.i)[np.asarray(sp2.live)]
    assert (np.diff(keys) >= 0).all()
    assert int(sp2.np) == 50
    # dead slots sorted to the end
    assert not np.asarray(sp2.live)[50:].any()


def _small_3d_deck(sort_interval, n=600, seed=4):
    import vpic_jax as vt
    sim = vt.Simulation(seed=seed)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, 8, 8, 8)
    sim.define_timestep(0.6 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0), (8, 8, 8))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 1024,
                             sort_interval=sort_interval)
    rng = np.random.default_rng(seed)
    sim.inject_particles(ele, *rng.uniform(0.0, 1.0, (3, n)),
                         *rng.normal(0.0, 0.4, (3, n)), 1.0 / n)
    return sim


@pytest.mark.parametrize("sort_interval", [0, 1, 4])
def test_deck_step_conserves_charge(sort_interval):
    """Deck-level charge conservation over 5 steps of a small 3-D deck:
    the current the step unloads into jf satisfies div J = -d(rho)/dt at
    every node that no periodic face touches, whether or not (and how
    often) the step re-sorts the particles first."""
    sim = _small_3d_deck(sort_interval)
    g = sim.grid
    q = sim.species[0].params.q
    state = sim.initialize()
    adv = jax.jit(sim.make_advance())

    def rho(sp):
        return np.asarray(P.accumulate_rho_p(
            jnp.zeros(g.nv, jnp.float32), sp, g, q)).reshape(g.shape)

    for _ in range(5):
        rho0 = rho(state.species[0])
        state = adv(state)
        rho1 = rho(state.species[0])
        f = state.fields
        jfx, jfy, jfz = (np.asarray(a) for a in (f.jfx, f.jfy, f.jfz))
        s, m = slice(2, -1), slice(1, -2)       # nodes 2..n, and minus one
        div = ((jfx[s, s, s] - jfx[s, s, m]) * g.rdx
               + (jfy[s, s, s] - jfy[s, m, s]) * g.rdy
               + (jfz[s, s, s] - jfz[m, s, s]) * g.rdz)
        rhs = -(rho1 - rho0)[s, s, s] / g.dt
        # f32 rho0/rho1 carry ~1e-7 of |rho| each; over one step |drho|
        # is ~1e-2 of |rho|, so the difference is good to ~1e-5 of its max
        np.testing.assert_allclose(div, rhs, atol=1e-4 * np.abs(rhs).max())
    assert int(state.species[0].np) == 600


def _sort_case(case):
    """A species whose voxel column mixes grid voxels with indices >= 2^23
    (exact in int32, not in f32); ``dead`` kills a third of the lanes and
    gives them distinct voxels."""
    rng = np.random.default_rng({"2d": 1, "3d": 2, "dead": 3}[case])
    g = (partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 1)
         if case == "2d" else simple_grid(n=8))
    cap, n = 512, 400
    vox = rng.integers(0, g.nv, cap).astype(np.int32)
    vox[::7] = (1 << 23) + rng.integers(0, 1 << 24, vox[::7].size)
    live = np.zeros(cap, bool)
    live[:n] = True
    if case == "dead":
        live = rng.random(cap) < 0.66
    cols = rng.normal(0, 1, (7, cap)).astype(np.float32)
    cols[6] = np.abs(cols[6])
    sp = SpeciesState(*(jnp.asarray(c) for c in cols[:3]),
                      i=jnp.asarray(vox), ux=jnp.asarray(cols[3]),
                      uy=jnp.asarray(cols[4]), uz=jnp.asarray(cols[5]),
                      w=jnp.asarray(cols[6]), live=jnp.asarray(live),
                      np=jnp.int32(int(live.sum())))
    return sp


def _rows(sp):
    """Each lane as an exact, hashable row (float bits, voxel, live)."""
    f = np.stack([np.asarray(getattr(sp, k)).view(np.int32) for k in
                  ("dx", "dy", "dz", "ux", "uy", "uz", "w")], 1)
    return sorted(map(tuple, np.column_stack(
        [f, np.asarray(sp.i), np.asarray(sp.live)]).tolist()))


@pytest.mark.parametrize("case", ["2d", "3d", "dead"])
def test_sort_p_is_an_exact_permutation(case):
    """sort_p moves whole rows: the multiset of (fields, voxel, live) rows
    is unchanged bit for bit (voxels >= 2^23 and dead lanes' voxels
    included), the live count is kept, and the live lanes form a prefix
    ordered by voxel."""
    sp = _sort_case(case)
    out = jax.jit(P.sort_p)(sp)
    assert _rows(out) == _rows(sp)
    live = np.asarray(out.live)
    n = int(np.asarray(sp.live).sum())
    assert live[:n].all() and not live[n:].any()
    assert int(out.np) == n
    keys = np.asarray(out.i)[:n]
    assert (np.diff(keys) >= 0).all()


def test_gather_rows_keeps_each_dtype_exact():
    """gather_rows moves int32 (beyond f32's 2^24), bool and f32 columns
    together without rounding any of them."""
    rng = np.random.default_rng(9)
    n = 300
    ints = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64
                        ).astype(np.int32)
    bools = rng.random(n) < 0.5
    floats = rng.normal(0, 1e-38, n).astype(np.float32)   # denormals
    src = rng.permutation(n).astype(np.int32)
    a, b, c = P.gather_rows(jnp.asarray(src), jnp.asarray(ints),
                            jnp.asarray(bools), jnp.asarray(floats))
    np.testing.assert_array_equal(np.asarray(a), ints[src])
    np.testing.assert_array_equal(np.asarray(b), bools[src])
    np.testing.assert_array_equal(np.asarray(c).view(np.int32),
                                  floats[src].view(np.int32))
