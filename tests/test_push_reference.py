"""One VPIC particle push against an independent float64 numpy reference.

The reference below is written straight from the reference code's scalar
loops -- interpolator_array_pipeline.cc (coefficient table),
advance_p_pipeline.cc (field gather, relativistic Boris push with the
tan(theta/2) expansion, half displacement), move_p.cc (the streak walk with
its quarter-face ACCUMULATE_J deposit) and rho_p.cc (boundary-corrected
rhob deposit of absorbed particles) -- one particle at a time in Python
floats.  It shares no code with ``ops/push.py`` or ``ops/interp.py``; the
test compares ``ops.push.advance_p`` (f32, all lanes at once) with it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vpic_jax.grid import (ABSORB_PARTICLES, REFLECT_PARTICLES,
                           partition_periodic_box)
from vpic_jax.ops import interp as I
from vpic_jax.ops import push as P
from vpic_jax.state import FieldState, SpeciesState

# f32 kernel against an f64 reference: every quantity is O(1) and passes
# through a few dozen roundings at 2^-24, so 1e-5 absolute / relative is
# ~100x the expected error and still far below any physics effect.
TOL = 1e-5


def _grid(dim, bc):
    n = (6, 5, 1) if dim == 2 else (5, 4, 3)
    g = partition_periodic_box(0, 0, 0, 1.0 * n[0], 1.0 * n[1], 1.0 * n[2],
                               *n)
    g = dataclasses.replace(g, dt=0.45)
    if bc != "periodic":
        code = REFLECT_PARTICLES if bc == "reflect" else ABSORB_PARTICLES
        g = g.with_bc(0, pbc=code).with_bc(3, pbc=code)
    return g


def _fields(g, rng):
    shp = g.shape
    f = FieldState.zeros(g)
    return f.replace(**{k: jnp.asarray(rng.normal(0, s, shp), jnp.float32)
                        for k, s in (("ex", 0.2), ("ey", 0.2), ("ez", 0.2),
                                     ("cbx", 0.6), ("cby", 0.6),
                                     ("cbz", 0.6))})


def _particles(g, rng, n, cap):
    """n live lanes in a cap-wide species; a third start in the x boundary
    cells heading outward so the wall BCs fire."""
    ix = rng.integers(1, g.nx + 1, n)
    edge = np.arange(n) % 3 == 0
    ix[edge] = np.where(rng.random(edge.sum()) < 0.5, 1, g.nx)
    iy = rng.integers(1, g.ny + 1, n)
    iz = rng.integers(1, g.nz + 1, n)
    off = rng.uniform(-0.95, 0.95, (n, 3))
    u = rng.normal(0, 0.6, (n, 3))
    u[edge, 0] = np.where(ix[edge] == 1, -1.0, 1.0) * (0.5 + np.abs(
        u[edge, 0]))
    w = rng.uniform(0.5, 1.5, n)

    def col(a, dtype=np.float32):
        out = np.zeros(cap, dtype)
        out[:n] = a
        return jnp.asarray(out)

    vox = ix + g.NX * (iy + g.NY * iz)
    return SpeciesState(
        dx=col(off[:, 0]), dy=col(off[:, 1]), dz=col(off[:, 2]),
        i=col(vox, np.int32), ux=col(u[:, 0]), uy=col(u[:, 1]),
        uz=col(u[:, 2]), w=col(w), live=col(np.ones(n, bool), bool),
        np=jnp.int32(n))


# ------------------------------------------------------------------ reference

def ref_interpolator(f, g):
    """interpolator_array_pipeline.cc: per-voxel coefficients (dict of
    (NZ, NY, NX) float64 arrays, interior voxels filled)."""
    A = {k: np.asarray(getattr(f, k), np.float64)
         for k in ("ex", "ey", "ez", "cbx", "cby", "cbz")}
    out = {}
    nz, ny, nx = g.nz, g.ny, g.nx

    def at(a, sx, sy, sz):
        return a[1 + sz:nz + 1 + sz, 1 + sy:ny + 1 + sy, 1 + sx:nx + 1 + sx]

    def quad(a, d1, d2, names):
        s1 = [0, 0, 0]
        s1[d1] = 1
        s2 = [0, 0, 0]
        s2[d2] = 1
        s3 = [s1[k] + s2[k] for k in range(3)]
        w0, w1, w2, w3 = at(a, 0, 0, 0), at(a, *s1), at(a, *s2), at(a, *s3)
        vals = (0.25 * ((w3 + w0) + (w1 + w2)),
                0.25 * ((w3 - w0) + (w1 - w2)),
                0.25 * ((w3 - w0) - (w1 - w2)),
                0.25 * ((w3 + w0) - (w1 + w2)))
        out.update(zip(names, vals))

    quad(A["ex"], 1, 2, ("ex", "dexdy", "dexdz", "d2exdydz"))
    quad(A["ey"], 2, 0, ("ey", "deydz", "deydx", "d2eydzdx"))
    quad(A["ez"], 0, 1, ("ez", "dezdx", "dezdy", "d2ezdxdy"))
    for name, d in (("cbx", 0), ("cby", 1), ("cbz", 2)):
        s = [0, 0, 0]
        s[d] = 1
        w0, w1 = at(A[name], 0, 0, 0), at(A[name], *s)
        out[name] = 0.5 * (w1 + w0)
        out["d" + name + "d" + "xyz"[d]] = 0.5 * (w1 - w0)
    return out


def ref_push(g, tab, sp, q, m, acc, rhob):
    """advance_p + move_p for every live lane, one at a time (float64).
    acc is (nv, 12), rhob (nv,); both are updated in place."""
    qdt_2mc = q * g.dt / (2 * m * g.cvac)
    cdt_d = (g.cvac * g.dt * g.rdx, g.cvac * g.dt * g.rdy,
             g.cvac * g.dt * g.rdz)
    n_ax = (g.nx, g.ny, g.nz)
    strides = (1, g.NX, g.NX * g.NY)
    cols = {k: np.asarray(getattr(sp, k), np.float64)
            for k in ("dx", "dy", "dz", "ux", "uy", "uz", "w")}
    vox = np.asarray(sp.i).astype(np.int64)
    live = np.asarray(sp.live).copy()
    out = {k: v.copy() for k, v in cols.items()}
    out_i = vox.copy()
    for p in np.nonzero(live)[0]:
        v = int(vox[p])
        z, r = divmod(v, strides[2])
        y, x = divmod(r, strides[1])
        c = {k: tab[k][z - 1, y - 1, x - 1] for k in tab}
        dx, dy, dz = cols["dx"][p], cols["dy"][p], cols["dz"][p]
        hax = qdt_2mc * ((c["ex"] + dy * c["dexdy"])
                         + dz * (c["dexdz"] + dy * c["d2exdydz"]))
        hay = qdt_2mc * ((c["ey"] + dz * c["deydz"])
                         + dx * (c["deydx"] + dz * c["d2eydzdx"]))
        haz = qdt_2mc * ((c["ez"] + dx * c["dezdx"])
                         + dy * (c["dezdy"] + dx * c["d2ezdxdy"]))
        cbx = c["cbx"] + dx * c["dcbxdx"]
        cby = c["cby"] + dy * c["dcbydy"]
        cbz = c["cbz"] + dz * c["dcbzdz"]
        ux = cols["ux"][p] + hax
        uy = cols["uy"][p] + hay
        uz = cols["uz"][p] + haz
        v0 = qdt_2mc / np.sqrt(1 + ux * ux + uy * uy + uz * uz)
        v1 = cbx * cbx + cby * cby + cbz * cbz
        v2 = v0 * v0 * v1
        v3 = v0 * (1 + v2 * (1 / 3 + v2 * (2 / 15)))
        v4 = 2 * v3 / (1 + v1 * v3 * v3)
        w0 = ux + v3 * (uy * cbz - uz * cby)
        w1 = uy + v3 * (uz * cbx - ux * cbz)
        w2 = uz + v3 * (ux * cby - uy * cbx)
        ux += v4 * (w1 * cbz - w2 * cby)
        uy += v4 * (w2 * cbx - w0 * cbz)
        uz += v4 * (w0 * cby - w1 * cbx)
        ux += hax
        uy += hay
        uz += haz
        rg = 1 / np.sqrt(1 + ux * ux + uy * uy + uz * uz)
        u = [ux, uy, uz]
        disp = [u[a] * cdt_d[a] * rg for a in range(3)]
        pos = [dx, dy, dz]
        coord = [x, y, z]
        qw = q * cols["w"][p]
        alive = True
        for _ in range(16):              # move_p.cc:216-353
            sdir = [1.0 if d > 0 else -1.0 for d in disp]
            t = [3.4e38 if disp[a] == 0 else (sdir[a] - pos[a]) / disp[a]
                 for a in range(3)]
            axis, v3 = 3, 2.0
            for a in range(3):
                if t[a] < v3:
                    axis, v3 = a, t[a]
            frac = 0.5 * v3
            s = [d * frac for d in disp]
            mid = [pos[a] + s[a] for a in range(3)]
            v5 = qw * s[0] * s[1] * s[2] / 3
            base = coord[0] + g.NX * (coord[1] + g.NY * coord[2])
            for k, (X, Y, Z) in enumerate(((0, 1, 2), (1, 2, 0), (2, 0, 1))):
                qu = qw * s[X]
                acc[base, 4 * k + 0] += qu * (1 - mid[Y]) * (1 - mid[Z]) + v5
                acc[base, 4 * k + 1] += qu * (1 + mid[Y]) * (1 - mid[Z]) - v5
                acc[base, 4 * k + 2] += qu * (1 - mid[Y]) * (1 + mid[Z]) - v5
                acc[base, 4 * k + 3] += qu * (1 + mid[Y]) * (1 + mid[Z]) + v5
            for a in range(3):
                disp[a] -= s[a]
                pos[a] += 2 * s[a]
            if axis == 3:
                break
            pos[axis] = sdir[axis]      # exactly on the face
            new = coord[axis] + int(sdir[axis])
            if 1 <= new <= n_ax[axis]:
                coord[axis] = new
                pos[axis] = -sdir[axis]
                continue
            bc = g.axis_bc(axis, int(sdir[axis]), particles=True)
            if bc == REFLECT_PARTICLES:
                u[axis] = -u[axis]
                disp[axis] = -disp[axis]
            elif bc == ABSORB_PARTICLES:
                ref_rhob(g, rhob, coord, pos, q * cols["w"][p])
                alive = False
                break
            else:                           # periodic
                coord[axis] = n_ax[axis] if new < 1 else 1
                pos[axis] = -sdir[axis]
        else:
            raise AssertionError("reference walk did not terminate")
        live[p] = alive
        out["dx"][p], out["dy"][p], out["dz"][p] = pos
        out["ux"][p], out["uy"][p], out["uz"][p] = u
        out_i[p] = coord[0] + g.NX * (coord[1] + g.NY * coord[2])
        if not alive:
            out["w"][p] = 0.0
    return out, out_i, live


def ref_rhob(g, rhob, coord, pos, qw):
    """accumulate_rhob (rho_p.cc:126-211): trilinear node weights, doubled
    on nodes that sit on the domain edge."""
    x, y, z = coord
    for k in range(8):
        sx, sy, sz = k & 1, (k >> 1) & 1, (k >> 2) & 1
        wgt = qw * g.r8V
        for s, d in ((sx, pos[0]), (sy, pos[1]), (sz, pos[2])):
            wgt *= (1 + d) if s else (1 - d)
        for s, c, n in ((sx, x, g.nx), (sy, y, g.ny), (sz, z, g.nz)):
            if (s == 0 and c == 1) or (s == 1 and c == n):
                wgt *= 2
        node = (x + sx) + g.NX * ((y + sy) + g.NY * (z + sz))
        rhob[node] += wgt


# ----------------------------------------------------------------------- test

@pytest.mark.parametrize("nspecies", [1, 2])
@pytest.mark.parametrize("bc", ["periodic", "reflect", "absorb"])
@pytest.mark.parametrize("dim", [2, 3])
def test_advance_p_matches_numpy_reference(dim, bc, nspecies):
    rng = np.random.default_rng(100 * dim + 10 * nspecies + len(bc))
    g = _grid(dim, bc)
    f = _fields(g, rng)
    qm = [(-1.0, 1.0), (1.0, 4.0)][:nspecies]
    sps = [_particles(g, rng, 40, 48) for _ in qm]

    fcoef = I.load_interpolator(f, g)
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    rhob = jnp.zeros((g.nv,), jnp.float32)
    got = []
    for sp, (q, m) in zip(sps, qm):
        res = P.advance_p(sp, fcoef, g, q, m, acc, rhob)
        assert int(res.n_pend) == 0
        assert not np.any(np.asarray(res.pend_face) == P.UNFINISHED)
        acc, rhob = res.acc, res.rhob_flat
        got.append(res.species)

    tab = ref_interpolator(f, g)
    np.testing.assert_allclose(
        np.asarray(fcoef).reshape(g.NZ, g.NY, g.NX, 18)[1:-1, 1:-1, 1:-1],
        np.stack([tab[k] for k in (
            "ex", "dexdy", "dexdz", "d2exdydz", "ey", "deydz", "deydx",
            "d2eydzdx", "ez", "dezdx", "dezdy", "d2ezdxdy", "cbx", "dcbxdx",
            "cby", "dcbydy", "cbz", "dcbzdz")], -1), rtol=TOL, atol=TOL)
    acc_r = np.zeros((g.nv, 12))
    rhob_r = np.zeros(g.nv)
    n_dead = 0
    for sp, new, (q, m) in zip(sps, got, qm):
        out, out_i, live = ref_push(g, tab, sp, q, m, acc_r, rhob_r)
        np.testing.assert_array_equal(np.asarray(new.live), live)
        np.testing.assert_array_equal(np.asarray(new.i)[live], out_i[live])
        assert int(new.np) == int(live.sum())
        n_dead += int(np.asarray(sp.live).sum() - live.sum())
        for k in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
            np.testing.assert_allclose(np.asarray(getattr(new, k))[live],
                                       out[k][live], rtol=TOL, atol=TOL,
                                       err_msg=k)
    if bc == "absorb":
        assert n_dead > 0, "no lane reached the absorbing wall"
    scale = np.abs(acc_r).max()
    np.testing.assert_allclose(np.asarray(acc), acc_r, atol=TOL * scale)
    np.testing.assert_allclose(np.asarray(rhob), rhob_r,
                               atol=TOL * max(np.abs(rhob_r).max(), 1.0))
