"""Emission models (src/emitter/).

The reference builds per-emitter component lists (32*cell + face encodings,
emitter.h:16-29) once at init by scanning deck region predicates
(deck/wrapper.h:310-383) and applies each emitter every step after the push
(advance.cc:58-60).  Here the component list is a pair of static device
arrays (voxel, face) built host-side; emission is a fixed-shape masked
injection: every component emits ``n_emit_per_face`` candidate lanes whose
weights are zeroed when the face is below threshold.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .grid import FACE_AXIS, FACE_SIDE, Grid
from .ops.push import DONE, deposit_rhob, streak_walk
from .state import SpeciesParams, SpeciesState

CHILD_LANGMUIR_NORM = 4.0 * math.sqrt(2.0) / 9.0  # Child law prefactor


def _region_inside(g: Grid, region: Callable, shard):
    """Rasterize the region predicate over the shard's ghosted brick (cell
    centers in GLOBAL coordinates -- deck/wrapper.h:310-383 region scans run
    per MPI rank with each rank's own offsets).  Ghost cells at shard seams
    take their true region value (so surfaces crossing a seam are not
    spuriously detected); ghost cells beyond the GLOBAL domain are outside
    (beyond-domain faces count as surface)."""
    x0 = g.x0 + shard[0] * g.nx * g.dx
    y0 = g.y0 + shard[1] * g.ny * g.dy
    z0 = g.z0 + shard[2] * g.nz * g.dz
    xc = x0 + g.dx * (np.arange(g.NX) - 0.5)
    yc = y0 + g.dy * (np.arange(g.NY) - 0.5)
    zc = z0 + g.dz * (np.arange(g.NZ) - 0.5)
    Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
    inside = np.vectorize(region, otypes=[bool])(X, Y, Z)
    for ax, (n, gn, off) in enumerate((
            (g.NX, g.gnx, shard[0] * g.nx),
            (g.NY, g.gny, shard[1] * g.ny),
            (g.NZ, g.gnz, shard[2] * g.nz))):
        gi = off + np.arange(n) - 1          # global cell id per local index
        edge = (gi < 0) | (gi >= gn)
        sl = [slice(None)] * 3
        sl[2 - ax] = edge                    # inside is [z, y, x]-ordered
        inside[tuple(sl)] = False
    return inside


def _shard_iter(g: Grid):
    px, py, pz = g.topology
    for sx in range(px):
        for sy in range(py):
            for sz in range(pz):
                yield (sx, sy, sz)


def _pack_sharded(g: Grid, per_shard):
    """Pad per-shard (vox, face) lists to a common length and stack with
    leading topology dims; returns (vox, face, valid) for axis_index
    slicing inside the jitted step (the set_region_material pattern)."""
    M = max(1, max(len(v) for v, _ in per_shard))
    px, py, pz = g.topology
    vox = np.zeros((px, py, pz, M), np.int32)
    fac = np.zeros((px, py, pz, M), np.int32)
    val = np.zeros((px, py, pz, M), bool)
    for (sx, sy, sz), (v, f) in zip(_shard_iter(g), per_shard):
        vox[sx, sy, sz, :len(v)] = v
        fac[sx, sy, sz, :len(f)] = f
        val[sx, sy, sz, :len(v)] = True
    return vox, fac, val


def _surface_scan(g: Grid, region: Callable, shard):
    inside = _region_inside(g, region, shard)
    vox, faces = [], []
    offs = {0: (0, 0, -1), 1: (0, -1, 0), 2: (-1, 0, 0),
            3: (0, 0, 1), 4: (0, 1, 0), 5: (1, 0, 0)}  # [dz,dy,dx] per face
    interior = inside.copy()
    interior[0, :, :] = interior[-1, :, :] = False
    interior[:, 0, :] = interior[:, -1, :] = False
    interior[:, :, 0] = interior[:, :, -1] = False
    idx = np.argwhere(interior)
    for (z, y, x) in idx:
        for f, (dz, dy, dx) in offs.items():
            if not inside[z + dz, y + dy, x + dx]:
                vox.append(int(x + g.NX * (y + g.NY * z)))
                faces.append(f)
    return (np.asarray(vox, np.int32), np.asarray(faces, np.int32))


def surface_components(g: Grid, region: Callable, shard=None):
    """Scan the region predicate over cell centers and return the (voxel,
    face) components of its surface: faces of inside-cells whose neighbor
    is outside or beyond the global domain (define_surface_emitter
    semantics).  On a decomposed grid (shard=None, g.sharded) every shard
    is rasterized with its own global offsets and the lists are padded /
    stacked with leading topology dims plus a validity mask; pass an
    explicit shard tuple to scan one brick."""
    if shard is not None:
        return _surface_scan(g, region, shard)
    if not g.sharded:
        return _surface_scan(g, region, (0, 0, 0))
    return _pack_sharded(g, [_surface_scan(g, region, s)
                             for s in _shard_iter(g)])


def child_langmuir(sp_idx: int, spp: SpeciesParams, components,
                   n_emit_per_face: int = 1, ut_para: float = 0.0,
                   ut_perp: float = 0.0, thresh_e_norm: float = 0.0,
                   norm: float = CHILD_LANGMUIR_NORM, max_streak: int = 4):
    """child_langmuir (child_langmuir.c:8-211): space-charge-limited (Child
    law) surface emission.  Per eligible face, emit n_emit_per_face macro
    particles with weight w = norm_axis sqrt(|E_n|^3), half-Maxwellian
    parallel momentum, random subcell position, random age (partial push
    through the streak walk), and -q rhob bookkeeping."""
    sharded = len(components) == 3
    if sharded:
        vox_np, face_np, val_np = components
        total = int(val_np.sum())
    else:
        vox_np, face_np = components
        val_np = None
        total = vox_np.shape[-1]
    nc = vox_np.shape[-1]
    if total == 0:
        return lambda species, f, fcoef, acc, rhob, g, step, rng: \
            (species, acc, rhob, rng)
    rep = lambda a: np.repeat(a, n_emit_per_face, axis=-1)
    vox_r, face_r = rep(vox_np), rep(face_np)
    val_r = rep(val_np) if sharded else None
    M = nc * n_emit_per_face

    def op(species, f, fcoef, acc, rhob, g: Grid, step, rng):
        species = list(species)
        sp = species[sp_idx]
        if sharded:
            # slice this shard's component list (leading topology dims,
            # the set_region_material pattern) and decorrelate the per-
            # shard emission RNG streams
            from .grid import flat_rank
            idx = tuple(jax.lax.axis_index(a) for a in g.mesh_axes)
            vox_c = jnp.asarray(vox_r)[idx]
            face_c = jnp.asarray(face_r)[idx]
            valid = jnp.asarray(val_r)[idx]
            rng = jax.random.fold_in(rng, flat_rank(g))
        else:
            vox_c, face_c, valid = jnp.asarray(vox_r), jnp.asarray(face_r), \
                None
        key = jax.random.fold_in(rng, step)
        k1, k2, k3, k4, k5, k6, rng2 = jax.random.split(key, 7)

        axis = _face_axis_arr()[face_c]
        side = jnp.asarray(FACE_SIDE, jnp.int32)[face_c]
        # Emission direction: inward normal (low faces emit +, high faces -).
        dirn = jnp.where(side < 0, 1.0, -1.0)
        e_col = jnp.asarray([0, 4, 8], jnp.int32)  # ex, ey, ez coeff col
        e_n = fcoef[vox_c, e_col[axis]]
        eligible = dirn * spp.q * e_n > abs(spp.q) * thresh_e_norm
        if valid is not None:
            eligible = eligible & valid

        qsp = spp.q
        pref = (norm * g.eps0 * g.dt) / (math.sqrt(abs(qsp * spp.m))
                                         * n_emit_per_face)
        norm_ax = jnp.asarray([
            pref * math.sqrt(g.rdx) * g.dy * g.dz,
            pref * math.sqrt(g.rdy) * g.dz * g.dx,
            pref * math.sqrt(g.rdz) * g.dx * g.dy], jnp.float32)[axis]
        w = jnp.where(eligible,
                      norm_ax * jnp.sqrt(jnp.abs(e_n) ** 3), 0.0)

        # Momenta: half-Maxwellian parallel + thermal perpendicular.
        u_par = dirn * ut_para * jnp.sqrt(
            2.0 * -jnp.log(jnp.maximum(jax.random.uniform(k1, (M,)), 1e-37)))
        u_p1 = ut_perp * jax.random.normal(k2, (M,))
        u_p2 = ut_perp * jax.random.normal(k3, (M,))
        uxyz = [None, None, None]
        for a in range(3):
            uxyz[a] = jnp.where(axis == a, u_par,
                                jnp.where((axis + 1) % 3 == a, u_p1, u_p2))

        # Positions: on the emitting face, random transverse offsets.
        r1 = 2.0 * jax.random.uniform(k4, (M,)) - 1.0
        r2 = 2.0 * jax.random.uniform(k5, (M,)) - 1.0
        pxyz = [None, None, None]
        for a in range(3):
            pxyz[a] = jnp.where(axis == a, -dirn,
                                jnp.where((axis + 1) % 3 == a, r1, r2))

        # Insert into dead slots WITHOUT reordering live lanes (slot order
        # must stay aligned with any pend/disp arrays the caller holds).
        free = jnp.nonzero(~sp.live, size=M, fill_value=sp.capacity)[0]
        rank = jnp.cumsum(eligible.astype(jnp.int32)) - 1
        slot = jnp.where(eligible, free[jnp.clip(rank, 0, M - 1)],
                         sp.capacity)
        n_new = jnp.minimum(jnp.sum(eligible.astype(jnp.int32)),
                            sp.capacity - sp.np)

        ins = lambda a, v: a.at[slot].set(v, mode="drop")
        live = ins(sp.live, eligible)
        sp = sp.replace(dx=ins(sp.dx, pxyz[0]), dy=ins(sp.dy, pxyz[1]),
                        dz=ins(sp.dz, pxyz[2]), i=ins(sp.i, vox_c),
                        ux=ins(sp.ux, uxyz[0]), uy=ins(sp.uy, uxyz[1]),
                        uz=ins(sp.uz, uxyz[2]), w=ins(sp.w, w),
                        live=live, np=sp.np + n_new)
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            -qsp, ins(jnp.zeros((sp.capacity,), bool),
                                      eligible))

        # Random age: partial push of the new particles (streak walk).
        gam = jnp.sqrt(1.0 + uxyz[0] ** 2 + uxyz[1] ** 2 + uxyz[2] ** 2)
        age = jax.random.uniform(k6, (M,)) * g.cvac * g.dt / gam
        dnew = [uxyz[a] * age * (g.rdx, g.rdy, g.rdz)[a] for a in range(3)]
        zeros = jnp.zeros((sp.capacity,), jnp.float32)
        disp = tuple(ins(zeros, dnew[a]) for a in range(3))
        newmask = ins(jnp.zeros((sp.capacity,), bool), eligible)
        pend = jnp.full((sp.capacity,), DONE, jnp.int32)
        zi, r = jnp.divmod(sp.i, g.sz)
        yi, xi = jnp.divmod(r, g.sy)
        (pos, disp, coords, u, alive, pend, acc, rhob) = streak_walk(
            g, qsp, sp.w, (sp.dx, sp.dy, sp.dz), disp, (xi, yi, zi),
            (sp.ux, sp.uy, sp.uz), newmask & sp.live, sp.live, pend, acc,
            rhob, max_streak)
        vox2 = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
        sp = sp.replace(dx=pos[0], dy=pos[1], dz=pos[2], i=vox2,
                        ux=u[0], uy=u[1], uz=u[2],
                        w=jnp.where(alive, sp.w, 0.0), live=alive,
                        np=jnp.sum(alive.astype(jnp.int32)))
        species[sp_idx] = sp
        return species, acc, rhob, rng2

    return op


def _face_axis_arr():
    # NOT a module-level jnp constant: that would initialize the JAX
    # backend at import time and bake the array onto one platform.
    return jnp.asarray(FACE_AXIS, jnp.int32)


def _volume_scan(g: Grid, region: Callable, shard):
    inside = _region_inside(g, region, shard)
    inside[0, :, :] = inside[-1, :, :] = False
    inside[:, 0, :] = inside[:, -1, :] = False
    inside[:, :, 0] = inside[:, :, -1] = False
    idx = np.argwhere(inside)
    vox, faces = [], []
    for (z, y, x) in idx:
        for f in range(6):
            vox.append(int(x + g.NX * (y + g.NY * z)))
            faces.append(f)
    return (np.asarray(vox, np.int32), np.asarray(faces, np.int32))


def volume_components(g: Grid, region: Callable, shard=None):
    """define_volume_emitter scan (deck/wrapper.h:310-383): every face of
    every cell inside the region is an emission component.  Sharded like
    surface_components."""
    if shard is not None:
        return _volume_scan(g, region, shard)
    if not g.sharded:
        return _volume_scan(g, region, (0, 0, 0))
    return _pack_sharded(g, [_volume_scan(g, region, s)
                             for s in _shard_iter(g)])


def runtime_inject(sp: SpeciesState, g: Grid, acc, rhob, key,
                   x, y, z, ux, uy, uz, w, qsp, age=None,
                   update_rhob: bool = False, max_streak: int = 4):
    """Device-side inject_particle (misc.cc:16-100) for
    user_particle_injection hooks: global coordinates -> (voxel, offset)
    conversion, optional rhob bookkeeping and "aged" partial push through
    the streak walk.  All arguments are fixed-size arrays; lanes with w < 0
    are skipped (the static-shape analogue of conditional injection).

    Returns (species, acc, rhob).  The coordinate -> (voxel, offset)
    conversion runs in DOUBLE-F32 (error-free TwoSum/TwoProd expansions,
    ~2^-45 relative) so it matches the reference's f64 staging
    (misc.cc:16-100) for any f32 input: a plain f32 conversion misplaces
    particles by a whole voxel near cell boundaries once n >~ 4096
    (absolute error ~n*2^-24 cells)."""
    M = x.shape[0]
    valid = w >= 0

    def _split(a):
        # Dekker 12/12-bit split of an f32 (exact under IEEE +,*)
        c = a * jnp.float32(4097.0)
        hi = c - (c - a)
        return hi, a - hi

    def conv(v, v0, v1, n):
        import numpy as _np
        rn = float(n) / (float(v1) - float(v0))     # trace-time f64
        rh = _np.float32(rn)
        rl = _np.float32(rn - float(rh))
        vh = _np.float32(v0)
        vl = _np.float32(float(v0) - float(vh))
        # d = v - v0 as (d, de): Knuth TwoSum of (v, -vh), minus vl
        s = v - vh
        b2 = s - v
        de = (v - (s - b2)) + (-vh - b2) - vl
        # s*rn as (p, pl): Dekker TwoProd + cross terms
        p = s * rh
        ah, al = _split(s)
        bh, bl = _split(rh)
        pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
        pl = pe + s * rl + de * rh
        iv = jnp.floor(p)
        r = (p - iv) + pl                 # p - floor(p) is exact
        rf = jnp.floor(r)                 # in {-1, 0, 1}
        iv = (iv + rf).astype(jnp.int32)
        frac = r - rf
        # domain-edge landing (misc.cc iv == n): offset 1.0 in cell n-1
        frac = jnp.where(iv >= n, 1.0, jnp.where(iv < 0, 0.0, frac))
        iv = jnp.clip(iv, 0, n - 1)
        return 2.0 * frac - 1.0, iv + 1

    dx, ix = conv(x, g.x0, g.x1, g.gnx)
    dy, iy = conv(y, g.y0, g.y1, g.gny)
    dz, iz = conv(z, g.z0, g.z1, g.gnz)
    vox = ix + g.NX * (iy + g.NY * iz)

    # Dead-slot insertion (no live-lane reordering; see child_langmuir).
    free = jnp.nonzero(~sp.live, size=M, fill_value=sp.capacity)[0]
    rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
    slot = jnp.where(valid, free[jnp.clip(rank, 0, M - 1)], sp.capacity)
    n_new = jnp.minimum(jnp.sum(valid.astype(jnp.int32)),
                        sp.capacity - sp.np)
    ins = lambda a, v: a.at[slot].set(v, mode="drop")
    sp = sp.replace(dx=ins(sp.dx, dx), dy=ins(sp.dy, dy), dz=ins(sp.dz, dz),
                    i=ins(sp.i, vox), ux=ins(sp.ux, ux), uy=ins(sp.uy, uy),
                    uz=ins(sp.uz, uz), w=ins(sp.w, jnp.maximum(w, 0.0)),
                    live=ins(sp.live, valid), np=sp.np + n_new)
    newmask = ins(jnp.zeros((sp.capacity,), bool), valid)
    if update_rhob:
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            -qsp, newmask)
    if age is not None:
        gam = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
        aged = age * g.cvac * g.dt / gam
        zeros = jnp.zeros((sp.capacity,), jnp.float32)
        disp = (ins(zeros, ux * aged * g.rdx),
                ins(zeros, uy * aged * g.rdy),
                ins(zeros, uz * aged * g.rdz))
        pend = jnp.full((sp.capacity,), DONE, jnp.int32)
        zi, r = jnp.divmod(sp.i, g.sz)
        yi, xi = jnp.divmod(r, g.sy)
        (pos, disp, coords, u, alive, pend, acc, rhob) = streak_walk(
            g, qsp, sp.w, (sp.dx, sp.dy, sp.dz), disp, (xi, yi, zi),
            (sp.ux, sp.uy, sp.uz), newmask & sp.live, sp.live, pend, acc,
            rhob, max_streak)
        vox2 = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
        sp = sp.replace(dx=pos[0], dy=pos[1], dz=pos[2], i=vox2,
                        ux=u[0], uy=u[1], uz=u[2],
                        w=jnp.where(alive, sp.w, 0.0), live=alive,
                        np=jnp.sum(alive.astype(jnp.int32)))
    return sp, acc, rhob
