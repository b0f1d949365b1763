"""Particle engine: fused interpolate -> Boris push -> current deposition.

Re-design of src/species_advance/standard/:

* ``advance_p`` <- advance_p_pipeline.cc:20-237 + move_p.cc:216-353, fused
  into ONE vectorized kernel.  The reference splits the common in-bounds case
  (inline ACCUMULATE_J) from the rare voxel-crossing case (a mover work-list
  consumed by a scalar streak walk).  Work-lists are hostile to SIMT/XLA, so
  here EVERY particle runs the same bounded streak walk: an in-bounds particle
  terminates on the first sub-streak and deposits exactly the inline-path
  currents (the walk's fractional-length math reduces to frac=1), while
  crossers take up to MAX_STREAK masked sub-streaks, reproducing move_p's
  reflection / periodic-wrap / absorb / remote-face semantics as masked lanes.
* Current deposition (the reference's per-thread accumulator replicas +
  deterministic tree reduction, sf_interface.h:107-158) becomes one
  scatter-add into a single (nv, 12) quarter-face accumulator.  On a GPU it
  lowers to f32 atomics, so the summation order (and the last bits of the
  currents) can differ from run to run.
* ``center_p`` / ``uncenter_p`` <- center_p_pipeline.cc / uncenter_p_pipeline.cc
* ``energy_p``  <- energy_p_pipeline.cc:17-68
* ``rho_p``     <- rho_p.cc:22-112 (accumulate_rho_p) and :125-211
  (accumulate_rhob with boundary-corrected weights)
* ``sort_p``    <- sort_p_pipeline.c, as a stable argsort by voxel key.

All arithmetic is f32 like the reference (momenta, fields, weights); the
relativistic Boris rotation uses the same 2nd-order tan(theta/2) Pade/Taylor
expansion (advance_p_pipeline.cc:117-132).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..grid import (ABSORB_PARTICLES, FIRST_CUSTOM_PBC, P_PERIODIC, P_REMOTE,
                    REFLECT_PARTICLES, Grid)
from ..state import SpeciesState

ONE_THIRD = 1.0 / 3.0
TWO_FIFTEENTHS = 2.0 / 15.0
BIG = 3.4e38

# pend_face codes produced by the walk for particles that could not finish
# locally: -1 = finished locally, 0..5 = left through that face toward a
# neighboring shard (migrated by boundary_p), 6 = ran out of streak
# iterations, 8..13 = hit a custom particle BC on face (code - 8)
# (dispatched to the registered handler by boundary_p).
DONE = -1
UNFINISHED = 6
CUSTOM_BASE = 8


def _div_magic(d: int, bound: int):
    """(M, k) with i // d == (i * M) >> k exactly for 0 <= i <= bound,
    all arithmetic in int32 (Granlund-Montgomery), or None if no such
    magic exists in 31 bits."""
    k = 1
    while ((1 << (k + 1)) // d + 1) * bound < (1 << 31):
        k += 1
    M = (1 << k) // d + 1
    e = M * d - (1 << k)
    if 0 < e and bound * e < (1 << k):
        return M, k
    return None


def div_const(i, d: int, bound: int):
    """Exact ``i // d`` for int32 i in [0, bound] via multiply-shift
    (Granlund-Montgomery): two integer ops instead of the generic integer
    divide on the voxel-decode paths.  Large d (no 31-bit magic) is split
    into exact chained divides: i//(d1*d2) == (i//d1)//d2."""
    d = int(d)
    if d & (d - 1) == 0:
        return jax.lax.shift_right_logical(i, d.bit_length() - 1)
    mk = _div_magic(d, bound)
    if mk is not None:
        M, k = mk
        return jax.lax.shift_right_logical(i * jnp.int32(M), k)
    # Chain: peel the largest factor d1 of d that has a magic at this
    # bound; the quotient's bound shrinks by d1, so the recursion
    # terminates (any factor >= 2 works eventually).
    for d1 in sorted(_factors(d), reverse=True):
        if d1 != d and d1 != 1 and _div_magic(d1, bound) is not None:
            return div_const(div_const(i, d1, bound), d // d1, bound // d1)
    return i // d  # no integer factor splits it: generic (slow) lowering


def _factors(d: int):
    fs = set()
    f = 1
    while f * f <= d:
        if d % f == 0:
            fs.add(f)
            fs.add(d // f)
        f += 1
    return fs


def divmod_const(i, d: int, bound: int):
    q = div_const(i, d, bound)
    return q, i - q * jnp.int32(int(d))


def mod_wrap1(i, n: int, bound: int):
    """(i - 1) % n + 1 for i in [1 - bound, bound] (periodic coordinate
    wrap into 1..n) without the slow generic int modulo."""
    k = (bound + n - 1) // n + 1
    shifted = i - 1 + jnp.int32(k * n)
    q = div_const(shifted, n, bound + k * n)
    return shifted - q * jnp.int32(n) + 1


def invert_perm(dest):
    """Inverse of a permutation given as dest[i] = output slot of input i.
    One 1-column scatter -- the only scatter a row permutation needs."""
    return jnp.zeros_like(dest).at[dest].set(
        jax.lax.iota(jnp.int32, dest.shape[0]))


def gather_rows(src, *arrays):
    """Permute same-length 1-d arrays by per-OUTPUT-slot source index:
    ``out[j] = a[src[j]]`` for every array.  Columns of one dtype ride one
    (N, k) row gather; each dtype keeps its own, so integer and boolean
    columns move exactly."""
    groups = {}
    for c, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(c)
    out = [None] * len(arrays)
    for dt, cols in groups.items():
        mat = jnp.stack([arrays[c] for c in cols], axis=1)
        moved = jnp.take(mat, src, axis=0)
        for j, c in enumerate(cols):
            out[c] = moved[:, j]
    return tuple(out)


class PushResult(NamedTuple):
    species: SpeciesState
    acc: jnp.ndarray          # (nv, 12) quarter-face current accumulator
    rhob_flat: jnp.ndarray    # (nv,) flat rhob including absorb deposits
    pend_face: jnp.ndarray    # (N,) int32, see codes above
    pend_disp: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]
    n_pend: jnp.ndarray       # int32: particles needing boundary handling


def _interp_fields(fcoef, dx, dy, dz, qdt_2mc):
    """Gathered-row interpolation (advance_p_pipeline.cc:93-106)."""
    hax = qdt_2mc * ((fcoef[:, 0] + dy * fcoef[:, 1])
                     + dz * (fcoef[:, 2] + dy * fcoef[:, 3]))
    hay = qdt_2mc * ((fcoef[:, 4] + dz * fcoef[:, 5])
                     + dx * (fcoef[:, 6] + dz * fcoef[:, 7]))
    haz = qdt_2mc * ((fcoef[:, 8] + dx * fcoef[:, 9])
                     + dy * (fcoef[:, 10] + dx * fcoef[:, 11]))
    cbx = fcoef[:, 12] + dx * fcoef[:, 13]
    cby = fcoef[:, 14] + dy * fcoef[:, 15]
    cbz = fcoef[:, 16] + dz * fcoef[:, 17]
    return hax, hay, haz, cbx, cby, cbz


def _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_2mc_or_4mc):
    """Relativistic Boris rotation with the reference's tan(theta/2)
    expansion (advance_p_pipeline.cc:117-132)."""
    v0 = qdt_2mc_or_4mc * jax.lax.rsqrt(1.0 + (ux * ux + (uy * uy + uz * uz)))
    v1 = cbx * cbx + (cby * cby + cbz * cbz)
    v2 = (v0 * v0) * v1
    v3 = v0 * (1.0 + v2 * (ONE_THIRD + v2 * TWO_FIFTEENTHS))
    v4 = v3 / (1.0 + v1 * (v3 * v3))
    v4 = v4 + v4
    w0 = ux + v3 * (uy * cbz - uz * cby)
    w1 = uy + v3 * (uz * cbx - ux * cbz)
    w2 = uz + v3 * (ux * cby - uy * cbx)
    ux = ux + v4 * (w1 * cbz - w2 * cby)
    uy = uy + v4 * (w2 * cbx - w0 * cbz)
    uz = uz + v4 * (w0 * cby - w1 * cbx)
    return ux, uy, uz


def _accumulate_j_cols(q, sdx, sdy, sdz, midx, midy, midz):
    """The 12 quarter-face current values for one sub-streak
    (ACCUMULATE_J, advance_p_pipeline.cc:183-207 == move_p.cc:276-297)."""
    v5 = q * sdx * sdy * sdz * ONE_THIRD

    def one(qu, dY, dZ):
        v1 = qu * dY
        v0 = qu - v1
        v1 = v1 + qu
        a = 1.0 + dZ
        v2 = v0 * a
        v3 = v1 * a
        b = 1.0 - dZ
        v0 = v0 * b
        v1 = v1 * b
        return (v0 + v5, v1 - v5, v2 - v5, v3 + v5)

    jx = one(q * sdx, midy, midz)
    jy = one(q * sdy, midz, midx)
    jz = one(q * sdz, midx, midy)
    return jnp.stack(jx + jy + jz, axis=-1)


def _trilinear_weights(dx, dy, dz, q):
    """8 node weights in VPIC's order (rho_p.cc:70-75):
    [(-,-,-),(+,-,-),(-,+,-),(+,+,-),(-,-,+),(+,-,+),(-,+,+),(+,+,+)]
    where +/- refers to the (x,y,z) upper/lower node of the voxel."""
    w6 = q - dx * q            # q(1-dx)
    w7 = q + dx * q            # q(1+dx)
    w4 = w6 - dy * w6
    w5 = w7 - dy * w7
    w6 = w6 + dy * w6
    w7 = w7 + dy * w7
    w0 = w4 - dz * w4
    w1 = w5 - dz * w5
    w2 = w6 - dz * w6
    w3 = w7 - dz * w7
    w4 = w4 + dz * w4
    w5 = w5 + dz * w5
    w6 = w6 + dz * w6
    w7 = w7 + dz * w7
    return jnp.stack([w0, w1, w2, w3, w4, w5, w6, w7], axis=-1)


def _node_offsets(g: Grid):
    sy, sz = g.sy, g.sz
    return jnp.array([0, 1, sy, sy + 1, sz, sz + 1, sz + sy, sz + sy + 1],
                     jnp.int32)


def deposit_rhob(rhob_flat, g: Grid, i, dx, dy, dz, w, qsp, mask):
    """accumulate_rhob (rho_p.cc:126-211): trilinear node deposit with the
    boundary-corrected doubling of weights on domain-edge nodes."""
    q = jnp.where(mask, qsp * g.r8V * w, 0.0)
    weights = _trilinear_weights(dx, dy, dz, q)

    z, r = divmod_const(i, g.sz, g.nv)
    y, x = divmod_const(r, g.sy, g.sz)
    lo_mask = jnp.array([[1, 1, 1, 1, 0, 0, 0, 0]], jnp.float32)  # z==1
    hi_mask = 1.0 - lo_mask
    weights = weights * jnp.where((z == 1)[:, None], 1.0 + lo_mask, 1.0)
    weights = weights * jnp.where((z == g.nz)[:, None], 1.0 + hi_mask, 1.0)
    ylo = jnp.array([[1, 1, 0, 0, 1, 1, 0, 0]], jnp.float32)
    weights = weights * jnp.where((y == 1)[:, None], 1.0 + ylo, 1.0)
    weights = weights * jnp.where((y == g.ny)[:, None], 2.0 - ylo, 1.0)
    xlo = jnp.array([[1, 0, 1, 0, 1, 0, 1, 0]], jnp.float32)
    weights = weights * jnp.where((x == 1)[:, None], 1.0 + xlo, 1.0)
    weights = weights * jnp.where((x == g.nx)[:, None], 2.0 - xlo, 1.0)

    nodes = i[:, None] + _node_offsets(g)[None, :]
    return rhob_flat.at[nodes.reshape(-1)].add(weights.reshape(-1),
                                               mode="drop")


def accumulate_rho_p(rhof_flat, sp: SpeciesState, g: Grid, qsp):
    """accumulate_rho_p (rho_p.cc:22-112): uncorrected trilinear deposit of
    all live particles into flat rhof.

    Cell-moment formulation: instead of 8 scatter-adds per particle, deposit the
    per-cell moment vector q*(1, dx, dy, dz, dxdy, dxdz, dydz, dxdydz)
    with ONE (N, 8) row scatter-add, then combine neighboring cells'
    moments into node values with 8 dense shifted adds.  Algebraically
    identical (node weight q(1+-dx)(1+-dy)(1+-dz) expands into exactly
    these moments); f32 summation order differs from the reference."""
    q = jnp.where(sp.alive, qsp * g.r8V * sp.w, 0.0)
    dx, dy, dz = sp.dx, sp.dy, sp.dz
    m = jnp.stack([q, q * dx, q * dy, q * dz, q * (dx * dy), q * (dx * dz),
                   q * (dy * dz), q * (dx * (dy * dz))], axis=1)
    mom = jnp.zeros((g.nv, 8), jnp.float32).at[sp.i].add(m, mode="drop")
    mom = mom.reshape(g.NZ, g.NY, g.NX, 8)
    rho = rhof_flat.reshape(g.NZ, g.NY, g.NX)
    for c in (0, 1):
        for b in (0, 1):
            for a in (0, 1):
                sx, sy, sz = 2 * a - 1, 2 * b - 1, 2 * c - 1
                contrib = (mom[..., 0] + sx * mom[..., 1]
                           + sy * mom[..., 2] + sz * mom[..., 3]
                           + (sx * sy) * mom[..., 4]
                           + (sx * sz) * mom[..., 5]
                           + (sy * sz) * mom[..., 6]
                           + (sx * sy * sz) * mom[..., 7])
                rho = rho.at[c:, b:, a:].add(
                    contrib[:g.NZ - c, :g.NY - b, :g.NX - a])
    return rho.reshape(-1)


def _ensure_varying(a, names):
    """Mark a (possibly replicated) value as mesh-varying over ``names`` so
    shard_map loop carries type-check; no-op for already-varying leaves."""
    try:
        vma = jax.typeof(a).vma
    except Exception:
        return a
    missing = tuple(n for n in names if n not in vma)
    if not missing:
        return a
    return jax.lax.pcast(a, missing, to="varying")


def _edge_masks(g: Grid, ax: int):
    """For a device-mesh-sharded axis, whether THIS shard owns the global
    low/high domain face (requires being inside shard_map).  Unsharded axes
    always own both.  With an irregular join table, a face is 'edge'
    (applies its local BC) iff it has no partner."""
    if g.face_partners is not None:
        from ..grid import flat_rank
        fr = flat_rank(g)
        lo = jnp.asarray(g.face_partners[ax])[fr] < 0
        hi = jnp.asarray(g.face_partners[ax + 3])[fr] < 0
        return lo, hi
    if g.topology[ax] == 1:
        return True, True
    idx = jax.lax.axis_index(g.mesh_axes[ax])
    return idx == 0, idx == g.topology[ax] - 1


def streak_walk(g: Grid, qsp, w, pos, disp, coords, u, active, alive,
                pend, acc, rhob, max_streak: int, vbc=None):
    """The move_p streak walk (move_p.cc:216-353) over all lanes at once.

    Shared by advance_p (every particle starts here; in-bounds lanes finish
    on the first sub-streak with deposits identical to the reference's
    inline ACCUMULATE_J path) and by boundary_p migration rounds
    (continuation of received particles' remaining displacement).

    ``vbc`` optionally carries per-voxel-face particle-BC overrides -- the
    analogue of the reference's grid->neighbor[6*nv] encoding
    (grid.h:116-121, decoded at boundary_p.cc:196-255): a flat (nv*6,)
    int32 array indexed voxel*6 + face (face = axis + 3*is_hi_side) whose
    entries are 0 (normal crossing), REFLECT_PARTICLES, ABSORB_PARTICLES,
    or a ready-made custom pend code (>= CUSTOM_BASE) dispatched to the
    deck's interior-surface handlers by boundary_p.  This is what lets
    decks attach reflux/absorb surfaces to interior region boundaries.

    pos/disp/coords/u are (x, y, z) triples of (N,) arrays; returns the
    updated tuples plus pend/acc/rhob.  Lanes with pend >= 0 hit a remote
    or custom face and keep their remaining displacement for boundary_p.
    """
    px, py, pz = pos
    dpx, dpy, dpz = disp
    xi, yi, zi = coords
    ux, uy, uz = u
    q0 = jnp.where(alive, qsp * w, 0.0)

    def streak(carry, _):
        (px, py, pz, dpx, dpy, dpz, xi, yi, zi,
         ux, uy, uz, active, alive, pend, acc, rhob) = carry

        dirx = jnp.where(dpx > 0, 1.0, -1.0)
        diry = jnp.where(dpy > 0, 1.0, -1.0)
        dirz = jnp.where(dpz > 0, 1.0, -1.0)
        v0 = jnp.where(dpx == 0, BIG, (dirx - px) / jnp.where(dpx == 0, 1, dpx))
        v1 = jnp.where(dpy == 0, BIG, (diry - py) / jnp.where(dpy == 0, 1, dpy))
        v2 = jnp.where(dpz == 0, BIG, (dirz - pz) / jnp.where(dpz == 0, 1, dpz))

        # axis = index of strictly smallest of (v0, v1, v2, 2.0) with the
        # reference's tie-break (earlier axis wins on ties; end-of-track wins
        # all ties at 2.0) -- move_p.cc:257-260.
        v3 = jnp.full_like(v0, 2.0)
        axis = jnp.full_like(xi, 3)
        take0 = v0 < v3
        v3 = jnp.where(take0, v0, v3)
        axis = jnp.where(take0, 0, axis)
        take1 = v1 < v3
        v3 = jnp.where(take1, v1, v3)
        axis = jnp.where(take1, 1, axis)
        take2 = v2 < v3
        v3 = jnp.where(take2, v2, v3)
        axis = jnp.where(take2, 2, axis)
        frac = 0.5 * v3

        sdx = dpx * frac
        sdy = dpy * frac
        sdz = dpz * frac
        midx = px + sdx
        midy = py + sdy
        midz = pz + sdz

        actf = active.astype(jnp.float32)
        vox = xi + g.NX * (yi + g.NY * zi)
        vals = _accumulate_j_cols(q0 * actf, sdx, sdy, sdz, midx, midy, midz)
        acc = acc.at[vox].add(vals, mode="drop")

        # Advance remaining displacement / position for active lanes.
        upd = lambda old, new: jnp.where(active, new, old)
        dpx = upd(dpx, dpx - sdx)
        dpy = upd(dpy, dpy - sdy)
        dpz = upd(dpz, dpz - sdz)
        px = upd(px, px + sdx + sdx)
        py = upd(py, py + sdy + sdy)
        pz = upd(pz, pz + sdz + sdz)

        ended = axis == 3
        crossing = active & ~ended
        active = active & ~ended

        # Put the crossing particle exactly on the face (move_p.cc:321-323).
        for ax, (p, d) in enumerate(((px, dirx), (py, diry), (pz, dirz))):
            m = crossing & (axis == ax)
            p_new = jnp.where(m, d, p)
            if ax == 0:
                px = p_new
            elif ax == 1:
                py = p_new
            else:
                pz = p_new

        # Per-voxel-face BC overrides come first (the reference decodes
        # its neighbor-table entry before any domain logic).
        if vbc is not None:
            dsel = jnp.where(axis == 0, dirx,
                             jnp.where(axis == 1, diry, dirz))
            face_l = jnp.where(axis < 3, axis, 0) + jnp.where(dsel > 0, 3, 0)
            vox_now = xi + g.NX * (yi + g.NY * zi)
            code = jnp.where(
                crossing,
                vbc[jnp.clip(vox_now * 6 + face_l, 0, vbc.shape[0] - 1)],
                0)
        else:
            code = None

        # Neighbor / boundary logic per axis (replaces g->neighbor table).
        vb_absorbed = None
        for ax in range(3):
            m = crossing & (axis == ax)
            if code is not None:
                vb_r = m & (code == REFLECT_PARTICLES)
                vb_a = m & (code == ABSORB_PARTICLES) & alive
                vb_p = m & (code >= CUSTOM_BASE)
                if ax == 0:
                    ux = jnp.where(vb_r, -ux, ux)
                    dpx = jnp.where(vb_r, -dpx, dpx)
                elif ax == 1:
                    uy = jnp.where(vb_r, -uy, uy)
                    dpy = jnp.where(vb_r, -dpy, dpy)
                else:
                    uz = jnp.where(vb_r, -uz, uz)
                    dpz = jnp.where(vb_r, -dpz, dpz)
                # one union-mask rhob deposit per round, after the loop
                # (positions/voxels of absorbed lanes are already frozen)
                vb_absorbed = vb_a if vb_absorbed is None \
                    else (vb_absorbed | vb_a)
                alive = alive & ~vb_a
                active = active & ~vb_a
                pend = jnp.where(vb_p, code, pend)
                active = active & ~vb_p
                m = m & ~(vb_r | vb_a | vb_p)
            n_ax = (g.nx, g.ny, g.nz)[ax]
            coord = (xi, yi, zi)[ax]
            d = (dirx, diry, dirz)[ax]
            pos_d = d > 0
            new_coord = coord + jnp.where(pos_d, 1, -1)
            out_lo = m & (new_coord < 1)
            out_hi = m & (new_coord > n_ax)
            inside = m & ~out_lo & ~out_hi

            # interior crossing: move voxel, flip offset coordinate
            coord = jnp.where(inside, new_coord, coord)
            flip = inside

            is_lo_edge, is_hi_edge = _edge_masks(g, ax)
            for side, out_all in ((-1, out_lo), (1, out_hi)):
                bc = g.axis_bc(ax, side, particles=True)
                is_edge = is_lo_edge if side < 0 else is_hi_edge
                face = ax + (0 if side < 0 else 3)
                has_partner = (g.face_partners is not None and
                               any(v >= 0 for v in g.face_partners[face]))
                # On a device-mesh-sharded axis, only the outermost shard
                # applies the global-domain BC; interior faces migrate.
                # Join-table faces migrate per rank (is_edge is the
                # per-rank unjoined mask).
                if (g.topology[ax] > 1 or has_partner) and bc != P_REMOTE:
                    out_m = out_all & is_edge
                    out_remote = out_all & ~is_edge
                    pend = jnp.where(out_remote, face, pend)
                    active = active & ~out_remote
                elif bc == P_REMOTE:
                    out_m = jnp.zeros_like(out_all)
                    pend = jnp.where(out_all, face, pend)
                    active = active & ~out_all
                else:
                    out_m = out_all
                if bc == P_PERIODIC:
                    wrapped = jnp.where(side < 0, n_ax, 1)
                    coord = jnp.where(out_m, wrapped, coord)
                    flip = flip | out_m
                elif bc == REFLECT_PARTICLES:
                    # Flip momentum + remaining displacement; particle stays
                    # on the wall and keeps walking (move_p.cc:327-334).
                    if ax == 0:
                        ux = jnp.where(out_m, -ux, ux)
                        dpx = jnp.where(out_m, -dpx, dpx)
                    elif ax == 1:
                        uy = jnp.where(out_m, -uy, uy)
                        dpy = jnp.where(out_m, -dpy, dpy)
                    else:
                        uz = jnp.where(out_m, -uz, uz)
                        dpz = jnp.where(out_m, -dpz, dpz)
                elif bc == ABSORB_PARTICLES:
                    vox_now = xi + g.NX * (yi + g.NY * zi)
                    rhob = deposit_rhob(rhob, g, vox_now, px, py, pz,
                                        w, qsp, out_m & alive)
                    alive = alive & ~out_m
                    active = active & ~out_m
                elif bc != P_REMOTE:
                    # Custom particle BC (maxwellian_reflux, absorb_tally,
                    # ...): park for boundary_p with the face code.
                    pend = jnp.where(out_m, CUSTOM_BASE + face, pend)
                    active = active & ~out_m

            # write back voxel coord and offset flip
            if ax == 0:
                xi = coord
                px = jnp.where(flip, -px, px)
            elif ax == 1:
                yi = coord
                py = jnp.where(flip, -py, py)
            else:
                zi = coord
                pz = jnp.where(flip, -pz, pz)

        if vb_absorbed is not None:
            vox_now = xi + g.NX * (yi + g.NY * zi)
            rhob = deposit_rhob(rhob, g, vox_now, px, py, pz, w, qsp,
                                vb_absorbed)

        carry = (px, py, pz, dpx, dpy, dpz, xi, yi, zi,
                 ux, uy, uz, active, alive, pend, acc, rhob)
        return carry, None

    carry = (px, py, pz, dpx, dpy, dpz, xi, yi, zi,
             ux, uy, uz, active, alive, pend, acc, rhob)
    # Under shard_map the state is varying over all three mesh axes (even
    # size-1 ones), so constant-initialized carries must be cast likewise.
    names = g.mesh_axes if g.sharded else ()
    if names:
        # Inside shard_map, loop carries must have consistent varying-axis
        # types; replicated-constant inits (zeros) become varying in the body.
        carry = jax.tree.map(lambda a: _ensure_varying(a, names), carry)
    # fori_loop keeps the compiled graph one-streak-body big.
    carry = jax.lax.fori_loop(0, max_streak,
                              lambda _, c: streak(c, None)[0], carry)
    (px, py, pz, dpx, dpy, dpz, xi, yi, zi,
     ux, uy, uz, active, alive, pend, acc, rhob) = carry

    # Lanes still active after max_streak ran out of iterations.
    pend = jnp.where(active, UNFINISHED, pend)
    return ((px, py, pz), (dpx, dpy, dpz), (xi, yi, zi), (ux, uy, uz),
            alive, pend, acc, rhob)


def advance_p(sp: SpeciesState, fcoef, g: Grid, qsp: float, msp: float,
              acc, rhob_flat, max_streak: int = 4,
              vbc=None) -> PushResult:
    """One leapfrog step for one species (see module docstring).

    ``acc`` is the shared (nv, 12) accumulator: contributions from every
    species add into it, like the reference's single accumulator array."""
    N = sp.capacity
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    cdt_dx = g.cvac * g.dt * g.rdx
    cdt_dy = g.cvac * g.dt * g.rdy
    cdt_dz = g.cvac * g.dt * g.rdz
    alive = sp.alive

    dx, dy, dz = sp.dx, sp.dy, sp.dz
    rows = fcoef[sp.i]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, dx, dy, dz, qdt_2mc)

    ux = sp.ux + hax
    uy = sp.uy + hay
    uz = sp.uz + haz
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_2mc)
    ux = ux + hax
    uy = uy + hay
    uz = uz + haz

    # Normalized half-displacement in voxel-offset units
    # (advance_p_pipeline.cc:142-151).
    rgamma = jax.lax.rsqrt(1.0 + (ux * ux + (uy * uy + uz * uz)))
    dispx = ux * cdt_dx * rgamma
    dispy = uy * cdt_dy * rgamma
    dispz = uz * cdt_dz * rgamma

    # Decode voxel coords once; carried through the walk.
    zi, r = divmod_const(sp.i, g.sz, g.nv)
    yi, xi = divmod_const(r, g.sy, g.sz)

    pend0 = jnp.full((N,), DONE, jnp.int32)
    (pos, disp, coords, u, alive, pend, acc, rhob_flat) = streak_walk(
        g, qsp, sp.w, (dx, dy, dz), (dispx, dispy, dispz), (xi, yi, zi),
        (ux, uy, uz), alive, alive, pend0, acc, rhob_flat, max_streak,
        vbc=vbc)

    vox = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
    new_sp = sp.replace(
        dx=pos[0], dy=pos[1], dz=pos[2], i=vox,
        ux=u[0], uy=u[1], uz=u[2],
        w=jnp.where(alive, sp.w, 0.0),
        live=alive,
        np=jnp.sum(alive.astype(jnp.int32)),
    )
    n_pend = jnp.sum((pend >= 0) & (pend < UNFINISHED))
    return PushResult(new_sp, acc, rhob_flat, pend, disp, n_pend)


def center_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp) -> SpeciesState:
    """center_p (center_p_pipeline.cc:16-100): u from time level t-1/2 to t:
    half E kick (qdt_2mc) then half Boris rotate (qdt_4mc)."""
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    qdt_4mc = 0.5 * qdt_2mc
    rows = fcoef[sp.i]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                                  qdt_2mc)
    ux, uy, uz = sp.ux + hax, sp.uy + hay, sp.uz + haz
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_4mc)
    a = sp.alive
    return sp.replace(ux=jnp.where(a, ux, sp.ux),
                      uy=jnp.where(a, uy, sp.uy),
                      uz=jnp.where(a, uz, sp.uz))


def uncenter_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp) -> SpeciesState:
    """uncenter_p (uncenter_p_pipeline.cc:16-98): u from t to t-1/2
    (backward half rotate then backward half kick)."""
    qdt_2mc = -(qsp * g.dt) / (2.0 * msp * g.cvac)
    qdt_4mc = 0.5 * qdt_2mc
    rows = fcoef[sp.i]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                                  qdt_2mc)
    ux, uy, uz = _boris_rotate(sp.ux, sp.uy, sp.uz, cbx, cby, cbz, qdt_4mc)
    ux, uy, uz = ux + hax, uy + hay, uz + haz
    a = sp.alive
    return sp.replace(ux=jnp.where(a, ux, sp.ux),
                      uy=jnp.where(a, uy, sp.uy),
                      uz=jnp.where(a, uz, sp.uz))


def energy_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp):
    """energy_p (energy_p_pipeline.cc:17-68): time-centered total kinetic
    energy of the species (shard-local partial; psum when sharded)."""
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    rows = fcoef[sp.i]
    hax, hay, haz, _, _, _ = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                            qdt_2mc)
    v0 = sp.ux + hax
    v1 = sp.uy + hay
    v2 = sp.uz + haz
    usq = v0 * v0 + v1 * v1 + v2 * v2
    ke = (msp * sp.w) * (usq / (1.0 + jnp.sqrt(1.0 + usq)))
    ke = jnp.where(sp.alive, ke, 0.0)
    return jnp.sum(ke) * (g.cvac * g.cvac)


def sort_p(sp: SpeciesState) -> SpeciesState:
    """Stable counting-sort analogue (sort_p_pipeline.c): reorder the live
    prefix by voxel so deposits within a voxel tile are contiguous and
    collision pairing can partition by cell."""
    key = jnp.where(sp.alive, sp.i, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key, stable=True)
    dx, dy, dz, ux, uy, uz, w, i, live = gather_rows(
        order, sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz, sp.w, sp.i,
        sp.live)
    return sp.replace(dx=dx, dy=dy, dz=dz, i=i, ux=ux, uy=uy, uz=uz, w=w,
                      live=live)
