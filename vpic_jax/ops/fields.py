"""Yee-mesh FDTD field solver, divergence cleaners and face synchronization.

Re-design of src/field_advance/standard/ (sfa.c, advance_b/e,
local.c, remote.c, the div cleaners and energy_f):

* Stencils are whole-array slice arithmetic over ghosted [z,y,x] arrays; XLA
  fuses each phase into a handful of elementwise kernels (the reference needs
  per-ISA SIMD variants + pipeline dispatch for the same effect).
* The reference's split begin/end remote ghost exchange + local ghost fill
  (remote.c:62-270, local.c:50-215) collapses into three ghost-fill ops
  (tang_b, norm_e, div_b).  On one shard, PERIODIC faces wrap; sharded faces
  are exchanged with lax.ppermute (_shard_halo_plane below), and
  XLA's latency-hiding scheduler provides the comm/compute overlap that the
  reference hand-codes (advance_e_pipeline.cc:60-210).
* Shared-face synchronization (remote.c:299-619) becomes plane-combine ops:
  sum for jf/rhof, average for rhob (it is accumulated locally pre-doubled)
  and for tang-E/norm-B.

Spatial axis convention: X=0, Y=1, Z=2; array axes are [z,y,x] so array axis
of spatial axis a is ``2 - a``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..grid import (ABSORB_FIELDS, ANTI_SYMMETRIC, PERIODIC, PMC, REMOTE,
                    SYMMETRIC, Grid)
from ..state import FieldState, MaterialCoeffs

# ---------------------------------------------------------------------------
# Small slicing helpers
# ---------------------------------------------------------------------------

_ALL = slice(None)


def _arr_axis(spatial_axis: int) -> int:
    return 2 - spatial_axis


def _plane_idx(a, spatial_axis: int, idx):
    sl = [_ALL, _ALL, _ALL]
    sl[_arr_axis(spatial_axis)] = idx
    return tuple(sl)


def get_plane(a, spatial_axis: int, idx):
    return a[_plane_idx(a, spatial_axis, idx)]


def slset(a, sl, val):
    """a.at[sl].set(val) for static slices/ints (val broadcasts)."""
    return a.at[sl].set(jnp.asarray(val, a.dtype))


def set_plane(a, spatial_axis: int, idx, val):
    aa = _arr_axis(spatial_axis)
    sl = [_ALL, _ALL, _ALL]
    sl[aa] = idx
    return slset(a, tuple(sl), val)


def _slc(a, sl):
    """Slice a mesh-shaped coefficient; broadcast scalars untouched."""
    return a[sl] if getattr(a, "ndim", 0) == 3 else a


def _sl3(zsl=_ALL, ysl=_ALL, xsl=_ALL):
    return (zsl, ysl, xsl)



def _sladd(a, sl, v):
    """a.at[sl].add(v) for static slices."""
    return slset(a, sl, a[sl] + v)

# Slices named by spatial extent (FORTRAN index ranges on 0..n+1 arrays):
INT = slice(1, -1)      # 1..n
INTH = slice(1, None)   # 1..n+1
LO = slice(0, -2)       # 0..n-1   (x-1 of 1..n)
LOH = slice(0, -1)      # 0..n     (x-1 of 1..n+1)
HI = slice(2, None)     # 2..n+1   (x+1 of 1..n)

# Tangential cb components per face axis (axis -> (compY, compZ) names).
_CB = ("cbx", "cby", "cbz")
_E = ("ex", "ey", "ez")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")


def _axes_of(axis: int) -> Tuple[int, int]:
    """The two axes transverse to ``axis`` (cyclic: x->(y,z), y->(z,x), z->(x,y))."""
    return ((axis + 1) % 3, (axis + 2) % 3)


# ---------------------------------------------------------------------------
# Ghost fills (local.c:50-215) + halo exchange (remote.c:62-270).
#
# Periodic faces of an unsharded axis wrap locally; axes sharded over the
# device mesh exchange boundary planes with lax.ppermute over ICI (requires
# running inside shard_map with g.mesh_axes names).  When the global-domain
# BC on a sharded axis is a local BC (pec/absorbing box decomposed over
# devices), only the outermost shard applies the local rule; interior shards
# take the remote plane -- selected with a where() on the shard index, which
# is how SPMD replaces the reference's per-rank g->bc branching.
# ---------------------------------------------------------------------------

def _shard_halo_plane(a, axis: int, side: int, g: Grid):
    """Neighbor shard's boundary plane for my ghost on (axis, side): every
    shard sends plane(n) toward +axis for low ghosts (k -> k+1) or plane(1)
    toward -axis for high ghosts (cyclic, so global periodic falls out).
    With an irregular domain graph (g.face_partners), the exchange rides
    explicit flat-rank pairs: my (axis, side) partner sends me its
    opposite-face plane."""
    n = (g.nx, g.ny, g.nz)[axis]
    src = n if side < 0 else 1
    plane = get_plane(a, axis, src)
    if g.face_partners is not None:
        tab = g.face_partners[axis + (0 if side < 0 else 3)]
        pairs = [(p, r) for r, p in enumerate(tab) if p >= 0]
        return jax.lax.ppermute(plane, g.mesh_axes, pairs)
    ns = g.topology[axis]
    shift = 1 if side < 0 else -1
    perm = [(k, (k + shift) % ns) for k in range(ns)]
    return jax.lax.ppermute(plane, g.mesh_axes[axis], perm)


def _edge_scalar(g: Grid, axis: int, side: int):
    """True on the shard owning the global-domain face (axis, side)."""
    idx = jax.lax.axis_index(g.mesh_axes[axis])
    return idx == (0 if side < 0 else g.topology[axis] - 1)


def _joined_scalar(g: Grid, axis: int, side: int):
    """Irregular-graph mode: True iff THIS rank's (axis, side) face has a
    partner in the join table (the per-rank analogue of ~_edge_scalar)."""
    from ..grid import flat_rank
    tab = g.face_partners[axis + (0 if side < 0 else 3)]
    return jnp.asarray(tab)[flat_rank(g)] >= 0


def _ghost_value(local_fn, a, axis, side, bc, g: Grid):
    """Combine the local-BC ghost rule with the sharded halo exchange."""
    n = (g.nx, g.ny, g.nz)[axis]
    wrap = n if side < 0 else 1
    if g.face_partners is not None:
        # join-table connectivity: per-rank choice between the partner's
        # plane and the local rule (local wrap when the face code says
        # periodic -- an unjoined rank on an unsharded axis)
        tab = g.face_partners[axis + (0 if side < 0 else 3)]
        loc = get_plane(a, axis, wrap) if bc == PERIODIC else local_fn()
        if all(v < 0 for v in tab):
            return loc
        remote = _shard_halo_plane(a, axis, side, g)
        return jnp.where(_joined_scalar(g, axis, side), remote, loc)
    if g.topology[axis] == 1:
        if bc == PERIODIC:
            return get_plane(a, axis, wrap)
        return local_fn()
    remote = _shard_halo_plane(a, axis, side, g)
    if bc == REMOTE:
        return remote
    return jnp.where(_edge_scalar(g, axis, side), local_fn(), remote)

def ghost_tang_b(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_tang_b (local.c:50-122): fill ghost tangential cB planes."""
    comps = {name: getattr(f, name) for name in _CB}
    e = {name: getattr(f, name) for name in _E}

    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        cdt_dn = g.cvac * g.dt * (g.rdx, g.rdy, g.rdz)[axis]
        t_axes = _axes_of(axis)
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            ghost = 0 if side < 0 else n + 1
            mirror = 1 if side < 0 else n
            for t in t_axes:
                name = _CB[t]
                a = comps[name]

                def local_fn(a=a, t=t, axis=axis, side=side, bc=bc,
                             mirror=mirror, ghost=ghost, n=n, cdt_dn=cdt_dn,
                             t_axes=t_axes):
                    if bc in (PERIODIC, REMOTE):
                        return get_plane(a, axis, n if side < 0 else 1)
                    if bc == ANTI_SYMMETRIC:
                        return get_plane(a, axis, mirror)
                    if bc in (SYMMETRIC, PMC):
                        return -get_plane(a, axis, mirror)
                    if bc == ABSORB_FIELDS:
                        # Higdon/Mur hybrid ABC (local.c:82-107).  Ghost cb_t
                        # couples to e_o (the other transverse component)
                        # through t1 and to e_n (the face-normal component,
                        # differenced along o) through t2; the reference's
                        # (Z,Y)-edge loop (updating cb_Y = t_axes[0]) uses
                        # "- t1 + t2", the (Y,Z) loop (cb_Z) "+ t1 - t2".
                        higend = 1.03527618 if (g.gnx > 1 or g.gny > 1 or
                                                g.gnz > 1) else 1.0
                        drive = cdt_dn * higend
                        decay = (1.0 - drive) / (1.0 + drive)
                        drive = 2.0 * drive / (1.0 + drive)
                        o = t_axes[1] if t == t_axes[0] else t_axes[0]
                        e_o = e[_E[o]]
                        e_n = e[_E[axis]]
                        face = 1 if side < 0 else n + 1
                        t1 = cdt_dn * (
                            get_plane(e_o, axis, face + (1 if side < 0 else -1))
                            - get_plane(e_o, axis, face))
                        if side > 0:
                            t1 = -t1
                        cdt_do = g.cvac * g.dt * (g.rdx, g.rdy, g.rdz)[o]
                        t2 = cdt_do * (_plane_shift(e_n, axis, mirror, o, +1)
                                       - get_plane(e_n, axis, mirror))
                        base = (decay * get_plane(a, axis, ghost)
                                + drive * get_plane(a, axis, mirror))
                        return (base - t1 + t2 if t == t_axes[0]
                                else base + t1 - t2)
                    raise ValueError(f"bad field bc {bc}")

                val = _ghost_value(local_fn, a, axis, side, bc, g)
                comps[name] = set_plane(a, axis, ghost, val)
    return f.replace(**comps)


def _plane_shift(arr, plane_axis: int, plane_idx: int, shift_axis: int,
                 shift: int):
    """Extract plane ``plane_idx`` along ``plane_axis`` of ``arr`` shifted by
    ``shift`` voxels along ``shift_axis`` (zero-filled at the array edge)."""
    sl = [_ALL, _ALL, _ALL]
    sl[_arr_axis(plane_axis)] = plane_idx
    plane = arr[tuple(sl)]
    # Which axis of the 2-d plane corresponds to shift_axis?
    rem = [ax for ax in (0, 1, 2) if ax != _arr_axis(plane_axis)]
    pax = rem.index(_arr_axis(shift_axis))
    n = plane.shape[pax]
    pad = [(0, 0), (0, 0)]
    if shift > 0:
        pad[pax] = (0, shift)
        out = jnp.pad(plane, pad)
        return jax.lax.slice_in_dim(out, shift, shift + n, axis=pax)
    else:
        pad[pax] = (-shift, 0)
        out = jnp.pad(plane, pad)
        return jax.lax.slice_in_dim(out, 0, n, axis=pax)


def ghost_norm_e(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_norm_e (local.c:128-179): ghost normal E (+ tca) planes."""
    out = {}
    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        for comp_set in (_E, _TCA):
            name = comp_set[axis]
            a = out.get(name, getattr(f, name))
            for side in (-1, 1):
                bc = g.axis_bc(axis, side)
                ghost = 0 if side < 0 else n + 1
                m1 = 1 if side < 0 else n
                m2 = 2 if side < 0 else n - 1

                def local_fn(a=a, bc=bc, axis=axis, side=side, m1=m1, m2=m2,
                             n=n):
                    if bc in (PERIODIC, REMOTE):
                        return get_plane(a, axis, n if side < 0 else 1)
                    if bc == ANTI_SYMMETRIC:
                        return get_plane(a, axis, m1)
                    if bc in (SYMMETRIC, PMC):
                        return -get_plane(a, axis, m1)
                    if bc == ABSORB_FIELDS:
                        return (2.0 * get_plane(a, axis, m1)
                                - get_plane(a, axis, m2))
                    raise ValueError(f"bad field bc {bc}")

                a = set_plane(a, axis, ghost,
                              _ghost_value(local_fn, a, axis, side, bc, g))
            out[name] = a
    return f.replace(**out)


def ghost_div_b(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_div_b (local.c:181-215)."""
    a = f.div_b_err
    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            ghost = 0 if side < 0 else n + 1
            mirror = 1 if side < 0 else n

            def local_fn(a=a, bc=bc, axis=axis, side=side, mirror=mirror, n=n):
                if bc in (PERIODIC, REMOTE):
                    return get_plane(a, axis, n if side < 0 else 1)
                if bc == ANTI_SYMMETRIC:
                    return get_plane(a, axis, mirror)
                if bc in (SYMMETRIC, PMC):
                    return -get_plane(a, axis, mirror)
                if bc == ABSORB_FIELDS:
                    return jnp.zeros_like(get_plane(a, axis, mirror))
                raise ValueError(f"bad field bc {bc}")

            a = set_plane(a, axis, ghost,
                          _ghost_value(local_fn, a, axis, side, bc, g))
    return f.replace(div_b_err=a)


# ---------------------------------------------------------------------------
# Local adjusts (local.c:224-444)
# ---------------------------------------------------------------------------

def _local_faces(g: Grid):
    """Yield (axis, side, bc) for faces with a *local* (non-comm) BC."""
    for axis in range(3):
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            if bc not in (PERIODIC, REMOTE):
                yield axis, side, bc


def _set_boundary_plane(a, axis, side, g: Grid, new_plane):
    """Set the boundary plane (index 1 or n+1); on device-mesh-sharded axes
    only the shard owning the global face applies it."""
    n = (g.nx, g.ny, g.nz)[axis]
    face = 1 if side < 0 else n + 1
    if g.face_partners is not None:
        tab = g.face_partners[axis + (0 if side < 0 else 3)]
        if any(v >= 0 for v in tab):
            # joined ranks keep their plane; unjoined apply the local rule
            new_plane = jnp.where(_joined_scalar(g, axis, side),
                                  get_plane(a, axis, face), new_plane)
    elif g.topology[axis] > 1:
        new_plane = jnp.where(_edge_scalar(g, axis, side), new_plane,
                              get_plane(a, axis, face))
    return set_plane(a, axis, face, new_plane)


def adjust_tang_e(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_tang_e: zero tangential E/TCA on pec boundary planes."""
    out = {}
    for axis, side, bc in _local_faces(g):
        if bc != ANTI_SYMMETRIC:
            continue
        for t in _axes_of(axis):
            for comp_set in (_E, _TCA):
                name = comp_set[t]
                a = out.get(name, getattr(f, name))
                out[name] = _set_boundary_plane(
                    a, axis, side, g, jnp.zeros_like(get_plane(a, axis, 1)))
    return f.replace(**out) if out else f


def adjust_norm_b(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_norm_b: zero normal cB on symmetric boundary planes."""
    out = {}
    for axis, side, bc in _local_faces(g):
        if bc != SYMMETRIC:
            continue
        name = _CB[axis]
        a = out.get(name, getattr(f, name))
        out[name] = _set_boundary_plane(
            a, axis, side, g, jnp.zeros_like(get_plane(a, axis, 1)))
    return f.replace(**out) if out else f


def adjust_div_e_err(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_div_e: zero div-E error on pec/absorbing boundary nodes."""
    a = f.div_e_err
    changed = False
    for axis, side, bc in _local_faces(g):
        if bc not in (ANTI_SYMMETRIC, ABSORB_FIELDS):
            continue
        a = _set_boundary_plane(a, axis, side, g,
                                jnp.zeros_like(get_plane(a, axis, 1)))
        changed = True
    return f.replace(div_e_err=a) if changed else f


def adjust_jf(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_jf (local.c:335-368): zero (pec) or double (sym/pmc/abs)
    tangential jf on boundary planes."""
    out = {}
    for axis, side, bc in _local_faces(g):
        n = (g.nx, g.ny, g.nz)[axis]
        face = 1 if side < 0 else n + 1
        scale = 0.0 if bc == ANTI_SYMMETRIC else 2.0
        for t in _axes_of(axis):
            name = _JF[t]
            a = out.get(name, getattr(f, name))
            out[name] = _set_boundary_plane(
                a, axis, side, g, scale * get_plane(a, axis, face))
    return f.replace(**out) if out else f


def adjust_rhof(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_rhof: zero (pec) or double (sym/pmc/abs) boundary rhof."""
    a = f.rhof
    changed = False
    for axis, side, bc in _local_faces(g):
        n = (g.nx, g.ny, g.nz)[axis]
        face = 1 if side < 0 else n + 1
        scale = 0.0 if bc == ANTI_SYMMETRIC else 2.0
        a = _set_boundary_plane(a, axis, side, g,
                                scale * get_plane(a, axis, face))
        changed = True
    return f.replace(rhof=a) if changed else f


def adjust_rhob(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_rhob: zero boundary rhob on pec faces only."""
    a = f.rhob
    changed = False
    for axis, side, bc in _local_faces(g):
        if bc != ANTI_SYMMETRIC:
            continue
        a = _set_boundary_plane(a, axis, side, g,
                                jnp.zeros_like(get_plane(a, axis, 1)))
        changed = True
    return f.replace(rhob=a) if changed else f


# ---------------------------------------------------------------------------
# Shared-face synchronization (remote.c:298-619).  Unsharded PERIODIC axes
# combine plane 1 with plane n+1 locally; device-mesh-sharded axes exchange
# boundary planes with the +/- neighbors via ppermute and combine (the
# combine is commutative so both sides compute bitwise-identical results,
# which is the determinism property the reference gets from its exchange).
# ---------------------------------------------------------------------------

def _sync_axes(g: Grid):
    """Axes whose boundary planes are shared: (axis, cross_shard?)."""
    for axis in range(3):
        if g.face_partners is not None:
            if any(v >= 0 for v in g.face_partners[axis]) or \
                    any(v >= 0 for v in g.face_partners[axis + 3]):
                yield axis, True
            elif (g.axis_bc(axis, -1) == PERIODIC
                  and g.axis_bc(axis, 1) == PERIODIC):
                yield axis, False
        elif g.topology[axis] > 1:
            yield axis, True
        elif (g.axis_bc(axis, -1) == PERIODIC
              and g.axis_bc(axis, 1) == PERIODIC):
            yield axis, False


def _combine(lo, hi, mode):
    if mode == "sum":
        return lo + hi
    if mode == "avg":
        return 0.5 * (lo + hi)
    raise ValueError(mode)


def _combine_shared(a, axis: int, g: Grid, cross: bool, mode: str,
                    want_err: bool = False):
    n = (g.nx, g.ny, g.nz)[axis]
    lo = get_plane(a, axis, 1)
    hi = get_plane(a, axis, n + 1)
    err = None
    if not cross:
        v = _combine(lo, hi, mode)
        if want_err:
            err = jnp.sum((lo - hi) ** 2)
        a = set_plane(a, axis, 1, v)
        a = set_plane(a, axis, n + 1, v)
        return a, err
    if g.face_partners is not None:
        # join-table mode: per-rank choice between the partner combine,
        # the local periodic wrap (unjoined rank, locally periodic axis),
        # and keeping the local plane (unjoined rank, local BC)
        tab_lo = g.face_partners[axis]
        tab_hi = g.face_partners[axis + 3]
        up = [(p, r) for r, p in enumerate(tab_lo) if p >= 0]
        down = [(p, r) for r, p in enumerate(tab_hi) if p >= 0]
        recv_lo = jax.lax.ppermute(hi, g.mesh_axes, up)
        recv_hi = jax.lax.ppermute(lo, g.mesh_axes, down)
        j_lo = _joined_scalar(g, axis, -1)
        j_hi = _joined_scalar(g, axis, 1)
        local_wrap = (g.axis_bc(axis, -1) == PERIODIC
                      and g.axis_bc(axis, 1) == PERIODIC)
        base = _combine(lo, hi, mode) if local_wrap else None
        new_lo = jnp.where(j_lo, _combine(lo, recv_lo, mode),
                           base if base is not None else lo)
        new_hi = jnp.where(j_hi, _combine(hi, recv_hi, mode),
                           base if base is not None else hi)
        if want_err:
            err = jnp.sum(jnp.where(j_lo, (lo - recv_lo) ** 2, 0.0)) \
                + jnp.sum(jnp.where(j_hi, (hi - recv_hi) ** 2, 0.0))
        a = set_plane(a, axis, 1, new_lo)
        a = set_plane(a, axis, n + 1, new_hi)
        return a, err
    name = g.mesh_axes[axis]
    ns = g.topology[axis]
    up = [(k, (k + 1) % ns) for k in range(ns)]
    down = [(k, (k - 1) % ns) for k in range(ns)]
    recv_lo = jax.lax.ppermute(hi, name, up)    # neighbor k-1's high plane
    recv_hi = jax.lax.ppermute(lo, name, down)  # neighbor k+1's low plane
    new_lo = _combine(lo, recv_lo, mode)
    new_hi = _combine(hi, recv_hi, mode)
    if want_err:
        err = jnp.sum((lo - recv_lo) ** 2) + jnp.sum((hi - recv_hi) ** 2)
    bc_lo = g.axis_bc(axis, -1)
    bc_hi = g.axis_bc(axis, 1)
    if bc_lo != REMOTE:  # global-domain local BC: edge shard keeps its plane
        new_lo = jnp.where(_edge_scalar(g, axis, -1), lo, new_lo)
    if bc_hi != REMOTE:
        new_hi = jnp.where(_edge_scalar(g, axis, 1), hi, new_hi)
    a = set_plane(a, axis, 1, new_lo)
    a = set_plane(a, axis, n + 1, new_hi)
    return a, err


def all_sum(x, g: Grid):
    """mp_allsum analogue: psum over all mesh axes (inside shard_map);
    identity on a single shard.  Summing over singleton axes too is free
    and marks the result replicated over the WHOLE mesh, which shard_map's
    varying-axes check needs to accept out_specs=P()."""
    if not g.sharded:
        return x
    return jax.lax.psum(x, g.mesh_axes)


def synchronize_jf(f: FieldState, g: Grid) -> FieldState:
    """synchronize_jf (remote.c:417-508): local adjust then shared-face sum
    of the tangential current components."""
    f = adjust_jf(f, g)
    out = {name: getattr(f, name) for name in _JF}
    for axis, cross in _sync_axes(g):
        for t in _axes_of(axis):
            out[_JF[t]], _ = _combine_shared(out[_JF[t]], axis, g, cross,
                                             "sum")
    return f.replace(**out)


def synchronize_rho(f: FieldState, g: Grid) -> FieldState:
    """synchronize_rho (remote.c:534-619): local adjust; shared-face rhof sum
    and rhob average (rhob is accumulated locally pre-doubled)."""
    f = adjust_rhof(f, g)
    f = adjust_rhob(f, g)
    rhof, rhob = f.rhof, f.rhob
    for axis, cross in _sync_axes(g):
        rhof, _ = _combine_shared(rhof, axis, g, cross, "sum")
        rhob, _ = _combine_shared(rhob, axis, g, cross, "avg")
    return f.replace(rhof=rhof, rhob=rhob)


def synchronize_tang_e_norm_b(f: FieldState, g: Grid):
    """synchronize_tang_e_norm_b (remote.c:298-415): adjusts, then averages
    shared-face normal cB and tangential E/TCA; returns (fields, global
    desynchronization error)."""
    f = adjust_tang_e(f, g)
    f = adjust_norm_b(f, g)
    err = jnp.zeros((), jnp.float32)
    out = {n: getattr(f, n) for n in (_CB + _E + _TCA)}
    for axis, cross in _sync_axes(g):
        name = _CB[axis]
        out[name], e = _combine_shared(out[name], axis, g, cross, "avg",
                                       want_err=True)
        err = err + e
        for t in _axes_of(axis):
            ename = _E[t]
            out[ename], e = _combine_shared(out[ename], axis, g, cross,
                                            "avg", want_err=True)
            err = err + e
            tname = _TCA[t]
            out[tname], _ = _combine_shared(out[tname], axis, g, cross, "avg")
    return f.replace(**out), all_sum(err, g)


# ---------------------------------------------------------------------------
# advance_b (advance_b_pipeline.h:57-59 + boundary planes, advance_b_pipeline.cc)
# ---------------------------------------------------------------------------

def advance_b(f: FieldState, g: Grid, frac: float) -> FieldState:
    """Faraday (half/full) step: cB -= frac*c*dt * curl E.

    Updates cbx over x in 1..nx+1, y,z in 1..n (plus the symmetric statements
    for cby/cbz), exactly the interior + high-boundary-plane extent the
    reference covers with its separate exterior loops.  Needs no ghosts.
    """
    px = frac * g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = frac * g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = frac * g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    ex, ey, ez = f.ex, f.ey, f.ez

    # cbx[z,y,x] -= py*(ez[z,y+1,x]-ez[z,y,x]) - pz*(ey[z+1,y,x]-ey[z,y,x])
    dcbx = (py * (ez[_sl3(INT, HI, INTH)] - ez[_sl3(INT, INT, INTH)])
            - pz * (ey[_sl3(HI, INT, INTH)] - ey[_sl3(INT, INT, INTH)]))
    cbx = _sladd(f.cbx, _sl3(INT, INT, INTH), -dcbx)

    dcby = (pz * (ex[_sl3(HI, INTH, INT)] - ex[_sl3(INT, INTH, INT)])
            - px * (ez[_sl3(INT, INTH, HI)] - ez[_sl3(INT, INTH, INT)]))
    cby = _sladd(f.cby, _sl3(INT, INTH, INT), -dcby)

    dcbz = (px * (ey[_sl3(INTH, INT, HI)] - ey[_sl3(INTH, INT, INT)])
            - py * (ex[_sl3(INTH, HI, INT)] - ex[_sl3(INTH, INT, INT)]))
    cbz = _sladd(f.cbz, _sl3(INTH, INT, INT), -dcbz)

    return f.replace(cbx=cbx, cby=cby, cbz=cbz)


# ---------------------------------------------------------------------------
# advance_e (advance_e_pipeline.h:50-76; TCA radiation-damped exponential
# differencing of Ampere's law)
# ---------------------------------------------------------------------------

def advance_e(f: FieldState, g: Grid, m: MaterialCoeffs,
              damp: float = 0.0) -> FieldState:
    """Advance E a full step; fills tang-B ghosts, updates every E edge
    (interior + boundary planes in one fused pass) then applies
    local_adjust_tang_e.  Matches advance_e_pipeline.cc:60-210 + vacuum
    variant (material coefficients broadcast as scalars)."""
    f = ghost_tang_b(f, g)

    px = (1 + damp) * g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = (1 + damp) * g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = (1 + damp) * g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    cj = g.dt / g.eps0

    # ex over x in 1..nx, y in 1..ny+1, z in 1..nz+1
    t = _sl3(INTH, INTH, INT)
    ym = _sl3(INTH, LOH, INT)   # (x, y-1, z)
    zm = _sl3(LOH, INTH, INT)   # (x, y, z-1)
    tcax = ((py * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[ym] * _slc(m.rmuz, ym))
             - pz * (f.cby[t] * _slc(m.rmuy, t) - f.cby[zm] * _slc(m.rmuy, zm)))
            - damp * f.tcax[t])
    ex = (_slc(m.decayx, t) * f.ex[t]
          + _slc(m.drivex, t) * (tcax - cj * f.jfx[t]))
    new_tcax = slset(f.tcax, t, tcax)
    new_ex = slset(f.ex, t, ex)

    # ey over y in 1..ny, z in 1..nz+1, x in 1..nx+1
    t = _sl3(INTH, INT, INTH)
    zm = _sl3(LOH, INT, INTH)
    xm = _sl3(INTH, INT, LOH)
    tcay = ((pz * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[zm] * _slc(m.rmux, zm))
             - px * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[xm] * _slc(m.rmuz, xm)))
            - damp * f.tcay[t])
    ey = (_slc(m.decayy, t) * f.ey[t]
          + _slc(m.drivey, t) * (tcay - cj * f.jfy[t]))
    new_tcay = slset(f.tcay, t, tcay)
    new_ey = slset(f.ey, t, ey)

    # ez over z in 1..nz, x in 1..nx+1, y in 1..ny+1
    t = _sl3(INT, INTH, INTH)
    xm = _sl3(INT, INTH, LOH)
    ym = _sl3(INT, LOH, INTH)
    tcaz = ((px * (f.cby[t] * _slc(m.rmuy, t) - f.cby[xm] * _slc(m.rmuy, xm))
             - py * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[ym] * _slc(m.rmux, ym)))
            - damp * f.tcaz[t])
    ez = (_slc(m.decayz, t) * f.ez[t]
          + _slc(m.drivez, t) * (tcaz - cj * f.jfz[t]))
    new_tcaz = slset(f.tcaz, t, tcaz)
    new_ez = slset(f.ez, t, ez)

    f = f.replace(ex=new_ex, ey=new_ey, ez=new_ez,
                  tcax=new_tcax, tcay=new_tcay, tcaz=new_tcaz)
    return adjust_tang_e(f, g)


def compute_curl_b(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_curl_b (init: seed TCA from curl B without damping/E update)."""
    px = g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    f = ghost_tang_b(f, g)

    t = _sl3(INTH, INTH, INT)
    ym = _sl3(INTH, LOH, INT)
    zm = _sl3(LOH, INTH, INT)
    tcax = (py * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[ym] * _slc(m.rmuz, ym))
            - pz * (f.cby[t] * _slc(m.rmuy, t) - f.cby[zm] * _slc(m.rmuy, zm)))
    new_tcax = slset(f.tcax, t, tcax)

    t = _sl3(INTH, INT, INTH)
    zm = _sl3(LOH, INT, INTH)
    xm = _sl3(INTH, INT, LOH)
    tcay = (pz * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[zm] * _slc(m.rmux, zm))
            - px * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[xm] * _slc(m.rmuz, xm)))
    new_tcay = slset(f.tcay, t, tcay)

    t = _sl3(INT, INTH, INTH)
    xm = _sl3(INT, INTH, LOH)
    ym = _sl3(INT, LOH, INTH)
    tcaz = (px * (f.cby[t] * _slc(m.rmuy, t) - f.cby[xm] * _slc(m.rmuy, xm))
            - py * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[ym] * _slc(m.rmux, ym)))
    new_tcaz = slset(f.tcaz, t, tcaz)

    f = f.replace(tcax=new_tcax, tcay=new_tcay, tcaz=new_tcaz)
    return adjust_tang_e(f, g)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def clear_jf(f: FieldState) -> FieldState:
    return f.replace(jfx=jnp.zeros_like(f.jfx), jfy=jnp.zeros_like(f.jfy),
                     jfz=jnp.zeros_like(f.jfz))


def clear_rhof(f: FieldState) -> FieldState:
    return f.replace(rhof=jnp.zeros_like(f.rhof))


# ---------------------------------------------------------------------------
# Divergence cleaning (Marder passes)
# ---------------------------------------------------------------------------

def compute_div_e_err(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_div_e_err_pipeline.h:48-52 over every node 1..n+1."""
    f = ghost_norm_e(f, g)
    px = g.rdx if g.gnx > 1 else 0.0
    py = g.rdy if g.gny > 1 else 0.0
    pz = g.rdz if g.gnz > 1 else 0.0
    cj = 1.0 / g.eps0

    t = _sl3(INTH, INTH, INTH)
    xm = _sl3(INTH, INTH, LOH)
    ym = _sl3(INTH, LOH, INTH)
    zm = _sl3(LOH, INTH, INTH)
    err = _slc(m.nonconductive, t) * (
        px * (_slc(m.epsx, t) * f.ex[t] - _slc(m.epsx, xm) * f.ex[xm])
        + py * (_slc(m.epsy, t) * f.ey[t] - _slc(m.epsy, ym) * f.ey[ym])
        + pz * (_slc(m.epsz, t) * f.ez[t] - _slc(m.epsz, zm) * f.ez[zm])
        - cj * (f.rhof[t] + f.rhob[t]))
    f = f.replace(div_e_err=slset(f.div_e_err, t, err))
    return adjust_div_e_err(f, g)


def compute_rhob(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_rhob_pipeline.h:47-51: rhob = div(eps eps0 E) - rhof at nodes."""
    f = ghost_norm_e(f, g)
    px = g.eps0 * g.rdx if g.gnx > 1 else 0.0
    py = g.eps0 * g.rdy if g.gny > 1 else 0.0
    pz = g.eps0 * g.rdz if g.gnz > 1 else 0.0

    t = _sl3(INTH, INTH, INTH)
    xm = _sl3(INTH, INTH, LOH)
    ym = _sl3(INTH, LOH, INTH)
    zm = _sl3(LOH, INTH, INTH)
    rhob = _slc(m.nonconductive, t) * (
        px * (_slc(m.epsx, t) * f.ex[t] - _slc(m.epsx, xm) * f.ex[xm])
        + py * (_slc(m.epsy, t) * f.ey[t] - _slc(m.epsy, ym) * f.ey[ym])
        + pz * (_slc(m.epsz, t) * f.ez[t] - _slc(m.epsz, zm) * f.ez[zm])
        - f.rhof[t])
    f = f.replace(rhob=slset(f.rhob, t, rhob))
    return adjust_rhob(f, g)


def compute_rms_div_e_err(f: FieldState, g: Grid):
    """RMS div-E error with half/quarter weights on shared/boundary nodes
    (compute_rms_div_e_err_pipeline.c:70-140).  Shard-local partial; the
    caller all-reduces (mp_allsum analogue) when sharded."""
    e = f.div_e_err[_sl3(INTH, INTH, INTH)].astype(jnp.float32) ** 2
    w = 1.0
    for axis, n in ((0, g.nx), (1, g.ny), (2, g.nz)):
        wax = jnp.ones((e.shape[_arr_axis(axis)],), jnp.float32)
        wax = wax.at[0].set(0.5).at[-1].set(0.5)
        shape = [1, 1, 1]
        shape[_arr_axis(axis)] = -1
        w = w * wax.reshape(shape)
    num = jnp.sum(e * w) * g.dV
    den = jnp.float32(g.nx * g.ny * g.nz) * g.dV
    return num, den


def clean_div_e(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """clean_div_e_pipeline.h:52-57 Marder pass over every E edge."""
    rdx = g.rdx if g.gnx > 1 else 0.0
    rdy = g.rdy if g.gny > 1 else 0.0
    rdz = g.rdz if g.gnz > 1 else 0.0
    alphadt = 0.3888889 / (rdx * rdx + rdy * rdy + rdz * rdz)
    px, py, pz = alphadt * rdx, alphadt * rdy, alphadt * rdz
    err = f.div_e_err

    t = _sl3(INTH, INTH, INT)
    xp = _sl3(INTH, INTH, HI)
    ex = _sladd(f.ex, t, _slc(m.drivex, t) * px * (err[xp] - err[t]))

    t = _sl3(INTH, INT, INTH)
    yp = _sl3(INTH, HI, INTH)
    ey = _sladd(f.ey, t, _slc(m.drivey, t) * py * (err[yp] - err[t]))

    t = _sl3(INT, INTH, INTH)
    zp = _sl3(HI, INTH, INTH)
    ez = _sladd(f.ez, t, _slc(m.drivez, t) * pz * (err[zp] - err[t]))

    return f.replace(ex=ex, ey=ey, ez=ez)


def compute_div_b_err(f: FieldState, g: Grid) -> FieldState:
    """compute_div_b_err_pipeline.cc:45-47 over cells 1..n."""
    px = g.rdx if g.gnx > 1 else 0.0
    py = g.rdy if g.gny > 1 else 0.0
    pz = g.rdz if g.gnz > 1 else 0.0
    t = _sl3(INT, INT, INT)
    err = (px * (f.cbx[_sl3(INT, INT, HI)] - f.cbx[t])
           + py * (f.cby[_sl3(INT, HI, INT)] - f.cby[t])
           + pz * (f.cbz[_sl3(HI, INT, INT)] - f.cbz[t]))
    return f.replace(div_b_err=slset(f.div_b_err, t, err))


def compute_rms_div_b_err(f: FieldState, g: Grid):
    """Interior-cell RMS of div-B error (compute_rms_div_b_err_pipeline.c)."""
    e = f.div_b_err[_sl3(INT, INT, INT)].astype(jnp.float32) ** 2
    num = jnp.sum(e) * g.dV
    den = jnp.float32(g.nx * g.ny * g.nz) * g.dV
    return num, den


def clean_div_b(f: FieldState, g: Grid) -> FieldState:
    """clean_div_b Marder pass: cb += alphadt * grad(div_b_err), faces 1..n+1."""
    f = ghost_div_b(f, g)
    rdx = g.rdx if g.gnx > 1 else 0.0
    rdy = g.rdy if g.gny > 1 else 0.0
    rdz = g.rdz if g.gnz > 1 else 0.0
    alphadt = 0.3888889 / (rdx * rdx + rdy * rdy + rdz * rdz)
    px, py, pz = alphadt * rdx, alphadt * rdy, alphadt * rdz
    err = f.div_b_err

    t = _sl3(INT, INT, INTH)
    xm = _sl3(INT, INT, LOH)
    cbx = _sladd(f.cbx, t, px * (err[t] - err[xm]))

    t = _sl3(INT, INTH, INT)
    ym = _sl3(INT, LOH, INT)
    cby = _sladd(f.cby, t, py * (err[t] - err[ym]))

    t = _sl3(INTH, INT, INT)
    zm = _sl3(LOH, INT, INT)
    cbz = _sladd(f.cbz, t, pz * (err[t] - err[zm]))

    f = f.replace(cbx=cbx, cby=cby, cbz=cbz)
    return adjust_norm_b(f, g)


# ---------------------------------------------------------------------------
# Field energies (energy_f_pipeline.h REDUCE_EN + 0.5*eps0*dV scaling)
# ---------------------------------------------------------------------------

def energy_f(f: FieldState, g: Grid, m: MaterialCoeffs):
    """Returns the 6-vector [ex, ey, ez, bx, by, bz] field energies
    (shard-local partial; psum when sharded)."""
    def esum(a, eps, off1_axis, off2_axis):
        t = _sl3(INT, INT, INT)
        total = _slc(eps, t) * a[t] ** 2
        for offs in ((off1_axis,), (off2_axis,), (off1_axis, off2_axis)):
            sl = [INT, INT, INT]
            for ax in offs:
                sl[_arr_axis(ax)] = HI
            sl = tuple(sl)
            total = total + _slc(eps, sl) * a[sl] ** 2
        return 0.25 * jnp.sum(total)

    def bsum(a, rmu, off_axis):
        t = _sl3(INT, INT, INT)
        sl = [INT, INT, INT]
        sl[_arr_axis(off_axis)] = HI
        sl = tuple(sl)
        return 0.5 * jnp.sum(_slc(rmu, t) * a[t] ** 2
                             + _slc(rmu, sl) * a[sl] ** 2)

    v0 = 0.5 * g.eps0 * g.dV
    en = jnp.stack([
        esum(f.ex, m.epsx, 1, 2),
        esum(f.ey, m.epsy, 2, 0),
        esum(f.ez, m.epsz, 0, 1),
        bsum(f.cbx, m.rmux, 0),
        bsum(f.cby, m.rmuy, 1),
        bsum(f.cbz, m.rmuz, 2),
    ])
    return v0 * en
