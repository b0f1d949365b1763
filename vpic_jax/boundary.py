"""Particle boundary interaction + cross-shard migration.

Re-design of src/boundary/boundary_p.cc:36-518 for the SPMD device-mesh
execution model:

* The reference walks a dynamic mover list in reverse, packs
  ``particle_injector_t`` records into per-face MPI buffers, resizes storage
  by a silver ratio, and backfills holes.  Static-shape equivalent: particles
  that hit a remote face are *parked* by the streak walk (pend code = face),
  packed into fixed-capacity per-face buffers with a cumsum ranking, migrated
  with lax.ppermute over ICI, appended to the live prefix after an O(N)
  stable compaction, and their remaining displacement continued through the
  same streak walk -- repeated ``num_comm_round`` times (vpic.cc:79) to chase
  multi-hop particles.
* Buffer overflow replaces the reference's dynamic resize: overflowing
  particles are dropped with their charge accumulated to rhob -- the same
  semantics as the reference's leftover-mover drop (advance.cc:78-101) --
  and counted for diagnostics.
* Custom particle BCs (ids <= -3: maxwellian_reflux, absorb_tally, ...) are
  dispatched per face to registered handlers, mirroring the particle_bc_t
  interact dispatch (boundary_p.cc:250-255).

Injector record layout (one f32 row; particle_injector_t analogue,
species_advance_aos.h:45-52):
  0:posx 1:posy 2:posz  3:xi 4:yi 5:zi  6:ux 7:uy 8:uz  9:w  10-12:remaining
  displacement.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .grid import FACE_AXIS, FACE_SIDE, Grid
from .ops.push import (CUSTOM_BASE, DONE, SpeciesState, deposit_rhob,
                       gather_rows, invert_perm, streak_walk)

BUF_COLS = 13


def compact(sp: SpeciesState, *extra):
    """Stable partition: live slots to the front (the reference's backfill,
    boundary_p.cc:418-438, as an O(N) scatter instead of per-hole moves).
    ``extra`` arrays are permuted identically."""
    live = sp.live
    live_rank = jnp.cumsum(live.astype(jnp.int32))
    n_live = live_rank[-1] if live.shape[0] else jnp.int32(0)
    dead_rank = jnp.cumsum((~live).astype(jnp.int32))
    dest = jnp.where(live, live_rank - 1, n_live + dead_rank - 1)
    src = invert_perm(dest)
    dx, dy, dz, ux, uy, uz, w, i, live, *moved_extra = gather_rows(
        src, sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz, sp.w, sp.i,
        sp.live, *extra)
    sp = sp.replace(dx=dx, dy=dy, dz=dz, i=i, ux=ux, uy=uy, uz=uz, w=w,
                    live=live, np=n_live)
    return (sp,) + tuple(moved_extra)


def _face_perm(g: Grid, face: int):
    if g.face_partners is not None:
        # irregular domain graph: each rank sends its face-f movers to its
        # join-table partner (explicit flat-rank pairs over the full mesh)
        tab = g.face_partners[face]
        return g.mesh_axes, [(r, p) for r, p in enumerate(tab) if p >= 0]
    axis = FACE_AXIS[face]
    s = FACE_SIDE[face]
    ns = g.topology[axis]
    return g.mesh_axes[axis], [(k, (k + s) % ns) for k in range(ns)]


def _remote_faces(g: Grid):
    if g.face_partners is not None:
        return [f for f in range(6)
                if any(v >= 0 for v in g.face_partners[f])]
    return [f for f in range(6) if g.topology[FACE_AXIS[f]] > 1]


class MigrationStats(NamedTuple):
    n_dropped: jnp.ndarray  # particles lost to buffer/capacity overflow


def _migrate_round(sp: SpeciesState, pend, disp, acc, rhob, g: Grid,
                   qsp: float, mig_cap: int, max_streak: int,
                   n_dropped, vbc=None):
    """One communication round: pack -> ppermute -> unpack -> continue walk."""
    remote_faces = _remote_faces(g)
    if not remote_faces:
        return sp, pend, disp, acc, rhob, n_dropped

    dpx, dpy, dpz = disp
    zi, r = jnp.divmod(sp.i, g.sz)
    yi, xi = jnp.divmod(r, g.sy)
    rows = jnp.stack([sp.dx, sp.dy, sp.dz,
                      xi.astype(jnp.float32), yi.astype(jnp.float32),
                      zi.astype(jnp.float32),
                      sp.ux, sp.uy, sp.uz, sp.w, dpx, dpy, dpz], axis=-1)

    send = {}
    counts = {}
    live = sp.live
    for f in remote_faces:
        mask = pend == f
        rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
        dest = jnp.where(mask, rank, mig_cap)
        buf = jnp.zeros((mig_cap, BUF_COLS), jnp.float32)
        send[f] = buf.at[dest].set(rows, mode="drop")
        n_sel = jnp.sum(mask.astype(jnp.int32))
        counts[f] = jnp.minimum(n_sel, mig_cap)
        # overflow lanes: drop with charge -> rhob (reference drops leftover
        # movers the same way, advance.cc:78-101)
        ovf = mask & (rank >= mig_cap)
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w, qsp,
                            ovf & live)
        n_dropped = n_dropped + jnp.sum(ovf.astype(jnp.int32))
        live = live & ~mask
        pend = jnp.where(mask, DONE, pend)

    sp = sp.replace(live=live, w=jnp.where(live, sp.w, 0.0))
    dpx = jnp.where(live, dpx, 0.0)
    dpy = jnp.where(live, dpy, 0.0)
    dpz = jnp.where(live, dpz, 0.0)

    # Exchange buffers + counts along each face's mesh axis.
    recv, rcount = {}, {}
    for f in remote_faces:
        name, perm = _face_perm(g, f)
        recv[f] = jax.lax.ppermute(send[f], name, perm)
        rcount[f] = jax.lax.ppermute(counts[f].reshape(1), name, perm)[0]

    # Free the holes, then append received particles to the live prefix.
    (sp, pend, dpx, dpy, dpz) = compact(sp, pend, dpx, dpy, dpz)
    cont = jnp.zeros_like(sp.live)

    for f in remote_faces:
        axis = FACE_AXIS[f]
        s = FACE_SIDE[f]
        n_ax = (g.nx, g.ny, g.nz)[axis]
        buf = recv[f]
        n_r = rcount[f]
        row_idx = jax.lax.broadcasted_iota(jnp.int32, (mig_cap, 1), 0)[:, 0]
        valid = row_idx < n_r
        slot = jnp.where(valid, sp.np + row_idx, sp.capacity)
        n_ins = jnp.minimum(n_r, sp.capacity - sp.np)
        n_dropped = n_dropped + (n_r - n_ins)

        # Arrival coordinate transform: exported through the neighbor's face
        # (axis, s) => enters on my opposite side (boundary_p.cc:226 flip).
        pos = [buf[:, 0], buf[:, 1], buf[:, 2]]
        coords = [buf[:, 3].astype(jnp.int32), buf[:, 4].astype(jnp.int32),
                  buf[:, 5].astype(jnp.int32)]
        pos[axis] = -pos[axis]
        coords[axis] = jnp.full_like(coords[axis], n_ax if s < 0 else 1)
        vox = coords[0] + g.NX * (coords[1] + g.NY * coords[2])

        def ins(a, col_vals):
            return a.at[slot].set(col_vals, mode="drop")

        sp = sp.replace(
            dx=ins(sp.dx, pos[0]), dy=ins(sp.dy, pos[1]),
            dz=ins(sp.dz, pos[2]), i=ins(sp.i, vox),
            ux=ins(sp.ux, buf[:, 6]), uy=ins(sp.uy, buf[:, 7]),
            uz=ins(sp.uz, buf[:, 8]), w=ins(sp.w, buf[:, 9]),
            live=ins(sp.live, valid),
            np=sp.np + n_ins)
        dpx = ins(dpx, buf[:, 10])
        dpy = ins(dpy, buf[:, 11])
        dpz = ins(dpz, buf[:, 12])
        pend = ins(pend, jnp.full((mig_cap,), DONE, jnp.int32))
        cont = ins(cont, valid)

    # Continue the received particles' remaining displacement (the move_p
    # continuation, boundary_p.cc:440-494); re-exports set fresh pend codes.
    zi, r = jnp.divmod(sp.i, g.sz)
    yi, xi = jnp.divmod(r, g.sy)
    (pos, disp, coords, u, alive, pend, acc, rhob) = streak_walk(
        g, qsp, sp.w, (sp.dx, sp.dy, sp.dz), (dpx, dpy, dpz), (xi, yi, zi),
        (sp.ux, sp.uy, sp.uz), cont & sp.live, sp.live, pend, acc, rhob,
        max_streak, vbc=vbc)
    vox = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
    sp = sp.replace(dx=pos[0], dy=pos[1], dz=pos[2], i=vox,
                    ux=u[0], uy=u[1], uz=u[2],
                    w=jnp.where(alive, sp.w, 0.0), live=alive,
                    np=jnp.sum(alive.astype(jnp.int32)))
    return sp, pend, disp, acc, rhob, n_dropped


def boundary_p(species: Sequence[SpeciesState], sp_params, pends, disps,
               acc, rhob, g: Grid, num_comm_round: int = 3,
               mig_frac: float = 0.125, max_streak: int = 4,
               custom_handlers: Optional[Dict[int, Callable]] = None,
               key=None, diag=None, vbc=None):
    """Process parked particles for every species: custom-BC dispatch,
    ``num_comm_round`` migration rounds, then leftover drop (+rhob).

    custom_handlers maps face index -> handler with signature
      handler(key, sp, pend, disp, acc, rhob, g, spp, face, diag)
        -> (sp, pend, disp, acc, rhob, diag)
    (the particle_bc_t interact dispatch, boundary_p.cc:250-255); handlers
    consume lanes with pend == CUSTOM_BASE + face and run their own
    streak-walk continuation.  ``diag`` is a dict of named device scalars
    handlers accumulate into (tally counts etc.); it must be initialized
    with a fixed key structure (Simulation.initialize does) so it can ride
    a lax.scan carry.  Returns (species, acc, rhob, n_dropped, diag).
    """
    species = list(species)
    pends = list(pends)
    disps = list(disps)
    n_dropped = jnp.int32(0)
    custom_handlers = custom_handlers or {}
    if key is None:
        key = jax.random.PRNGKey(0)
    if diag is None:
        diag = {}

    def run_handlers(key, sp, pend, disp, acc, rhob, diag, spp):
        for face, handler in custom_handlers.items():
            key, sub = jax.random.split(key)
            sp, pend, disp, acc, rhob, diag = handler(
                sub, sp, pend, disp, acc, rhob, g, spp, face, diag)
        return key, sp, pend, disp, acc, rhob, diag

    for k, spp in enumerate(sp_params):
        sp, pend, disp = species[k], pends[k], disps[k]
        mig_cap = max(64, int(sp.capacity * mig_frac))

        # Custom particle BCs first (boundary_p.cc:250-255 dispatch).
        key, sp, pend, disp, acc, rhob, diag = run_handlers(
            key, sp, pend, disp, acc, rhob, diag, spp)

        for _ in range(num_comm_round):
            sp, pend, disp, acc, rhob, n_dropped = _migrate_round(
                sp, pend, disp, acc, rhob, g, spp.q, mig_cap, max_streak,
                n_dropped, vbc=vbc)
            # Handlers may need to run again for multi-hop arrivals.
            key, sp, pend, disp, acc, rhob, diag = run_handlers(
                key, sp, pend, disp, acc, rhob, diag, spp)

        # Leftover pends: drop with charge -> rhob (advance.cc:78-101).
        leftover = (pend >= 0) & (pend != DONE) & sp.live & \
                   (pend != jnp.int32(6))
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            spp.q, leftover)
        live = sp.live & ~leftover
        n_dropped = n_dropped + jnp.sum(leftover.astype(jnp.int32))
        sp = sp.replace(live=live, w=jnp.where(live, sp.w, 0.0),
                        np=jnp.sum(live.astype(jnp.int32)))
        species[k] = sp
        pends[k] = pend
        disps[k] = disp

    return species, acc, rhob, n_dropped, diag
