"""Hydro (fluid-moment) accumulation: accumulate_hydro_p
(src/species_advance/standard/hydro_p.c:27-166) vectorized.

Per particle: half E kick + half Boris rotate to time-center the momentum,
then trilinear node-centered deposit of the 14 moments
  [jx jy jz rho  px py pz ke  txx tyy tzz tyz tzx txy]
into a (nv, 14) array (hydro_t analogue, sf_interface.h:168-198).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..grid import Grid
from ..state import SpeciesState
from .fields import _combine_shared, _sync_axes, get_plane, set_plane
from .push import _boris_rotate, _interp_fields

N_HYDRO = 14
HYDRO_NAMES = ("jx", "jy", "jz", "rho", "px", "py", "pz", "ke",
               "txx", "tyy", "tzz", "tyz", "tzx", "txy")


def accumulate_hydro_p(hydro, sp: SpeciesState, fcoef, g: Grid, qsp, msp):
    """Add one species' moments into hydro (nv, 14)."""
    c = g.cvac
    mspc = msp * c
    qdt_2mc = (qsp * g.dt) / (2.0 * mspc)
    qdt_4mc2 = qdt_2mc / (2.0 * c)

    rows = fcoef[sp.i]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                                  qdt_2mc)
    ux = sp.ux + hax
    uy = sp.uy + hay
    uz = sp.uz + haz
    usq = ux * ux + uy * uy + uz * uz
    gam = jnp.sqrt(1.0 + usq)
    ke_mc = usq * c / (gam + 1.0)          # c (gamma - 1), robust form
    vz_fac = c / gam
    # half Boris rotate; the reference's angle scalar is qdt_4mc2 * c/gamma,
    # which _boris_rotate produces from arg * rsqrt(1 + u^2) with arg below
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_4mc2 * c)
    vx, vy, vzv = ux * vz_fac, uy * vz_fac, uz * vz_fac

    w = jnp.where(sp.alive, sp.w, 0.0)

    t_q = qsp
    px_, py_, pz_ = mspc * ux, mspc * uy, mspc * uz
    mom = jnp.stack([t_q * vx, t_q * vy, t_q * vzv,
                     jnp.full_like(vx, t_q),
                     px_, py_, pz_, mspc * ke_mc,
                     px_ * vx, py_ * vy, pz_ * vzv,
                     py_ * vzv, pz_ * vx, px_ * vy], axis=-1)  # (N, 14)

    # Cell-moment formulation (see ops/push.accumulate_rho_p): deposit the
    # trilinear basis x moment outer product with ONE (N, 8*14) row
    # scatter-add instead of 8 node scatter-adds per particle, then
    # combine neighbor cells into node values with 8 dense shifted adds.
    q = g.r8V * w
    dx, dy, dz = sp.dx, sp.dy, sp.dz
    basis = jnp.stack([q, q * dx, q * dy, q * dz, q * (dx * dy),
                       q * (dx * dz), q * (dy * dz),
                       q * (dx * (dy * dz))], axis=-1)         # (N, 8)
    vals = (basis[:, :, None] * mom[:, None, :]).reshape(
        -1, 8 * N_HYDRO)
    cm = jnp.zeros((g.nv, 8 * N_HYDRO), jnp.float32).at[sp.i].add(
        vals, mode="drop").reshape(g.NZ, g.NY, g.NX, 8, N_HYDRO)
    hy = hydro.reshape(g.NZ, g.NY, g.NX, N_HYDRO)
    for c in (0, 1):
        for b in (0, 1):
            for a in (0, 1):
                sx, sy, sz = 2 * a - 1, 2 * b - 1, 2 * c - 1
                contrib = (cm[..., 0, :] + sx * cm[..., 1, :]
                           + sy * cm[..., 2, :] + sz * cm[..., 3, :]
                           + (sx * sy) * cm[..., 4, :]
                           + (sx * sz) * cm[..., 5, :]
                           + (sy * sz) * cm[..., 6, :]
                           + (sx * sy * sz) * cm[..., 7, :])
                hy = hy.at[c:, b:, a:].add(
                    contrib[:g.NZ - c, :g.NY - b, :g.NX - a])
    return hy.reshape(g.nv, N_HYDRO)


def synchronize_hydro(hydro, g: Grid):
    """synchronize_hydro_array (hydro_array.c): sum node moments on shared
    faces (periodic wrap / cross-shard) so diagnostics see total values."""
    h = hydro.reshape(g.NZ, g.NY, g.NX, N_HYDRO)
    for axis, cross in _sync_axes(g):
        h, _ = _combine_shared(h, axis, g, cross, "sum")
    return h.reshape(g.nv, N_HYDRO)
