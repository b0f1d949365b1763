"""Field <-> particle interface arrays.

Re-design of src/sf_interface/:

* ``load_interpolator``  <- interpolator_array_pipeline.cc:21-126.  Produces a
  flat (nv, 18) coefficient table (rows indexed by voxel) so the particle push
  gathers one contiguous 72-byte row per particle.
* ``unload_accumulator`` <- unload_accumulator_pipeline.cc:17-137.  Folds the
  (nv, 12) quarter-face current accumulator into the Yee-edge jf fields.
  The reference's (1 + n_pipeline) accumulator replicas + deterministic tree
  reduction (sf_interface.h:107-158, reduce_accumulators) are unnecessary
  here: deposition is one XLA scatter-add into a single accumulator (see
  ops/push.py), so clear = jnp.zeros and reduce = identity.

Coefficient row layout (matches interpolator_t, sf_interface.h:62-80):
  0 ex        1 dexdy    2 dexdz    3 d2exdydz
  4 ey        5 deydz    6 deydx    7 d2eydzdx
  8 ez        9 dezdx   10 dezdy   11 d2ezdxdy
 12 cbx      13 dcbxdx  14 cby     15 dcbydy   16 cbz  17 dcbzdz

Accumulator column layout (matches accumulator_t, sf_interface.h:115-131):
  jx[0..3], jy[0..3], jz[0..3] quarter-face currents.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grid import Grid
from ..state import FieldState
from .fields import HI, INT, INTH, LO, LOH, _sl3, _sladd

FOURTH = 0.25
HALF = 0.5


def load_interpolator(f: FieldState, g: Grid):
    """Build the (nv, 18) interpolation-coefficient table.

    E components use a bilinear fit in their two transverse directions
    (value, two slopes, one cross term); B components a linear fit along
    their own axis -- exactly the reference's stencil.
    """
    coeffs = jnp.zeros((g.NZ, g.NY, g.NX, 18), jnp.float32)
    t = _sl3(INT, INT, INT)            # voxel (x, y, z), interior

    def quads(a, ax1, ax2):
        """w0=a(t), w1=a(+ax1), w2=a(+ax2), w3=a(+ax1+ax2)."""
        sl1 = [INT, INT, INT]
        sl1[2 - ax1] = HI
        sl2 = [INT, INT, INT]
        sl2[2 - ax2] = HI
        sl3_ = [INT, INT, INT]
        sl3_[2 - ax1] = HI
        sl3_[2 - ax2] = HI
        w0 = a[t]
        w1 = a[tuple(sl1)]
        w2 = a[tuple(sl2)]
        w3 = a[tuple(sl3_)]
        return (FOURTH * ((w3 + w0) + (w1 + w2)),
                FOURTH * ((w3 - w0) + (w1 - w2)),
                FOURTH * ((w3 - w0) - (w1 - w2)),
                FOURTH * ((w3 + w0) - (w1 + w2)))

    def lin(a, ax):
        sl1 = [INT, INT, INT]
        sl1[2 - ax] = HI
        w0 = a[t]
        w1 = a[tuple(sl1)]
        return HALF * (w1 + w0), HALF * (w1 - w0)

    ex, dexdy, dexdz, d2exdydz = quads(f.ex, 1, 2)
    ey, deydz, deydx, d2eydzdx = quads(f.ey, 2, 0)
    ez, dezdx, dezdy, d2ezdxdy = quads(f.ez, 0, 1)
    cbx, dcbxdx = lin(f.cbx, 0)
    cby, dcbydy = lin(f.cby, 1)
    cbz, dcbzdz = lin(f.cbz, 2)

    stacked = jnp.stack([ex, dexdy, dexdz, d2exdydz,
                         ey, deydz, deydx, d2eydzdx,
                         ez, dezdx, dezdy, d2ezdxdy,
                         cbx, dcbxdx, cby, dcbydy, cbz, dcbzdz], axis=-1)
    coeffs = coeffs.at[INT, INT, INT, :].set(stacked)
    return coeffs.reshape(g.nv, 18)


def unload_accumulator(f: FieldState, acc, g: Grid) -> FieldState:
    """acc (nv, 12) quarter-face currents -> jf Yee-edge currents.

    jfx(x,y,z) += cx*( a(x,y,z).jx0 + a(x,y-1,z).jx1 + a(x,y,z-1).jx2
                       + a(x,y-1,z-1).jx3 )   over x,y,z in 1..n+1
    with cx = 0.25*rdy*rdz/dt (cyclic for y,z).  Ghost accumulator rows are
    zero by construction (particles only ever occupy interior voxels).
    """
    a = acc.reshape(g.NZ, g.NY, g.NX, 12)
    cx = 0.25 * g.rdy * g.rdz / g.dt
    cy = 0.25 * g.rdz * g.rdx / g.dt
    cz = 0.25 * g.rdx * g.rdy / g.dt

    t = _sl3(INTH, INTH, INTH)

    def fold(col0, c, ax1, ax2):
        """col0..col0+3 columns combined at offsets (0,0), (-ax1), (-ax2),
        (-ax1-ax2)."""
        s0 = list(t)
        s1 = list(t)
        s1[2 - ax1] = LOH
        s2 = list(t)
        s2[2 - ax2] = LOH
        s3 = list(t)
        s3[2 - ax1] = LOH
        s3[2 - ax2] = LOH
        return c * (a[tuple(s0) + (col0,)] + a[tuple(s1) + (col0 + 1,)]
                    + a[tuple(s2) + (col0 + 2,)] + a[tuple(s3) + (col0 + 3,)])

    jfx = _sladd(f.jfx, t, fold(0, cx, 1, 2))
    jfy = _sladd(f.jfy, t, fold(4, cy, 2, 0))
    jfz = _sladd(f.jfz, t, fold(8, cz, 0, 1))
    return f.replace(jfx=jfx, jfy=jfy, jfz=jfz)
