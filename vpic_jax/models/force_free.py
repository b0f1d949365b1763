"""Force-free (twisted flux-tube) current sheet deck.

Port of /root/reference/sample/force_free:20-180: a periodic 3-D box with
the helical force-free field B = b0 (cos(alpha z), heli sin(alpha z), 0)
and drifting bi-Maxwellian electrons carrying the force-free current
(ions cold and stationary), the discretization-corrected electron drift
vdre *= tan(a dz/2)/(a dz/2) included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .. import deck as D


@dataclass
class ForceFreeParams:
    # physics (reference force_free:34-42)
    mi_me: float = 100.0
    tez_texy: float = 0.8729
    tiz_tixy: float = 1.0
    tixy_texy: float = 0.8729
    wpe_wce: float = 1.926
    ntwist: float = 1.0
    heli: float = 1.0
    taui: float = 20.0
    # numerics (reference: 224 x 96 x 64 at 320 ppc; defaults here are a
    # test-scale version of the same deck -- pass the reference numbers
    # for the production run)
    nx: int = 32
    ny: int = 16
    nz: int = 16
    nppc: float = 8.0
    damp: float = 0.00035
    cfl_req: float = 0.99
    wcedt_max: float = 0.1
    topology: Tuple[int, int, int] = (1, 1, 1)
    seed: int = 7


def build(p: ForceFreeParams = ForceFreeParams()) -> D.Simulation:
    c, eps0 = 1.0, 0.25 / math.pi
    wce, ec, me = 1.0, 1.0, 1.0
    mi = p.mi_me * me
    wci = wce / p.mi_me
    wpe = wce * p.wpe_wce

    b0 = me * wce / ec
    alpha = (wpe / c) * math.sqrt((1 / p.tez_texy - 1)
                                  + (1 / p.tiz_tixy - 1) / p.mi_me)
    lz = 2 * math.pi * p.ntwist / alpha
    lx = p.nx * lz / p.nz
    ly = p.ny * lz / p.nz
    n0 = eps0 * me * wpe * wpe / (ec * ec)
    Npe = n0 * lx * ly * lz
    Ne = int(0.5 * p.nppc * p.nx * p.ny * p.nz)

    vdre = p.heli * (alpha * c / wpe) * (wce / wpe)
    vdre *= math.tan(0.5 * alpha * lz / p.nz) / (0.5 * alpha * lz / p.nz)
    vtxye = vdre
    vtze = vtxye * math.sqrt(p.tez_texy)
    vdri = 0.0
    vtxyi = vtxye * math.sqrt(p.tixy_texy / p.mi_me)
    vtzi = vtxyi * math.sqrt(p.tiz_tixy)

    sim = D.Simulation(seed=p.seed)
    sim.define_units(c, eps0)
    g0 = D.partition_periodic_box(0, 0, 0, lx, ly, lz, p.nx, p.ny, p.nz)
    dt = p.cfl_req * g0.courant_length() / c
    if wce * dt > p.wcedt_max:
        dt = p.wcedt_max / wce
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (lx, ly, lz),
                             (p.nx, p.ny, p.nz), p.topology)
    sim.num_step = int(p.taui / (wci * dt))
    sim.status_interval = 16
    sim.sync_shared_interval = 128
    sim.clean_div_b_interval = 128
    sim.clean_div_e_interval = 128

    nshard = int(np.prod(p.topology))
    electron = sim.define_species("electron", -ec, me,
                                  1.2 * Ne / nshard, sort_interval=16)
    ion = sim.define_species("ion", ec, mi, 1.2 * Ne / nshard,
                             sort_interval=32)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=p.damp)

    sim.set_region_field(
        D.everywhere, bx=lambda x, y, z: b0 * np.cos(alpha * z),
        by=lambda x, y, z: p.heli * b0 * np.sin(alpha * z))

    g = sim.grid
    rng = np.random.default_rng(p.seed)

    w0 = Npe / Ne     # physical particles per macro (reference q = ec*w0)

    def load(sp, vtxy, vtz, vdr):
        rows = []
        for _ in range(Ne):
            x = rng.uniform(0, lx)
            y = rng.uniform(0, ly)
            z = rng.uniform(0, lz)
            # B direction at the Yee-discretized cell center
            tmp = alpha * (g.dz * (int(z / g.dz) + 0.5))
            cs = math.cos(tmp)
            sn = p.heli * math.sin(tmp)
            while True:
                vperp1 = rng.normal(0, vtxy)
                vperp2 = rng.normal(0, vtz)
                vpara = rng.normal(0, vtxy)
                if vperp1 ** 2 + vperp2 ** 2 + vpara ** 2 < 1:
                    break
            s = math.sqrt(1 - vdr * vdr) / (1 + vdr * vpara)
            vperp1 *= s
            vperp2 *= s
            vpara = (vpara + vdr) / (1 + vdr * vpara)
            gam = math.sqrt(max(1 - vperp1 ** 2 - vperp2 ** 2
                                - vpara ** 2, 1e-30))
            rows.append((x, y, z, (-vperp1 * sn + vpara * cs) / gam,
                         (vperp1 * cs + vpara * sn) / gam, vperp2 / gam))
        sim.inject_particles(sp, *np.transpose(rows), w=w0)

    load(electron, vtxye, vtze, vdre)
    load(ion, vtxyi, vtzi, vdri)
    sim.meta = dict(alpha=alpha, b0=b0, vdre=vdre, dt=dt, Ne=Ne, w0=w0)
    return sim
