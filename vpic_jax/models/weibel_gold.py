"""Reference-parity Weibel deck: the EXACT simulation of the reference's
committed gold energy history.

This is a faithful port of test/unit/energy_comparison/weibel_driver.cc
(the deck whose output is the committed
test/unit/energy_comparison/energies_gold): a 16x1x1 periodic box,
bi-Maxwellian electrons+ions (vth_x << vth_perp -> Weibel filamentation),
700 steps, divergence cleaning and sync OFF, energies dumped every step.

Unlike models/weibel.py (a generic Weibel deck on our own RNG), the
initial particle load here reproduces the reference's random stream
bit-for-bit via utils/vpic_rng (SFMT-11213 + ziggurat, seed_entropy(1),
single rank, n_rng=2 -- the pool size pinned by matching the gold file's
step-0 particle energies to 1.5e-7).  With identical initial conditions
the energy history can be compared against energies_gold at the
reference's own per-step tolerances (compare_energies.h:42-60 via
weibel_driver.cc:305-330: E-sum 30%, B-sum 3%, particle-sum 1%).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..deck import Simulation
from ..utils.vpic_rng import entropy_rng


@dataclass
class WeibelGoldParams:
    num_step: int = 700
    nx: int = 16
    ny: int = 1
    nz: int = 1
    Lx: float = 2.09439510239320
    Ly: float = 1.0
    Lz: float = 1.0
    nppc: float = 200.0       # macro electrons per cell (= ions per cell)
    mi_me: float = 1836.0
    cfl_req: float = 0.99
    wpedt_max: float = 0.36
    # gold-generation environment: 1 rank, pipeline count 1 -> n_rng 2
    n_rng: int = 2


def build(p: WeibelGoldParams = WeibelGoldParams()) -> Simulation:
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    n0 = 1.0
    vthe = 0.25 / math.sqrt(2.0)
    vthi = 0.25 / math.sqrt(2.0)
    vthex = 0.05 / math.sqrt(2.0)
    vthix = 0.05 / math.sqrt(2.0)
    mi = me * p.mi_me

    sim = Simulation(seed=1)
    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    wpe = c  # c/de with de = 1
    dt = p.cfl_req * dg / c
    if wpe * dt > p.wpedt_max:
        dt = p.wpedt_max / wpe
    sim.define_timestep(dt)
    sim.num_step = p.num_step
    # weibel_driver.cc:123-125: all cleaning/sync off
    sim.clean_div_e_interval = 0
    sim.clean_div_b_interval = 0
    sim.sync_shared_interval = 0

    sim.define_periodic_grid((0.0, -0.5 * p.Ly, -0.5 * p.Lz),
                             (p.Lx, 0.5 * p.Ly, 0.5 * p.Lz),
                             (p.nx, p.ny, p.nz), (1, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)

    Ne = int(p.nppc * p.nx * p.ny * p.nz)
    we = n0 * p.Lx * p.Ly * p.Lz / Ne
    wi = we

    electron = sim.define_species("electron", -ec, me, 2.4 * Ne, -1, 0, 0)
    ion = sim.define_species("ion", ec, mi, 2.4 * Ne, -1, 0, 0)

    # Reference-exact particle load: one shared rng(0) stream, per-particle
    # (x,y,z) uniforms then electron normals then ion normals
    # (weibel_driver.cc:247-277)
    r = entropy_rng(1, p.n_rng, rank=0, world_size=1, index=0)
    xmin, xmax = 0.0, p.Lx
    ymin, ymax = -0.5 * p.Ly, 0.5 * p.Ly
    zmin, zmax = -0.5 * p.Lz, 0.5 * p.Lz
    eles, ions = [], []
    for _ in range(Ne):
        x = r.uniform(xmin, xmax)
        y = r.uniform(ymin, ymax)
        z = r.uniform(zmin, zmax)
        for out, vx, v in ((eles, vthex, vthe), (ions, vthix, vthi)):
            out.append((x, y, z, r.normal(0, vx), r.normal(0, v),
                        r.normal(0, v)))
    sim.inject_particles(electron, *np.transpose(eles), we)
    sim.inject_particles(ion, *np.transpose(ions), wi)

    sim.meta = dict(dt=dt, Ne=Ne, we=we)
    return sim
