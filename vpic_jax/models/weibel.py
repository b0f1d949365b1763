"""Weibel-instability deck (analogue of the reference's
test/unit/energy_comparison/weibel_driver.cc physics regression): a periodic
box with temperature-anisotropic electrons (T_perp >> T_par) over a neutral
drifting-free ion background.  The anisotropy drives magnetic filamentation;
the energy history (field growth out of particle kinetic energy while total
energy stays conserved) is the regression oracle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..deck import Simulation, everywhere


@dataclass
class WeibelParams:
    seed: int = 0
    nx: int = 32
    ny: int = 32
    nz: int = 1
    Lx: float = 16.0
    Ly: float = 16.0
    Lz: float = 0.5
    nppc: float = 32.0       # per species
    uth_perp: float = 0.4    # electron thermal momentum, perp (y,z)
    uth_par: float = 0.1     # electron thermal momentum, par (x)
    mi_me: float = 1836.0
    cfl_req: float = 0.98
    wpedt_max: float = 0.2
    topology: tuple = (1, 1, 1)
    sort_interval: int = 25


def build(p: WeibelParams = WeibelParams()) -> Simulation:
    sim = Simulation(seed=p.seed)
    sim.seed_entropy(p.seed)
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    n0 = 1.0
    wpe = math.sqrt(n0 * ec * ec / (me * eps0))

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    dt = min(p.cfl_req * dg / c, p.wpedt_max / wpe)
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, p.Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.clean_div_e_interval = 50
    sim.clean_div_b_interval = 50
    sim.sync_shared_interval = 50

    n_cells = p.nx * p.ny * p.nz
    Ne = int(p.nppc * n_cells)
    n_shards = p.topology[0] * p.topology[1] * p.topology[2]
    vol = p.Lx * p.Ly * p.Lz
    we = n0 * vol / Ne

    electron = sim.define_species("electron", -ec, me, 1.2 * Ne / n_shards,
                                  -1, p.sort_interval, 1)
    ion = sim.define_species("ion", ec, me * p.mi_me, 1.2 * Ne / n_shards,
                             -1, 4 * p.sort_interval, 1)

    rng = sim.rng(0)
    xs = rng.uniform(0, p.Lx, Ne)
    ys = rng.uniform(0, p.Ly, Ne)
    zs = rng.uniform(0, p.Lz, Ne)
    ex_ = rng.normal(0, p.uth_par, Ne)
    ey_ = rng.normal(0, p.uth_perp, Ne)
    ez_ = rng.normal(0, p.uth_perp, Ne)
    uthi = p.uth_par / math.sqrt(p.mi_me)
    ix_ = rng.normal(0, uthi, Ne)
    iy_ = rng.normal(0, uthi, Ne)
    iz_ = rng.normal(0, uthi, Ne)
    sim.inject_particles(electron, xs, ys, zs, ex_, ey_, ez_, we)
    sim.inject_particles(ion, xs, ys, zs, ix_, iy_, iz_, we)

    sim.meta = dict(wpe=wpe, dt=dt, Ne=Ne, we=we)
    return sim
