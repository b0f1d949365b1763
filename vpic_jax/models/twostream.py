"""1-D two-stream instability deck.

The reference is a 1/2/3-D code (/root/reference/README.md:3-30) but every
other sample deck here is 2-D or 3-D; this deck pins the degenerate-axis
(ny = nz = 1) paths.  Physics: two symmetric counter-streaming cold-ish
electron beams over a neutralizing immobile ion background in a periodic
box.  The electrostatic two-stream instability pumps beam kinetic energy
into longitudinal E-field energy, growing exponentially out of shot noise
at rate ~ wpe/2 until trapping saturates it -- field growth by orders of
magnitude with total energy conserved is the regression oracle
(tests/test_twostream.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..deck import Simulation


@dataclass
class TwoStreamParams:
    seed: int = 0
    nx: int = 64
    Lx: float = 2.0 * math.pi * 3.0   # ~3 fastest-growing wavelengths
    nppc: float = 64.0                # per beam
    v0: float = 0.2                   # beam drift (momentum/mc)
    vth: float = 0.005                # beam thermal spread
    mi_me: float = 1836.0
    cfl_req: float = 0.98
    wpedt_max: float = 0.2
    sort_interval: int = 25


def build(p: TwoStreamParams = TwoStreamParams()) -> Simulation:
    sim = Simulation(seed=p.seed)
    sim.seed_entropy(p.seed)
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    n0 = 1.0
    wpe = math.sqrt(n0 * ec * ec / (me * eps0))

    # transverse box: one cell, same physical size as a longitudinal cell
    dx = p.Lx / p.nx
    Ly = Lz = dx

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, Ly, Lz, p.nx, 1, 1)
    dt = min(p.cfl_req * dg / c, p.wpedt_max / wpe)
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, Ly, Lz), (p.nx, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.clean_div_e_interval = 50
    sim.clean_div_b_interval = 50
    sim.sync_shared_interval = 50

    Ne = int(p.nppc * p.nx)          # per beam
    vol = p.Lx * Ly * Lz
    we = 0.5 * n0 * vol / Ne         # each beam carries half the density

    electron = sim.define_species("electron", -ec, me, 2.4 * Ne, -1,
                                  p.sort_interval, 1)
    ion = sim.define_species("ion", ec, me * p.mi_me, 2.4 * Ne, -1,
                             4 * p.sort_interval, 1)

    rng = sim.rng(0)
    for sgn in (1.0, -1.0):
        xs = rng.uniform(0, p.Lx, Ne)
        ys = rng.uniform(0, Ly, Ne)
        zs = rng.uniform(0, Lz, Ne)
        ux = rng.normal(sgn * p.v0, p.vth, Ne)
        sim.inject_particles(electron, xs, ys, zs, ux, 0.0, 0.0, we)
        # cold stationary ions carry the neutralizing charge
        xi = rng.uniform(0, p.Lx, Ne)
        yi = rng.uniform(0, Ly, Ne)
        zi = rng.uniform(0, Lz, Ne)
        sim.inject_particles(ion, xi, yi, zi, 0.0, 0.0, 0.0, we)

    sim.meta = dict(wpe=wpe, dt=dt, Ne=Ne, we=we, v0=p.v0)
    return sim
