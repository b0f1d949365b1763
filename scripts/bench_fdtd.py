#!/usr/bin/env python
"""FDTD field-solve benchmark: the sample/bench/fdtd_scaling analogue.

Times the pure Maxwell phase (advance_b x2 + advance_e + interpolator
rebuild) from one scanned 64-step dispatch at several grid sizes, and the
same field phase on a virtual 8-device mesh to expose halo-exchange
overhead (fdtd_scaling measures comm overhead the same way).
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

import vpic_jax as vt


def build(nx, ny, nz, topology=(1, 1, 1)):
    sim = vt.Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, nx, ny, nz, *topology)
    sim.define_timestep(0.95 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (nx, ny, nz),
                             topology=topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.set_region_field(vt.everywhere,
                         ey=lambda x, y, z: np.cos(2 * np.pi * x))
    return sim


def bench(nx, ny, nz, topology=(1, 1, 1), n_steps=64):
    sim = build(nx, ny, nz, topology)
    state = sim.initialize()
    adv = sim.make_multi_step(n_steps)
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    t0 = time.time()
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    el = time.time() - t0
    nv = nx * ny * nz
    print(f"{nx}x{ny}x{nz} topo={topology}  {el / n_steps * 1e3:8.3f} "
          f"ms/step  {nv * n_steps / el / 1e6:8.1f} Mcell-updates/s",
          flush=True)


if __name__ == "__main__":
    for shape in ((64, 64, 1), (256, 256, 1), (64, 64, 64)):
        bench(*shape)
