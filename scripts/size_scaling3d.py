#!/usr/bin/env python
"""Throughput vs problem size for the 3-D reconnection deck (dev tool).

Usage: size_scaling3d.py
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from vpic_jax.models import reconnection
from vpic_jax.utils.compile_cache import enable_compile_cache


def measure(nx, ny, nz, nppc, n_steps=50):
    p = reconnection.ReconnectionParams(
        nx=nx, ny=ny, nz=nz, nppc=nppc, tau_coll_interval=10 ** 9)
    sim = reconnection.build(p)
    state = sim.initialize()
    adv = sim.make_multi_step(n_steps)
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    n_particles = sum(int(s.np) for s in state.species)
    t0 = time.time()
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    el = time.time() - t0
    print(f"nx={nx} ny={ny} nz={nz} nppc={nppc}  np={n_particles}  "
          f"step={el/n_steps*1e3:7.2f} ms  "
          f"{n_particles*n_steps/el/1e6:8.1f} Mpush/s", flush=True)


if __name__ == "__main__":
    enable_compile_cache()
    for nx, ny, nz, nppc in ((32, 32, 32, 32), (32, 32, 32, 128),
                             (64, 64, 64, 16)):
        try:
            measure(nx, ny, nz, nppc)
        except Exception as e:
            print(f"{nx}^3-ish nppc={nppc}  FAILED: {type(e).__name__}: {e}",
                  flush=True)
