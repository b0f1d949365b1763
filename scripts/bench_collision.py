#!/usr/bin/env python
"""Collision-model benchmark: the sample/bench/collision analogue.

Exercises all four in-src collision models (hard_sphere, Takizuka-Abe,
Langevin, large_angle_coulomb binary) over a thermal population and
reports particle-collisions/s per model from one scanned 32-step
dispatch.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vpic_jax import collision as C
from vpic_jax.grid import partition_periodic_box
from vpic_jax.state import SpeciesParams, SpeciesState


def make_species(n, uth, g, cap, seed=0):
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, g.nx, (3, n))
    lin = (1 + vox[0]) + g.NX * ((1 + vox[1]) + g.NY * (1 + vox[2]))
    arr = lambda x: jnp.asarray(
        np.concatenate([x, np.zeros(cap - n)]).astype(np.float32))
    live = np.zeros(cap, bool)
    live[:n] = True
    return SpeciesState(
        dx=arr(rng.uniform(-1, 1, n)), dy=arr(rng.uniform(-1, 1, n)),
        dz=arr(rng.uniform(-1, 1, n)),
        i=jnp.asarray(np.concatenate([lin, np.zeros(cap - n)])
                      .astype(np.int32)),
        ux=arr(rng.normal(0, uth, n)), uy=arr(rng.normal(0, uth, n)),
        uz=arr(rng.normal(0, uth, n)), w=arr(np.ones(n)),
        live=jnp.asarray(live), np=jnp.int32(n))


def bench(name, op, sp, g, n_steps=32):
    def many(sp, key):
        def body(carry, step):
            sp, key = carry
            key, sub = jax.random.split(key)
            species, _ = op([sp], None, g, step, sub)
            return (species[0], key), None
        (sp, _), _ = jax.lax.scan(body, (sp, key),
                                  jnp.arange(n_steps, dtype=jnp.int32))
        return sp
    f = jax.jit(many)
    key = jax.random.PRNGKey(0)
    out = f(sp, key)
    jax.block_until_ready(out.ux)
    t0 = time.time()
    out = f(sp, key)
    jax.block_until_ready(out.ux)
    el = time.time() - t0
    n = int(out.np)
    print(f"{name:28s} {el / n_steps * 1e3:8.3f} ms/step   "
          f"{n * n_steps / el / 1e6:8.1f} M particle-collisions/s")


def main():
    n, cap = 1 << 19, 1 << 19
    g = dataclasses.replace(
        partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 16), dt=0.05)
    spp = SpeciesParams("a", 1.0, 1.0, cap)
    sp = make_species(n, 0.2, g, cap)

    bench("hard_sphere (binary)",
          C.make_binary_op(C.hard_sphere_model(0.3, 0.3), 0, 0, spp, spp,
                           sample=1.0, interval=1), sp, g)
    bench("takizuka-abe (binary)",
          C.make_takizuka_abe_op(0, 0, spp, spp, g, log_lambda=10.0,
                                 n0=float(n), interval=1), sp, g)
    bench("large_angle_coulomb (bin.)",
          C.make_binary_op(
              C.large_angle_coulomb_model(1.0, 1.0, 1.0, 1.0, 0.1),
              0, 0, spp, spp, sample=1.0, interval=1), sp, g)
    bench("langevin (unary)",
          C.make_langevin_op(0, spp, kT=0.04, nu=2.0, interval=1), sp, g)


if __name__ == "__main__":
    main()
