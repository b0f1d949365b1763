#!/usr/bin/env python
"""Benchmark harness: particle pushes/s on one GPU on the 2D harris deck
(analogue of sample/bench/advance_p, which prints Mparticle-pushes/s).

Prints the device on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ...}

``--deck harris3d [nx nz nppc]`` benches the 3-D deck instead (default tier
32^3 x 128 = 4.2M particles); scripts/bench3d.py runs the standard tiers.
Exits non-zero when JAX finds no GPU.
"""

import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 1)[0])


def require_gpu():
    """Enable the compile cache, print the device, fail off-GPU."""
    from vpic_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform != "gpu":
        sys.exit(f"bench: no GPU (platform {d.platform!r})")


def run_deck(deck: str, args):
    import jax
    import numpy as np

    from vpic_jax.models import harris

    if deck == "harris3d":
        nx, nz, nppc = ((int(a) for a in args[:3]) if len(args) >= 3
                        else (32, 32, 128))
        p = harris.HarrisParams(nx=nx, ny=nx, nz=nz, nppc=nppc,
                                Lx=16.0, Ly=16.0, Lz=16.0)
        n_steps = 100
        metric = f"particle_pushes_per_second_per_chip_harris3d_{nx}x{nx}x{nz}x{nppc}"
    else:
        p = harris.HarrisParams(nx=64, ny=64, nppc=64)
        n_steps = 200
        metric = "particle_pushes_per_second_per_chip_harris2d"
    sim = harris.build(p)
    state = sim.initialize()
    # the whole measured segment is ONE dispatch (lax.scan over the
    # advance), as Simulation.run does between diagnostics
    adv = sim.make_multi_step(n_steps)

    # compile + warm up
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    n_particles = sum(int(s.np) for s in state.species)
    e0 = np.asarray(sim.energies(state), np.float64)

    t0 = time.time()
    state = adv(state)
    jax.block_until_ready(state.fields.ex)
    elapsed = time.time() - t0

    pushes_per_s = n_particles * n_steps / elapsed

    # sanity: energy must stay conserved or the number is meaningless.
    # Healthy drift is ~1e-5 per 50 steps on this deck; lost-particle bugs
    # show up at the 1e-3 level, so a 1e-3 bound over the measured steps
    # separates the two.
    e1 = np.asarray(sim.energies(state), np.float64)
    assert np.isfinite(e1).all(), "non-finite energies: benchmark invalid"
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    assert drift < 1e-3, \
        f"energy drift {drift:.2e} over {n_steps} steps: benchmark invalid"

    return {
        "metric": metric,
        "value": pushes_per_s,
        "unit": "pushes/s",
    }


def main():
    args = sys.argv[1:]
    deck = "harris2d"
    if "--deck" in args:
        k = args.index("--deck")
        deck = args[k + 1]
        args = args[k + 2:]
    require_gpu()
    print(json.dumps(run_deck(deck, args)))


if __name__ == "__main__":
    main()
