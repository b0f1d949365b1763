#!/usr/bin/env python
"""10k-step harris energy-drift measurement (BASELINE.md axis: total
energy conserved to ~1e-6-level over 10k steps).  Runs on the default JAX
device in scan chunks; prints the relative total-energy drift every 1000
steps.

Usage: drift_10k.py [nx ny nppc [nsteps]] [--damp D] [--gold]

--gold replicates the reference deck's EXACT particle load (bit-exact
SFMT rng(0) stream under seed_entropy(0)) so the drift curve is
same-trajectory comparable to scripts/run_reference_drift.sh.

--damp 0 isolates numerical (non-)conservation: the deck default
damp=0.001 is TCA radiation damping, which REMOVES energy by design
(a secular ~-1e-6/step on this config), so the conservation axis must
be measured with damping off.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from vpic_jax.models import harris
from vpic_jax.utils.compile_cache import enable_compile_cache


def main():
    enable_compile_cache()
    a = sys.argv[1:]
    damp = 0.001
    if "--damp" in a:
        k = a.index("--damp")
        damp = float(a[k + 1])
        del a[k:k + 2]
    gold = "--gold" in a
    a = [x for x in a if not x.startswith("--")]
    nx, ny, nppc = (int(x) for x in a[:3]) if len(a) >= 3 else (64, 64, 64)
    nsteps = int(a[3]) if len(a) > 3 else 10000
    chunk = 500
    p = harris.HarrisParams(nx=nx, ny=ny, nppc=nppc, damp=damp,
                            gold_load=gold)
    sim = harris.build(p)
    state = sim.initialize()
    adv = sim.make_multi_step(chunk)
    e0v = np.asarray(sim.energies(state), np.float64)
    print("step 0 energies (ex ey ez bx by bz sp0 sp1):",
          " ".join(f"{v:.7e}" for v in e0v), flush=True)
    e0 = float(e0v.sum())
    t0 = time.time()
    done = 0
    while done < nsteps:
        state = adv(state)
        done += chunk
        if done % 1000 == 0:
            e = float(np.asarray(sim.energies(state)).sum())
            print(f"step {done:6d}  drift {(e - e0) / e0:+.3e}  "
                  f"({(time.time() - t0):.0f}s)", flush=True)
    e = float(np.asarray(sim.energies(state)).sum())
    print(f"FINAL: {nsteps} steps, relative total-energy drift "
          f"{(e - e0) / e0:+.3e}")


if __name__ == "__main__":
    main()
