#!/usr/bin/env python
"""Two-stream linear growth-rate comparison: reference VPIC vs vpic_jax
(VERDICT round-4 item 7 -- second-deck physics parity).

Fits the exponential growth of the longitudinal E-field energy out of
shot noise on matched decks (vpic_jax/models/twostream.py parameters;
reference runs from scripts/run_reference_twostream.sh, one per seed)
and compares the SEED-AVERAGED rates -- a single 64-ppc, 3-wavelength
box has ~20% mode-competition seed noise in the fitted rate, so the
parity claim is made on the ensemble mean.  Both are also checked
against the analytic cold-symmetric-beam maximum gamma = wpe/sqrt(8)
(warm corrections push the realized rate below it).

Usage: twostream_rate.py [--device] [--seeds N] [--refdir /tmp/ref_ts_]

The repo runs on the CPU unless --device asks for JAX's default device.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def fit_rate(t, e):
    """Growth rate of energy e(t): fit log(e) on the clean exponential
    stretch, 5%..50% of the saturation peak (below that the seeded mode
    is still establishing itself over the shot-noise spectrum; above it
    trapping flattens the rise).  Energy grows at 2*gamma."""
    e = np.asarray(e, np.float64)
    pk = int(np.argmax(e))
    lo, hi = 0.05 * e[pk], 0.5 * e[pk]
    m = (e > lo) & (e < hi)
    m[pk:] = False          # pre-saturation rise only
    idx = np.nonzero(m)[0]
    assert len(idx) >= 4, f"window too small: {m.sum()} points"
    sl = np.polyfit(t[idx], np.log(e[idx]), 1)[0]
    return 0.5 * sl


def main():
    args = sys.argv[1:]
    nseeds = int(args[args.index("--seeds") + 1]) if "--seeds" in args \
        else 5
    refdir = args[args.index("--refdir") + 1] if "--refdir" in args \
        else "/tmp/ref_ts_"
    import jax
    if "--device" not in args:
        jax.config.update("jax_platforms", "cpu")
    from vpic_jax.models import twostream

    g_refs = []
    for s in range(nseeds):
        path = f"{refdir}{s}/energies"
        d = np.loadtxt(path, comments="%")
        ref_dt = 0.2
        with open(path) as fh:
            for line in fh:
                if "timestep" in line:
                    ref_dt = float(line.split("=")[1])
        g_refs.append(fit_rate(d[:, 0] * ref_dt, d[:, 1]))
        print(f"ref  seed {s}: gamma/wpe = {g_refs[-1]:.4f}", flush=True)

    g_uss = []
    for s in range(nseeds):
        p = twostream.TwoStreamParams(seed=s)
        sim = twostream.build(p)
        state = sim.initialize()
        adv = jax.jit(sim.make_advance())
        ts, ex = [], []
        wpe, dt = sim.meta["wpe"], sim.meta["dt"]
        for step in range(401):
            if step % 2 == 0:
                en = np.asarray(sim.energies(state), np.float64)
                ts.append(step * dt)
                ex.append(en[0])
            state = adv(state)
        g_uss.append(fit_rate(np.asarray(ts), np.asarray(ex)) / wpe)
        print(f"repo seed {s}: gamma/wpe = {g_uss[-1]:.4f}", flush=True)

    ana = 1.0 / np.sqrt(8.0)
    mr, mu = np.mean(g_refs), np.mean(g_uss)
    sr, su = np.std(g_refs), np.std(g_uss)
    print(f"reference : gamma/wpe = {mr:.4f} +- {sr:.4f} ({nseeds} seeds)")
    print(f"vpic_jax  : gamma/wpe = {mu:.4f} +- {su:.4f} ({nseeds} seeds)")
    print(f"analytic  : gamma/wpe = {ana:.4f} (cold symmetric beams)")
    rel = abs(mu - mr) / mr
    print(f"ref-vs-repo rel diff of means: {rel:.3f}")
    assert rel < max(0.10, 2.0 * (sr + su) / mr / np.sqrt(nseeds)), \
        "growth rates disagree beyond seed noise"
    assert abs(mr - ana) / ana < 0.35, "reference rate far from analytic"
    print("OK")


if __name__ == "__main__":
    main()
