#!/usr/bin/env python
"""Device-time split of the PIC step on a GPU, from one profiler trace.

Runs a harris deck for ``n`` scanned steps once untraced (step time,
pushes/s) and once under ``utils.profile.trace``, then sums the device
kernels of the trace by the step's named scopes (sort_p, interp_load,
push_deposit, boundary_p, acc_unload, field_advance, div_clean; ``copy``
for XLA's buffer copies, ``other`` for the rest) and reports the device
idle share of the traced window.  XLA runs the step's kernels inside CUDA
graphs, so trace events carry only the kernel name; each kernel is mapped
to its scope through the op_name metadata of the fusion of that name in
the compiled HLO.

Usage: trace_phases.py [--deck 2d|3d-load|3d] [--steps N] [--out DIR]

Prints one JSON line per deck; the raw trace and the 40 longest kernels
(with their trace stats) stay under --out (default: traces/ in the
checkout).
"""

import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCOPES = ("sort_p", "interp_load", "push_deposit", "boundary_p",
          "acc_unload", "field_advance", "div_clean")

DECKS = {
    # bench.py's 2-D cell: 64x64 cells x 64 ppc = 262,144 particles
    "2d": dict(nx=64, ny=64, nppc=64),
    # chip_smoke.py's 3-D load: 128x128x64 cells x 64 ppc = 67M particles
    "3d-load": dict(nx=128, ny=128, nz=64, nppc=64,
                    Lx=64.0, Ly=64.0, Lz=32.0),
    # bench.py's default 3-D tier: 32^3 x 128 ppc = 4.2M particles
    "3d": dict(nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0, Lz=16.0),
}


def classify(text: str) -> str:
    for s in SCOPES:
        if s in text:
            return s
    return "other"


def scope_map(hlo_text: str):
    """Kernel name -> scope from optimized HLO text: XLA names a fusion's
    kernel after the instruction, '.' and '-' becoming '_'."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?'
                     r'metadata=\{[^}]*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[re.sub(r"[.\-]", "_", m.group(1))] = classify(m.group(2))
    return out


def kernel_scope(name: str, smap) -> str:
    if name in smap:
        return smap[name]
    if "cub::" in name or "RadixSort" in name:
        return "sort_p"          # the step's only sort is sort_p's argsort
    if name.startswith(("memcpy", "Memcpy", "Memset")):
        return "copy"
    return classify(name)


def reduce_trace(path: str, top_out: str, smap=None):
    """Sum device kernel time per scope over the GPU planes of one
    .xplane.pb; busy = union of kernel intervals over the window."""
    import jax
    pd = jax.profiler.ProfileData.from_file(path)
    per, spans, top = {}, [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for ln in ops or [ln for ln in lines if "Stream" in ln.name]:
            for ev in ln.events:
                stats = {k: str(v) for k, v in ev.stats}
                cat = kernel_scope(ev.name, smap or {})
                if cat == "other":
                    cat = classify(" ".join(stats.values()))
                per[cat] = per.get(cat, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                top.append((ev.duration_ns, ev.name, cat, stats))
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top.sort(key=lambda t: -t[0])
    with open(top_out, "w") as fh:
        json.dump([dict(ns=t[0], name=t[1], scope=t[2], stats=t[3])
                   for t in top[:40]], fh, indent=1)
    return dict(kernel_ns=per, busy_ns=busy, window_ns=window,
                idle_share=1.0 - busy / window)


def run(deck: str, n_steps: int, out: str):
    import jax
    from vpic_jax.models import harris
    from vpic_jax.utils.profile import trace
    sim = harris.build(harris.HarrisParams(**DECKS[deck]))
    state = sim.initialize()
    n = sum(int(sp.np) for sp in state.species)
    adv = sim.make_multi_step(n_steps).lower(state).compile()
    smap = scope_map(adv.as_text())
    state = jax.block_until_ready(adv(state))          # warm up
    t0 = time.time()
    state = jax.block_until_ready(adv(state))
    el = time.time() - t0
    logdir = os.path.join(out, deck)
    with trace(logdir):
        state = jax.block_until_ready(adv(state))
    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, os.path.join(out, f"{deck}_top.json"), smap)
    per_step = {k: v / n_steps / 1e6 for k, v in
                (red or {}).get("kernel_ns", {}).items()}
    return dict(deck=deck, particles=n, steps=n_steps,
                step_ms=el / n_steps * 1e3, pushes_per_s=n * n_steps / el,
                device_ms_per_step=per_step,
                idle_share=(red or {}).get("idle_share"))


def main(argv):
    from vpic_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"trace_phases: no GPU (platform {d.platform!r})")
    decks = [argv[argv.index("--deck") + 1]] if "--deck" in argv \
        else ["2d", "3d-load"]
    n_steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 20
    out = argv[argv.index("--out") + 1] if "--out" in argv \
        else os.path.join(ROOT, "traces")
    os.makedirs(out, exist_ok=True)
    print(f"device: {d.device_kind} x {len(jax.devices())}", flush=True)
    for deck in decks:
        print(json.dumps(run(deck, n_steps, out)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
