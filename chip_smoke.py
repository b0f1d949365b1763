#!/usr/bin/env python
"""Smoke proof that the PIC step runs on an NVIDIA GPU, end to end.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the decomposed 3-D phase only

Phases (one process; any failure exits non-zero):

* harris-2d-gold   the reference harris load (64x64 cells x 64 ppc, 262,144
                   particles, damp 0.001) for 1000 steps through
                   Simulation.run; relative total-energy drift within 8.5e-5
                   of the reference VPIC's -1.884e-4 (ENERGY_AXIS.md), and
                   the E-field energy at step 100 within 1.5e-4 of the
                   host CPU's run of the same load.
* push-parity      one advance_p (both species, shared accumulator) and one
                   sort_p on the GPU against the same jitted functions on
                   the host CPU, on the 2-D harris bench deck (262k) and
                   3-D harris 32^3 x 128 ppc (4.2M); plus whether one push
                   and one full step repeat bit for bit on the GPU.
* harris-3d-load   3-D harris 128x128x64 cells x 64 ppc (67M particles),
                   20 steps through make_multi_step: finite energies, drift
                   < 1e-3, particle count kept, Gauss-law residual within
                   the unit-test bound; pushes/s and peak device memory.
* cli-checkpoint   ``python -m vpic_jax harris`` in-process: 40 steps with a
                   checkpoint at 20, then a restart from it to 40, compared
                   with the uninterrupted run.
* four-card        (--four) 3-D harris 64^3 x 64 ppc (16.8M) on a (1,2,2)
                   mesh against topology (1,1,1) on one card, 20 steps.

Prints the card's name and power limit (nvidia-smi), the JAX version, one
JSON line per phase, and last exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# relative total-energy drift of the reference VPIC on the gold-load harris
# deck at step 1000, damp = 0.001 (ENERGY_AXIS.md), and the band around it.
# By step 1000 the dynamics has amplified last-bit differences: runs of
# this code from the same load (six on an H100, whose f32 atomics reorder
# sums run to run, and three on the CPU, two with one ux nudged by 1 ulp)
# read -1.46e-4 .. -2.09e-4, std 2.0e-5; the reference's own 1-ulp twin
# moved by 1.8e-5.  Two independent trajectories then differ with std
# ~sqrt(2) * 2.0e-5 = 2.8e-5, and the band is three of those.  It catches
# gross faults (one species' deposit dropped: drift +0.28), not subtle ones
# (a bf16-rounded accumulator moves the step-1000 drift by only 2.2e-6).
REF_DRIFT_1000 = -1.884e-4
DRIFT_BAND = 8.5e-5
# The tight check: at step 100 the trajectories are still correlated, and
# the E-field energy (ex+ey+ez), driven by the deposited current, is the
# column most sensitive to the deposit's precision, so the GPU is held to
# the host CPU running the same load in this process.  Measured on an
# H100 (400 W): three clean runs within 1.1e-5 .. 4.0e-5 of the CPU, a
# bf16-rounded accumulator 5.3e-4 away; the tolerance sits between them.
E_FIELD_100_TOL = 1.5e-4


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def energies(sim, state):
    import numpy as np
    return np.asarray(sim.energies(state), np.float64)


def n_particles(state):
    import numpy as np
    return int(sum(np.asarray(sp.np).sum() for sp in state.species))


def gauss_residual(sim, state):
    """RMS Gauss-law residual over n0, as tests/test_harris.py computes it
    (bound there: 0.05)."""
    import jax
    import numpy as np
    from vpic_jax.ops import fields as F
    from vpic_jax.ops import push as P
    g = sim.grid
    m = sim._material_coeffs()

    def resid(f, species):
        f = F.clear_rhof(f)
        rhof = f.rhof.reshape(-1)
        for st, sp in zip(sim.species, species):
            rhof = P.accumulate_rho_p(rhof, sp, g, st.params.q)
        f = F.synchronize_rho(f.replace(rhof=rhof.reshape(g.shape)), g)
        f = F.compute_div_e_err(f, g, m)
        return F.compute_rms_div_e_err(f, g)

    num, den = jax.jit(resid)(state.fields, state.species)
    return g.eps0 * float(np.sqrt(float(num) / float(den))) / sim.meta["n0"]


def phase_harris_2d_gold():
    import jax
    import numpy as np
    from vpic_jax.models import harris
    t0 = time.time()
    sim = harris.build(harris.HarrisParams(gold_load=True))
    state0 = sim.initialize()
    setup_s = time.time() - t0
    e0, n0 = energies(sim, state0), n_particles(state0)

    def e_field(s):
        return float(energies(sim, s)[:3].sum())

    t0 = time.time()
    state = sim.run(state0, num_step=100, verbose=False)
    e_100 = e_field(state)
    state = sim.run(state, num_step=1000, verbose=False)
    run_s = time.time() - t0
    e1, n1 = energies(sim, state), n_particles(state)
    drift = float((e1.sum() - e0.sum()) / e0.sum())
    cpu = jax.devices("cpu")[0]
    t0 = time.time()
    with jax.default_device(cpu):
        state_c = sim.run(jax.device_put(state0, cpu), num_step=100,
                          verbose=False)
        assert state_c.fields.ex.devices() == {cpu}
        e_100_cpu = e_field(state_c)
    cpu_s = time.time() - t0
    rel_100 = (e_100 - e_100_cpu) / e_100_cpu
    emit("harris-2d-gold", particles=n0, steps=1000, drift=drift,
         ref_drift=REF_DRIFT_1000, delta=drift - REF_DRIFT_1000,
         band=DRIFT_BAND, e_field_100=e_100, e_field_100_cpu=e_100_cpu,
         e_field_100_rel=rel_100, tol_100=E_FIELD_100_TOL,
         setup_s=setup_s, run_s=run_s, cpu_100_s=cpu_s)
    assert np.isfinite(e1).all(), "non-finite energies"
    assert n1 == n0, f"particle count {n0} -> {n1}"
    assert abs(rel_100) <= E_FIELD_100_TOL, \
        f"step-100 E-field energy {rel_100:.2e} off the CPU's"
    assert abs(drift - REF_DRIFT_1000) <= DRIFT_BAND, \
        f"drift {drift:.4e} outside {REF_DRIFT_1000} +- {DRIFT_BAND}"


def _rows(sp):
    """Lanes as a lexicographically sorted (N, 9) int32 matrix of exact bit
    patterns: (dx dy dz ux uy uz w) bits, voxel, live."""
    import numpy as np
    cols = [np.asarray(getattr(sp, k)).view(np.int32) for k in
            ("dx", "dy", "dz", "ux", "uy", "uz", "w")]
    cols += [np.asarray(sp.i), np.asarray(sp.live).astype(np.int32)]
    m = np.stack(cols, 1)
    return m[np.lexsort(m.T[::-1])]


def _parity(label, sim):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vpic_jax.ops import interp as I
    from vpic_jax.ops import push as P
    g = sim.grid
    qm = [(st.params.q, st.params.m) for st in sim.species]
    state = sim.initialize()

    @jax.jit
    def push(f, species):
        fcoef = I.load_interpolator(f, g)
        acc = jnp.zeros((g.nv, 12), jnp.float32)
        rhob = f.rhob.reshape(-1)
        out = []
        for sp, (q, m) in zip(species, qm):
            r = P.advance_p(sp, fcoef, g, q, m, acc, rhob)
            acc, rhob = r.acc, r.rhob_flat
            out.append(r.species)
        return fcoef, tuple(out), acc, rhob

    sort = jax.jit(lambda ss: tuple(P.sort_p(s) for s in ss))
    cpu = jax.devices("cpu")[0]
    args = (state.fields, state.species)
    gpu_out = jax.block_until_ready(push(*args))
    again = jax.block_until_ready(push(*args))
    cpu_out = push(*jax.device_put(args, cpu))
    h = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    (fc_g, sp_g, acc_g, rb_g), (fc_c, sp_c, acc_c, rb_c) = h(gpu_out), \
        h(cpu_out)
    push_repeat = all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(h(again)), jax.tree.leaves((fc_g, sp_g, acc_g,
                                                    rb_g))))

    np.testing.assert_allclose(fc_g, fc_c, rtol=1e-6,
                               atol=1e-6 * np.abs(fc_c).max(),
                               err_msg=f"{label}: interpolator")
    # lanes whose walk ends on a cell face (an offset within 1e-5 of +-1
    # on either device) may sit in either of the two cells that share it
    # after last-bit differences; they are counted, not compared
    n_live, n_face, voxel_mismatch = 0, 0, 0
    for k, (a, b) in enumerate(zip(sp_g, sp_c)):
        live = b.live
        on_face = np.zeros_like(live)
        for d in ("dx", "dy", "dz"):
            for s in (getattr(a, d), getattr(b, d)):
                on_face |= np.abs(s) > 1 - 1e-5
        np.testing.assert_array_equal(a.live, b.live,
                                      err_msg=f"{label}: live sp{k}")
        n_live += int(live.sum())
        n_face += int((live & on_face).sum())
        diff = live & (a.i != b.i)
        voxel_mismatch += int(diff.sum())
        assert not (diff & ~on_face).any(), \
            f"{label}: sp{k} voxel differs off a cell face"
        cmp = live & ~on_face
        for f in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
            np.testing.assert_allclose(
                getattr(a, f)[cmp], getattr(b, f)[cmp], rtol=1e-5,
                atol=1e-6, err_msg=f"{label}: {f} sp{k}")
    acc_err = float(np.abs(acc_g - acc_c).max() / np.abs(acc_c).max())
    rhob_err = float(np.abs(rb_g - rb_c).max()
                     / max(np.abs(rb_c).max(), 1e-30))
    assert acc_err <= 1e-5, f"{label}: accumulator {acc_err:.2e}"
    assert rhob_err <= 1e-5, f"{label}: rhob {rhob_err:.2e}"

    # sort_p on the GPU: a bit-exact permutation with the live lanes first
    # in voxel order, identical to the CPU's stable sort of the same input
    srt_g = h(sort(gpu_out[1]))
    srt_c = h(sort(jax.device_put(gpu_out[1], cpu)))
    for k, (a, b, src) in enumerate(zip(srt_g, srt_c, sp_g)):
        assert np.array_equal(_rows(a), _rows(src)), \
            f"{label}: sort_p sp{k} is not a permutation of its input"
        n = int(src.live.sum())
        assert a.live[:n].all() and not a.live[n:].any()
        assert (np.diff(a.i[:n]) >= 0).all()
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.array_equal(x, y), f"{label}: sort_p GPU != CPU"

    # one full deck step, twice from the same state
    step = sim.make_step()
    s1 = h(step(state))
    s2 = h(step(state))
    step_repeat = all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(s1), jax.tree.leaves(s2)))
    return dict(particles=n_live, face_lanes=n_face,
                voxel_mismatch=voxel_mismatch, acc_rel_err=acc_err,
                rhob_rel_err=rhob_err, push_bitwise_repeat=push_repeat,
                step_bitwise_repeat=step_repeat)


def phase_push_parity():
    from vpic_jax.models import harris
    decks = {
        "harris2d-64x64x64": harris.HarrisParams(nx=64, ny=64, nppc=64),
        "harris3d-32x32x32x128": harris.HarrisParams(
            nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0, Lz=16.0),
    }
    repeat = True
    for label, p in decks.items():
        r = _parity(label, harris.build(p))
        emit("push-parity", deck=label, **r)
        repeat &= r["step_bitwise_repeat"]
    return repeat


def phase_harris_3d_load():
    import jax
    import numpy as np
    from vpic_jax.models import harris
    p = harris.HarrisParams(nx=128, ny=128, nz=64, nppc=64,
                            Lx=64.0, Ly=64.0, Lz=32.0)
    t0 = time.time()
    sim = harris.build(p)
    state = sim.initialize()
    jax.block_until_ready(state.fields.ex)
    setup_s = time.time() - t0
    e0, n0 = energies(sim, state), n_particles(state)
    adv = sim.make_multi_step(10)
    t0 = time.time()
    state = jax.block_until_ready(adv(state))
    first_s = time.time() - t0             # compile + 10 steps
    t0 = time.time()
    state = jax.block_until_ready(adv(state))
    steady_s = time.time() - t0            # 10 steps
    e1, n1 = energies(sim, state), n_particles(state)
    drift = float(abs(e1.sum() - e0.sum()) / e0.sum())
    gauss = gauss_residual(sim, state)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    emit("harris-3d-load", particles=n0, steps=20, drift=drift,
         gauss_rms_over_n0=gauss, pushes_per_s=n0 * 10 / steady_s,
         steady_step_s=steady_s / 10, first_call_s=first_s,
         setup_s=setup_s, peak_bytes_in_use=peak)
    assert np.isfinite(e1).all(), "non-finite energies"
    assert drift < 1e-3, f"drift {drift:.2e}"
    assert n1 == n0, f"particle count {n0} -> {n1}"
    assert gauss < 0.05, f"Gauss-law residual {gauss:.3e} n0"


def phase_cli_checkpoint(bitwise):
    import jax
    import numpy as np
    from vpic_jax.__main__ import main
    with tempfile.TemporaryDirectory() as d:
        base = os.path.join(d, "ck")
        full = main(["harris", "--num-step", "40", "--checkpt",
                     base + ":20"])
        rest = main(["harris", "--num-step", "40", "--restore",
                     base + ".20"])
    a = jax.tree.map(np.asarray, jax.device_get(full))
    b = jax.tree.map(np.asarray, jax.device_get(rest))
    assert int(b.step) == int(a.step) == 40
    na, nb = n_particles(a), n_particles(b)
    if bitwise:
        same = all(np.array_equal(x, y) for x, y in zip(
            jax.tree.leaves(a), jax.tree.leaves(b)))
        worst = 0.0 if same else float("inf")
    else:
        # the GPU deposit sums with f32 atomics in an order that changes
        # from run to run, so a restart is not bitwise.  After the 20
        # steps past the checkpoint the runs differ by 4.1e-5 of a field
        # component's peak (H100, 400 W); 1e-3 leaves 25x for that drift
        # of rounding, while a restart that lost or misplaced state would
        # differ at the level of the fields themselves
        worst = max(float(np.abs(getattr(a.fields, k) - getattr(
            b.fields, k)).max() / max(np.abs(getattr(a.fields, k)).max(),
                                      1e-30))
            for k in ("ex", "ey", "ez", "cbx", "cby", "cbz"))
        same = worst <= 1e-3
    emit("cli-checkpoint", particles=na, bitwise=bitwise,
         worst_field_rel_diff=worst)
    assert na == nb, f"particles {na} vs {nb}"
    assert same, f"restart differs from the uninterrupted run ({worst})"


def phase_four_card():
    import jax
    import numpy as np
    from vpic_jax.models import harris
    kw = dict(nx=64, ny=64, nz=64, nppc=64, Lx=32.0, Ly=32.0, Lz=32.0)
    out = {}
    for topo in ((1, 2, 2), (1, 1, 1)):
        sim = harris.build(harris.HarrisParams(**kw, topology=topo))
        state = sim.initialize()
        e0 = energies(sim, state)
        adv = sim.make_multi_step(20)
        t0 = time.time()
        state = jax.block_until_ready(adv(state))
        el = time.time() - t0
        # the fewest devices any one leaf of the state is spread over
        devs = min(len(leaf.sharding.device_set)
                   for leaf in jax.tree.leaves(state))
        out[topo] = (n_particles(state), e0, energies(sim, state), devs, el)
        del state
    (n4, e04, e4, d4, t4), (n1, e01, e1, _, t1) = out[(1, 2, 2)], \
        out[(1, 1, 1)]
    rel = float(np.abs(e4 - e1).max() / e1.sum())
    emit("four-card", particles=n1, steps=20, devices=d4,
         energy_rel_diff=rel, total_energy_4=float(e4.sum()),
         total_energy_1=float(e1.sum()), first_call_s_4=t4,
         first_call_s_1=t1)
    assert np.isfinite(e4).all() and np.isfinite(e1).all()
    assert n4 == n1, f"particles {n4} (4 cards) vs {n1} (1 card)"
    assert rel <= 1e-4, f"energies differ by {rel:.2e} of the total"
    assert d4 == 4, f"a leaf of the state is on only {d4} device(s)"


def main(argv):
    four = "--four" in argv
    sys.path.insert(0, HERE)
    try:
        from vpic_jax.utils.compile_cache import enable_compile_cache
    except ImportError:
        sys.exit("chip_smoke: run from a checkout of the repository")
    enable_compile_cache()
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})")
    if four and len(devs) < 4:
        sys.exit(f"chip_smoke --four: {len(devs)} GPU(s), need 4")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    print(f"jax {jax.__version__}; devices: {len(devs)} x "
          f"{devs[0].device_kind}", flush=True)

    if four:
        phase_four_card()
    else:
        phase_harris_2d_gold()
        deterministic = phase_push_parity()
        phase_harris_3d_load()
        phase_cli_checkpoint(bitwise=deterministic)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main(sys.argv[1:])
