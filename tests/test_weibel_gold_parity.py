"""Reference-parity physics validation against the reference's COMMITTED
gold energy history (test/unit/energy_comparison/energies_gold), at the
reference's own per-step tolerances (weibel_driver.cc:305-330 /
compare_energies.h:42-60).  This is the cross-implementation check the
repo-generated gold files (test_energy_gold.py) cannot provide.

Requires the reference checkout for the gold data file; skipped when it is
absent so the suite remains standalone.
"""

import os

import numpy as np
import pytest

import vpic_jax.models.weibel_gold as weibel_gold

GOLD = "/root/reference/test/unit/energy_comparison/energies_gold"


def _rng_vectors():
    """Test vectors recorded from a standalone build of the reference's
    src/util/rng (seed 4): u64rand, drand, drandn streams."""
    u64 = [17147376929591792993, 6965463857445509147, 3203500969475508548,
           6056437697146837393, 2487030829115505180, 8795985754231021642]
    drand = [0.92956116597456206, 0.37759855233058415,
             0.17366213553323828, 0.32832014543848531]
    drandn = [-1.7611320139045581, -0.22697768142078983,
              0.30982289086507325, -0.6939780653429386,
              0.083171949093377523, 0.42086487449359328,
              0.36793257077179969, -0.17718506981770299]
    return u64, drand, drandn


def test_vpic_rng_matches_reference_stream():
    from vpic_jax.utils.vpic_rng import VpicRng
    u64, drand, drandn = _rng_vectors()
    r = VpicRng(4)
    assert [r._next_u64() for _ in range(6)] == u64
    r = VpicRng(4)
    assert [float(r.drand()) for _ in range(4)] == drand
    # drandn: ziggurat table is REGENERATED (not copied); deviates agree
    # with the reference build to <= 2 ulps (the committed reference table
    # embeds its generator's own rounding)
    r = VpicRng(4)
    got = np.array([r.drandn() for _ in range(8)])
    np.testing.assert_allclose(got, drandn, rtol=5e-15)


def test_entropy_pool_seeding_matches_gold_load():
    """seed_entropy(1) @ 1 rank, n_rng=2 reproduces the gold file's step-0
    particle energies (the quantity that pins the pool-seed arithmetic)."""
    if not os.path.exists(GOLD):
        pytest.skip("reference checkout not available")
    gold = np.loadtxt(GOLD)
    sim = weibel_gold.build()
    # host-side: sum w m c^2 (gamma - 1) over the staged injected load
    def ke(name):
        st = next(s for s in sim.species if s.params.name == name)
        xs = st.rows()   # one row per injected particle
        ux, uy, uz, w = xs[:, 6], xs[:, 7], xs[:, 8], xs[:, 9]
        g = np.sqrt(1.0 + ux ** 2 + uy ** 2 + uz ** 2)
        return float(np.sum(w * st.params.m * (g - 1.0)))
    assert abs(ke("ion") - gold[0, 7]) / gold[0, 7] < 1e-5
    assert abs(ke("electron") - gold[0, 8]) / gold[0, 8] < 1e-5


def _masked_errs(a, b):
    """compare_energies.h:42-105 error metric: relative |A-B|/min(A,B),
    absolute (vs double eps) when min(|A|,|B|) < 10*f32 eps."""
    thresh = 10 * np.finfo(np.float32).eps
    small = np.minimum(np.abs(a), np.abs(b)) < thresh
    rel = np.abs(a - b) / np.where(small, 1.0, np.minimum(a, b))
    return np.where(small,
                    np.where(np.abs(a - b) < np.finfo(np.float64).eps,
                             0.0, np.inf),
                    rel)


@pytest.mark.slow
def test_weibel_energy_history_vs_reference_gold():
    if not os.path.exists(GOLD):
        pytest.skip("reference checkout not available")
    import jax
    gold = np.loadtxt(GOLD)
    sim = weibel_gold.build()
    state = sim.initialize()
    adv = jax.jit(sim.make_advance())
    rows = [np.asarray(sim.energies(state), np.float64)]
    for _ in range(700):
        state = adv(state)
        rows.append(np.asarray(sim.energies(state), np.float64))
    ours = np.stack(rows)   # [ex ey ez bx by bz KE_e KE_i]

    E, B = ours[:, 0:3].sum(1), ours[:, 3:6].sum(1)
    P = ours[:, 6] + ours[:, 7]
    gE, gB = gold[:, 1:4].sum(1), gold[:, 4:7].sum(1)
    gP = gold[:, 7:9].sum(1)

    # weibel_driver.cc:305-330: per-line masked-sum tolerances
    assert _masked_errs(E, gE).max() < 0.3, "E-field history out of tol"
    assert _masked_errs(B, gB).max() < 0.03, "B-field history out of tol"
    assert _masked_errs(P, gP).max() < 0.01, "particle history out of tol"
