"""Monte-Carlo collision operators.

Re-design of src/collision/ (framework: collision.c, binary.c,
unary.c, langevin.c; models: hard_sphere.c, large_angle_coulomb.c; plus the
deck-level Takizuka-Abe operator from sample/reconnection/open-collisional
promoted to a first-class model, per SURVEY 2.6).

The reference's binary framework samples nc random pairs per voxel with a
serial per-thread RNG (binary_pipeline.c:44-155).  Serial rejection sampling
is hostile to a vector machine, so pairing is reformulated:

* both species are sorted by (voxel, random) -- a per-cell shuffle;
* intraspecies: globally adjacent slots (2m, 2m+1) form a pair when they lie
  in the same voxel (conflict-free: each particle is in at most one pair);
* interspecies: the r-th shuffled i-particle of a cell pairs with the
  (r mod nl)-th shuffled j-particle; j-side updates are scatter-added deltas.

The collision-rate -> probability normalization matches binary.c:106-117:
  pr = w_max * (dt * interval / dV) * (np / nc) * K(pair)
with np = nk(nk+1)/2, nc ~ nk/2 (intra) and np = nk*nl, nc = nk (inter), and
the detailed-balance update rule (update the lighter particle always, the
heavier with probability w_min/w_max, binary_pipeline.c:143-152).

Momentum transfer uses the reference's geometry (hard_sphere.c:126-236):
a random transverse unit vector T1 built by zeroing the smallest component
of the relative velocity, with the scattering angle set by the model.
All models are non-relativistic in the collision kinematics (the reference's
in-src models likewise use momentum differences directly).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .grid import Grid
from .state import SpeciesParams, SpeciesState

# ---------------------------------------------------------------------------
# sorting / partition helpers
# ---------------------------------------------------------------------------


def shuffle_sort(sp: SpeciesState, key) -> SpeciesState:
    """Sort by voxel with a random tiebreak: a per-cell shuffle (the analogue
    of the in-cell shuffle the deck-level T&A operator performs).  Dead
    lanes sort LAST (live stays a prefix -- the deck's extent sorts rely
    on this)."""
    from .ops.push import gather_rows
    r = (jax.random.bits(key, (sp.capacity,), jnp.uint32) >> 1) \
        .astype(jnp.int32)
    k = jnp.where(sp.alive, sp.i, jnp.int32(2 ** 30))
    order = jnp.lexsort((r, k)).astype(jnp.int32)
    dx, dy, dz, ux, uy, uz, w, i, live = gather_rows(
        order, sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz, sp.w, sp.i,
        sp.live)
    return sp.replace(dx=dx, dy=dy, dz=dz, i=i, ux=ux, uy=uy, uz=uz,
                      w=w, live=live)


def cell_partition(sp: SpeciesState, g: Grid):
    """(start[voxel], count[voxel]) over the sorted live prefix -- the
    sp->partition array of the reference (species_advance_aos.h:74-80)."""
    key = jnp.where(sp.alive, sp.i, g.nv)
    start = jnp.searchsorted(key, jnp.arange(g.nv), side="left")
    end = jnp.searchsorted(key, jnp.arange(g.nv), side="right")
    return start, end - start


def _perp_vector(urx, ury, urz):
    """T1: unit vector perpendicular to ur, built by zeroing ur's smallest
    component and rotating the other two 90 degrees (hard_sphere.c:189-199)."""
    ax, ay, az = jnp.abs(urx), jnp.abs(ury), jnp.abs(urz)
    # smallest component index
    min_x = (ax <= ay) & (ax <= az)
    min_y = (~min_x) & (ay <= az)
    min_z = ~(min_x | min_y)
    tx = jnp.where(min_x, 0.0, jnp.where(min_y, -urz, -ury))
    ty = jnp.where(min_x, -urz, jnp.where(min_y, 0.0, urx))
    tz = jnp.where(min_x, ury, jnp.where(min_y, urx, 0.0))
    tn = jax.lax.rsqrt(jnp.maximum(tx * tx + ty * ty + tz * tz, 1e-30))
    return tx * tn, ty * tn, tz * tn


def _deflect(urx, ury, urz, cos_t, sin_t, phi_c, phi_s):
    """Change in relative velocity for scattering by (theta, phi) about ur."""
    ur = jnp.sqrt(urx * urx + ury * ury + urz * urz)
    t1x, t1y, t1z = _perp_vector(urx, ury, urz)
    # T2 = ur x T1 / |ur|
    inv = jax.lax.rsqrt(jnp.maximum(ur * ur, 1e-30))
    t2x = (ury * t1z - urz * t1y) * inv
    t2y = (urz * t1x - urx * t1z) * inv
    t2z = (urx * t1y - ury * t1x) * inv
    px = phi_c * t1x + phi_s * t2x
    py = phi_c * t1y + phi_s * t2y
    pz = phi_c * t1z + phi_s * t2z
    dx = (cos_t - 1.0) * urx + sin_t * ur * px
    dy = (cos_t - 1.0) * ury + sin_t * ur * py
    dz = (cos_t - 1.0) * urz + sin_t * ur * pz
    return dx, dy, dz


# ---------------------------------------------------------------------------
# Binary collision framework
# ---------------------------------------------------------------------------

@dataclass
class BinaryModel:
    """A binary collision model: rate constant + scattering law
    (binary_collision_model analogue, collision.h:237-246)."""

    name: str
    # K(ur, params) -> rate constant (volume/time); ur = |u_i - u_j| * c
    rate_constant: Callable
    # theta sampler: (key, ur, pr-like aux) -> (cos_t, sin_t)
    sample_angle: Callable
    params: dict
    # cumulative models (T&A) fold pr to 1 and carry the rate in the
    # scattering variance: exempt from large-pr tallies and sub-cycling
    saturates: bool = False


def make_binary_op(model: BinaryModel, spi_idx: int, spj_idx: int,
                   spi: SpeciesParams, spj: SpeciesParams,
                   sample: float = 1.0, interval: int = 1,
                   pr_rounds: int = 1):
    """Build a collision op callable for Simulation.collision_ops.

    Signature: (species_list, fields, grid, step, rng[, diag]) ->
    (species, rng[, diag]).

    Large collision probabilities: a single Bernoulli draw against pr
    under-scatters once pr >~ 1 (dense/cold voxels, long intervals).  The
    reference detects this and WARNS that "the collision rate for such
    pairs will be lower than it should be physically"
    (binary_pipeline.c:131-199); here the count of saturated candidates
    rides the jit-carried diag dict (key ``coll_large_pr:<name>:i:j``) when
    the deck plumbs one.  ``pr_rounds`` > 1 goes beyond the reference and
    COMPENSATES by sub-cycling: each application runs ``pr_rounds``
    independent pairing+scatter rounds at pr/pr_rounds each (collision
    count per pair -> Binomial(R, pr/R) ~ Poisson(pr)), keeping the
    physical rate up to pr ~ pr_rounds at pr_rounds x the cost."""
    mi, mj = spi.m, spj.m
    mu = mi * mj / (mi + mj)
    intra = spi_idx == spj_idx
    if pr_rounds < 1:
        raise ValueError("pr_rounds must be >= 1")
    if getattr(model, "saturates", False) and pr_rounds != 1:
        raise ValueError(
            f"{model.name}: cumulative models fold pr into the scattering "
            "strength; sub-cycling would double-count the rate")
    tally_key = f"coll_large_pr:{model.name}:{spi_idx}:{spj_idx}"
    tally = not getattr(model, "saturates", False)

    def op(species, f, g: Grid, step, rng, diag=None):
        def one_round(species, keys, nlarge, count_large):
            k_shuf_i, k_shuf_j, k_pr, k_phi, k_theta, k_bal = keys
            species = list(species)
            si = shuffle_sort(species[spi_idx], k_shuf_i)
            sj = si if intra else shuffle_sort(species[spj_idx], k_shuf_j)
            start_i, cnt_i = cell_partition(si, g)
            start_j, cnt_j = (start_i, cnt_i) if intra \
                else cell_partition(sj, g)
            N = si.capacity
            dtint_dV = g.dt * interval / g.dV

            if intra:
                # adjacent-slot pairs (2m, 2m+1) within the same voxel
                half = N // 2
                ia = 2 * jnp.arange(half)
                ib = ia + 1
                same = (si.i[ia] == si.i[ib]) & si.live[ia] & si.live[ib]
                nk = cnt_i[si.i[ia]].astype(jnp.float32)
                npairs = 0.5 * nk * (nk + 1.0)
                ncand = jnp.maximum(0.5 * nk * sample, 1.0)
                pr_norm = dtint_dV * npairs / ncand
            else:
                # each live i-particle pairs with the (rank mod nl)-th
                # j-particle of its voxel
                ia = jnp.arange(N)
                vox = si.i
                rank = ia - start_i[vox]
                nl = jnp.maximum(cnt_j[vox], 1)
                ib = start_j[vox] + rank % nl
                same = si.live & (cnt_j[vox] > 0)
                nlf = cnt_j[vox].astype(jnp.float32)
                pr_norm = dtint_dV * nlf / sample

            uix, uiy, uiz = si.ux[ia], si.uy[ia], si.uz[ia]
            ujx, ujy, ujz = sj.ux[ib], sj.uy[ib], sj.uz[ib]
            wi_, wj_ = si.w[ia], sj.w[ib]
            urx, ury, urz = uix - ujx, uiy - ujy, uiz - ujz
            ur = jnp.sqrt(urx * urx + ury * ury + urz * urz) * g.cvac

            K = model.rate_constant(ur, model.params)
            w_max = jnp.maximum(wi_, wj_)
            w_min = jnp.minimum(wi_, wj_)
            pr_full = jnp.where(same, w_max * pr_norm * K, 0.0)
            if count_large:
                nlarge = nlarge + jnp.sum(
                    (pr_full > pr_rounds).astype(jnp.int32))
            pr = pr_full / pr_rounds
            hit = jax.random.uniform(k_pr, pr.shape) < pr

            cos_t, sin_t = model.sample_angle(k_theta, ur, model.params, pr)
            phi = jax.random.uniform(k_phi, pr.shape, minval=0.0,
                                     maxval=2.0 * math.pi)
            ddx, ddy, ddz = _deflect(urx, ury, urz, cos_t, sin_t,
                                     jnp.cos(phi), jnp.sin(phi))

            # detailed balance: always update the lighter computational
            # particle; the heavier with probability w_min/w_max
            upd_heavy = (jax.random.uniform(k_bal, pr.shape) * w_max) < w_min
            upd_i = hit & ((wi_ <= wj_) | upd_heavy)
            upd_j = hit & ((wj_ <= wi_) | upd_heavy)
            fi = jnp.where(upd_i, mu / mi, 0.0)
            fj = jnp.where(upd_j, mu / mj, 0.0)

            if intra:
                si = si.replace(
                    ux=si.ux.at[ia].add(fi * ddx).at[ib].add(-fj * ddx),
                    uy=si.uy.at[ia].add(fi * ddy).at[ib].add(-fj * ddy),
                    uz=si.uz.at[ia].add(fi * ddz).at[ib].add(-fj * ddz))
                species[spi_idx] = si
            else:
                si = si.replace(ux=si.ux + fi * ddx, uy=si.uy + fi * ddy,
                                uz=si.uz + fi * ddz)
                sj = sj.replace(
                    ux=sj.ux.at[ib].add(-fj * ddx),
                    uy=sj.uy.at[ib].add(-fj * ddy),
                    uz=sj.uz.at[ib].add(-fj * ddz))
                species[spi_idx] = si
                species[spj_idx] = sj
            return tuple(species), nlarge

        def apply(args):
            species, rng, nlarge = args
            # NOTE (round-4 change): the key schedule here moved from one
            # split(key, 7) to per-round fold_in(base, r) when pr_rounds
            # sub-cycling landed -- collision trajectories from decks run
            # before that commit do not bit-reproduce across it (the
            # statistics are unchanged; gold_load trajectory pins are
            # collisionless and unaffected).
            base = jax.random.fold_in(rng, step)
            rng2 = jax.random.fold_in(base, pr_rounds)  # distinct from rounds
            for r in range(pr_rounds):
                keys = jax.random.split(jax.random.fold_in(base, r), 6)
                species, nlarge = one_round(species, keys, nlarge,
                                            tally and r == 0)
            return species, rng2, nlarge

        nlarge0 = (diag[tally_key] if diag is not None and
                   tally_key in diag else jnp.zeros((), jnp.int32))
        if interval <= 0:
            out = species, rng, nlarge0
        else:
            out = jax.lax.cond(step % interval == 0, apply, lambda a: a,
                               (tuple(species), rng, nlarge0))
        species, rng, nlarge = out
        if diag is None:
            return list(species), rng
        diag = dict(diag)
        if tally:
            diag[tally_key] = nlarge
        return list(species), rng, diag

    op.has_diag = True
    if tally:
        op.diag_init = lambda: {tally_key: jnp.zeros((), jnp.int32)}
    return op


# ---------------------------------------------------------------------------
# Concrete binary models
# ---------------------------------------------------------------------------

def hard_sphere_model(radius_i: float, radius_j: float) -> BinaryModel:
    """Hard-sphere scattering (hard_sphere.c:99-124): K = pi R^2 |vr|;
    scattering angle from a uniformly sampled impact parameter,
    cos(theta) = 2(b/R)^2 - 1."""
    R = radius_i + radius_j
    Kc = math.pi * R * R

    def rate(ur, p):
        return Kc * ur

    def angle(key, ur, p, pr):
        b2 = jax.random.uniform(key, ur.shape)  # (b/R)^2 uniform in [0,1)
        cos_t = 2.0 * b2 - 1.0
        sin_t = 2.0 * jnp.sqrt(jnp.maximum(b2 * (1.0 - b2), 0.0))
        return cos_t, sin_t

    return BinaryModel("hard sphere", rate, angle, dict(R=R))


def large_angle_coulomb_model(q_i: float, q_j: float, m_i: float, m_j: float,
                              eps0: float = 1.0,
                              bmax: float = 1.0) -> BinaryModel:
    """Rutherford scattering with an impact-parameter cutoff
    (large_angle_coulomb.c, API collision.h:282-306): collisions with
    b < bmax at rate K = pi bmax^2 |vr|; angle from the Rutherford relation
    tan(theta/2) = b0/(2 b), b uniform-in-area on [0, bmax]."""
    mu = m_i * m_j / (m_i + m_j)
    pre = abs(q_i * q_j) / (4.0 * math.pi * eps0 * mu)

    def rate(ur, p):
        return math.pi * bmax * bmax * ur

    def angle(key, ur, p, pr):
        b = bmax * jnp.sqrt(jax.random.uniform(key, ur.shape))
        # b0/2 = q_i q_j / (4 pi eps0 mu vr^2): 90-degree impact parameter
        half_b0 = pre / jnp.maximum(ur * ur, 1e-30)
        t = half_b0 / jnp.maximum(b, 1e-30)  # tan(theta/2)
        cos_t = (1.0 - t * t) / (1.0 + t * t)
        sin_t = 2.0 * t / (1.0 + t * t)
        return cos_t, sin_t

    return BinaryModel("large angle coulomb", rate, angle,
                       dict(bmax=bmax, pre=pre))


def make_takizuka_abe_op(spi_idx: int, spj_idx: int, spi: SpeciesParams,
                         spj: SpeciesParams, g: Grid, nu0_dt: float = None,
                         log_lambda: float = 10.0, n0: float = 1.0,
                         interval: int = 1, sample: float = 1.0):
    """Takizuka & Abe (J. Comput. Phys. 25, 205 (1977)) cumulative
    small-angle Coulomb pair collisions, promoted to a first-class model
    (the reference ships it deck-level, sample/reconnection/open-collisional).

    Every sampled pair scatters: tan(theta/2) = delta with delta drawn from
    N(0, var), var = [ (qi qj)^2 n log_lambda / (8 pi eps0^2 mu^2 vr^3) ] dt.
    ``n`` is the local pair density estimated from in-cell macroweights.
    """
    mi, mj = spi.m, spj.m
    mu = mi * mj / (mi + mj)
    qi, qj = spi.q, spj.q
    pref = ((qi * qj) ** 2) * log_lambda / \
        (8.0 * math.pi * g.eps0 ** 2 * mu ** 2)

    def rate(ur, p):
        # Every sampled pair "collides": fold pr to 1 by using a rate that
        # saturates the probability (scattering strength carries the physics)
        return jnp.full_like(ur, 1e30)

    def angle(key, ur, p, pr):
        var = pref * p["n_local"] * g.dt * interval / \
            jnp.maximum(ur, 1e-12) ** 3
        delta = jnp.sqrt(var) * jax.random.normal(key, ur.shape)
        # comoving pairs do not scatter; huge delta is full backscatter
        delta = jnp.where(ur > 1e-12, jnp.clip(delta, -1e3, 1e3), 0.0)
        cos_t = (1.0 - delta * delta) / (1.0 + delta * delta)
        sin_t = 2.0 * delta / (1.0 + delta * delta)
        return cos_t, sin_t

    model = BinaryModel("takizuka-abe", rate, angle, dict(n_local=n0),
                        saturates=True)
    return make_binary_op(model, spi_idx, spj_idx, spi, spj,
                          sample=sample, interval=interval)


# ---------------------------------------------------------------------------
# Unary collision framework + Langevin
# ---------------------------------------------------------------------------

def make_unary_op(sp_idx: int, rate_constant: Callable, collide: Callable,
                  interval: int = 1):
    """unary_collision_model (unary.c, API collision.h:122-129): per
    particle, collide against a fixed background with probability
    dt*interval*K(p); ``collide`` maps (key, ux, uy, uz, mask) -> new u."""

    def op(species, f, g: Grid, step, rng):
        def apply(args):
            species, rng = args
            species = list(species)
            sp = species[sp_idx]
            k1, k2, rng2 = jax.random.split(jax.random.fold_in(rng, step), 3)
            K = rate_constant(sp.ux, sp.uy, sp.uz, g)
            pr = jnp.where(sp.alive, K * g.dt * interval, 0.0)
            hit = jax.random.uniform(k1, pr.shape) < pr
            ux, uy, uz = collide(k2, sp.ux, sp.uy, sp.uz, hit)
            species[sp_idx] = sp.replace(ux=ux, uy=uy, uz=uz)
            return tuple(species), rng2

        if interval <= 0:
            return species, rng
        species, rng = jax.lax.cond(step % interval == 0, apply,
                                    lambda a: a, (tuple(species), rng))
        return list(species), rng

    return op


def hard_sphere_fluid_rate(n_bg: float, radius: float, vd=(0.0, 0.0, 0.0),
                           kT_over_m: float = 0.0):
    """hard_sphere_fluid_rate_constant (hard_sphere.c:99-110): Pade fit of
    the drifting-Maxwellian-averaged rate K = n pi R^2 <|vr|>."""
    a = 8.0 / math.pi
    b = 4.0 / (12.0 - 3.0 * math.pi)
    gma = (3.0 * math.pi - 8.0) / (24.0 - 6.0 * math.pi)
    ut2 = kT_over_m
    Kt2 = (n_bg * math.pi * radius * radius) ** 2

    def rate(ux, uy, uz, g: Grid):
        urx = ux * g.cvac - vd[0]
        ury = uy * g.cvac - vd[1]
        urz = uz * g.cvac - vd[2]
        ur2 = urx * urx + ury * ury + urz * urz
        return jnp.sqrt((a * Kt2 * ut2 * ut2
                         + ur2 * (b * Kt2 * ut2 + ur2 * gma * Kt2))
                        / jnp.maximum(ut2 + ur2 * gma, 1e-30))

    return rate


def make_langevin_op(sp_idx: int, sp: SpeciesParams, kT: float, nu: float,
                     interval: int = 1):
    """langevin.c: Anderson-thermostat Ornstein-Uhlenbeck kick,
    u <- decay u + drive N(0,1) with decay = exp(-nu dt interval) and
    drive = sqrt((1 - decay^2) kT / (m c^2))^(1/2)... (langevin_pipeline.c:
    54-89 derivation)."""

    def op(species, f, g: Grid, step, rng):
        decay = math.exp(-nu * g.dt * interval)
        drive_sq = (1.0 - decay * decay) * kT / (sp.m * g.cvac * g.cvac)
        drive = math.sqrt(drive_sq)

        def apply(args):
            species, rng = args
            species = list(species)
            s = species[sp_idx]
            key, rng2 = jax.random.split(jax.random.fold_in(rng, step))
            r = jax.random.normal(key, (3, s.capacity))
            keep = s.alive
            upd = lambda u, n: jnp.where(keep, decay * u + drive * n, u)
            species[sp_idx] = s.replace(ux=upd(s.ux, r[0]),
                                        uy=upd(s.uy, r[1]),
                                        uz=upd(s.uz, r[2]))
            return tuple(species), rng2

        if interval <= 0:
            return species, rng
        species, rng = jax.lax.cond(step % interval == 0, apply,
                                    lambda a: a, (tuple(species), rng))
        return list(species), rng

    return op


def _fluid_collide(uth_bg, vd, mu_over_mi, mu_over_mbg, angle_fn):
    """Unary collide callback: sample a background partner from a drifting
    Maxwellian, scatter the pair elastically, keep only the test particle's
    update (the background is a fixed fluid, unary.c semantics)."""

    def collide(key, ux, uy, uz, hit):
        k1, k2, k3 = jax.random.split(key, 3)
        ub = uth_bg * jax.random.normal(k1, (3,) + ux.shape)
        urx = ux - (ub[0] + vd[0])
        ury = uy - (ub[1] + vd[1])
        urz = uz - (ub[2] + vd[2])
        ur = jnp.sqrt(urx * urx + ury * ury + urz * urz)
        cos_t, sin_t = angle_fn(k2, ur)
        phi = jax.random.uniform(k3, ux.shape, minval=0.0,
                                 maxval=2.0 * math.pi)
        ddx, ddy, ddz = _deflect(urx, ury, urz, cos_t, sin_t,
                                 jnp.cos(phi), jnp.sin(phi))
        return (jnp.where(hit, ux + mu_over_mi * ddx, ux),
                jnp.where(hit, uy + mu_over_mi * ddy, uy),
                jnp.where(hit, uz + mu_over_mi * ddz, uz))

    return collide


def make_hard_sphere_fluid_op(sp_idx: int, spp: SpeciesParams,
                              n_bg: float, radius: float, m_bg: float,
                              kT_bg: float = 0.0, vd=(0.0, 0.0, 0.0),
                              interval: int = 1):
    """hard_sphere fluid model (hard_sphere.c:99-110 + unary framework):
    test particles scatter off a fixed drifting-Maxwellian hard-sphere
    background."""
    mu_i = m_bg / (spp.m + m_bg)       # mu / m_i
    uth = math.sqrt(kT_bg / m_bg) if kT_bg > 0 else 0.0
    rate = hard_sphere_fluid_rate(n_bg, radius, vd, kT_bg / m_bg
                                  if m_bg > 0 else 0.0)

    def angle(key, ur):
        b2 = jax.random.uniform(key, ur.shape)
        return 2.0 * b2 - 1.0, 2.0 * jnp.sqrt(jnp.maximum(
            b2 * (1.0 - b2), 0.0))

    return make_unary_op(sp_idx, rate,
                         _fluid_collide(uth, vd, mu_i, None, angle),
                         interval=interval)


def make_large_angle_coulomb_fluid_op(sp_idx: int, spp: SpeciesParams,
                                      n_bg: float, q_bg: float, m_bg: float,
                                      kT_bg: float = 0.0,
                                      vd=(0.0, 0.0, 0.0), bmax: float = 1.0,
                                      eps0: float = 1.0, interval: int = 1):
    """large_angle_coulomb fluid model (large_angle_coulomb.c + unary
    framework): Rutherford scattering with impact-parameter cutoff off a
    fixed background."""
    mu = spp.m * m_bg / (spp.m + m_bg)
    mu_i = m_bg / (spp.m + m_bg)
    pre = abs(spp.q * q_bg) / (4.0 * math.pi * eps0 * mu)
    uth = math.sqrt(kT_bg / m_bg) if kT_bg > 0 else 0.0

    def rate(ux, uy, uz, g: Grid):
        urx = ux * g.cvac - vd[0]
        ury = uy * g.cvac - vd[1]
        urz = uz * g.cvac - vd[2]
        ur = jnp.sqrt(urx * urx + ury * ury + urz * urz)
        return n_bg * math.pi * bmax * bmax * ur

    def angle(key, ur):
        b = bmax * jnp.sqrt(jax.random.uniform(key, ur.shape))
        half_b0 = pre / jnp.maximum(ur * ur, 1e-30)
        t = half_b0 / jnp.maximum(b, 1e-30)
        return (1.0 - t * t) / (1.0 + t * t), 2.0 * t / (1.0 + t * t)

    return make_unary_op(sp_idx, rate,
                         _fluid_collide(uth, vd, mu_i, None, angle),
                         interval=interval)
