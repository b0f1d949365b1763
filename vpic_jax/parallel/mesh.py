"""Device-mesh execution: the mp/MPI layer (src/util/mp/) re-imagined.

The reference boots MPI, wires 6 persistent per-face ports per rank and
hand-schedules begin/end exchanges.  Here the whole per-shard step runs
inside jax.shard_map over a 3-d Mesh whose axes mirror the domain
decomposition; halo exchange and face synchronization are lax.ppermute
collectives inside ops/fields.py + boundary.py, and XLA's scheduler overlaps
them with the interior compute (the reference hand-codes that overlap,
advance_e_pipeline.cc:60-210).

Global-state convention: every leaf of a sharded SimState carries 3 leading
mesh dims (px, py, pz); shard-local code sees the squeezed view.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..grid import Grid


def make_mesh(g: Grid) -> Mesh:
    n = g.n_shards
    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"topology {g.topology} needs {n} devices, "
                           f"have {len(devs)}")
    arr = np.array(devs[:n]).reshape(g.topology)
    return Mesh(arr, g.mesh_axes)


def local_view(tree):
    return jax.tree.map(lambda a: a[0, 0, 0], tree)


def global_view(tree):
    return jax.tree.map(lambda a: a[None, None, None], tree)


def shard_fn(fn, g: Grid, mesh: Mesh):
    """Lift a shard-local state->state function to the global sharded state."""
    spec = P(*g.mesh_axes)

    def wrapped(gstate):
        def local(gs):
            return global_view(fn(local_view(gs)))

        return shard_map(local, mesh=mesh, in_specs=spec,
                         out_specs=spec)(gstate)

    return wrapped


def shard_reduce_fn(fn, g: Grid, mesh: Mesh):
    """Lift a shard-local state->replicated-scalar(s) function (the function
    must psum internally, e.g. via ops.fields.all_sum)."""
    in_spec = P(*g.mesh_axes)

    def wrapped(gstate):
        def local(gs):
            return fn(local_view(gs))

        return shard_map(local, mesh=mesh, in_specs=in_spec,
                         out_specs=P())(gstate)

    return wrapped


def dryrun(n_devices: int) -> None:
    """Driver hook: jit + run ONE full sharded training step on tiny shapes
    over an n_devices mesh (decomposed along y like the reference harris
    deck's 1 x nproc x 1 topology, harris:153-156)."""
    from ..models import harris

    p = harris.HarrisParams(nx=8, ny=8 * n_devices, nz=1, nppc=8,
                            Lx=4.0, Ly=4.0 * n_devices,
                            topology=(1, n_devices, 1),
                            sort_interval=0)
    sim = harris.build(p)
    state = sim.initialize()
    step = sim.make_step()
    state = step(state)
    jax.block_until_ready(state.fields.ex)
    en = sim.energies(state)
    assert bool(jax.numpy.isfinite(en).all()), "non-finite energies"
    print(f"dryrun_multichip({n_devices}): ok, step={int(state.step.max())}, "
          f"energies={np.asarray(en)}")

    # and one step of an IRREGULAR domain graph (join_domain across
    # ranks, per-face partner-table ppermutes): a 4-rank x line spliced
    # into two independent 2-rank periodic rings
    if n_devices >= 4:
        import vpic_jax as vt
        simj = vt.Simulation(seed=0)
        simj.define_units(1.0, 1.0)
        g0 = vt.partition_periodic_box(0, 0, 0, 4.0, 1.0, 0.125,
                                       32, 8, 1)
        simj.define_timestep(0.7 * g0.courant_length())
        simj.define_periodic_grid((0, 0, 0), (4.0, 1.0, 0.125),
                                  (32, 8, 1), (4, 1, 1))
        simj.define_material("vacuum", 1.0)
        simj.define_field_array(damp=0.0)
        ele = simj.define_species("electron", -1.0, 1.0, 256)
        for i in range(64):
            simj.inject_particle(ele, 0.0625 * i + 0.03, 0.5, 0.0625,
                                 0.5, 0.1, 0.0, w=1.0)
        simj.join_domain(3, 1, 0)
        simj.join_domain(3, 0, 1)
        simj.join_domain(3, 3, 2)
        simj.join_domain(3, 2, 3)
        statej = simj.make_step()(simj.initialize())
        jax.block_until_ready(statej.fields.ex)
        assert int(np.asarray(statej.species[0].np).sum()) == 64
        print(f"dryrun_multichip({n_devices}): irregular-join ok")

    # sharded surface emitter: per-shard component lists sliced by
    # axis_index inside the step (round-4 fix; deck/wrapper.h:310-383)
    from ..models import emission as EM
    sime = EM.build(EM.EmissionParams(topology=(2, 1, 1), nx=32, ny=8))
    statee = sime.make_step()(sime.initialize())
    jax.block_until_ready(statee.fields.ex)
    n_emitted = int(np.asarray(statee.species[0].live).sum())
    assert n_emitted > 0, "sharded emitter emitted nothing"
    print(f"dryrun_multichip({n_devices}): sharded-emitter ok "
          f"({n_emitted} emitted)")

    # 3-D deck on a full (2,2,2) mesh (all axes sharded)
    if n_devices >= 8:
        import vpic_jax as vt
        sim3 = vt.Simulation(seed=2)
        sim3.define_units(1.0, 1.0)
        n3 = 32
        g3 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, n3, n3, n3,
                                       2, 2, 2)
        sim3.define_timestep(0.6 * g3.courant_length())
        sim3.define_periodic_grid((0, 0, 0), (1, 1, 1), (n3, n3, n3),
                                  topology=(2, 2, 2))
        sim3.define_material("vacuum", 1.0)
        sim3.define_field_array(damp=0.0)
        el3 = sim3.define_species("e", -1.0, 1.0, 8192, -1, 4, 1)
        rng3 = np.random.default_rng(0)
        for _ in range(512):
            sim3.inject_particle(el3, *rng3.uniform(0.01, 0.99, 3),
                                 *rng3.normal(0, 0.3, 3), 1.0)
        state3 = sim3.make_step()(sim3.initialize())
        jax.block_until_ready(state3.fields.ex)
        en3 = sim3.energies(state3)
        assert bool(jax.numpy.isfinite(en3).all()), "3-D: non-finite"
        print(f"dryrun_multichip({n_devices}): (2,2,2) 3-D ok")

    # custom particle-BC handler (maxwellian_reflux) on a DECOMPOSED face:
    # every y-shard owns a piece of the low-x reflux wall, and the handler
    # key decorrelates per shard (boundary_p.cc:36-518 analogue under
    # shard_map)
    import vpic_jax as vt
    from ..boundary_ops import maxwellian_reflux
    simr = vt.Simulation(seed=3)
    simr.define_units(1.0, 1.0)
    gr = vt.partition_periodic_box(0, 0, 0, 1.0, 2.0, 0.125, 16, 16, 1,
                                   1, 2, 1)
    simr.define_timestep(0.6 * gr.courant_length())
    simr.define_periodic_grid((0, 0, 0), (1.0, 2.0, 0.125), (16, 16, 1),
                              topology=(1, 2, 1))
    simr.define_material("vacuum", 1.0)
    simr.define_field_array(damp=0.0)
    elr = simr.define_species("e", -1.0, 1.0, 512, -1, 4, 1)
    rngr = np.random.default_rng(1)
    for _ in range(128):
        simr.inject_particle(elr, rngr.uniform(0.02, 0.2),
                             rngr.uniform(0.05, 1.95), 0.0625,
                             -abs(rngr.normal(0, 0.8)),
                             rngr.normal(0, 0.3), 0.0, 1.0)
    simr.set_domain_particle_bc(
        vt.BOUNDARY(-1, 0, 0),
        maxwellian_reflux({"e": 0.3}, {"e": 0.3}))
    stater = simr.make_step()(simr.initialize())
    jax.block_until_ready(stater.fields.ex)
    nr = int(np.asarray(stater.species[0].live).sum())
    assert nr == 128, f"reflux lost particles: {nr}"
    print(f"dryrun_multichip({n_devices}): sharded-reflux ok")

    # collisional deck (Takizuka-Abe binary pairing) on a (2,1,1) mesh:
    # per-shard partition sort + pairing + scatter under shard_map
    from ..models import reconnection as RC
    simc = RC.build(RC.ReconnectionParams(
        nx=16, ny=8, nz=1, nppc=8, Lx=8.0, Ly=4.0, Lz=1.0,
        topology=(2, 1, 1), tau_coll_interval=1))
    statec = simc.make_step()(simc.initialize())
    jax.block_until_ready(statec.fields.ex)
    enc = simc.energies(statec)
    assert bool(jax.numpy.isfinite(enc).all()), "sharded T&A: non-finite"
    print(f"dryrun_multichip({n_devices}): sharded-collisional (2,1,1) ok")
