"""Checkpoint / restart.

The reference serializes a registered-object graph per rank with function
pointers by symbol name (src/util/checkpt/, SURVEY 3.5).  Here the
state is a pure pytree + a reified deck config, so checkpointing is simply a
faithful array dump plus a JSON header; the deck (Python) is re-run to
rebuild the static program and the saved arrays replace the fresh state --
the analogue of --restore (deck/main.cc:74-91) with the config JSON playing
the role the function-pointer symbol table played.

``modify`` implements --modify (misc.cc:136+): ASCII "field value" lines
overriding num_step and the dump/clean intervals on restore.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .state import FieldState, SimState, SpeciesState

_FIELDS = [f.name for f in FieldState.__dataclass_fields__.values()]
_SP = [f.name for f in SpeciesState.__dataclass_fields__.values()]


def checkpt(state: SimState, fbase: str, tag=None, sim=None) -> str:
    """Write ``{fbase}.{tag}.npz`` (+ .json config).  Like the reference's
    checkpt(fbase, tag) naming (deck/main.cc:47-54)."""
    tag = int(state.step.max()) if tag is None else tag
    fname = f"{fbase}.{tag}"
    arrays = {}
    for n in _FIELDS:
        arrays[f"f.{n}"] = np.asarray(getattr(state.fields, n))
    for k, sp in enumerate(state.species):
        for n in _SP:
            arrays[f"sp{k}.{n}"] = np.asarray(getattr(sp, n))
    arrays["step"] = np.asarray(state.step)
    arrays["rng"] = np.asarray(state.rng)
    for n, v in (state.diag or {}).items():
        arrays[f"diag::{n}"] = np.asarray(v)
    np.savez_compressed(fname + ".npz", **arrays)

    if sim is not None:
        cfg = dict(
            num_step=sim.num_step,
            status_interval=sim.status_interval,
            sync_shared_interval=sim.sync_shared_interval,
            clean_div_e_interval=sim.clean_div_e_interval,
            clean_div_b_interval=sim.clean_div_b_interval,
            num_comm_round=sim.num_comm_round,
            damp=sim.damp,
            species=[dict(name=st.params.name, q=st.params.q, m=st.params.m,
                          capacity=st.params.capacity)
                     for st in sim.species],
            grid=dict(nx=sim.grid.nx, ny=sim.grid.ny, nz=sim.grid.nz,
                      dt=sim.grid.dt, topology=list(sim.grid.topology),
                      field_bc=list(sim.grid.field_bc),
                      particle_bc=list(sim.grid.particle_bc),
                      face_partners=(
                          None if sim.grid.face_partners is None else
                          [list(t) for t in sim.grid.face_partners])),
            user_global=getattr(sim, "user_global", {}),
        )
        with open(fname + ".json", "w") as fh:
            json.dump(cfg, fh, indent=1)
    return fname


def restore(fbase_tag: str, sim=None) -> SimState:
    """Rebuild a SimState from ``{fbase}.{tag}``.  If ``sim`` is given, its
    static config is sanity-checked against the saved one (the reference
    asserts equal world size on restore, DMPPolicy.h:40-57)."""
    data = np.load(fbase_tag + ".npz")
    cfg_path = fbase_tag + ".json"
    if sim is not None and os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            cfg = json.load(fh)
        gg = cfg["grid"]
        if (gg["nx"], gg["ny"], gg["nz"]) != (sim.grid.nx, sim.grid.ny,
                                              sim.grid.nz) or \
                tuple(gg["topology"]) != tuple(sim.grid.topology):
            raise ValueError("checkpoint grid/topology mismatch: "
                             f"{gg} vs {sim.grid}")
        fp_saved = gg.get("face_partners")
        fp_saved = (None if fp_saved is None else
                    tuple(tuple(t) for t in fp_saved))
        if fp_saved != sim.grid.face_partners:
            raise ValueError(
                "checkpoint domain-graph (face_partners) mismatch: saved "
                f"{fp_saved} vs deck {sim.grid.face_partners}; restore "
                "joined decks onto a sim with identical join_domain calls")
        sim.num_step = cfg["num_step"]
        sim.user_global = cfg.get("user_global", {})

    fields = FieldState(**{n: jnp.asarray(data[f"f.{n}"]) for n in _FIELDS})
    species = []
    k = 0
    while f"sp{k}.dx" in data:
        species.append(SpeciesState(
            **{n: jnp.asarray(data[f"sp{k}.{n}"]) for n in _SP}))
        k += 1
    diag = {n[len("diag::"):]: jnp.asarray(data[n])
            for n in data.files if n.startswith("diag::")}
    return SimState(fields=fields, species=tuple(species),
                    step=jnp.asarray(data["step"]),
                    rng=jnp.asarray(data["rng"]), diag=diag)


def remap(fbase_tag: str, sim) -> SimState:
    """restart_remap analogue (the reference ships an offline tool to
    re-decompose per-rank restart dumps onto a different rank count):
    load ``{fbase}.{tag}`` written under ANY topology and rebuild the
    state for ``sim``'s topology.  The global grid must match; per-shard
    species capacities come from the new deck.  Fields re-split exactly
    (interior seams take the neighbor's synchronized values; the global
    ghost shell is preserved); particle voxel indices are re-derived
    from global cells; RNG streams re-broadcast (like ranks changing in
    the reference); diag tallies keep their global sums on shard 0."""
    data = np.load(fbase_tag + ".npz")
    with open(fbase_tag + ".json") as fh:
        cfg = json.load(fh)
    gg = cfg["grid"]
    told = tuple(gg["topology"])
    g = sim.grid
    tnew = g.topology
    if g.face_partners is not None or gg.get("face_partners") is not None:
        # re-decomposition assumes cartesian brick adjacency; an irregular
        # join graph has no unique re-split across a different topology
        raise NotImplementedError(
            "remap across topologies is cartesian-only; restore joined "
            "(face_partners) decks onto the same topology with restore()")
    nxo, nyo, nzo = gg["nx"], gg["ny"], gg["nz"]
    if (nxo * told[0], nyo * told[1], nzo * told[2]) != (g.gnx, g.gny,
                                                         g.gnz):
        raise ValueError("remap: global grid mismatch")
    sh_old = told != (1, 1, 1)
    sh_new = g.sharded
    NXo, NYo, NZo = nxo + 2, nyo + 2, nzo + 2
    NXn, NYn, NZn = g.NX, g.NY, g.NZ

    def stitch(A):
        """(px,py,pz,NZo,NYo,NXo) or (NZo,NYo,NXo) -> ghost-extended
        global (gnz+2, gny+2, gnx+2)."""
        if not sh_old:
            return np.asarray(A)
        A = np.asarray(A)
        G = np.zeros((g.gnz + 2, g.gny + 2, g.gnx + 2), A.dtype)
        px, py, pz = told
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    G[sz * nzo:sz * nzo + NZo, sy * nyo:sy * nyo + NYo,
                      sx * nxo:sx * nxo + NXo] = A[sx, sy, sz]
        # second pass: owners win the interiors (a neighbor's ghost copy
        # may have clobbered them above; equal for synchronized fields,
        # but be exact regardless)
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    G[1 + sz * nzo:1 + (sz + 1) * nzo,
                      1 + sy * nyo:1 + (sy + 1) * nyo,
                      1 + sx * nxo:1 + (sx + 1) * nxo] = \
                        A[sx, sy, sz][1:-1, 1:-1, 1:-1]
        return G

    def split(G):
        if not sh_new:
            return jnp.asarray(G)
        px, py, pz = tnew
        nxn, nyn, nzn = g.nx, g.ny, g.nz
        out = np.zeros(tnew + (NZn, NYn, NXn), G.dtype)
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    out[sx, sy, sz] = G[sz * nzn:sz * nzn + NZn,
                                        sy * nyn:sy * nyn + NYn,
                                        sx * nxn:sx * nxn + NXn]
        return jnp.asarray(out)

    fields = FieldState(**{n: split(stitch(data[f"f.{n}"]))
                           for n in _FIELDS})

    # ---- species: gather live lanes globally, re-derive voxels ----
    species = []
    k = 0
    while f"sp{k}.dx" in data:
        cols = {n: np.asarray(data[f"sp{k}.{n}"]) for n in _SP}
        live = cols["live"].reshape(-1).astype(bool)
        flat = {n: cols[n].reshape(-1)[live]
                for n in _SP if n not in ("np",)}
        if sh_old:
            # per-lane owning shard from the storage layout
            px, py, pz = told
            Nl = cols["dx"].shape[-1]
            sidx = np.indices((px, py, pz))
            lane_shard = np.broadcast_to(
                sidx[:, :, :, :, None], (3, px, py, pz, Nl)
            ).reshape(3, -1)[:, live]
        else:
            lane_shard = np.zeros((3, int(live.sum())), np.int64)
        i = flat["i"].astype(np.int64)
        zi, r = np.divmod(i, NXo * NYo)
        yi, xi = np.divmod(r, NXo)
        # canonicalize fused-path resident indices (checkpoints store them
        # raw): unwrapped-y images (nz == 1) and periodic ghost cells
        if nzo == 1:
            yu = yi + (zi - 1) * NYo
            yi = (yu - 1) % nyo + 1
            zi = np.ones_like(zi)
        xi = (xi - 1) % nxo + 1
        yi = (yi - 1) % nyo + 1
        zi = (zi - 1) % nzo + 1
        gxi = xi + lane_shard[0] * nxo
        gyi = yi + lane_shard[1] * nyo
        gzi = zi + lane_shard[2] * nzo
        nsx = np.clip((gxi - 1) // g.nx, 0, tnew[0] - 1)
        nsy = np.clip((gyi - 1) // g.ny, 0, tnew[1] - 1)
        nsz = np.clip((gzi - 1) // g.nz, 0, tnew[2] - 1)
        lx = gxi - nsx * g.nx
        ly = gyi - nsy * g.ny
        lz = gzi - nsz * g.nz
        new_i = (lx + NXn * (ly + NYn * lz)).astype(np.int32)

        cap = sim.species[k].params.capacity
        shp = (tnew + (cap,)) if sh_new else (cap,)
        out = {n: np.zeros(shp, cols[n].dtype) for n in _SP
               if n not in ("np",)}
        out["live"] = np.zeros(shp, bool)
        # vectorized placement: stable-sort lanes by target shard, then
        # each lane's slot is its rank within its shard run
        key = (nsx * tnew[1] + nsy) * tnew[2] + nsz
        order = np.argsort(key, kind="stable")
        ks = key[order]
        counts3 = np.bincount(ks, minlength=int(np.prod(tnew))).reshape(
            tnew)
        if counts3.max(initial=0) > cap:
            sdt = np.unravel_index(counts3.argmax(), tnew)
            raise RuntimeError(
                f"remap: species {k} shard {tuple(int(v) for v in sdt)} "
                f"holds {int(counts3.max())} > capacity {cap}; raise "
                f"max_local_np in the new deck")
        run_start = np.concatenate([[0], np.cumsum(np.bincount(
            ks, minlength=int(np.prod(tnew))))[:-1]])
        slot = np.arange(ks.size) - run_start[ks]
        tgt = ((nsx[order], nsy[order], nsz[order], slot) if sh_new
               else (slot,))
        for n in out:
            if n == "i":
                out[n][tgt] = new_i[order]
            elif n == "live":
                out[n][tgt] = True
            else:
                out[n][tgt] = flat[n][order]
        npc = counts3 if sh_new else np.int32(counts3.reshape(()))
        species.append(SpeciesState(
            **{n: jnp.asarray(out[n]) for n in out},
            np=jnp.asarray(npc, jnp.int32)))
        k += 1

    step_scalar = int(np.asarray(data["step"]).max())
    step = (jnp.full(tnew, step_scalar, jnp.int32) if sh_new
            else jnp.int32(step_scalar))
    rng0 = np.asarray(data["rng"]).reshape(-1, 2)[0]
    rng = (jnp.broadcast_to(jnp.asarray(rng0, jnp.uint32),
                            tnew + (2,)) if sh_new
           else jnp.asarray(rng0, jnp.uint32))
    diag = {}
    for n in data.files:
        if not n.startswith("diag::"):
            continue
        v = np.asarray(data[n])
        name = n[len("diag::"):]
        per = v.reshape(-1, *v.shape[len(told):]) if sh_old else v[None]
        if per.shape[1:] == ():
            tot = per.sum(axis=0)          # scalar tallies: global sum
        elif per.ndim == 1:
            tot = per.sum(axis=0)
        else:
            # non-scalar leaves (link_boundary ring buffers) cannot be
            # merged element-wise; they reset -- flush write_links before
            # remapping if the pending records matter
            tot = np.zeros(per.shape[1:], v.dtype)
        if sh_new:
            out = np.zeros(tnew + tot.shape, v.dtype)
            out[(0,) * 3] = tot
            diag[name] = jnp.asarray(out)
        else:
            diag[name] = jnp.asarray(tot)
    return SimState(fields=fields, species=tuple(species), step=step,
                    rng=rng, diag=diag)


def modify(sim, path: str):
    """--modify (misc.cc:136+): ASCII 'field value' per line."""
    allowed = {"num_step", "status_interval", "sync_shared_interval",
               "clean_div_e_interval", "clean_div_b_interval",
               "num_comm_round"}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 2:
                continue
            field, val = parts
            if field in allowed:
                setattr(sim, field, int(float(val)))
    return sim


def checksum(state: SimState) -> str:
    """Field/species state checksum (the optional OpenSSL checksum hooks,
    src/vpic/misc.cc:177-280) for regression comparisons."""
    import hashlib
    h = hashlib.sha256()
    for n in _FIELDS:
        h.update(np.asarray(getattr(state.fields, n)).tobytes())
    for sp in state.species:
        for n in _SP:
            h.update(np.asarray(getattr(sp, n)).tobytes())
    return h.hexdigest()
