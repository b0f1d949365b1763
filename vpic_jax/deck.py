"""The deck layer: VPIC's input-deck vocabulary as a Python builder.

The reference compiles user C++ decks *into* the binary (bin/vpic.in +
deck/wrapper.h); here a deck is ordinary Python driving a ``Simulation``
builder with the same vocabulary (define_units, define_timestep,
define_periodic_grid, set_domain_field_bc, define_material,
define_field_array, define_species, set_region_field, inject_particle, ...),
which compiles to a static ``Grid`` + ``MaterialCoeffs`` and a ``SimState``
pytree, plus a single jitted ``advance`` step (src/vpic/advance.cc:15-208).

Host-side staging (particle injection, region rasterization) runs in numpy at
double precision exactly like the reference's deck execution
(misc.cc:16-100); everything per-step runs on device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dfield
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid import (ABSORB_FIELDS, ABSORB_PARTICLES, BOUNDARY, FACE_AXIS,
                   FACE_SIDE, PEC, PERIODIC, P_PERIODIC, REFLECT_PARTICLES,
                   Grid, partition_absorbing_box, partition_metal_box,
                   partition_periodic_box)
from . import boundary as B
from .ops import fields as F
from .ops import interp as I
from .ops import push as P
from .state import (FieldState, MaterialCoeffs, SimState, SpeciesParams,
                    SpeciesState)

everywhere = lambda x, y, z: True


def _run_singles(step_fn, state, n):
    for _ in range(n):
        state = step_fn(state)
    return state


@dataclass
class Material:
    name: str
    epsx: float = 1.0
    epsy: float = 1.0
    epsz: float = 1.0
    mux: float = 1.0
    muy: float = 1.0
    muz: float = 1.0
    sigmax: float = 0.0
    sigmay: float = 0.0
    sigmaz: float = 0.0
    zetax: float = 0.0
    zetay: float = 0.0
    zetaz: float = 0.0
    id: int = 0


@dataclass
class _StagedSpecies:
    params: SpeciesParams
    # host-side staged injections in injection order: (n, 12) float64
    # blocks of rows (dx, dy, dz, ix, iy, iz, ux, uy, uz, w, age,
    # update_rhob), one block per inject_particles call
    blocks: List[np.ndarray] = dfield(default_factory=list)

    def rows(self) -> np.ndarray:
        return (np.concatenate(self.blocks) if self.blocks
                else np.zeros((0, 12)))


class Simulation:
    """vpic_simulation analogue (src/vpic/vpic.h:120-671)."""

    def __init__(self, seed: int = 0):
        self.grid: Optional[Grid] = None
        self.materials: List[Material] = []
        self.species: List[_StagedSpecies] = []
        self.damp = 0.0
        self._cvac = 1.0
        self._eps0 = 1.0
        self._dt = 0.0
        # High-level step-loop parameters (vpic.h:133-173)
        self.num_step = 0
        self.status_interval = 0
        self.sync_shared_interval = 0
        self.clean_div_e_interval = 0
        self.clean_div_b_interval = 0
        self.num_div_e_round = 2
        self.num_div_b_round = 2
        self.num_comm_round = 3
        self.max_streak = 4
        # User hooks (deck sections): callables state -> state pieces.
        self.user_field_injection = None      # (FieldState, step) -> FieldState
        self.user_current_injection = None    # (FieldState, step) -> FieldState
        self.user_particle_injection = None
        self.user_particle_collisions = None
        self.collision_ops: list = []
        self.emitters: list = []
        self.pbc_handlers: dict = {}   # face -> custom particle-BC handler
        # per-voxel-face particle-BC overrides (grid->neighbor analogue,
        # grid.h:116-121): (..., nv, 6) int32 codes
        self._vbc = None
        self._n_region_pbc = 0
        self._entropy = np.random.RandomState(seed)
        self._sync_entropy = np.random.RandomState(seed + 0x5EED)
        self._field_init: Optional[FieldState] = None
        self._rank = 0
        # user-global blob (vpic.h:189 user_global[16384]): arbitrary
        # JSON-serializable deck state carried through checkpoint/restore
        self.user_global: dict = {}

    # ---------------- units / grid ----------------

    def seed_entropy(self, seed: int):
        self._entropy = np.random.RandomState(seed + self._rank)
        self._sync_entropy = np.random.RandomState(seed + 0x5EED)

    def rng(self, _i: int = 0) -> np.random.RandomState:
        """Deck-level RNG pool handle (rng(i) in decks)."""
        return self._entropy

    def sync_rng(self, _i: int = 0) -> np.random.RandomState:
        return self._sync_entropy

    def uniform(self, rng, lo, hi):
        return lo + (hi - lo) * rng.random_sample()

    def normal(self, rng, mu, sigma):
        return mu + sigma * rng.standard_normal()

    def define_units(self, cvac: float, eps0: float):
        self._cvac = float(cvac)
        self._eps0 = float(eps0)

    def define_timestep(self, dt: float):
        self._dt = float(dt)

    def courant_length(self, lx, ly, lz, nx, ny, nz):
        s = 0.0
        if nx > 1:
            s += (nx / lx) ** 2
        if ny > 1:
            s += (ny / ly) ** 2
        if nz > 1:
            s += (nz / lz) ** 2
        return s ** -0.5

    def define_periodic_grid(self, lo, hi, n, topology=(1, 1, 1)):
        self.grid = partition_periodic_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def define_absorbing_grid(self, lo, hi, n, topology=(1, 1, 1),
                              pbc=ABSORB_PARTICLES):
        self.grid = partition_absorbing_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            pbc=pbc, dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def define_reflecting_grid(self, lo, hi, n, topology=(1, 1, 1)):
        self.grid = partition_metal_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def size_domain(self, nx, ny, nz):
        """size_domain (vpic.h:380, grid/ops.c partition entry): a
        particle-reflecting metal box with unit spacing at the origin;
        decks then override geometry via set_domain_geometry and faces
        via set_domain_field_bc / join_domain, exactly the reference's
        size_domain -> grid->x0/dx surgery -> set_fbc/join_grid flow."""
        self.grid = partition_metal_box(
            0.0, 0.0, 0.0, float(nx), float(ny), float(nz),
            int(nx), int(ny), int(nz), 1, 1, 1,
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def set_domain_geometry(self, x0=None, y0=None, z0=None,
                            dx=None, dy=None, dz=None):
        """The deck-side analogue of writing grid->x0/dx directly
        (sample/cygnus:88-95): rebuild the frozen Grid with the new
        corner / spacing (the Grid stores corners; spacings are derived,
        so dx overrides become x1 = x0 + dx*gnx)."""
        import dataclasses as _dc
        g = self.grid
        nx0 = g.x0 if x0 is None else float(x0)
        ny0 = g.y0 if y0 is None else float(y0)
        nz0 = g.z0 if z0 is None else float(z0)
        nx1 = nx0 + (float(dx) * g.gnx if dx is not None
                     else (g.x1 - g.x0))
        ny1 = ny0 + (float(dy) * g.gny if dy is not None
                     else (g.y1 - g.y0))
        nz1 = nz0 + (float(dz) * g.gnz if dz is not None
                     else (g.z1 - g.z0))
        self.grid = _dc.replace(g, x0=nx0, y0=ny0, z0=nz0,
                                x1=nx1, y1=ny1, z1=nz1)
        return self.grid

    def join_domain(self, boundary: int, rank: int, src_rank: int = 0):
        """join_domain (grid/ops.c:119 join_grid): connect a local face to
        another domain's opposite face.
        - self-join (rank == src_rank) on an unsharded axis: the face pair
          becomes periodic (sample/cygnus:96-97's 2-D y periodicity).
        - rank != src_rank: an irregular domain-graph join.  The grid's
          per-face partner tables (seeded from the cartesian topology the
          first time) record that src_rank's ``boundary`` face connects to
          ``rank``'s opposite face; halo exchange and particle migration
          then ride explicit flat-rank ppermute pairs (grid/ops.c:119-212's
          hand-wired port splicing).  Joins are reciprocal: the opposite
          entry on ``rank`` is updated (and any stale link unspliced), so
          each face's partner map stays a valid permutation."""
        face = int(boundary)
        if rank == src_rank:
            from .grid import P_PERIODIC, PERIODIC
            axis = face % 3
            # periodicity needs both faces of the axis; apply to the pair
            self.grid = self.grid.with_bc(axis, fbc=PERIODIC,
                                          pbc=P_PERIODIC)
            self.grid = self.grid.with_bc(axis + 3, fbc=PERIODIC,
                                          pbc=P_PERIODIC)
            return self.grid
        import dataclasses as _dc
        from .grid import cartesian_partners
        g = self.grid
        n = g.n_shards
        if not (0 <= rank < n and 0 <= src_rank < n):
            raise ValueError(
                f"join_domain({face}, {rank}, {src_rank}): ranks must be "
                f"< n_shards ({n}); partition with a topology covering "
                "every domain first")
        tabs = [list(t) for t in (g.face_partners
                                  or cartesian_partners(g))]
        opp = (face + 3) % 6

        def unlink(fc, r):
            p = tabs[fc][r]
            if p >= 0 and tabs[(fc + 3) % 6][p] == r:
                tabs[(fc + 3) % 6][p] = -1
            tabs[fc][r] = -1

        unlink(face, src_rank)
        unlink(opp, rank)
        tabs[face][src_rank] = rank
        tabs[opp][rank] = src_rank
        self.grid = _dc.replace(
            g, face_partners=tuple(tuple(t) for t in tabs))
        return self.grid

    def set_domain_field_bc(self, face: int, bc: int):
        self.grid = self.grid.with_bc(face, fbc=bc)

    def set_domain_particle_bc(self, face: int, bc):
        """bc: a built-in code (reflect/absorb/...) or a custom handler
        built by vpic_jax.boundary_ops (maxwellian_reflux, absorb_tally...)
        -- the define/set particle-BC vocabulary (vpic.h:510-530)."""
        if callable(bc):
            self.pbc_handlers[face] = bc
            from .grid import FIRST_CUSTOM_PBC
            bc = FIRST_CUSTOM_PBC - len(self.pbc_handlers) + 1
        self.grid = self.grid.with_bc(face, pbc=bc)

    def set_region_particle_bc(self, region, bc):
        """Attach a particle BC to the SURFACE of an interior region: the
        per-voxel neighbor-table encoding of the reference (grid.h:116-121,
        decoded at boundary_p.cc:196-255), which lets decks hang reflux /
        absorb / custom surfaces on interior region boundaries instead of
        whole domain faces.  Every voxel face between a cell inside the
        region and a cell outside it gets the code ON BOTH SIDES (exit
        face of either cell).  ``bc`` is REFLECT_PARTICLES,
        ABSORB_PARTICLES, or a custom handler built by
        vpic_jax.boundary_ops (registered under key 6 + 6*h + face and
        dispatched by boundary_p exactly like domain-face handlers; the
        geometric exit face is key % 6).  Rasterized per shard on
        decomposed grids (leading topology dims, sliced via axis_index
        inside the jitted step, like set_region_material)."""
        from .grid import ABSORB_PARTICLES, REFLECT_PARTICLES
        from .ops.push import CUSTOM_BASE
        g = self.grid
        if callable(bc):
            h = self._n_region_pbc
            self._n_region_pbc += 1
            for f in range(6):
                self.pbc_handlers[6 + 6 * h + f] = bc
            codes = [CUSTOM_BASE + 6 + 6 * h + f for f in range(6)]
        else:
            if int(bc) not in (ABSORB_PARTICLES, REFLECT_PARTICLES):
                raise ValueError("set_region_particle_bc: bc must be "
                                 "ABSORB/REFLECT or a handler")
            codes = [int(bc)] * 6

        if self._vbc is None:
            lead = g.topology if g.sharded else ()
            self._vbc = np.zeros(lead + (g.NZ, g.NY, g.NX, 6), np.int32)

        def paint(vb, sx, sy, sz):
            xc = g.x0 + g.dx * (sx * g.nx + np.arange(g.NX) - 0.5)
            yc = g.y0 + g.dy * (sy * g.ny + np.arange(g.NY) - 0.5)
            zc = g.z0 + g.dz * (sz * g.nz + np.arange(g.NZ) - 0.5)
            Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
            inside = np.vectorize(region, otypes=[bool])(X, Y, Z)
            aa = {0: 2, 1: 1, 2: 0}    # grid axis -> array axis
            for ax in range(3):
                a = aa[ax]
                # neighbor in +ax: nb_hi[v] = inside[v + 1]
                nb_hi = np.roll(inside, -1, axis=a)
                nb_hi[(slice(None),) * a + (-1,)] = inside[
                    (slice(None),) * a + (-1,)]
                face_hi = inside != nb_hi        # in/out face above v
                # exit face f = ax + 3 seen from v; f = ax seen from v+1
                vb[..., ax + 3][face_hi] = codes[ax + 3]
                lo_of_upper = np.roll(face_hi, 1, axis=a)
                lo_of_upper[(slice(None),) * a + (0,)] = False
                vb[..., ax][lo_of_upper] = codes[ax]

        if not g.sharded:
            paint(self._vbc, 0, 0, 0)
        else:
            px, py, pz = g.topology
            for sx in range(px):
                for sy in range(py):
                    for sz in range(pz):
                        paint(self._vbc[sx, sy, sz], sx, sy, sz)

    def _local_vbc(self):
        """Shard-local (nv*6,) flat per-voxel-face BC codes, or None."""
        if self._vbc is None:
            return None
        g = self.grid
        vb = jnp.asarray(self._vbc)
        if g.sharded:
            idx = tuple(jax.lax.axis_index(a) for a in g.mesh_axes)
            vb = vb[idx]
        return vb.reshape(-1)

    def define_surface_emitter(self, emitter_factory, region, sp: SpeciesParams,
                               **kw):
        """define_surface_emitter (deck/wrapper.h:310-383): scan the region's
        surface into a static component list and register the emission op."""
        from . import emitter as E
        comps = E.surface_components(self.grid, region)
        op = emitter_factory(sp.id, sp, comps, **kw)
        self.emitters.append(op)
        return op

    def define_volume_emitter(self, emitter_factory, region,
                              sp: SpeciesParams, **kw):
        """define_volume_emitter (deck/wrapper.h:348-383): every face of
        every in-region cell becomes an emission component."""
        from . import emitter as E
        comps = E.volume_components(self.grid, region)
        op = emitter_factory(sp.id, sp, comps, **kw)
        self.emitters.append(op)
        return op

    # ---------------- materials / field array ----------------

    def define_material(self, name, eps=1.0, mu=1.0, sigma=0.0, zeta=0.0,
                        **tensor) -> Material:
        def three(v):
            return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)

        ex, ey, ez = three(tensor.get("eps", eps))
        mx, my, mz = three(tensor.get("mu", mu))
        sx, sy, sz = three(tensor.get("sigma", sigma))
        zx, zy, zz = three(tensor.get("zeta", zeta))
        m = Material(name, ex, ey, ez, mx, my, mz, sx, sy, sz, zx, zy, zz,
                     id=len(self.materials))
        self.materials.append(m)
        return m

    def lookup_material(self, name: str) -> Material:
        for m in self.materials:
            if m.name == name:
                return m
        raise KeyError(name)

    def define_field_array(self, _kernels=None, damp: float = 0.0):
        self.damp = float(damp)
        self._field_ops = []
        # Material-id meshes at the 8 stagger classes (field_t material
        # members, field_advance.h:152-160), filled by set_region_material.
        g = self.grid
        self._mat_ids = {k: np.zeros(g.shape, np.int16)
                         for k in ("ematx", "ematy", "ematz", "nmat",
                                   "fmatx", "fmaty", "fmatz", "cmat")}
        self._multi_material = False

    def set_region_material(self, region, volume_mat, surface_mat=None):
        """set_region_material (deck/wrapper.h:211-253): assign the volume
        material to every stagger location fully inside the region and the
        surface material to locations partially inside.  On a decomposed
        grid every shard's ghosted brick is rasterized with its own global
        coordinate offsets (the reference's region macros run per MPI rank
        the same way), giving id meshes with leading topology dims."""
        if isinstance(volume_mat, str):
            volume_mat = self.lookup_material(volume_mat)
        if isinstance(surface_mat, str):
            surface_mat = self.lookup_material(surface_mat)
        if surface_mat is None:
            surface_mat = volume_mat
        g = self.grid
        self._multi_material = True
        if g.sharded and self._mat_ids["cmat"].ndim == 3:
            self._mat_ids = {k: np.zeros(g.topology + g.shape, np.int16)
                             for k in self._mat_ids}

        def paint(ids_view, sx, sy, sz):
            xc = g.x0 + g.dx * (sx * g.nx + np.arange(g.NX) - 0.5)
            yc = g.y0 + g.dy * (sy * g.ny + np.arange(g.NY) - 0.5)
            zc = g.z0 + g.dz * (sz * g.nz + np.arange(g.NZ) - 0.5)
            Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
            inside = np.vectorize(region, otypes=[bool])(X, Y, Z)

            def sh(dz, dy, dx):
                """inside(cell shifted -d), i.e. out[v] = inside[v - d];
                False beyond the array edge.  Offsets are 0 or 1."""
                NZ, NY, NX = inside.shape
                out = np.zeros_like(inside)
                out[dz:, dy:, dx:] = inside[:NZ - dz, :NY - dy, :NX - dx]
                return out

            ccc = inside
            lcc = sh(0, 0, 1)   # cell (i-1, j, k) relative to voxel i
            clc = sh(0, 1, 0)
            llc = sh(0, 1, 1)
            ccl = sh(1, 0, 0)
            lcl = sh(1, 0, 1)
            cll = sh(1, 1, 0)
            lll = sh(1, 1, 1)

            combos = dict(
                ematx=(ccc, clc, ccl, cll), ematy=(ccc, ccl, lcc, lcl),
                ematz=(ccc, lcc, clc, llc), fmatx=(ccc, lcc),
                fmaty=(ccc, clc), fmatz=(ccc, ccl),
                nmat=(ccc, lcc, clc, llc, ccl, lcl, cll, lll))
            for name, cells in combos.items():
                any_in = np.logical_or.reduce(cells)
                all_in = np.logical_and.reduce(cells)
                ids = ids_view[name]
                ids[any_in] = surface_mat.id
                ids[all_in] = volume_mat.id
            ids_view["cmat"][ccc] = volume_mat.id

        if not g.sharded:
            paint(self._mat_ids, 0, 0, 0)
        else:
            px, py, pz = g.topology
            for sx in range(px):
                for sy in range(py):
                    for sz in range(pz):
                        paint({k: v[sx, sy, sz]
                               for k, v in self._mat_ids.items()},
                              sx, sy, sz)

    def _axis_coeffs(self, sigma, eps):
        """Exponential differencing coefficients (sfa.c:115-133)."""
        g = self.grid
        ax = (sigma * g.dt) / (eps * g.eps0)
        decay = math.exp(-ax)
        if ax == 0:
            drive = 1.0 / eps
        elif decay == 0:
            drive = 0.0
        else:
            drive = 2.0 * math.exp(-0.5 * ax) * math.sinh(0.5 * ax) / (ax * eps)
        return decay, drive

    def _material_coeffs(self) -> MaterialCoeffs:
        """create_sfa_params (sfa.c:55-151).  Single material -> 0-d scalar
        coefficients (the vacuum fast-kernel analogue, sfa.c:202-211);
        region-assigned multi-material meshes pre-expand the per-material
        tables onto the stagger-matched id meshes (gather-free
        stencils)."""
        if not self.materials:
            raise RuntimeError("no materials defined")
        if not getattr(self, "_multi_material", False):
            m = self.materials[0]
            dx_, vx = self._axis_coeffs(m.sigmax, m.epsx)
            dy_, vy = self._axis_coeffs(m.sigmay, m.epsy)
            dz_, vz = self._axis_coeffs(m.sigmaz, m.epsz)
            noncond = 1.0 if (m.sigmax == 0 and m.sigmay == 0
                              and m.sigmaz == 0) else 0.0
            fl = lambda v: jnp.float32(v)
            return MaterialCoeffs(
                decayx=fl(dx_), decayy=fl(dy_), decayz=fl(dz_),
                drivex=fl(vx), drivey=fl(vy), drivez=fl(vz),
                rmux=fl(1.0 / m.mux), rmuy=fl(1.0 / m.muy),
                rmuz=fl(1.0 / m.muz), nonconductive=fl(noncond),
                epsx=fl(m.epsx), epsy=fl(m.epsy), epsz=fl(m.epsz))

        nm = len(self.materials)
        decay = np.zeros((nm, 3), np.float32)
        drive = np.zeros((nm, 3), np.float32)
        rmu = np.zeros((nm, 3), np.float32)
        noncond = np.zeros((nm,), np.float32)
        eps = np.zeros((nm, 3), np.float32)
        for m in self.materials:
            for a, (sg, ep) in enumerate(((m.sigmax, m.epsx),
                                          (m.sigmay, m.epsy),
                                          (m.sigmaz, m.epsz))):
                decay[m.id, a], drive[m.id, a] = self._axis_coeffs(sg, ep)
            rmu[m.id] = (1.0 / m.mux, 1.0 / m.muy, 1.0 / m.muz)
            eps[m.id] = (m.epsx, m.epsy, m.epsz)
            noncond[m.id] = 1.0 if (m.sigmax == 0 and m.sigmay == 0
                                    and m.sigmaz == 0) else 0.0
        ids = self._mat_ids
        j = jnp.asarray
        return MaterialCoeffs(
            decayx=j(decay[ids["ematx"], 0]), decayy=j(decay[ids["ematy"], 1]),
            decayz=j(decay[ids["ematz"], 2]),
            drivex=j(drive[ids["ematx"], 0]), drivey=j(drive[ids["ematy"], 1]),
            drivez=j(drive[ids["ematz"], 2]),
            rmux=j(rmu[ids["fmatx"], 0]), rmuy=j(rmu[ids["fmaty"], 1]),
            rmuz=j(rmu[ids["fmatz"], 2]),
            nonconductive=j(noncond[ids["nmat"]]),
            epsx=j(eps[ids["ematx"], 0]), epsy=j(eps[ids["ematy"], 1]),
            epsz=j(eps[ids["ematz"], 2]))

    def _local_material_coeffs(self, m: MaterialCoeffs) -> MaterialCoeffs:
        """Shard-local view of multi-material coefficient meshes: built
        with leading (px,py,pz) dims by set_region_material, sliced to this
        shard inside shard_map via the mesh axis indices (the analogue of
        each MPI rank holding its own sfa_params tables).  No-op for scalar
        (single-material) coefficients or unsharded grids."""
        g = self.grid
        if not (g.sharded and getattr(self, "_multi_material", False)):
            return m
        idx = tuple(jax.lax.axis_index(a) for a in g.mesh_axes)
        return jax.tree.map(
            lambda a: a[idx] if getattr(a, "ndim", 0) >= 3 else a, m)

    # ---------------- species / particles ----------------

    def define_species(self, name, q, m, max_local_np, max_local_nm=-1,
                       sort_interval=0, sort_out_of_place=1) -> SpeciesParams:
        p = SpeciesParams(name=name, q=float(q), m=float(m),
                          capacity=int(math.ceil(max_local_np)),
                          sort_interval=int(sort_interval),
                          id=len(self.species))
        self.species.append(_StagedSpecies(params=p))
        return p

    def _staged(self, sp: SpeciesParams) -> _StagedSpecies:
        return self.species[sp.id]

    def inject_particle(self, sp: SpeciesParams, x, y, z, ux, uy, uz, w,
                        age=0.0, update_rhob=0):
        """One particle; see inject_particles.  Decks that load many
        particles pass arrays to inject_particles instead."""
        self.inject_particles(sp, x, y, z, ux, uy, uz, w, age, update_rhob)

    def inject_particles(self, sp: SpeciesParams, x, y, z, ux, uy, uz, w,
                         age=0.0, update_rhob=0):
        """Robust global -> (voxel, offset) conversion in double precision
        (misc.cc:16-100), over arrays (scalars broadcast).  Particles
        outside the domain are skipped.  Host-side staging, binned per
        shard at initialize(); device-side runtime injection is provided by
        the emission module."""
        g = self.grid
        x, y, z, ux, uy, uz, w, age, urb = np.broadcast_arrays(
            *(np.asarray(v, np.float64) for v in
              (x, y, z, ux, uy, uz, w, age, update_rhob)))
        if (w < 0).any():
            raise ValueError("inject_particle: w < 0")
        keep = ((g.x0 <= x) & (x <= g.x1) & (g.y0 <= y) & (y <= g.y1)
                & (g.z0 <= z) & (z <= g.z1))

        def conv(v, v0, v1, n):
            v = float(n) * ((v - v0) / (v1 - v0))
            iv = np.trunc(v)
            v = v - iv
            v = (v + v) - 1.0
            top = iv == n
            return np.where(top, 1.0, v), np.where(top, n - 1, iv) + 1

        dx, ix = conv(x[keep], g.x0, g.x1, g.gnx)
        dy, iy = conv(y[keep], g.y0, g.y1, g.gny)
        dz, iz = conv(z[keep], g.z0, g.z1, g.gnz)
        self._staged(sp).blocks.append(np.stack(
            [dx, dy, dz, ix, iy, iz, ux[keep], uy[keep], uz[keep], w[keep],
             age[keep], urb[keep]], axis=1))

    # ---------------- field loading ----------------

    def set_region_field(self, region, ex=0, ey=0, ez=0, bx=0, by=0, bz=0):
        """set_point_region_field (deck/wrapper.h:190-210): evaluate each
        component's expression at its Yee stagger position (over ghosts too)
        wherever ``region(x,y,z)`` holds.  Expressions are scalars or
        callables f(x, y, z); B is stored internally as cB.  Recorded here,
        materialized per shard at initialize()."""
        self._field_ops.append((region, dict(ex=ex, ey=ey, ez=ez,
                                             bx=bx, by=by, bz=bz)))

    def _local_corner(self, sx: int, sy: int, sz: int):
        g = self.grid
        return (g.x0 + sx * g.nx * g.dx,
                g.y0 + sy * g.ny * g.dy,
                g.z0 + sz * g.nz * g.dz)

    def _materialize_fields(self, shard=(0, 0, 0)) -> np.ndarray:
        """Evaluate the recorded region-field ops on one shard's local
        ghosted mesh; returns 6 numpy arrays (ex, ey, ez, cbx, cby, cbz)."""
        g = self.grid
        c = g.cvac
        x0, y0, z0 = self._local_corner(*shard)
        xn = x0 + g.dx * (np.arange(g.NX) - 1.0)
        yn = y0 + g.dy * (np.arange(g.NY) - 1.0)
        zn = z0 + g.dz * (np.arange(g.NZ) - 1.0)
        xc, yc, zc = xn + 0.5 * g.dx, yn + 0.5 * g.dy, zn + 0.5 * g.dz

        out = {k: np.zeros(g.shape, np.float32)
               for k in ("ex", "ey", "ez", "cbx", "cby", "cbz")}
        # Yee stagger sample positions (wrapper.h:196-207).
        stagger = dict(ex=(xc, yn, zn), ey=(xn, yc, zn), ez=(xn, yn, zc),
                       cbx=(xn, yc, zc), cby=(xc, yn, zc), cbz=(xc, yc, zn))
        scales = dict(ex=1.0, ey=1.0, ez=1.0, cbx=c, cby=c, cbz=c)
        keymap = dict(ex="ex", ey="ey", ez="ez", bx="cbx", by="cby", bz="cbz")

        for region, exprs in self._field_ops:
            for ekey, expr in exprs.items():
                name = keymap[ekey]
                xs, ys, zs = stagger[name]
                Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
                if callable(expr):
                    vals = np.vectorize(expr, otypes=[np.float64])(X, Y, Z)
                else:
                    vals = np.full(X.shape, float(expr))
                if callable(region):
                    mask = np.vectorize(region, otypes=[bool])(X, Y, Z)
                else:
                    mask = np.full(X.shape, bool(region))
                out[name] = np.where(mask, scales[name] * vals,
                                     out[name]).astype(np.float32)
        return out

    # ---------------- initialize (initialize.cc:5-64) ----------------

    def _pack_species(self):
        """Stage injected particles into device buffers; with a sharded grid,
        bin per shard (global voxel -> (shard, local voxel)) and add the 3
        leading mesh dims.  Returns (species_states, update_rhob_masks)."""
        g = self.grid
        px, py, pz = g.topology
        out, urbs, ages = [], [], []
        for st in self.species:
            cap = st.params.capacity
            rows = st.rows()
            a, age, urb = rows[:, :10], rows[:, 10], rows[:, 11] != 0
            gi = a[:, 3].astype(np.int64)
            gj = a[:, 4].astype(np.int64)
            gk = a[:, 5].astype(np.int64)
            sx = (gi - 1) // g.nx
            sy_ = (gj - 1) // g.ny
            sz_ = (gk - 1) // g.nz
            li = gi - sx * g.nx
            lj = gj - sy_ * g.ny
            lk = gk - sz_ * g.nz
            vox = (li + g.NX * (lj + g.NY * lk)).astype(np.int32)

            # each particle's slot is its rank among its shard's particles,
            # in injection order
            shard_flat = (sx * py + sy_) * pz + sz_
            order = np.argsort(shard_flat, kind="stable")
            counts = np.bincount(shard_flat, minlength=px * py * pz)
            if counts.max(initial=0) > cap:
                s = np.unravel_index(counts.argmax(), (px, py, pz))
                raise RuntimeError(
                    f"species {st.params.name}: shard "
                    f"{tuple(int(v) for v in s)} overflows capacity {cap}")
            run_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
            ks = shard_flat[order]
            tgt = (sx[order], sy_[order], sz_[order],
                   np.arange(ks.size) - run_start[ks])
            counts = counts.reshape(px, py, pz).astype(np.int32)

            shape = (px, py, pz, cap)

            def buf(col, dtype):
                b = np.zeros(shape, dtype)
                b[tgt] = col[order]
                return b

            fbuf = {k: buf(a[:, c], np.float32) for k, c in (
                ("dx", 0), ("dy", 1), ("dz", 2), ("ux", 6), ("uy", 7),
                ("uz", 8), ("w", 9))}
            ibuf = buf(vox, np.int32)
            lbuf = buf(np.ones(len(a), bool), bool)
            ubuf = buf(urb, bool)
            abuf = buf(age, np.float32)

            def maybe_squeeze(arr):
                return arr[0, 0, 0] if not g.sharded else arr

            s = SpeciesState(
                dx=jnp.asarray(maybe_squeeze(fbuf["dx"])),
                dy=jnp.asarray(maybe_squeeze(fbuf["dy"])),
                dz=jnp.asarray(maybe_squeeze(fbuf["dz"])),
                i=jnp.asarray(maybe_squeeze(ibuf)),
                ux=jnp.asarray(maybe_squeeze(fbuf["ux"])),
                uy=jnp.asarray(maybe_squeeze(fbuf["uy"])),
                uz=jnp.asarray(maybe_squeeze(fbuf["uz"])),
                w=jnp.asarray(maybe_squeeze(fbuf["w"])),
                live=jnp.asarray(maybe_squeeze(lbuf)),
                np=(jnp.asarray(counts) if g.sharded
                    else jnp.int32(counts[0, 0, 0])))
            out.append(s)
            urbs.append(jnp.asarray(maybe_squeeze(ubuf)))
            ages.append(jnp.asarray(maybe_squeeze(abuf))
                        if age.any() else None)
        return tuple(out), tuple(urbs), tuple(ages)

    def _build_initial_fields(self):
        """Materialize the recorded region-field ops into a FieldState (with
        the 3 leading mesh dims when sharded)."""
        g = self.grid
        px, py, pz = g.topology
        if not g.sharded:
            vals = self._materialize_fields((0, 0, 0))
            f = FieldState.zeros(g)
            return f.replace(**{k: jnp.asarray(v) for k, v in vals.items()})
        comps = {k: np.zeros((px, py, pz) + g.shape, np.float32)
                 for k in ("ex", "ey", "ez", "cbx", "cby", "cbz")}
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    vals = self._materialize_fields((sx, sy, sz))
                    for k, v in vals.items():
                        comps[k][sx, sy, sz] = v
        z = jnp.zeros((px, py, pz) + g.shape, jnp.float32)
        f = FieldState(**{k: jnp.asarray(comps[k]) if k in comps else z
                          for k in ("ex", "ey", "ez", "cbx", "cby", "cbz",
                                    "tcax", "tcay", "tcaz", "jfx", "jfy",
                                    "jfz", "rhof", "rhob", "div_e_err",
                                    "div_b_err")})
        return f

    def initialize(self, key=None) -> SimState:
        """Post-deck derived-state fixups (initialize.cc:5-64)."""
        g = self.grid
        if g.face_partners is not None:
            # A rank whose face carries P_REMOTE but has no partner in the
            # join table would park its exiting particles for a migration
            # that never happens (boundary._face_perm excludes unjoined
            # ranks from the ppermute pairs): silent particle loss with no
            # rhob deposit.  join_domain's unsplicing makes this state easy
            # to reach; refuse it here instead (grid/ops.c:119-212 joins
            # must leave every remote port wired).
            from .grid import P_REMOTE as _P_REMOTE
            for face in range(6):
                if g.particle_bc[face] != _P_REMOTE:
                    continue
                bad = [r for r, p in enumerate(g.face_partners[face])
                       if p < 0]
                if bad:
                    raise ValueError(
                        f"initialize(): face {face} has particle bc "
                        f"P_REMOTE but ranks {bad} are unjoined in the "
                        "domain graph -- their exiting particles would be "
                        "silently destroyed.  join_domain() every rank's "
                        "face or set an explicit per-face particle BC "
                        "(set_domain_particle_bc) first.")
        m_global = self._material_coeffs()
        f = self._build_initial_fields()
        species, urbs, ages = self._pack_species()

        def _init(state_in):
            f, species, urbs, ages = state_in
            m = self._local_material_coeffs(m_global)
            rhob = f.rhob.reshape(-1)
            for st, sp, urb in zip(self.species, species, urbs):
                rhob = P.deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz,
                                      sp.w, -st.params.q, urb & sp.live)
            # Aged injection (misc.cc:88-99): particles staged with
            # age != 0 get the partial push NOW -- displacement
            # u * age * cvac * dt / gamma through the exact streak walk
            # (boundary interactions included: reflect bounces, absorbs
            # kill with their rhob deposit, like move_p at injection).
            # The walk's current deposits are discarded, matching the
            # reference where clear_accumulator_array at the top of the
            # first advance() wipes injection-time accumulator activity.
            species = list(species)
            for k, (st, agearr) in enumerate(zip(self.species, ages)):
                if agearr is None:
                    continue
                sp = species[k]
                spp = st.params
                gam = jnp.sqrt(1.0 + sp.ux ** 2 + sp.uy ** 2 + sp.uz ** 2)
                aged = agearr * (g.cvac * g.dt) / gam
                disp = (sp.ux * aged * g.rdx, sp.uy * aged * g.rdy,
                        sp.uz * aged * g.rdz)
                zi, r_ = jnp.divmod(sp.i, g.sz)
                yi, xi = jnp.divmod(r_, g.sy)
                pend = jnp.full((spp.capacity,), P.DONE, jnp.int32)
                acc0 = jnp.zeros((g.nv, 12), jnp.float32)
                mask = sp.live & (agearr != 0.0)
                (pos, _, coords, u, alive, pend, _, rhob) = P.streak_walk(
                    g, spp.q, sp.w, (sp.dx, sp.dy, sp.dz), disp,
                    (xi, yi, zi), (sp.ux, sp.uy, sp.uz), mask, sp.live,
                    pend, acc0, rhob, self.max_streak)
                vox2 = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
                species[k] = sp.replace(
                    dx=pos[0], dy=pos[1], dz=pos[2], i=vox2,
                    ux=u[0], uy=u[1], uz=u[2],
                    w=jnp.where(alive, sp.w, 0.0), live=alive,
                    np=jnp.sum(alive.astype(jnp.int32)))
            species = tuple(species)
            f = f.replace(rhob=rhob.reshape(g.shape))
            f, _ = F.synchronize_tang_e_norm_b(f, g)
            f = F.compute_div_b_err(f, g)
            f = F.clean_div_b(f, g)
            f = F.compute_curl_b(f, g, m)
            f = F.clear_rhof(f)
            rhof = f.rhof.reshape(-1)
            for st, sp in zip(self.species, species):
                rhof = P.accumulate_rho_p(rhof, sp, g, st.params.q)
            f = f.replace(rhof=rhof.reshape(g.shape))
            f = F.synchronize_rho(f, g)
            f = F.compute_rhob(f, g, m)
            f = F.compute_div_e_err(f, g, m)
            f = F.clean_div_e(f, g, m)
            f, _ = F.synchronize_tang_e_norm_b(f, g)
            fcoef = I.load_interpolator(f, g)
            species = tuple(
                P.uncenter_p(sp, fcoef, g, st.params.q, st.params.m)
                for st, sp in zip(self.species, species))
            return f, species

        if g.sharded:
            from .parallel.mesh import make_mesh, shard_fn
            mesh = make_mesh(g)
            f, species = jax.jit(shard_fn(_init, g, mesh))(
                (f, species, urbs, ages))
        else:
            f, species = jax.jit(_init)((f, species, urbs, ages))
        if key is None:
            key = jax.random.PRNGKey(self._entropy.randint(0, 2**31 - 1))
        step0 = jnp.int32(0)
        # pre-create the jit-carried diagnostics keys (custom-BC tallies,
        # link buffers) so the dict structure is fixed for lax.scan
        diag = {}
        sp_params = [st.params for st in self.species]
        for face, h in self.pbc_handlers.items():
            if hasattr(h, "diag_init"):
                diag.update(h.diag_init(sp_params, face))
        for cop in self.collision_ops:
            if hasattr(cop, "diag_init"):
                diag.update(cop.diag_init())
        state = SimState(fields=f, species=species, step=step0, rng=key,
                         diag=diag)
        if g.sharded:
            state = state.replace(
                step=jnp.zeros(g.topology, jnp.int32),
                rng=jnp.broadcast_to(key, g.topology + key.shape),
                diag={k: jnp.broadcast_to(v, g.topology + v.shape)
                      for k, v in diag.items()})
            # every leaf leads with the mesh dims: one shard per device
            state = jax.device_put(state, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(*g.mesh_axes)))
        return state

    # ---------------- the step (advance.cc:15-208) ----------------

    def make_advance(self) -> Callable[[SimState], SimState]:
        g = self.grid
        m_global = self._material_coeffs()
        damp = self.damp
        sp_params = [st.params for st in self.species]
        collision_ops = tuple(self.collision_ops)
        emitters = tuple(self.emitters)
        u_field = self.user_field_injection
        u_current = self.user_current_injection
        u_pinject = self.user_particle_injection
        u_collide = self.user_particle_collisions

        def advance(state: SimState) -> SimState:
            f = state.fields
            species = list(state.species)
            step = state.step
            rng = state.rng
            m = self._local_material_coeffs(m_global)
            vbc = self._local_vbc()
            # jit-carried diagnostics (custom-BC tallies etc.); structure is
            # fixed at initialize() so it can ride a lax.scan carry
            diag = state.diag if state.diag is not None else {}

            # --- sort (performance + collision partition) ---
            # (named scopes label each phase's device ops in profiler
            # traces: sort_p, interp_load, push_deposit, boundary_p,
            # acc_unload, field_advance, div_clean)
            with jax.named_scope("sort_p"):
                for k, spp in enumerate(sp_params):
                    if spp.sort_interval > 0:
                        species[k] = jax.lax.cond(
                            step % spp.sort_interval == 0,
                            P.sort_p, lambda s: s, species[k])

            # --- collisions (before push; advance.cc:45-47) ---
            for op in collision_ops:
                if getattr(op, "has_diag", False):
                    species, rng, diag = op(species, f, g, step, rng, diag)
                else:
                    species, rng = op(species, f, g, step, rng)
            if u_collide is not None:
                species, rng = u_collide(species, f, g, step, rng)

            rhob = f.rhob.reshape(-1)

            # --- particle push + current deposition ---
            with jax.named_scope("interp_load"):
                fcoef = I.load_interpolator(f, g)
            acc = jnp.zeros((g.nv, 12), jnp.float32)
            pends, disps = [], []
            with jax.named_scope("push_deposit"):
                for k, spp in enumerate(sp_params):
                    res = P.advance_p(species[k], fcoef, g, spp.q, spp.m,
                                      acc, rhob, max_streak=self.max_streak,
                                      vbc=vbc)
                    species[k] = res.species
                    acc = res.acc
                    rhob = res.rhob_flat
                    pends.append(res.pend_face)
                    disps.append(res.pend_disp)

            # --- emission / user injection (advance.cc:58-60) ---
            for em in emitters:
                species, acc, rhob, rng = em(species, f, fcoef, acc,
                                             rhob, g, step, rng)
            if u_pinject is not None:
                species, acc, rhob, rng = u_pinject(
                    species, f, fcoef, acc, rhob, g, step, rng)

            # --- boundary interaction + cross-shard migration
            #     (boundary_p x num_comm_round, advance.cc:73-101) ---
            needs_boundary = (g.sharded or self.pbc_handlers or
                              self._vbc is not None or
                              any(bc <= -3 for bc in g.particle_bc))
            if needs_boundary:
                rng, bkey = jax.random.split(
                    jax.random.fold_in(rng, step))
                with jax.named_scope("boundary_p"):
                    species, acc, rhob, _, diag = B.boundary_p(
                        species, sp_params, pends, disps, acc, rhob, g,
                        num_comm_round=self.num_comm_round,
                        max_streak=self.max_streak,
                        custom_handlers=self.pbc_handlers, key=bkey,
                        diag=diag, vbc=vbc)

            with jax.named_scope("acc_unload"):
                f = F.clear_jf(f)
                f = I.unload_accumulator(f, acc, g)
                f = F.synchronize_jf(f, g)
            f = f.replace(rhob=rhob.reshape(g.shape))

            if u_current is not None:
                f = u_current(f, step)

            # --- field advance ---
            with jax.named_scope("field_advance"):
                f = F.advance_b(f, g, 0.5)
                f = F.advance_e(f, g, m, damp)
                if u_field is not None:
                    f = u_field(f, step)
                f = F.advance_b(f, g, 0.5)

            # --- divergence cleaning (periodic) ---
            def clean_e(f):
                f = F.clear_rhof(f)
                rhof = f.rhof.reshape(-1)
                for k, spp in enumerate(sp_params):
                    rhof = P.accumulate_rho_p(rhof, species[k], g,
                                              spp.q)
                f = f.replace(rhof=rhof.reshape(g.shape))
                f = F.synchronize_rho(f, g)
                for _ in range(self.num_div_e_round):
                    f = F.compute_div_e_err(f, g, m)
                    f = F.clean_div_e(f, g, m)
                return f

            def clean_b(f):
                for _ in range(self.num_div_b_round):
                    f = F.compute_div_b_err(f, g)
                    f = F.clean_div_b(f, g)
                return f

            with jax.named_scope("div_clean"):
                ce = self.clean_div_e_interval
                cb = self.clean_div_b_interval
                sy = self.sync_shared_interval
                if ce > 0 and ce == cb == sy:
                    # common deck idiom (all three on one cadence): ONE cond
                    f = jax.lax.cond(
                        step % ce == 0,
                        lambda f: F.synchronize_tang_e_norm_b(
                            clean_b(clean_e(f)), g)[0],
                        lambda f: f, f)
                else:
                    if ce > 0:
                        f = jax.lax.cond(step % ce == 0, clean_e,
                                         lambda f: f, f)
                    if cb > 0:
                        f = jax.lax.cond(step % cb == 0, clean_b,
                                         lambda f: f, f)
                    if sy > 0:
                        f = jax.lax.cond(
                            step % sy == 0,
                            lambda f: F.synchronize_tang_e_norm_b(f, g)[0],
                            lambda f: f, f)

            return state.replace(fields=f, species=tuple(species),
                                 step=step + 1, rng=rng,
                                 diag=diag if state.diag is not None
                                 else None)

        return advance

    def make_step(self) -> Callable[[SimState], SimState]:
        """The jitted full step: shard-local advance lifted over the device
        mesh when the grid is decomposed."""
        adv = self.make_advance()
        if not self.grid.sharded:
            return jax.jit(adv)
        from .parallel.mesh import make_mesh, shard_fn
        mesh = make_mesh(self.grid)
        return jax.jit(shard_fn(adv, self.grid, mesh))

    def make_multi_step(self, n_sub: int) -> Callable[[SimState], SimState]:
        """n_sub steps fused into ONE dispatch via lax.scan."""
        adv = self.make_advance()
        if self.grid.sharded:
            from .parallel.mesh import make_mesh, shard_fn
            adv = shard_fn(adv, self.grid, make_mesh(self.grid))

        def many(state):
            return jax.lax.scan(lambda c, _: (adv(c), None), state, None,
                                length=n_sub)[0]

        return jax.jit(many)

    def run(self, state: SimState = None, num_step: int = None,
            energies_file: str = None, checkpt_base: str = None,
            checkpt_interval: int = 0, quota_s: float = None,
            verbose: bool = True) -> SimState:
        """The main loop (deck/main.cc:121 `while(advance());`) with the
        standard diagnostics idioms: status printing + profile table at
        status_interval, energies appending, interval- or quota-based
        checkpointing (sample/harris:395-404)."""
        import time as _time
        from . import checkpoint as _ck
        from . import dump as _dump
        from .utils.profile import Profile

        if state is None:
            state = self.initialize()
        n = num_step if num_step is not None else self.num_step
        # chunk steps into single dispatches (scan) between diagnostics
        intervals = [v for v in (self.status_interval, checkpt_interval)
                     if v]
        # gcd so the chunked loop lands EXACTLY on every diagnostic step
        chunk = math.gcd(*intervals, 0) if intervals else min(max(n, 1), 100)
        step_fn = self.make_step()
        many_fn = self.make_multi_step(chunk) if chunk > 1 else step_fn
        prof = Profile()
        t0 = _time.time()
        if energies_file:
            _dump.dump_energies(self, state, energies_file, append=False)
        start = int(jnp.max(state.step))
        k = start
        while k < n:
            # align to the interval grid (restore may start mid-interval)
            todo = min(chunk - k % chunk, n - k)
            with prof.tic("advance", todo):
                state = many_fn(state) if todo == chunk else _run_singles(
                    step_fn, state, todo)
            k += todo
            if self.status_interval and k % self.status_interval == 0:
                jax.block_until_ready(state.fields.ex)
                if verbose:
                    print(f"Completed step {k} of {n}")
                    prof.update_profile()
                if energies_file:
                    with prof.tic("dump_energies"):
                        _dump.dump_energies(self, state, energies_file)
            if checkpt_base and checkpt_interval and \
                    k % checkpt_interval == 0:
                with prof.tic("checkpt"):
                    _ck.checkpt(state, checkpt_base, sim=self)
            if quota_s is not None and _time.time() - t0 > quota_s:
                if checkpt_base:
                    _ck.checkpt(state, checkpt_base, tag="quota", sim=self)
                break
        jax.block_until_ready(state.fields.ex)
        return state

    # ---------------- diagnostics ----------------

    def _energies_local(self, f, species):
        g = self.grid
        m = self._local_material_coeffs(self._material_coeffs())
        en_f = F.all_sum(F.energy_f(f, g, m), g)
        fcoef = I.load_interpolator(f, g)
        en_p = [F.all_sum(P.energy_p(sp, fcoef, g, st.params.q, st.params.m),
                          g)
                for st, sp in zip(self.species, species)]
        return jnp.concatenate([en_f, jnp.stack(en_p)]) if en_p else en_f

    def energies(self, state: SimState):
        """dump_energies columns (dump.cc:37-77):
        [ex, ey, ez, bx, by, bz, KE_sp0, KE_sp1, ...]"""
        g = self.grid
        fn = getattr(self, "_energies_jit", None)
        if fn is None:
            if not g.sharded:
                fn = jax.jit(lambda s: self._energies_local(s[0], s[1]))
            else:
                from .parallel.mesh import make_mesh, shard_reduce_fn
                mesh = make_mesh(g)
                fn = jax.jit(shard_reduce_fn(
                    lambda s: self._energies_local(s[0], s[1]), g, mesh))
            self._energies_jit = fn
        return fn((state.fields, state.species))
