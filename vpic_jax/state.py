"""Simulation state pytrees.

Replaces the reference's pointer-linked runtime objects with JAX pytrees:

* ``FieldState``    <- ``field_t`` interleaved AoS (field_advance.h:152-160),
  re-laid-out as SoA full-grid arrays ``[z, y, x]`` (ghosted) so stencils are
  pure slice arithmetic fused by XLA.
* ``MaterialCoeffs`` <- ``material_coefficient_t`` (sfa_private.h:14-29),
  pre-expanded onto the mesh (trades memory for gather-free
  stencils).  Uniform-material runs store 0-d scalars so XLA broadcasts and
  the vacuum fast path (sfa.c:202-211) falls out for free.
* ``SpeciesState``  <- ``species_t`` + ``particle_t`` AoS
  (species_advance_aos.h:21-94), re-laid-out as fixed-capacity SoA arrays with
  a live-count; slots >= np are dead (w = 0, voxel = 0 which is a ghost cell,
  so dead lanes deposit nothing anywhere that matters).
* ``SimState``      <- the dynamic members of ``vpic_simulation``
  (src/vpic/vpic.h:183-202).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .grid import Grid


def _register(cls):
    """Register a dataclass as a pytree (all fields are children)."""
    names = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in names), None

    def unflatten(_, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register
@dataclass
class FieldState:
    """All field-mesh quantities, each shaped ``grid.shape = (nz+2, ny+2, nx+2)``.

    Yee staggering (field_advance.h:44-87): ex on x-edges, cbx on x-faces,
    jf on edges with e, rho on nodes, div_b_err at cell centers, tca with e.
    Index 0 and n+1 along each axis are ghosts except for components
    node-centered along that axis, whose n+1 plane holds real boundary data.
    """

    ex: Any
    ey: Any
    ez: Any
    cbx: Any
    cby: Any
    cbz: Any
    tcax: Any
    tcay: Any
    tcaz: Any
    jfx: Any
    jfy: Any
    jfz: Any
    rhof: Any
    rhob: Any
    div_e_err: Any
    div_b_err: Any

    @classmethod
    def zeros(cls, g: Grid, dtype=jnp.float32) -> "FieldState":
        z = lambda: jnp.zeros(g.shape, dtype)
        return cls(*[z() for _ in range(16)])

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)


@_register
@dataclass
class MaterialCoeffs:
    """Pre-expanded advance_e / div-clean coefficients (sfa.c:112-148).

    Each entry is either a 0-d scalar (single material fills all space) or a
    full ghosted mesh array sampled at the component's stagger location:
    decay/drive/eps at the matching E-edge, rmu at the matching B-face,
    nonconductive at nodes.
    """

    decayx: Any
    decayy: Any
    decayz: Any
    drivex: Any
    drivey: Any
    drivez: Any
    rmux: Any
    rmuy: Any
    rmuz: Any
    nonconductive: Any
    epsx: Any
    epsy: Any
    epsz: Any

    @classmethod
    def vacuum(cls) -> "MaterialCoeffs":
        one = jnp.float32(1.0)
        return cls(*([one] * 13))


@_register
@dataclass
class SpeciesState:
    """Fixed-capacity SoA particle storage for one species.

    dx,dy,dz: voxel-centered offsets in [-1,1] (species_advance_aos.h:23-26)
    i:        local voxel linear index (int32)
    ux,uy,uz: normalized momentum (gamma * beta)
    w:        macro-particle weight
    np:       live count (slots [0, np) are live; the live prefix is an
              invariant maintained by injection / migration compaction)
    """

    dx: Any
    dy: Any
    dz: Any
    i: Any
    ux: Any
    uy: Any
    uz: Any
    w: Any
    live: Any  # bool (N,): slot holds a live particle
    np: Any    # int32 scalar: number of live slots (sum of live)

    @classmethod
    def empty(cls, capacity: int, dtype=jnp.float32) -> "SpeciesState":
        zf = lambda: jnp.zeros((capacity,), dtype)
        return cls(dx=zf(), dy=zf(), dz=zf(),
                   i=jnp.zeros((capacity,), jnp.int32),
                   ux=zf(), uy=zf(), uz=zf(), w=zf(),
                   live=jnp.zeros((capacity,), bool),
                   np=jnp.int32(0))

    @property
    def capacity(self) -> int:
        return self.dx.shape[0]

    @property
    def alive(self):
        """Boolean mask of live slots."""
        return self.live

    def replace(self, **kw) -> "SpeciesState":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SpeciesParams:
    """Static species parameters (species_t scalars, species_advance_aos.h:56-66)."""

    name: str
    q: float
    m: float
    capacity: int
    sort_interval: int = 0
    id: int = 0


@_register
@dataclass
class SimState:
    """Dynamic simulation state: everything a timestep reads and writes."""

    fields: FieldState
    species: Tuple[SpeciesState, ...]
    step: Any          # int32 scalar
    rng: Any           # jax PRNG key (sync pool seed; per-use fold_in)
    # Diagnostics accumulated by the jitted step (dict of named device
    # scalars, e.g. absorb_tally counts): carried functionally so counts
    # survive lax.scan multi-stepping (the counterpart of the reference's
    # host-side pbc_interactor tallies, absorb_tally.c:12-84)
    diag: Any = None

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)
