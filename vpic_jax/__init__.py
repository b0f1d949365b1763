"""vpic_jax: a relativistic electromagnetic particle-in-cell framework with
the capabilities of VPIC (LANL's Vector Particle-In-Cell code), built on
JAX/XLA.

Layer map (mirrors SURVEY.md section 1):
  deck.Simulation     -- input-deck vocabulary + step orchestration
  ops.push            -- particle engine (advance_p/move_p/sort/energy/rho)
  ops.fields          -- Yee FDTD solver, div cleaners, BCs, synchronization
  ops.interp          -- interpolator / accumulator field<->particle interface
  parallel            -- device-mesh decomposition, halo exchange, migration
  boundary / collision / emitter -- particle BCs, Monte-Carlo collisions,
                          emission models
  checkpoint / dump   -- checkpoint-restart and binary diagnostics I/O
"""

from .grid import (ABSORB_FIELDS, ABSORB_PARTICLES, ANTI_SYMMETRIC, BOUNDARY,
                   METAL, PEC, PERIODIC, PMC, REFLECT_PARTICLES, SYMMETRIC,
                   Grid, partition_absorbing_box, partition_metal_box,
                   partition_periodic_box)
from .state import (FieldState, MaterialCoeffs, SimState, SpeciesParams,
                    SpeciesState)
from .deck import Material, Simulation, everywhere
from .utils.log import error, message, sim_log, warning
from . import (boundary_ops, checkpoint, collision, diagnostics, dump,
               emitter)  # noqa: F401

__version__ = "0.1.0"
