import os
import sys

# Tests run on a virtual 8-device CPU mesh so multi-shard logic is exercised
# without accelerator hardware; the config override also holds when jax was
# imported before this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Slow-test marking: the full suite is the gate; `-m "not slow"` is the
# fast iteration lane (a few minutes on CPU).  Tests >= ~15 s on CPU are
# listed here (a central list beats 35 scattered decorators for keeping
# the lane budget in one place).
# ---------------------------------------------------------------------------
import pytest as _pytest

_SLOW = {
    "test_cli_py_deck_chunked_checkpoints", "test_cyclo_uniform_b",
    "test_lpi_2d_decomposition",
    "test_sharded_local_bc_axis_matches_single_device",
    "test_sharded_harris_matches_single_device", "test_dryrun_multichip",
    "test_takizuka_abe_isotropizes", "test_sharded_2d_mesh_weibel",
    "test_asymm4sp_runs_and_conserves",
    "test_beam_plasma_two_stream", "test_lpi_laser_propagates_and_heats",
    "test_weibel_growth_and_energy",
    "test_weibel_energy_history_matches_gold",
    "test_interior_absorber_sharded_matches_single", "test_cli_runner",
    "test_emission_diode_current",
    "test_interspecies_coulomb_momentum_exchange", "test_accel_uniform_e",
    "test_fluid_collision_models", "test_pcomm_migration_roundtrip",
    "test_sharded_material_regions_match_single",
    "test_collisional_reconnection_3d",
    "test_cygnus_pulse_drives_fields", "test_langevin_thermalizes",
    "test_interior_handler_tally", "test_force_free_energy_conservation",
    "test_waveguide_cutoff", "test_runtime_injection_hook",
    "test_weibel_energy_history_vs_reference_gold",
    "test_shapes_materials_shape_the_wave",
    "test_conductor_damps_wave",
    "test_link_boundary_records_and_write", "test_child_langmuir_emits",
    "test_interior_reflector_conserves_particles",
    "test_volume_emitter_emits_everywhere_in_region",
    "test_maxwellian_reflux_conserves_particles",
    "test_absorb_tally_survives_scan_multistep", "test_unary_framework",
    "test_strided_field_hydro_dumps", "test_absorb_tally_removes_and_charges",
    "test_interior_absorber_general_path",
    "test_gold_load_step0_energies_match_reference",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW:
            item.add_marker(_pytest.mark.slow)
