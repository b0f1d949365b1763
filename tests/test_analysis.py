"""utilities/analysis.py: centering / smoothing / spectra parity with the
reference MATLAB semantics (center_field.m averaging branch,
smooth_field.m |k|^2 roll-off filter) plus Parseval on the spectra."""

import numpy as np

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from utilities import analysis as A


def test_node_center_matches_reference_averaging():
    rng = np.random.default_rng(0)
    nz, ny, nx = 4, 6, 8
    # x-staggered quantity (lives on x-cells): centering averages x
    v = rng.normal(size=(nz + 1, ny + 1, nx))
    c = A.node_center(v, nx, ny, nz)
    assert c.shape == (nz, ny, nx)
    # manual: drop periodic copies, average along x only
    vv = v[:nz, :ny, :]
    expect = 0.5 * (np.roll(vv, 1, axis=2) + vv)
    np.testing.assert_allclose(c, expect)


def test_fourier_smooth_removes_short_and_keeps_long():
    nz, ny, nx = 1, 1, 64
    dx = 0.5
    x = np.arange(nx) * dx
    L = nx * dx
    long_l, short_l = L / 2.0, L / 16.0
    v = (np.sin(2 * np.pi * x / long_l)
         + np.sin(2 * np.pi * x / short_l))[None, None, :]
    s = A.fourier_smooth(v, dx, 1.0, 1.0,
                         lambda_stop=L / 8.0, lambda_pass=L / 4.0)
    long_part = np.sin(2 * np.pi * x / long_l)[None, None, :]
    # long wavelength preserved, short removed
    np.testing.assert_allclose(s, long_part, atol=1e-10)


def test_power_spectrum_parseval_and_peak():
    rng = np.random.default_rng(1)
    nz, ny, nx = 2, 8, 16
    v = rng.normal(size=(nz, ny, nx))
    kz, ky, kx, P = A.power_spectrum(v, dx=0.25)
    assert abs(P.sum() - np.mean(v ** 2)) < 1e-12
    # a pure mode peaks at its wavenumber
    x = np.arange(nx) * 0.25
    mode = np.broadcast_to(np.cos(2 * np.pi * 3 * x / (nx * 0.25)),
                           (nz, ny, nx))
    _, _, kxm, Pm = A.power_spectrum(np.asarray(mode), dx=0.25)
    peak = np.unravel_index(np.argmax(Pm), Pm.shape)
    assert abs(abs(kxm[peak[2]]) - 2 * np.pi * 3 / (nx * 0.25)) < 1e-9

    kc, ps = A.radial_spectrum(v, dx=0.25)
    assert abs(ps.sum() - np.mean(v ** 2)) < 1e-12


def test_field_frames_sequence(tmp_path):
    import jax
    import vpic_jax as vt
    from vpic_jax import dump as D
    from utilities import read_dumps  # noqa: F401  (import path check)

    sim = vt.Simulation(seed=0)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 8)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (8, 8, 8))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.set_region_field(vt.everywhere,
                         ex=lambda x, y, z: np.sin(2 * np.pi * x))
    state = sim.initialize()
    base = str(tmp_path / "flds")
    for step in (0, 5):
        D.dump_fields(sim, state.replace(step=np.int32(step)), base)
    steps, frames = A.field_frames(base, "ex")
    assert list(steps) == [0, 5]
    assert frames.shape == (2, 8, 8, 8)
    steps2, series = A.probe_series(base, "ex", (2, 3, 4))
    assert series.shape == (2,)
