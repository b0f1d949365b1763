"""Absorbing-field boundary (Higdon/Mur ABC, local.c:82-107 port) and CLI
runner tests."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from vpic_jax.grid import ABSORB_FIELDS, partition_periodic_box
from vpic_jax.state import FieldState, MaterialCoeffs
from vpic_jax.ops import fields as F


def test_absorbing_wall_eats_pulse():
    """A wave packet launched at the +x absorbing wall mostly leaves the
    box: residual energy a few percent (1st-order ABC at 15-degree cone)."""
    nx = 128
    g0 = partition_periodic_box(0, 0, 0, 1.0, 4 / nx, 4 / nx, nx, 4, 4)
    g0 = dataclasses.replace(g0, dt=0.5 * g0.courant_length())
    bc = list(g0.field_bc)
    bc[0] = bc[3] = ABSORB_FIELDS
    g = dataclasses.replace(g0, field_bc=tuple(bc))
    m = MaterialCoeffs.vacuum()

    f = FieldState.zeros(g)
    xn = g.x0 + g.dx * (np.arange(g.NX) - 1.0)
    xc = xn + 0.5 * g.dx
    # rightward-travelling gaussian packet: Ey = f(x), cBz = f(x) (E = cB)
    env = lambda x: np.exp(-0.5 * ((x - 0.5) / 0.06) ** 2) * \
        np.cos(2 * np.pi * 16 * x)
    f = f.replace(
        ey=jnp.asarray(np.broadcast_to(env(xn), g.shape).astype(np.float32)),
        cbz=jnp.asarray(np.broadcast_to(env(xc + 0.5 * g.cvac * g.dt),
                                        g.shape).astype(np.float32)))
    e0 = float(np.asarray(F.energy_f(f, g, m)).sum())

    @jax.jit
    def run(f, n):
        def body(_, f):
            f = F.advance_b(f, g, 0.5)
            f = F.advance_e(f, g, m, 0.0)
            return F.advance_b(f, g, 0.5)
        return jax.lax.fori_loop(0, n, body, f)

    # transit to the +x wall and out: distance ~0.5 at c=1
    n_steps = int(1.0 / (g.cvac * g.dt))
    f = run(f, n_steps)
    e1 = float(np.asarray(F.energy_f(f, g, m)).sum())
    assert e1 < 0.05 * e0          # pulse absorbed, not reflected
    assert np.isfinite(e1)


def test_cli_runner(tmp_path):
    # a tiny weibel via a .py deck (the default-size built-in is too slow
    # on CPU); built-in NAME resolution is covered by the unknown-name
    # error path below
    deck = tmp_path / "small.py"
    deck.write_text(
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from vpic_jax.models import weibel\n"
        "def build():\n"
        "    return weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=4,\n"
        "                                            Lx=8.0, Ly=8.0))\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "vpic_jax", str(deck), "--num-step", "2",
         "--energies", str(tmp_path / "en"),
         "--checkpt", str(tmp_path / "ck") + ":2"],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr[-500:]
    assert os.path.exists(tmp_path / "en")
    assert os.path.exists(str(tmp_path / "ck") + ".2.npz")
    out = subprocess.run(
        [sys.executable, "-m", "vpic_jax", "no_such_deck"],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode != 0 and "weibel" in out.stderr


def test_cli_py_deck_chunked_checkpoints(tmp_path):
    """A .py deck through the CLI with a checkpoint interval that does NOT
    divide the status interval: the gcd-chunked scan loop must still land on
    every diagnostic step, and restore must realign to the interval grid."""
    deck = tmp_path / "deck.py"
    deck.write_text(
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from vpic_jax.models import weibel\n"
        "def build():\n"
        "    sim = weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=4,\n"
        "                                           Lx=8.0, Ly=8.0))\n"
        "    sim.status_interval = 4\n"
        "    sim.num_step = 13\n"
        "    return sim\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "vpic_jax", str(deck),
         "--energies", str(tmp_path / "en"),
         "--checkpt", str(tmp_path / "ck") + ":6"],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr[-800:]
    # gcd(4, 6) = 2: both the step-4 dumps and step-6/12 checkpoints fire
    assert os.path.exists(str(tmp_path / "ck") + ".6.npz")
    assert os.path.exists(str(tmp_path / "ck") + ".12.npz")
    rows = [l.split() for l in open(tmp_path / "en")
            if not l.startswith("%")]
    assert [int(r[0]) for r in rows] == [0, 4, 8, 12]
    # restore mid-interval (step 6): next dump must realign to step 8
    out = subprocess.run(
        [sys.executable, "-m", "vpic_jax", str(deck),
         "--restore", str(tmp_path / "ck") + ".6",
         "--energies", str(tmp_path / "en2")],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr[-800:]
    rows2 = [l.split() for l in open(tmp_path / "en2")
             if not l.startswith("%")]
    assert [int(r[0]) for r in rows2] == [6, 8, 12]
    # physics identical across the restart (same jitted advance)
    full = {int(r[0]): [float(v) for v in r[1:]] for r in rows}
    for r in rows2:
        if int(r[0]) in full:
            np.testing.assert_allclose([float(v) for v in r[1:]],
                                       full[int(r[0])], rtol=1e-6)
