import numpy as np
import pytest

from vpic_jax.grid import (PERIODIC, REMOTE, Grid, partition_periodic_box)


def test_voxel_roundtrip():
    g = Grid(nx=5, ny=3, nz=2)
    for x in range(g.NX):
        for y in range(g.NY):
            for z in range(g.NZ):
                i = g.voxel(x, y, z)
                assert g.decode_voxel(i) == (x, y, z)
    assert g.nv == g.NX * g.NY * g.NZ
    assert g.voxel(1, 0, 0) - g.voxel(0, 0, 0) == 1
    assert g.voxel(0, 1, 0) - g.voxel(0, 0, 0) == g.sy
    assert g.voxel(0, 0, 1) - g.voxel(0, 0, 0) == g.sz


def test_voxel_matches_array_flatten():
    # VOXEL(x,y,z) must index the C-order flatten of [z,y,x] arrays.
    g = Grid(nx=4, ny=3, nz=2)
    a = np.arange(g.nv).reshape(g.shape)
    for (x, y, z) in [(0, 0, 0), (3, 2, 1), (5, 4, 3), (1, 2, 3)]:
        assert a[z, y, x] == a.reshape(-1)[g.voxel(x, y, z)]


def test_partition_periodic():
    g = partition_periodic_box(0, 0, 0, 1, 2, 3, 8, 16, 4, 1, 2, 1, dt=0.1)
    assert (g.nx, g.ny, g.nz) == (8, 8, 4)
    assert g.gny == 16
    assert g.field_bc[0] == PERIODIC and g.field_bc[3] == PERIODIC
    assert g.field_bc[1] == REMOTE and g.field_bc[4] == REMOTE
    assert abs(g.dy - 2.0 / 16) < 1e-12
    with pytest.raises(ValueError):
        partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 9, 4, 1, 2, 1)


def test_courant_length():
    g = partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 1, 1, 1, 1)
    dg = g.courant_length()
    assert abs(dg - (2 * 16 ** 2) ** -0.5) < 1e-12
