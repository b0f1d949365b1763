#!/usr/bin/env python
"""Post-processing reader for the V0-format binary dumps written by
vpic_jax.dump (the analogue of the reference's MATLAB/IDL loaders,
interfaces/matlab/*.m).  Pure numpy; no framework import needed."""

import struct
import sys

import numpy as np

HEADER_FMT = "<5bhifd2i i 3i 4f 3f 3f 2i i f"


def read_header(fh):
    raw = fh.read(struct.calcsize(HEADER_FMT))
    vals = struct.unpack(HEADER_FMT, raw)
    (cb, ss, si, sf, sd, magic16, magic32, f1, d1, version, dump_type,
     step, nx, ny, nz, dt, dx, dy, dz, x0, y0, z0, cvac, eps0, damp,
     rank, nproc, sp_id, q_m) = vals
    assert magic16 == 0xcafe - 0x10000 and magic32 == -0x21524111, \
        "not a V0 dump"
    return dict(version=version, dump_type=dump_type, step=step,
                nx=nx, ny=ny, nz=nz, dt=dt, dx=dx, dy=dy, dz=dz,
                x0=x0, y0=y0, z0=z0, cvac=cvac, eps0=eps0,
                rank=rank, nproc=nproc, sp_id=sp_id, q_m=q_m)


def read_array_header(fh):
    esize, ndim = struct.unpack("<2i", fh.read(8))
    dims = struct.unpack(f"<{ndim}i", fh.read(4 * ndim))
    return esize, dims


FIELD_NAMES = ("ex", "ey", "ez", "div_e_err", "cbx", "cby", "cbz",
               "div_b_err", "tcax", "tcay", "tcaz", "rhob",
               "jfx", "jfy", "jfz", "rhof")
MAT_NAMES = ("ematx", "ematy", "ematz", "nmat",
             "fmatx", "fmaty", "fmatz", "cmat")
HYDRO_NAMES = ("jx", "jy", "jz", "rho", "px", "py", "pz", "ke",
               "txx", "tyy", "tzz", "tyz", "tzx", "txy", "pad0", "pad1")


def read_fields(path):
    with open(path, "rb") as fh:
        hdr = read_header(fh)
        esize, dims = read_array_header(fh)
        n = dims[0] * dims[1] * dims[2]
        # field_t: 16 floats + 8 material-id int16s per voxel
        rec = np.frombuffer(fh.read(n * 80),
                            dtype=[("f", "<f4", (16,)), ("m", "<i2", (8,))])
        out = {name: rec["f"][:, c].reshape(dims[2], dims[1], dims[0])
               for c, name in enumerate(FIELD_NAMES)}
        out.update({name: rec["m"][:, c].reshape(dims[2], dims[1], dims[0])
                    for c, name in enumerate(MAT_NAMES)})
        return hdr, out


def read_hydro(path):
    with open(path, "rb") as fh:
        hdr = read_header(fh)
        esize, dims = read_array_header(fh)
        n = dims[0] * dims[1] * dims[2]
        rec = np.frombuffer(fh.read(n * 64), "<f4").reshape(n, 16)
        out = {name: rec[:, c].reshape(dims[2], dims[1], dims[0])
               for c, name in enumerate(HYDRO_NAMES[:14])}
        return hdr, out


def read_particles(path):
    with open(path, "rb") as fh:
        hdr = read_header(fh)
        esize, dims = read_array_header(fh)
        dtype = np.dtype([("dx", "<f4"), ("dy", "<f4"), ("dz", "<f4"),
                          ("i", "<i4"), ("ux", "<f4"), ("uy", "<f4"),
                          ("uz", "<f4"), ("w", "<f4")])
        rec = np.frombuffer(fh.read(dims[0] * esize), dtype)
        return hdr, rec


def _stitch(fbase, tag, topology, reader):
    """Reassemble per-rank ghosted V0 dumps `{fbase}.{tag}.{rank}` into
    global interior arrays — the analogue of the reference's global joiner
    (interfaces/c/joiner).  `topology` is the (px, py, pz) decomposition
    (the V0 header carries rank/nproc but not the topology, exactly like
    the reference, whose joiner reads it from the global.vpc manifest).
    Rank order matches vpic_jax.dump._shard_iter: x-major, z-minor."""
    px, py, pz = topology
    n = px * py * pz
    hdr0 = None
    out = {}
    for rank in range(n):
        hdr, loc = reader(f"{fbase}.{tag}.{rank}")
        if hdr0 is None:
            hdr0 = hdr
            if hdr["nproc"] != n:
                raise ValueError(f"topology {topology} implies {n} ranks "
                                 f"but dump says nproc={hdr['nproc']}")
            nx, ny, nz = hdr["nx"], hdr["ny"], hdr["nz"]
        sx, sy, sz = rank // (py * pz), (rank // pz) % py, rank % pz
        for name, a in loc.items():
            if name not in out:
                out[name] = np.zeros((nz * pz, ny * py, nx * px), a.dtype)
            out[name][sz * nz:(sz + 1) * nz, sy * ny:(sy + 1) * ny,
                      sx * nx:(sx + 1) * nx] = a[1:nz + 1, 1:ny + 1,
                                                 1:nx + 1]
    return hdr0, out


def stitch_fields(fbase, tag, topology):
    """Global (gnz, gny, gnx) interior field + material-id arrays from the
    per-rank files of one dump_fields call."""
    return _stitch(fbase, tag, topology, read_fields)


def stitch_hydro(fbase, tag, topology):
    return _stitch(fbase, tag, topology, read_hydro)


def stitch_particles(fbase, tag, nproc):
    """Concatenate per-rank particle dumps; voxel indices are left in each
    rank's local ghosted convention (as in the reference's raw dumps)."""
    hdr0, recs = None, []
    for rank in range(nproc):
        hdr, rec = read_particles(f"{fbase}.{tag}.{rank}")
        hdr0 = hdr0 or hdr
        recs.append(rec)
    return hdr0, np.concatenate(recs)


if __name__ == "__main__":
    if sys.argv[1] == "stitch":
        # read_dumps.py stitch <fields|hydro> <fbase> <tag> PX PY PZ <out.npz>
        kind, fbase, tag = sys.argv[2:5]
        topo = tuple(int(v) for v in sys.argv[5:8])
        fn = stitch_fields if kind == "fields" else stitch_hydro
        hdr, out = fn(fbase, tag, topo)
        np.savez(sys.argv[8], **out)
        print(f"stitched {hdr['nproc']} ranks -> {sys.argv[8]} "
              f"({out[next(iter(out))].shape})")
    else:
        hdr, _ = read_fields(sys.argv[1])
        print(hdr)
