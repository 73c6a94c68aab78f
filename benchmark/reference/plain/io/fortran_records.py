"""Fortran binary file compatibility layer.

Port of ``c2ray_tpu/io/fortran_records.py`` (numpy, byte for byte the
same files).

The reference exchanges all cubes as Fortran files in two flavours
(cubep3m.F90:79-112):
- "unformatted" sequential: each record framed by 4-byte length markers
- "binary"/stream (ifort): raw data, no markers

Cube files carry a (m1, m2, m3) int32 header record followed by the
data record in Fortran (column-major) order (output.F90:268-272,
mat_ini_cubep3m.F90:258-286).
"""

import numpy as np


def write_fortran_record(f, arr: np.ndarray, markers=True):
    data = arr.tobytes(order="F")
    if markers:
        f.write(np.int32(len(data)).tobytes())
    f.write(data)
    if markers:
        f.write(np.int32(len(data)).tobytes())


def read_fortran_record(f, dtype, count, markers=True):
    if markers:
        n = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
        expected = count * np.dtype(dtype).itemsize
        if n != expected:
            raise IOError(f"record length {n} != expected {expected}")
    data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                         dtype=dtype).copy()
    if markers:
        f.read(4)
    return data


def write_unformatted_cube(path, cube: np.ndarray, dtype=None,
                           markers=True, header=True):
    """Write a cube with mesh header, Fortran order (output.F90:268-272)."""
    cube = np.asarray(cube)
    if dtype is not None:
        cube = cube.astype(dtype)
    with open(path, "wb") as f:
        if header:
            write_fortran_record(
                f, np.asarray(cube.shape, dtype=np.int32), markers)
        write_fortran_record(f, cube, markers)


def read_unformatted_cube(path, dtype=np.float32, mesh=None, markers=True,
                          header=True) -> np.ndarray:
    """Read a cube written by `write_unformatted_cube` or by the
    reference's writers/readers (mat_ini_cubep3m.F90:250-286)."""
    with open(path, "rb") as f:
        if header:
            shape = tuple(read_fortran_record(f, np.int32, 3, markers))
        else:
            if mesh is None:
                raise ValueError("headerless cube needs an explicit mesh")
            shape = (mesh, mesh, mesh) if np.isscalar(mesh) else tuple(mesh)
        n = int(np.prod(shape))
        data = read_fortran_record(f, dtype, n, markers)
    return data.reshape(shape, order="F")
