"""Minimal PLY mesh reader/writer (ascii + binary_little_endian); the
port's own copy of ``scanerf_tpu/geometry/ply.py``.

Replaces the reference's vendored tinyply (``cuda/include/tinyply.h``) for
loading the proxy mesh (``mesh/mesh.ply``). Supports the subset the
pipeline needs: float vertex x/y/z and int vertex_indices face lists.
"""

from __future__ import annotations

import struct

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (vertices [V,3] float32, faces [F,3] int32)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', cdt, dt, name)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        verts = None
        faces = None
        if fmt == "ascii":
            for name, cnt, props in elements:
                rows = [f.readline().decode("ascii").split() for _ in range(cnt)]
                if name == "vertex":
                    names = [p[0] for p in props]
                    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                    verts = np.array(
                        [[float(r[xi]), float(r[yi]), float(r[zi])] for r in rows],
                        np.float32,
                    )
                elif name == "face":
                    faces = np.array(
                        [[int(v) for v in r[1:4]] for r in rows], np.int32
                    )
        elif fmt == "binary_little_endian":
            for name, cnt, props in elements:
                if name == "vertex":
                    dt = np.dtype(
                        [(p[0], "<" + _PLY_DTYPES[p[1]]) for p in props]
                    )
                    data = np.frombuffer(f.read(dt.itemsize * cnt), dtype=dt)
                    verts = np.stack(
                        [data["x"], data["y"], data["z"]], axis=-1
                    ).astype(np.float32)
                elif name == "face":
                    assert props[0][0] == "list"
                    cdt = np.dtype("<" + _PLY_DTYPES[props[0][1]])
                    idt = np.dtype("<" + _PLY_DTYPES[props[0][2]])
                    out = np.empty((cnt, 3), np.int32)
                    for i in range(cnt):
                        (n,) = np.frombuffer(f.read(cdt.itemsize), dtype=cdt)
                        idxs = np.frombuffer(f.read(idt.itemsize * int(n)), dtype=idt)
                        out[i] = idxs[:3]
                    faces = out
                else:
                    # skip unknown fixed-size element
                    row = sum(
                        np.dtype(_PLY_DTYPES[p[1]]).itemsize
                        for p in props
                        if p[0] != "list"
                    )
                    f.read(row * cnt)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    if verts is None:
        raise ValueError("PLY missing vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return verts, faces


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write binary_little_endian PLY."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(vertices.astype("<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<B3i", 3, *face))
