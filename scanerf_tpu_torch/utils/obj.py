"""OBJ debug-visualization writers (counterpart of
``scanerf_tpu/utils/obj.py``): AABB boxes, point scatters along camera
look directions, and the OBJ writer."""

from __future__ import annotations

import numpy as np

_BOX_FACES = np.array(
    [
        [0, 1, 2], [0, 2, 3],  # bottom
        [4, 5, 6], [4, 6, 7],  # top
        [0, 1, 5], [0, 5, 4],
        [1, 2, 6], [1, 6, 5],
        [2, 3, 7], [2, 7, 6],
        [3, 0, 4], [3, 4, 7],
    ],
    np.int64,
)
_BOX_CORNERS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
        [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1],
    ],
    np.float32,
)


def draw_aabbs(centers: np.ndarray, sizes: np.ndarray):
    """Box meshes of AABBs (centers, full sizes [K, 3]) -> (verts [8K, 3],
    faces [12K, 3])."""
    centers = np.asarray(centers, np.float32)
    h = np.asarray(sizes, np.float32) / 2.0
    verts = centers[:, None, :] + _BOX_CORNERS[None] * h[:, None, :]
    faces = _BOX_FACES[None] + (np.arange(len(centers)) * 8)[:, None, None]
    return verts.reshape(-1, 3), faces.reshape(-1, 3)


def cameras_scatter(Rs: np.ndarray, ts: np.ndarray, length: float = 0.8):
    """10 points along each camera's look direction (the rotation's third
    column, or its third row for a non-3x3 R) from its position."""
    pts = []
    for R, t in zip(Rs, ts):
        z = R[:, 2] if R.shape == (3, 3) else R[2]
        for s in np.linspace(0, length, 10):
            pts.append(t + s * z)
    return np.array(pts, np.float32)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray | None = None):
    """Vertices (and 0-based triangle faces) as an OBJ file."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in faces:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def points_to_obj(path: str, points: np.ndarray):
    write_obj(path, np.asarray(points).reshape(-1, 3))
