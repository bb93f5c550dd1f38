"""Mesh and camera alignment (counterpart of
``scanerf_tpu/preprocess/rectify_mesh.py``): rotate the proxy mesh and
the cameras by Euler angles about a centre, scale them, and write
``mesh_align.ply``, ``align_info.txt`` and ``camera_align.log``, through
the port's PLY reader and writer.

    python -m scanerf_tpu_torch.preprocess.rectify_mesh MESH.ply CAMERA.log
"""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import io as data_io
from scanerf_tpu_torch.geometry import ply


def euler_rotation(angles_deg) -> np.ndarray:
    """Rz @ Ry @ Rx of the angles (x, y, z) in degrees."""
    ax, ay, az = (np.deg2rad(a) for a in angles_deg)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def rectify_mesh(mesh_path: str, cam_path: str, angle=(-90.0, 20.0, 0.0), mesh_center=None,
                 scale: float = 2.0) -> None:
    """x -> scale * R (x - center) for the mesh's vertices and the cameras'
    centres, R @ rotation for the cameras; the centre defaults to the
    vertices' mean. Writes beside the inputs."""
    verts, faces = ply.read_ply(mesh_path)
    ks, c2ws, H, W = data_io.read_campara(cam_path, return_shape=True)
    if mesh_center is None:
        mesh_center = verts.mean(0)
    mesh_center = np.asarray(mesh_center, np.float64)

    R = euler_rotation(angle)
    verts_out = (scale * ((verts - mesh_center) @ R.T)).astype(np.float32)
    Cs = scale * ((c2ws[:, :3, 3] - mesh_center) @ R.T)
    Rs = R @ c2ws[:, :3, :3]
    c2ws_out = np.concatenate([Rs, Cs[..., None]], -1).astype(np.float32)

    mesh_dir = os.path.dirname(mesh_path)
    ply.write_ply(os.path.join(mesh_dir, "mesh_align.ply"), verts_out, faces)
    with open(os.path.join(mesh_dir, "align_info.txt"), "w") as f:
        f.write(f"center: {mesh_center[0]} {mesh_center[1]} {mesh_center[2]}\n")
        f.write(f"angle: {angle[0]} {angle[1]} {angle[2]}\n")
        f.write(f"scale: {scale}\n")
    data_io.write_campara(os.path.join(os.path.dirname(cam_path), "camera_align.log"),
                          ks, c2ws_out, H, W)


def main():
    import sys

    rectify_mesh(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
