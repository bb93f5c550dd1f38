"""Camera paths for novel-view rendering (counterpart of
``scanerf_tpu/utils/pose_paths.py``; numpy only): linear interpolation
between c2w poses with re-orthogonalised axes, blender-style spherical
poses, small circular oscillations around an anchor, and the
``renderPath.log`` that the render CLI's DEMO mode reads (camera.log
format).
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v)


def interpolate_poses(c2w_a: np.ndarray, c2w_b: np.ndarray, num: int) -> np.ndarray:
    """``num`` poses [num, 3, 4] from ``c2w_a`` to ``c2w_b``: centre and
    viewing axis interpolated linearly, the up axis the two poses' mean,
    the frame re-orthogonalised."""
    poses = np.zeros((num, 3, 4), np.float32)
    up_axis = 0.5 * c2w_a[:, 1] + 0.5 * c2w_b[:, 1]
    for i, step in enumerate(np.linspace(0, 1, num)):
        center = c2w_a[:, 3] * (1 - step) + c2w_b[:, 3] * step
        z_axis = c2w_a[:, 2] * (1 - step) + c2w_b[:, 2] * step
        x_axis = _normalize(np.cross(up_axis, z_axis))
        y_axis = _normalize(np.cross(z_axis, x_axis))
        z_axis = _normalize(z_axis)
        poses[i] = np.stack([x_axis, y_axis, z_axis, center], axis=-1)
    return poses


def interpolate_path(c2ws: np.ndarray, steps_per_pair: int = 30) -> np.ndarray:
    """Chain ``interpolate_poses`` through keyframe poses [K, 3, 4]."""
    out = [interpolate_poses(a, b, steps_per_pair) for a, b in zip(c2ws[:-1], c2ws[1:])]
    return np.concatenate(out)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """A [3, 4] pose on a sphere of ``radius`` looking at the origin."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    eye = radius * np.array([np.sin(th) * np.cos(ph), -np.sin(ph), -np.cos(th) * np.cos(ph)])
    z = _normalize(-eye)
    x = _normalize(np.cross(np.array([0.0, 1.0, 0.0]), z))
    y = np.cross(z, x)
    return np.concatenate([np.stack([x, y, z], -1), eye[:, None]], -1).astype(np.float32)


def circular_path(anchor_c2w: np.ndarray, num: int = 60, scale: float = 1.0) -> np.ndarray:
    """``num`` poses [num, 3, 4] moving the anchor's centre on a circle of
    radius 0.05 * ``scale`` in its own x-y plane."""
    out = []
    for i in range(num):
        t = 2 * np.pi * i / num
        dx = 0.05 * scale * np.sin(t)
        dy = 0.05 * scale * np.cos(t)
        c2w = anchor_c2w.copy()
        c2w[:, 3] = c2w[:, 3] + c2w[:, 0] * dx + c2w[:, 1] * dy
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def write_render_path(path: str, ks: np.ndarray, c2ws: np.ndarray, H: int, W: int) -> None:
    """Write poses [N, 3, 4] with intrinsics [3, 3] (shared) or [N, 3, 3]
    as a camera.log-format file (``renderPath.log``)."""
    from scanerf_tpu_torch.data import io as data_io

    if ks.ndim == 2:
        ks = np.tile(ks[None], (len(c2ws), 1, 1))
    data_io.write_campara(path, ks, c2ws, H, W)
