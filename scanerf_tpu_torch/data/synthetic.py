"""Synthetic sphere scene with analytic ground truth (the port's own numpy
copy of ``scanerf_tpu/data/synthetic.py:13-72, 196-233``): cameras on a
circle looking at a lambertian sphere over a checkered ground plane, under
a sky gradient."""

from __future__ import annotations

import numpy as np


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=(0, 1, 0)) -> np.ndarray:
    """Camera-to-world [3,4] with +z forward (the convention of
    ``camera.log`` c2w rows and BARF ray generation)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.concatenate([np.stack([x, y, z], -1), eye[:, None]], -1).astype(
        np.float32
    )


def trace_sphere_scene(
    rays_o: np.ndarray, rays_d: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Analytic scene: unit-radius-0.5 lambertian sphere at origin over a
    textured ground plane y=-0.5, sky gradient background.

    Returns (rgb [N,3], depth [N,1]); depth in units of |rays_d|.
    """
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o = rays_o

    rgb = np.zeros((o.shape[0], 3), np.float32)
    depth = np.full((o.shape[0], 1), 1e3, np.float32)

    # sky gradient
    tsky = 0.5 * (d[:, 1] + 1)
    rgb[:] = np.stack(
        [0.5 + 0.3 * tsky, 0.6 + 0.2 * tsky, 0.8 + 0.2 * tsky], -1
    )

    # ground plane y = -0.5
    denom = d[:, 1]
    t_plane = np.where(np.abs(denom) > 1e-6, (-0.5 - o[:, 1]) / denom, -1.0)
    hit_p = t_plane > 1e-3
    p = o + t_plane[:, None] * d
    checker = ((np.floor(p[:, 0] * 2) + np.floor(p[:, 2] * 2)) % 2).astype(bool)
    plane_col = np.where(checker[:, None], [[0.7, 0.3, 0.2]], [[0.25, 0.5, 0.3]])
    rgb[hit_p] = plane_col[hit_p]
    depth[hit_p, 0] = t_plane[hit_p]

    # sphere radius .35 at origin height 0
    oc = o
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - 0.35**2
    disc = b * b - c
    t_sph = -b - np.sqrt(np.maximum(disc, 0.0))
    hit_s = (disc > 0) & (t_sph > 1e-3) & (t_sph < depth[:, 0])
    n = (o + t_sph[:, None] * d) / 0.35
    light = np.clip(n @ np.array([0.5, 0.7, -0.5]) / np.linalg.norm([0.5, 0.7, -0.5]), 0, 1)
    sph_col = np.stack(
        [0.2 + 0.7 * light, 0.2 + 0.4 * light, 0.2 + 0.2 * light], -1
    )
    rgb[hit_s] = sph_col[hit_s]
    depth[hit_s, 0] = t_sph[hit_s]

    # convert depth to units of the UNNORMALIZED ray
    scale = np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rgb.astype(np.float32), (depth / scale).astype(np.float32)


def make_sphere_dataset(
    n_cameras: int = 8,
    H: int = 48,
    W: int = 48,
    radius: float = 1.5,
    height_variation: float = 0.0,
):
    """Cameras on a circle looking at the origin; returns
    (images [N,H,W,3], depths [N,H,W], ks [N,3,3], c2ws [N,3,4]).

    ``height_variation`` > 0 staggers camera heights — needed when the
    poses feed Procrustes-based evaluation (coplanar centers leave the
    alignment rotation under-determined)."""
    f = 0.8 * W
    ks = np.stack(
        [
            np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
            for _ in range(n_cameras)
        ]
    )
    c2ws = []
    for i in range(n_cameras):
        th = 2 * np.pi * i / n_cameras
        h = 0.6 + height_variation * np.sin(2.3 * th + 0.7)
        eye = np.array([radius * np.sin(th), h, -radius * np.cos(th)])
        c2ws.append(look_at_c2w(eye, np.zeros(3)))
    c2ws = np.stack(c2ws)

    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    images, depths = [], []
    for i in range(n_cameras):
        dirs_cam = pix @ np.linalg.inv(ks[i]).T
        R, t = c2ws[i][:, :3], c2ws[i][:, 3]
        dirs = dirs_cam @ R.T
        o = np.broadcast_to(t, dirs.shape)
        rgb, depth = trace_sphere_scene(o, dirs)
        images.append(rgb.reshape(H, W, 3))
        depths.append(depth.reshape(H, W))
    return np.stack(images), np.stack(depths), ks, c2ws
