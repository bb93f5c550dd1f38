"""Synthetic sphere scene with analytic ground truth (the port's own numpy
copy of ``scanerf_tpu/data/synthetic.py``): cameras on a circle looking at
a lambertian sphere over a checkered ground plane, under a sky gradient;
``write_scene_dir`` writes it as a scene directory in the reference
layout, its images with the port's PNG writer."""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import io as data_io
from scanerf_tpu_torch.data.png import write_png
from scanerf_tpu_torch.geometry.ply import write_ply


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


def write_scene_dir(
    path: str,
    n_cameras: int = 8,
    H: int = 48,
    W: int = 48,
    radius: float = 1.5,
    n_tiles: int = 1,
    with_mesh: bool = True,
    unequal_views: bool = False,
    height_variation: float = 0.3,
) -> None:
    """Materialize a reference-layout scene directory from the analytic
    sphere scene: camera.log, images/, mesh/mesh.ply, tiles metadata,
    blocks/test.txt — everything the training CLI consumes."""
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    os.makedirs(os.path.join(path, "mesh"), exist_ok=True)
    os.makedirs(os.path.join(path, "tiles"), exist_ok=True)
    os.makedirs(os.path.join(path, "blocks"), exist_ok=True)

    os.makedirs(os.path.join(path, "mono_depths"), exist_ok=True)
    os.makedirs(os.path.join(path, "mono_normals"), exist_ok=True)

    images, depths, ks, c2ws = make_sphere_dataset(
        n_cameras, H, W, radius, height_variation=height_variation
    )
    data_io.write_campara(os.path.join(path, "camera.log"), ks, c2ws, H, W)
    for i in range(n_cameras):
        write_png(
            os.path.join(path, "images", f"{i}.png"),
            (images[i] * 255).astype(np.uint8),
        )
        # mono priors emulate MiDaS output: BOUNDED relative depth. The
        # raw trace uses 1e3 for sky, which would dominate the depth-
        # consistency loss's least-squares scale/shift fit (real MiDaS
        # maps never contain such sentinels)
        np.save(
            os.path.join(path, "mono_depths", f"{i}.npy"),
            np.minimum(depths[i], 10.0),
        )
        np.save(
            os.path.join(path, "mono_normals", f"{i}.npy"),
            np.zeros((H, W, 3), np.float32),
        )

    if with_mesh:
        verts, faces = _sphere_ground_mesh()
        write_ply(os.path.join(path, "mesh", "mesh.ply"), verts, faces)

    # tiles metadata: n_tiles overlapping boxes around the origin
    infos = []
    views = {}
    for t in range(n_tiles):
        shift = 0.0 if n_tiles == 1 else -0.4 + 0.8 * t / max(n_tiles - 1, 1)
        infos.append(
            data_io.TileInfo(
                index=t,
                corner=np.array([-1.0 + shift, -1.0, -1.0], np.float32),
                size=np.array([2.0, 2.0, 2.0], np.float32),
                resolution=(16, 256),
                init_outside=False,
            )
        )
        # unequal per-tile camera counts exercise the trainer's
        # pad-to-max-cams path (tile.py:153-297 semantics: each tile sees
        # its own visible-view subset)
        n_t = n_cameras - 2 * t if unequal_views else n_cameras
        views[t] = list(range(max(n_t, 2)))
    data_io.write_tile_info(os.path.join(path, "tiles", "tile_info.txt"), infos)
    data_io.write_training_views(
        os.path.join(path, "tiles", "training_views.txt"), views
    )
    with open(os.path.join(path, "blocks", "test.txt"), "w") as f:
        for t in range(n_tiles):
            f.write(f"{t} 0\n")


def _sphere_ground_mesh(n: int = 16):
    us = np.linspace(0, np.pi, n)
    vs = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    verts = []
    for u in us:
        for v in vs:
            verts.append(
                [
                    0.35 * np.sin(u) * np.cos(v),
                    0.35 * np.sin(u) * np.sin(v),
                    0.35 * np.cos(u),
                ]
            )
    verts = np.array(verts, np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(2 * n):
            a = i * 2 * n + j
            b = i * 2 * n + (j + 1) % (2 * n)
            c = (i + 1) * 2 * n + j
            d = (i + 1) * 2 * n + (j + 1) % (2 * n)
            faces += [[a, b, c], [b, d, c]]
    faces = np.array(faces, np.int64)
    # ground plane y = -0.5
    g0 = len(verts)
    gverts = np.array(
        [[-3, -0.5, -3], [3, -0.5, -3], [3, -0.5, 3], [-3, -0.5, 3]], np.float32
    )
    gfaces = np.array([[g0, g0 + 1, g0 + 2], [g0, g0 + 2, g0 + 3]], np.int64)
    return np.concatenate([verts, gverts]), np.concatenate([faces, gfaces])
