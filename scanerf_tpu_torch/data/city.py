"""Synthetic city-block scene with analytic ground truth (counterpart of
``scanerf_tpu/data/city.py``, numpy only).

The multi-tile trainer's scene (the reference's deliverable is
city-scale scenes, ``config/community.yaml``): a grid of nx x nz tiles
over a street of box "buildings" with rooftop spheres, a checkered ground, and a sky
gradient, traced in closed form; a serpentine drone path of cameras
with UNEQUAL per-tile visibility; the full reference scene-directory
layout (camera.log + camera-gt.log, images/, mono priors, mesh/mesh.ply
for occupancy/masks, tiles metadata, blocks/test.txt).
"""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import io as data_io
from scanerf_tpu_torch.data.png import write_png
from scanerf_tpu_torch.data.synthetic import look_at_c2w
from scanerf_tpu_torch.geometry.ply import write_ply

TILE_PITCH = 1.6  # inner size 2.0 with the standard 0.2 overlap ratio


def _city_blocks(nx: int, nz: int, seed: int = 0):
    """Deterministic buildings: per tile cell, 2-3 boxes (xmin, ymin,
    zmin, xmax, ymax, zmax) + a palette color + optional roof sphere."""
    rng = np.random.RandomState(seed)
    boxes, colors, spheres = [], [], []
    palette = np.array([
        [0.75, 0.45, 0.35], [0.45, 0.55, 0.70], [0.65, 0.65, 0.55],
        [0.55, 0.40, 0.55], [0.40, 0.60, 0.50], [0.70, 0.60, 0.40],
    ])
    for ix in range(nx):
        for iz in range(nz):
            cx = ix * TILE_PITCH
            cz = iz * TILE_PITCH
            for _ in range(rng.randint(2, 4)):
                w = rng.uniform(0.25, 0.55)
                d = rng.uniform(0.25, 0.55)
                h = rng.uniform(0.25, 0.9)
                x0 = cx + rng.uniform(-0.55, 0.55 - w)
                z0 = cz + rng.uniform(-0.55, 0.55 - d)
                boxes.append([x0, -0.5, z0, x0 + w, -0.5 + h, z0 + d])
                colors.append(palette[rng.randint(len(palette))])
                if rng.rand() < 0.35:
                    spheres.append(
                        [x0 + w / 2, -0.5 + h + 0.08, z0 + d / 2, 0.08]
                    )
    return (
        np.array(boxes, np.float64),
        np.array(colors, np.float64),
        np.array(spheres, np.float64).reshape(-1, 4),
    )


_LIGHT = np.array([0.45, 0.8, -0.35]) / np.linalg.norm([0.45, 0.8, -0.35])


def trace_city_scene(rays_o, rays_d, boxes, colors, spheres):
    """Closed-form trace -> (rgb [N,3], depth [N,1] in |rays_d| units)."""
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o = rays_o.astype(np.float64)
    N = o.shape[0]
    depth = np.full(N, 1e3)
    rgb = np.zeros((N, 3))
    tsky = 0.5 * (d[:, 1] + 1)
    rgb[:] = np.stack(
        [0.55 + 0.25 * tsky, 0.65 + 0.15 * tsky, 0.8 + 0.2 * tsky], -1
    )

    # ground y=-0.5 checker
    denom = d[:, 1]
    t_pl = np.where(np.abs(denom) > 1e-9, (-0.5 - o[:, 1]) / denom, -1.0)
    hit = t_pl > 1e-3
    p = o + t_pl[:, None] * d
    checker = ((np.floor(p[:, 0] * 2.5) + np.floor(p[:, 2] * 2.5)) % 2
               ).astype(bool)
    col = np.where(checker[:, None], [[0.62, 0.60, 0.58]],
                   [[0.35, 0.42, 0.35]])
    rgb[hit] = col[hit]
    depth[hit] = t_pl[hit]

    # boxes (vectorized slab test, one box at a time: tens of boxes)
    for b, c in zip(boxes, colors):
        inv = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
        t0 = (b[:3] - o) * inv
        t1 = (b[3:] - o) * inv
        tn = np.minimum(t0, t1).max(axis=1)
        tf = np.maximum(t0, t1).min(axis=1)
        hit = (tf > tn) & (tn > 1e-3) & (tn < depth)
        if not hit.any():
            continue
        ph = o[hit] + tn[hit, None] * d[hit]
        # face normal = axis of the entering slab
        ax = np.argmax(np.minimum(t0, t1), axis=1)[hit]
        n = np.zeros((hit.sum(), 3))
        n[np.arange(len(ax)), ax] = -np.sign(d[hit, ax])
        light = np.clip(n @ _LIGHT, 0, 1)
        shade = 0.35 + 0.65 * light
        rgb[hit] = c[None, :] * shade[:, None]
        depth[hit] = tn[hit]

    for s in spheres:
        oc = o - s[:3]
        b2 = np.sum(oc * d, -1)
        c2 = np.sum(oc * oc, -1) - s[3] ** 2
        disc = b2 * b2 - c2
        t_s = -b2 - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t_s > 1e-3) & (t_s < depth)
        if not hit.any():
            continue
        n = (o[hit] + t_s[hit, None] * d[hit] - s[:3]) / s[3]
        light = np.clip(n @ _LIGHT, 0, 1)
        rgb[hit] = np.stack(
            [0.85 * light + 0.1, 0.75 * light + 0.1, 0.3 * light + 0.1], -1
        )
        depth[hit] = t_s[hit]

    scale = np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return (
        rgb.astype(np.float32),
        (depth[:, None] / scale).astype(np.float32),
    )


def _city_mesh(boxes):
    """Boxes + ground quad -> (verts, faces) proxy mesh."""
    verts, faces = [], []
    for b in boxes:
        v0 = len(verts)
        xs = (b[0], b[3])
        ys = (b[1], b[4])
        zs = (b[2], b[5])
        for x in xs:
            for y in ys:
                for z in zs:
                    verts.append([x, y, z])
        quads = [
            (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
            (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
        ]
        for q in quads:
            faces.append([v0 + q[0], v0 + q[1], v0 + q[2]])
            faces.append([v0 + q[0], v0 + q[2], v0 + q[3]])
    g0 = len(verts)
    lo = boxes[:, :3].min(0) - 2.0
    hi = boxes[:, 3:].max(0) + 2.0
    verts += [[lo[0], -0.5, lo[2]], [hi[0], -0.5, lo[2]],
              [hi[0], -0.5, hi[2]], [lo[0], -0.5, hi[2]]]
    faces += [[g0, g0 + 1, g0 + 2], [g0, g0 + 2, g0 + 3]]
    return np.array(verts, np.float32), np.array(faces, np.int64)


def make_city_cameras(nx, nz, n_cameras, H, W, seed=1):
    """Serpentine drone path over the city: each camera looks at a
    ground target a tile or two ahead — nearby tiles see it, far ones
    don't (unequal per-tile visibility)."""
    rng = np.random.RandomState(seed)
    f = 0.9 * W
    ks = np.tile(
        np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
        (n_cameras, 1, 1),
    )
    x_extent = (nx - 1) * TILE_PITCH
    z_extent = (nz - 1) * TILE_PITCH
    c2ws = []
    for i in range(n_cameras):
        u = i / max(n_cameras - 1, 1)
        # serpentine: sweep x forward and back while advancing z
        lap = u * max(nz, 2) * 0.999
        row = int(lap)
        frac = lap - row
        x = (frac if row % 2 == 0 else 1 - frac) * x_extent
        z = (row + 0.15 * np.sin(7 * u)) / max(nz, 2) * z_extent
        eye = np.array([
            x + rng.uniform(-0.15, 0.15),
            1.35 + 0.35 * np.sin(5.1 * u + 0.9),
            z - 1.1 + rng.uniform(-0.1, 0.1),
        ])
        target = np.array([
            x + rng.uniform(-0.3, 0.3), -0.2,
            min(z + 0.9, z_extent + 0.6),
        ])
        c2ws.append(look_at_c2w(eye, target))
    return ks, np.stack(c2ws)


def write_city_scene_dir(
    path: str,
    nx_tiles: int = 4,
    nz_tiles: int = 2,
    n_cameras: int = 96,
    H: int = 64,
    W: int = 64,
    seed: int = 0,
    min_views: int = 6,
) -> dict:
    """Materialize a reference-layout city scene; returns a summary. The
    images are written by the port's PNG codec (``data/png.py``)."""
    for sub in ("images", "mesh", "tiles", "blocks", "mono_depths",
                "mono_normals"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)

    boxes, colors, spheres = _city_blocks(nx_tiles, nz_tiles, seed)
    ks, c2ws = make_city_cameras(nx_tiles, nz_tiles, n_cameras, H, W)
    data_io.write_campara(os.path.join(path, "camera.log"), ks, c2ws, H, W)
    data_io.write_campara(
        os.path.join(path, "camera-gt.log"), ks, c2ws, H, W
    )

    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    for i in range(n_cameras):
        dirs = (pix @ np.linalg.inv(ks[i]).T) @ c2ws[i][:, :3].T
        o = np.broadcast_to(c2ws[i][:, 3], dirs.shape)
        rgb, depth = trace_city_scene(o, dirs, boxes, colors, spheres)
        write_png(
            os.path.join(path, "images", f"{i}.png"),
            (rgb.reshape(H, W, 3) * 255).astype(np.uint8),
        )
        np.save(os.path.join(path, "mono_depths", f"{i}.npy"),
                np.minimum(depth.reshape(H, W), 10.0))
        np.save(os.path.join(path, "mono_normals", f"{i}.npy"),
                np.zeros((H, W, 3), np.float32))

    verts, faces = _city_mesh(boxes)
    write_ply(os.path.join(path, "mesh", "mesh.ply"), verts, faces)

    # tiles: nx x nz grid, inner size 2.0 (pitch 1.6 -> 0.2 overlap)
    infos, views = [], {}
    t = 0
    centers = np.array(
        [c2w[:, 3] for c2w in c2ws]
    )
    look = np.array([c2w[:, 2] for c2w in c2ws])
    for ix in range(nx_tiles):
        for iz in range(nz_tiles):
            corner = np.array(
                [ix * TILE_PITCH - 1.0, -1.0, iz * TILE_PITCH - 1.0],
                np.float32,
            )
            infos.append(data_io.TileInfo(
                index=t, corner=corner,
                size=np.array([2.0, 2.0, 2.0], np.float32),
                resolution=(16, 1024), init_outside=False,
            ))
            center = corner + 1.0
            # visibility: camera close to the tile AND roughly facing it
            rel = center[None, :] - centers
            dist = np.linalg.norm(rel[:, [0, 2]], axis=1)
            facing = np.sum(
                rel / np.maximum(np.linalg.norm(rel, axis=1,
                                                keepdims=True), 1e-9)
                * look, axis=1,
            )
            score = np.where(facing > 0.2, dist, np.inf)
            vis = np.where(score < 2.4)[0]
            if len(vis) < min_views:
                vis = np.argsort(score)[:min_views]
            views[t] = [int(v) for v in np.sort(vis)]
            t += 1
    data_io.write_tile_info(
        os.path.join(path, "tiles", "tile_info.txt"), infos
    )
    data_io.write_training_views(
        os.path.join(path, "tiles", "training_views.txt"), views
    )
    with open(os.path.join(path, "blocks", "test.txt"), "w") as f:
        for tt, vv in views.items():
            f.write(f"{tt} {vv[len(vv) // 2]}\n")
    return {
        "n_tiles": t,
        "views_per_tile": {k: len(v) for k, v in views.items()},
        "n_boxes": len(boxes),
    }
