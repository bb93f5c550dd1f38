"""Tile allocation (counterpart of ``scanerf_tpu/preprocess/build_tiles.py``).

    python -m scanerf_tpu_torch.preprocess.build_tiles config/[SCENE].yaml [--device cpu]

1. A grid of overlapping tile corners over the proxy mesh's bounding box:
   ``corner = scene_min + offset + ijk * (1 - overlap) * tile_size``.
2. Each (camera, tile) pair's coverage score at 1/4 resolution: the share
   of the camera's rays that enter the tile in front of the mesh (the
   ray-box test on ``device``, ``ops/intersect.py``; the mesh depth from
   ``ProxyMesh.render_depth`` on the host).
3. The tiles that hold a camera, trimmed or extended to EXPECT_NUM by
   their mean camera distance.
4. Each tile's views: score above 0.1 (plus 0.1 for cameras inside it on
   outdoor scenes); a tile keeps MIN_NUM_IMAGE views or more, or goes.
5. ``tiles/training_views.txt``, ``tiles/tile_info.txt`` (base resolution
   32, finest 8192 outdoor / 4096 indoor) and ``tiles/tiles.obj`` in the
   scene directory, overwriting what is there.

``device`` defaults to "cuda" and raises without CUDA; "cpu" runs the
ray-box test in plain PyTorch on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.data import io as data_io
from scanerf_tpu_torch.geometry.mesh_engine import ProxyMesh
from scanerf_tpu_torch.ops.intersect import ray_aabb_multi
from scanerf_tpu_torch.utils import obj as obj_lib


def build_tiles(cfg, data_dir: str | None = None, device="cuda") -> dict:
    """Allocate the tiles of the scene at ``data_dir`` (default
    ``cfg.DATADIR``) under ``cfg.ALLOCATION`` and write them -> {"tiles":
    [TileInfo], "views": {tile: [camera]}}."""
    dev = _device.resolve(device)
    data_dir = data_dir or cfg.DATADIR
    alloc = cfg.ALLOCATION
    tile_size = np.asarray(alloc.TILE_SIZE, np.float32)
    overlap = float(alloc.OVERLAP_RATIO)
    offset = np.asarray(alloc.OFFSET, np.float32)
    expect_num = int(alloc.EXPECT_NUM)
    min_num_image = int(alloc.MIN_NUM_IMAGE)
    max_dim = np.asarray(alloc.MAX_DIM_TILE, np.int64)
    scene_type = alloc.SCENE_TYPE
    thresh = 0.1
    scale = 4

    tile_dir = os.path.join(data_dir, "tiles")
    os.makedirs(tile_dir, exist_ok=True)
    ignore = data_io.read_ignore(data_dir)
    fmesh = ProxyMesh(os.path.join(data_dir, "mesh", "mesh.ply"))
    bmin, bmax = fmesh.get_sceneinfo()

    scene_min = bmin + offset
    side = np.ceil((bmax - scene_min) / tile_size).astype(np.int64)
    side = np.minimum(np.maximum(side, 1), max_dim)
    xs, ys, zs = np.meshgrid(np.arange(side[0]), np.arange(side[1]), np.arange(side[2]),
                             indexing="ij")
    grid = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    tile_corners = scene_min + grid * (1 - overlap) * tile_size  # [K, 3]
    K = len(tile_corners)

    ks, c2ws, H, W = data_io.read_campara(os.path.join(data_dir, "camera.log"),
                                          return_shape=True)
    n_cam = ks.shape[0]

    # coverage: the share of 1/scale-resolution rays entering the tile in
    # front of the mesh
    centers = tile_corners + tile_size / 2.0
    centers_d = torch.tensor(centers, dtype=torch.float32, device=dev)
    halfs_d = torch.tensor(np.broadcast_to(tile_size / 2.0, centers.shape).copy(),
                           dtype=torch.float32, device=dev)
    related = np.zeros((K, n_cam), np.float32)
    Hs, Ws = H // scale, W // scale
    ys_pix, xs_pix = np.meshgrid(np.arange(Hs) + 0.5, np.arange(Ws) + 0.5, indexing="ij")
    pix = np.stack([xs_pix, ys_pix, np.ones_like(xs_pix)], -1).reshape(-1, 3)
    for ci in range(n_cam):
        k = ks[ci] / scale
        k[2, 2] = 1.0
        dirs_cam = pix @ np.linalg.inv(k).T
        R, t = c2ws[ci][:, :3], c2ws[ci][:, 3]
        rays_d = (dirs_cam @ R.T).astype(np.float32)
        rays_o = np.broadcast_to(t, rays_d.shape).astype(np.float32)
        bounds = ray_aabb_multi(torch.tensor(rays_o, device=dev),
                                torch.tensor(rays_d, device=dev), centers_d,
                                halfs_d).cpu().numpy()
        t_near = np.where(bounds[..., 0] == -1, 1e7, bounds[..., 0])  # [B, K]
        depth = fmesh.render_depth(rays_o, rays_d)
        depth = np.where(depth == 0, 1e5, depth)  # sky
        related[:, ci] = (t_near < depth[:, None]).sum(0) / (H * W) * scale**2

    cam_centers = c2ws[:, :, 3]
    tile_score = np.linalg.norm(cam_centers[None] - (tile_corners[:, None] + tile_size / 2.0),
                                axis=-1).mean(-1)
    cam_loc = (cam_centers[None] - tile_corners[:, None]) / tile_size
    inside = np.all((cam_loc >= 0) & (cam_loc < 1), axis=-1)  # [K, n_cam]

    has_cam = inside.any(axis=1)
    valid = list(np.nonzero(has_cam)[0])
    empty = list(np.nonzero(~has_cam)[0])
    if len(valid) < expect_num:
        valid += sorted(empty, key=lambda i: tile_score[i])[: expect_num - len(valid)]
    elif len(valid) > expect_num:
        valid = sorted(sorted(valid, key=lambda i: tile_score[i])[:expect_num])
    valid = sorted(valid)

    final_score = related if scene_type == "indoor" else thresh * inside + related
    final_score[:, ignore] = 0

    views: dict[int, list[int]] = {}
    kept_tiles = []
    for i in valid:
        order = np.argsort(-final_score[i])
        sel = [int(c) for c in order if final_score[i, c] > thresh]
        if len(sel) > min_num_image:
            views[len(kept_tiles)] = sel
            kept_tiles.append(i)
    data_io.write_training_views(os.path.join(tile_dir, "training_views.txt"), views)
    if not kept_tiles:
        print(f"WARNING: no tiles kept: every candidate had <= {min_num_image} views above "
              f"score {thresh} (check ALLOCATION.MIN_NUM_IMAGE)")

    resolution = 8192 if scene_type == "outdoor" else 4096
    infos = [data_io.TileInfo(index=j, corner=tile_corners[i].astype(np.float32),
                              size=tile_size, resolution=(32, resolution),
                              init_outside=False)
             for j, i in enumerate(kept_tiles)]
    data_io.write_tile_info(os.path.join(tile_dir, "tile_info.txt"), infos)

    kept_centers = tile_corners[kept_tiles] + tile_size / 2.0
    verts, faces = obj_lib.draw_aabbs(kept_centers,
                                      np.broadcast_to(tile_size, kept_centers.shape))
    obj_lib.write_obj(os.path.join(tile_dir, "tiles.obj"), verts, faces)
    return {"tiles": infos, "views": views}


def main(argv=None):
    import argparse

    from scanerf_tpu_torch.config import parse_yaml

    parser = argparse.ArgumentParser(
        prog="python -m scanerf_tpu_torch.preprocess.build_tiles",
        description="Allocate a scene's tiles and write them into its tiles/ directory.")
    parser.add_argument("config", help="scene yaml (overlaid on its SCENE base config)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' for the plain path")
    args = parser.parse_args(argv)
    build_tiles(parse_yaml(args.config), device=args.device)


if __name__ == "__main__":
    main()
