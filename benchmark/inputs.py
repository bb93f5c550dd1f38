"""Inputs the benchmark makes for both sides from a seed: scenes, tables,
decoders. Neither the program nor the reference makes its own.

Weights are drawn on the device by a ``torch.Generator`` seeded with the
run's seed, in one call a tensor, in the type they are served in (f32);
the same seed gives the same weights on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import field as F


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % 2**63)


def decoder_vectors(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n packed ShallowMLP vectors [n, 13994] (per layer the bias, then W
    as [out, in]), each entry U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as
    torch.nn.Linear initialises, in one draw."""
    scale = torch.cat([torch.full((fo * (1 + fi),), 1.0 / np.sqrt(fi))
                       for fi, fo in F.DECODER_SHAPES.values()]).to(device)
    u = torch.rand((n, scale.numel()), generator=gen, device=device)
    return (u * 2.0 - 1.0) * scale


def tables(gen: torch.Generator, levels: int, entries: int, std: float, device) -> torch.Tensor:
    """Hash tables [L, entries * 2] f32 ~ N(0, std^2), one draw."""
    return torch.randn((levels, entries * 2), generator=gen, device=device) * std


def train_weights(seed: int, cfg: dict, device):
    """(table [L, H*2], decoder vector [13994]) of a training cell."""
    w = cfg["weights"]
    g = generator(seed, device)
    tab = tables(g, cfg["levels"], 2 ** cfg["config"]["HASHGRID"]["LOG2_HASHMAP_SIZE"],
                 w["table_std"], device)
    return tab, decoder_vectors(g, 1, device)[0]


def city_weights(seed: int, cfg: dict, device):
    """(tables [L, T*H*2] tile-major within a level, decoders [T, 13994])
    of a render cell."""
    T = len(cfg["tiles"]["inner_corners"])
    g = generator(seed, device)
    tab = tables(g, cfg["levels"], T * 2 ** cfg["log2_table"], cfg["weights"]["table_std"],
                 device)
    return tab, decoder_vectors(g, T, device)


# ---------------------------------------------------------------------------
# the training tile: an analytic sphere over a ground plane
# ---------------------------------------------------------------------------

def look_at(eye, target, up=(0, 1, 0)) -> np.ndarray:
    """Camera-to-world [3, 4], +z forward."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    return np.concatenate([np.stack([x, np.cross(z, x), z], -1), eye[:, None]],
                          -1).astype(np.float32)


def trace_scene(o, d_raw):
    """Colour, depth (in units of the unnormalised ray) and world normal of
    rays against a sphere of radius 0.35 at the origin over a checkered
    plane y = -0.5, under a sky gradient (normal 0)."""
    d = d_raw / np.linalg.norm(d_raw, axis=-1, keepdims=True)
    n = o.shape[0]
    ts = 0.5 * (d[:, 1] + 1)
    rgb = np.stack([0.5 + 0.3 * ts, 0.6 + 0.2 * ts, 0.8 + 0.2 * ts], -1).astype(np.float32)
    depth = np.full(n, 1e3, np.float32)
    normal = np.zeros((n, 3), np.float32)
    tp = np.where(np.abs(d[:, 1]) > 1e-6, (-0.5 - o[:, 1]) / d[:, 1], -1.0)
    hp = tp > 1e-3
    p = o + tp[:, None] * d
    checker = ((np.floor(p[:, 0] * 2) + np.floor(p[:, 2] * 2)) % 2).astype(bool)
    rgb[hp] = np.where(checker[:, None], [[0.7, 0.3, 0.2]], [[0.25, 0.5, 0.3]])[hp]
    depth[hp] = tp[hp]
    normal[hp] = [0.0, 1.0, 0.0]
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o * o, -1) - 0.35**2)
    tsph = -b - np.sqrt(np.maximum(disc, 0.0))
    hs = (disc > 0) & (tsph > 1e-3) & (tsph < depth)
    nrm = (o + tsph[:, None] * d) / 0.35
    light = np.clip(nrm @ np.array([0.5, 0.7, -0.5]) / np.linalg.norm([0.5, 0.7, -0.5]), 0, 1)
    rgb[hs] = np.stack([0.2 + 0.7 * light, 0.2 + 0.4 * light, 0.2 + 0.2 * light], -1)[hs]
    depth[hs] = tsph[hs]
    normal[hs] = nrm[hs]
    return rgb, depth / np.linalg.norm(d_raw, axis=-1), normal


def tile_scene(cfg: dict, device="cpu") -> dict:
    """The training tile of a configuration: cameras on a circle of radius
    1.5 at height 0.6 looking at the origin (focal 0.8 W), their images,
    depths and camera-frame normals, the tile's doubled box, the occupancy
    grid of the surfaces dilated by a cell and a half (worked out on
    ``device``), and the level resolutions."""
    s = cfg["scene"]
    N, H, W = s["cameras"], s["height"], s["width"]
    f = 0.8 * W
    ks = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32), (N, 1, 1))
    c2ws = np.stack([look_at([1.5 * np.sin(th), 0.6, -1.5 * np.cos(th)], np.zeros(3))
                     for th in 2 * np.pi * np.arange(N) / N])
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    imgs, deps, nrms = [], [], []
    for i in range(N):
        R, t = c2ws[i][:, :3].astype(np.float64), c2ws[i][:, 3]
        dirs = pix @ np.linalg.inv(ks[i]).T @ R.T
        rgb, dep, nw = trace_scene(np.broadcast_to(t, dirs.shape), dirs)
        imgs.append(rgb.reshape(H, W, 3))
        deps.append(dep.reshape(H, W))
        nrms.append((nw @ R).reshape(H, W, 3))  # world -> camera frame
    corner, size = np.asarray(s["bbox_corner"], np.float32), np.asarray(s["bbox_size"], np.float32)
    size2 = size * 2.0
    min_bbox = corner + size / 2.0 - size2 / 2.0
    g = 2 ** s["grid_log2dim"]
    cell = size / g
    X, Y, Z = (torch.as_tensor(corner[d] + (np.arange(g) + 0.5) * cell[d], device=device)
               .view([g if e == d else 1 for e in range(3)]) for d in range(3))
    near = 1.5 * float(cell.max())
    occ = ((torch.sqrt(X * X + Y * Y + Z * Z) - 0.35).abs() < near) | ((Y + 0.5).abs() < near)
    res_lo, res_hi = cfg["resolutions"]
    return {"images": np.stack(imgs).astype(np.float32), "depths": np.stack(deps),
            "normals": np.stack(nrms).astype(np.float32), "ks": ks, "c2ws": c2ws,
            "bbox_corner": corner, "bbox_size_inner": size, "min_bbox": min_bbox,
            "bbox_size": size2, "occupied": occ.cpu().numpy(),
            "resolutions": F.level_resolutions((size2 / size2.min() * res_lo).astype(np.int32),
                                               (size2 / size2.min() * res_hi).astype(np.int32),
                                               cfg["levels"])}


# ---------------------------------------------------------------------------
# the city: tiles in a grid, spherical occupancy shells
# ---------------------------------------------------------------------------

def city_scene(cfg: dict, device="cpu") -> dict:
    """Tile boxes (doubled: corner, size [T, 3]), per-tile occupancy grids
    [T, R, R, R] bool on ``device`` (a spherical shell sampled at each
    tile's cell centres) and level resolutions [T, L, 3]."""
    t = cfg["tiles"]
    inner = np.float32(t["inner_size"])
    R = 2 ** t["grid_log2dim"]
    centre = np.asarray(t["shell_centre"], np.float64)
    corners, sizes, grids = [], [], []
    for ic in np.asarray(t["inner_corners"], np.float32):
        corners.append(ic - inner / 2)
        sizes.append(np.full(3, 2 * inner, np.float32))
        axis = (np.arange(R) + 0.5) / R * inner
        X, Y, Z = (torch.as_tensor(ic[d] + axis - centre[d], device=device)
                   .view([R if e == d else 1 for e in range(3)]) for d in range(3))
        r = torch.sqrt(X * X + Y * Y + Z * Z)
        grids.append((r - t["shell_radius"]).abs() < t["shell_half_width"])
    res = F.level_resolutions([cfg["resolutions"][0]] * 3, [cfg["resolutions"][1]] * 3,
                              cfg["levels"])
    T = len(corners)
    return {"corners": np.stack(corners), "sizes": np.stack(sizes), "grids": torch.stack(grids),
            "resolutions": np.tile(res[None], (T, 1, 1))}
