"""Scene IO: camera.log, images, mono priors, tiles metadata (the port's
own copy of ``scanerf_tpu/data/io.py``; images are read with the port's
PNG codec, ``data/png.py``, not with OpenCV).

Formats are byte-compatible with the reference dataset layout
(``load_data.py:60-179``, ``tile.py:95-110``, README "Directory
Structure"):

- ``camera.log``: 7 lines per camera — index / ``fx fy cx cy`` /
  ``W H near far`` / three rows of the 3x4 camera-to-world matrix /
  ``0 0 0 1``.
- ``images/{idx}.png`` loaded BGR / 255 (the reference uses cv2.imread
  and never converts — renders and metrics are consistently BGR; we
  preserve that).
- ``mono_depths/{idx}.npy``, ``mono_normals/{idx}.npy``.
- ``ignore.log``: "i" or "start end" lines of camera ids to drop.
- ``tiles/training_views.txt``: alternating "tileIdx" / space-separated
  view-id lines; ``tiles/tile_info.txt``: header + per-tile
  ``idx cx cy cz sx sy sz base finest init_outside``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from scanerf_tpu_torch.data import png


# ---------------------------------------------------------------------------
# camera.log
# ---------------------------------------------------------------------------

def read_campara(path: str, return_shape: bool = False):
    """Parse camera.log (load_data.py:60-100)."""
    with open(path) as f:
        lines = f.readlines()
    ks, c2ws = [], []
    height = width = near = far = 0.0
    for i in range(0, len(lines), 7):
        item = lines[i : i + 7]
        if len(item) < 7:
            break
        fx, fy, cx, cy = map(float, re.split(r"\s+", item[1].strip()))
        width, height, near, far = map(float, re.split(r"\s+", item[2].strip()))
        rows = [
            list(map(float, re.split(r"\s+", item[3 + r].strip())))
            for r in range(3)
        ]
        ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))
        c2ws.append(np.array(rows, np.float32))
    ks = np.stack(ks)
    c2ws = np.stack(c2ws)
    if return_shape:
        return ks, c2ws, int(height), int(width)
    return ks, c2ws


def write_campara(
    path: str,
    ks: np.ndarray,
    c2ws: np.ndarray,
    H: int,
    W: int,
    near: float = 0.1,
    far: float = 100.0,
) -> None:
    """Write camera.log (tools/tools.py:66-78 format)."""
    with open(path, "w") as f:
        for i in range(ks.shape[0]):
            K, P = ks[i], c2ws[i]
            f.write(f"{i}\n")
            f.write(f"{K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]}\n")
            f.write(f"{W} {H} {near} {far}\n")
            for r in range(3):
                f.write(f"{P[r,0]} {P[r,1]} {P[r,2]} {P[r,3]}\n")
            f.write("0 0 0 1\n")


# ---------------------------------------------------------------------------
# images / priors
# ---------------------------------------------------------------------------

def read_images(path: str, idx_list) -> np.ndarray:
    """Load images as BGR float [N,H,W,3] in [0,1] (load_data.py:102-115),
    the bytes ``cv2.imread`` gives divided by 255."""
    images = []
    for idx in idx_list:
        img = png.read_png(os.path.join(path, f"{idx}.png"))
        images.append(img.astype(np.float32) / 255.0)
    return np.stack(images)


def read_npy_stack(path: str, idx_list) -> np.ndarray:
    return np.stack(
        [np.load(os.path.join(path, f"{idx}.npy")) for idx in idx_list]
    )


def read_ignore(data_dir: str) -> list[int]:
    """Parse ignore.log (load_data.py:132-143)."""
    ignore: list[int] = []
    p = os.path.join(data_dir, "ignore.log")
    if not os.path.exists(p):
        return ignore
    with open(p) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) == 1 and parts[0]:
                ignore.append(int(parts[0]))
            elif len(parts) == 2:
                ignore += list(range(int(parts[0]), int(parts[1])))
    return ignore


@dataclass
class Scene:
    images: np.ndarray  # [N, H, W, 3] BGR
    c2ws: np.ndarray  # [N, 3, 4]
    ks: np.ndarray  # [N, 3, 3]
    H: int
    W: int
    idx_list: list[int] = field(default_factory=list)
    mono_depths: np.ndarray | None = None
    mono_normals: np.ndarray | None = None


def load_scene(
    data_dir: str,
    idx_list=None,
    mono_depth: bool = False,
    mono_normal: bool = False,
) -> Scene:
    """Load a scene directory (``load_snisr``, load_data.py:128-179)."""
    ignore = read_ignore(data_dir)
    ks, c2ws, H, W = read_campara(
        os.path.join(data_dir, "camera.log"), return_shape=True
    )
    if idx_list is None:
        idx_list = list(range(ks.shape[0]))
    idx_list = [i for i in idx_list if i not in ignore]
    ks = ks[idx_list]
    c2ws = c2ws[idx_list]
    images = read_images(os.path.join(data_dir, "images"), idx_list)
    depths = (
        read_npy_stack(os.path.join(data_dir, "mono_depths"), idx_list)
        if mono_depth
        else None
    )
    normals = (
        read_npy_stack(os.path.join(data_dir, "mono_normals"), idx_list)
        if mono_normal
        else None
    )
    return Scene(
        images=images, c2ws=c2ws, ks=ks, H=H, W=W, idx_list=idx_list,
        mono_depths=depths, mono_normals=normals,
    )


# ---------------------------------------------------------------------------
# Tanks & Temples cameras (tools/loader.py)
# ---------------------------------------------------------------------------

def load_cameras_tat(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load Tanks&Temples-style pose/ + intrinsics/ txt dirs:
    per-camera flattened 4x4 matrices, numeric filename order."""
    import glob as globlib

    def by_num(p):
        return int(os.path.splitext(os.path.basename(p))[0])

    pose_files = sorted(
        globlib.glob(os.path.join(path, "pose", "*.txt")), key=by_num
    )
    intr_files = sorted(
        globlib.glob(os.path.join(path, "intrinsics", "*.txt")), key=by_num
    )
    assert len(pose_files) == len(intr_files)
    ks, c2ws = [], []
    for pf, kf in zip(pose_files, intr_files):
        vals = [float(x) for x in open(pf).readline().split()]
        c2ws.append(np.array(vals[:12], np.float32).reshape(3, 4))
        kv = [float(x) for x in open(kf).readline().split()]
        ks.append(np.array(kv, np.float32).reshape(4, 4)[:3, :3])
    return np.stack(ks), np.stack(c2ws)


# ---------------------------------------------------------------------------
# tiles metadata
# ---------------------------------------------------------------------------

@dataclass
class TileInfo:
    index: int
    corner: np.ndarray  # [3]
    size: np.ndarray  # [3]
    resolution: tuple[int, int]  # (base, finest)
    init_outside: bool


def read_training_views(path: str) -> dict[int, list[int]]:
    """tiles/training_views.txt -> {tile: [view ids]} (tile.py:95-101)."""
    out: dict[int, list[int]] = {}
    with open(path) as f:
        lines = [l.strip() for l in f.readlines() if l.strip()]
    for i in range(0, len(lines), 2):
        out[int(lines[i])] = [int(x) for x in lines[i + 1].split(" ")]
    return out


def write_training_views(path: str, views: dict[int, list[int]]) -> None:
    with open(path, "w") as f:
        for tile, v in sorted(views.items()):
            f.write(f"{tile}\n")
            f.write(" ".join(str(x) for x in v) + "\n")


def read_tile_info(path: str) -> dict[int, TileInfo]:
    """tiles/tile_info.txt (tile.py:103-110): header line, then
    ``idx cx cy cz sx sy sz base finest init_outside`` per tile."""
    out: dict[int, TileInfo] = {}
    with open(path) as f:
        lines = [l.strip().split(" ") for l in f.readlines()[1:] if l.strip()]
    for line in lines:
        idx = int(line[0])
        out[idx] = TileInfo(
            index=idx,
            corner=np.array([float(line[1]), float(line[2]), float(line[3])], np.float32),
            size=np.array([float(line[4]), float(line[5]), float(line[6])], np.float32),
            resolution=(int(line[7]), int(line[8])),
            init_outside=int(line[9]) == 1,
        )
    return out


def write_tile_info(path: str, infos: list[TileInfo]) -> None:
    with open(path, "w") as f:
        f.write("tileIdx corner_x corner_y corner_z size_x size_y size_z base finest init_outside\n")
        for t in infos:
            f.write(
                f"{t.index} {t.corner[0]} {t.corner[1]} {t.corner[2]} "
                f"{t.size[0]} {t.size[1]} {t.size[2]} "
                f"{t.resolution[0]} {t.resolution[1]} {int(t.init_outside)}\n"
            )
