"""COLMAP binary sparse-model reader and ``camera.log`` extractor
(counterpart of ``scanerf_tpu/preprocess/colmap.py``).

Parses COLMAP's documented binary model (cameras.bin, images.bin,
points3D.bin: only the fields the pipeline needs) and writes the
pipeline's ``camera.log`` with the images renumbered in image-id order.

    python -m scanerf_tpu_torch.preprocess.colmap DATA_DIR
"""

from __future__ import annotations

import os
import shutil
import struct
from dataclasses import dataclass

import numpy as np

# COLMAP camera model id -> (name, number of params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray  # [3]
    rgb: np.ndarray  # [3] uint8
    error: float
    image_ids: np.ndarray  # [track_len] int32


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            out[cid] = ColmapCamera(cid, name, int(w), int(h),
                                    np.array(_read(f, f"<{n_params}d")))
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # the 2D points (x, y, point3D id) are not needed
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str) -> dict[int, ColmapPoint3D]:
    """points3D.bin: id, xyz, rgb, error and the track's image ids (its
    point2D indices are skipped)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(f, "<QdddBBBd")
            (track_len,) = _read(f, "<Q")
            elems = _read(f, f"<{2 * track_len}i")
            out[pid] = ColmapPoint3D(int(pid), np.array([x, y, z]),
                                     np.array([r, g, b], np.uint8), float(err),
                                     np.array(elems[0::2], np.int32))
    return out


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix [3, 3]."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def extract_colmap_camera(data_dir: str, sparse_subdir: str = "sparse/0",
                          copy_images: bool = True) -> int:
    """COLMAP project -> ``camera.log`` (and, with ``copy_images``, the
    images renumbered into ``new_images/{i}.png``): c2w rotation R^T and
    centre -R^T t of each image, the first camera's intrinsics, near 0 and
    far 1000. Returns the number of cameras written."""
    camdata = read_cameras_binary(os.path.join(data_dir, sparse_subdir, "cameras.bin"))
    imdata = read_images_binary(os.path.join(data_dir, sparse_subdir, "images.bin"))
    cam = camdata[next(iter(camdata))]
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        focal, cx, cy = cam.params[0], cam.params[1], cam.params[2]
        fx = fy = focal
    else:  # PINHOLE-style
        fx, fy, cx, cy = cam.params[:4]
    H, W = cam.height, cam.width

    img_out = os.path.join(data_dir, "new_images")
    if copy_images:
        os.makedirs(img_out, exist_ok=True)
    count = 0
    with open(os.path.join(data_dir, "camera.log"), "w") as f:
        for k in sorted(imdata):
            im = imdata[k]
            if copy_images:
                src = os.path.join(data_dir, "images", im.name)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(img_out, f"{count}.png"))
            R = qvec2rotmat(im.qvec).T  # w2c rotation -> c2w rotation
            C = -R @ im.tvec.reshape(3, 1)
            f.write(f"{count}\n")
            f.write(f"{fx:.2f} {fy:.2f} {cx} {cy}\n")
            f.write(f"{W} {H} 0 1000\n")
            for r in range(3):
                f.write(f"{R[r,0]:.8f} {R[r,1]:.8f} {R[r,2]:.8f} {C[r,0]:.8f}\n")
            f.write("0 0 0 1\n")
            count += 1
    return count


def main():
    import sys

    extract_colmap_camera(sys.argv[1])


if __name__ == "__main__":
    main()
