"""LLFF pose utilities: COLMAP -> ``poses_bounds.npy`` and the LLFF loader
(counterpart of ``scanerf_tpu/preprocess/llff.py``).

``gen_poses`` converts an existing COLMAP reconstruction (``sparse/0``;
COLMAP itself is run out of band) into LLFF's ``poses_bounds.npy``:
camera-to-world [3, 4] in LLFF's [-u, r, -t] axis order, an hwf column,
and each view's near / far depth percentiles of its visible sparse
points. ``load_llff_data`` reads such a dataset back, ``minify`` box-
filters its images. PNG images go through the port's own codec
(``data/png.py``); other formats need OpenCV (``cv2``), imported where
such an image is read, and raise naming it where it is missing.
"""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import png
from scanerf_tpu_torch.preprocess.colmap import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def _image_files(d: str) -> list[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(_IMG_EXTS)]


def load_colmap_llff(realdir: str):
    """COLMAP sparse/0 -> (poses [3, 5, N] in LLFF's [-u, r, -t] column
    order with the hwf column appended, the points3D dict, the views'
    permutation by image name)."""
    sparse = os.path.join(realdir, "sparse/0")
    camdata = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    cam = camdata[sorted(camdata.keys())[0]]
    hwf = np.array([cam.height, cam.width, cam.params[0]]).reshape(3, 1)

    imdata = read_images_binary(os.path.join(sparse, "images.bin"))
    perm = np.argsort([imdata[k].name for k in imdata])
    bottom = np.array([0, 0, 0, 1.0]).reshape(1, 4)
    w2c = []
    for k in imdata:
        im = imdata[k]
        Rt = np.concatenate([qvec2rotmat(im.qvec), im.tvec.reshape(3, 1)], 1)
        w2c.append(np.concatenate([Rt, bottom], 0))
    c2w = np.linalg.inv(np.stack(w2c))
    poses = c2w[:, :3, :4].transpose(1, 2, 0)
    poses = np.concatenate([poses, np.tile(hwf[..., None], (1, 1, poses.shape[-1]))], 1)
    # [r, -u, t] -> [-u, r, -t]
    poses = np.concatenate([poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4],
                            poses[:, 4:5]], 1)
    pts3d = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    return poses, pts3d, perm


def save_poses_bounds(basedir: str, poses, pts3d, perm) -> np.ndarray:
    """Write ``poses_bounds.npy``: a row a view (in ``perm`` order),
    [poses[..., i].ravel(), near, far], near / far the 0.1 / 99.9
    percentiles of the depths of the view's visible sparse points."""
    n_views = poses.shape[-1]
    pts_arr = np.stack([p.xyz for p in pts3d.values()])
    vis_arr = np.zeros((len(pts3d), n_views), np.int64)
    for i, p in enumerate(pts3d.values()):
        for ind in p.image_ids:
            if ind - 1 >= n_views:
                raise ValueError("point visibility references image id past the pose "
                                 f"count ({ind} > {n_views})")
            vis_arr[i, ind - 1] = 1
    zvals = np.sum(-(pts_arr[:, None, :].transpose(2, 0, 1) - poses[:3, 3:4, :])
                   * poses[:3, 2:3, :], 0)  # [P, N]
    rows = []
    for i in perm:
        zs = zvals[:, i][vis_arr[:, i] == 1]
        rows.append(np.concatenate([poses[..., i].ravel(),
                                    [np.percentile(zs, 0.1), np.percentile(zs, 99.9)]]))
    out = np.array(rows)
    np.save(os.path.join(basedir, "poses_bounds.npy"), out)
    return out


def gen_poses(basedir: str) -> np.ndarray:
    """COLMAP sparse/0 -> ``poses_bounds.npy`` (returned too)."""
    poses, pts3d, perm = load_colmap_llff(basedir)
    return save_poses_bounds(basedir, poses, pts3d, perm)


def _box_downsample(img: np.ndarray, f: int) -> np.ndarray:
    h, w = img.shape[:2]
    img = img[: h // f * f, : w // f * f]
    return img.reshape((h // f, f, w // f, f) + img.shape[2:]).mean(axis=(1, 3))


def _imread_rgb(path: str) -> np.ndarray:
    """An image as RGB uint8 [H, W, 3]: PNG through ``data/png.py``, any
    other format through OpenCV."""
    if path.lower().endswith(".png"):
        return png.read_png(path)[..., ::-1]
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs the 'opencv-python' package (cv2); "
                           "PNG images need neither") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1]  # BGR -> RGB (LLFF stores RGB)


def minify(basedir: str, factor: int) -> str:
    """images/ -> images_{factor}/ as PNGs, each box-filtered by
    ``factor`` (kept if the directory exists). Returns the directory."""
    outdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(outdir):
        return outdir
    os.makedirs(outdir)
    for f in _image_files(os.path.join(basedir, "images")):
        down = _box_downsample(_imread_rgb(f).astype(np.float64), factor)
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        png.write_png(os.path.join(outdir, name), down.astype(np.uint8)[..., ::-1])
    return outdir


def load_llff_data(basedir: str, factor: int | None = None, load_imgs: bool = True):
    """An LLFF dataset -> (poses [3, 5, N], bds [2, N], imgs [H, W, 3, N]
    float in [0, 1]); imgs left out with ``load_imgs=False``. With
    ``factor`` > 1 the images are read from ``minify``'s directory and
    hwf follows them."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    bds = poses_arr[:, -2:].transpose(1, 0)
    if factor is not None and factor > 1:
        imgdir = minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")
    imgfiles = _image_files(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"{len(imgfiles)} images vs {poses.shape[-1]} poses in {basedir}")
    sh = _imread_rgb(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape(2, 1)
    poses[2, 4, :] = poses[2, 4, :] / factor
    if not load_imgs:
        return poses, bds
    imgs = np.stack([_imread_rgb(f)[..., :3] / 255.0 for f in imgfiles], -1)
    return poses, bds, imgs


def llff_to_cameras(poses: np.ndarray):
    """LLFF poses [3, 5, N] -> (c2w [N, 4, 4] in the OpenCV convention of
    ``camera.log``, K [N, 3, 3]): columns [-u, r, -t] back to [r, -u, t]."""
    n = poses.shape[-1]
    p = poses.transpose(2, 0, 1)  # [N, 3, 5]
    c2w = np.tile(np.eye(4), (n, 1, 1))
    c2w[:, :3, 0] = p[:, :, 1]
    c2w[:, :3, 1] = p[:, :, 0]
    c2w[:, :3, 2] = -p[:, :, 2]
    c2w[:, :3, 3] = p[:, :, 3]
    h, w, f = p[:, 0, 4], p[:, 1, 4], p[:, 2, 4]
    K = np.zeros((n, 3, 3))
    K[:, 0, 0] = f
    K[:, 1, 1] = f
    K[:, 0, 2] = w / 2.0
    K[:, 1, 2] = h / 2.0
    K[:, 2, 2] = 1.0
    return c2w, K
