"""RealityCapture Bundler export -> ``coarse_camera.log`` (counterpart of
``scanerf_tpu/preprocess/reality_capture.py``): parses a Bundler ``.out``
file (focal, 3x3 rotation and translation a camera, y / z flipped
against the pipeline's convention), applies the two global axis
transforms, crops RealityCapture's frame borders off the PNG images
(through ``data/png.py``) and writes ``coarse_camera.log``.

    python -m scanerf_tpu_torch.preprocess.reality_capture DATA_DIR OUTPUT_DIR
"""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import png


def read_bundler(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (focals [N], c2ws [N, 3, 4]) in the pipeline's convention."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    while lines and lines[0].startswith("#"):
        lines = lines[1:]
    n_cam = int(lines[0].split(" ")[0])
    lines = lines[1:]

    g1 = np.eye(4)
    g1[1, 1] = -1
    g2 = np.eye(4)
    g2[1, 1] = 0
    g2[1, 2] = 1
    g2[2, 1] = 1
    g2[2, 2] = 0
    pre = np.linalg.inv(g2) @ np.linalg.inv(g1)

    focals, c2ws = [], []
    for i in range(n_cam):
        item = lines[i * 5: (i + 1) * 5]
        focal = float(item[0].split(" ")[0])
        R = np.array([[float(x) for x in item[1 + r].split(" ")] for r in range(3)])
        t = np.array([float(x) for x in item[4].split(" ")])
        R = R.T  # w2c -> c2w rotation
        c = -R @ t[:, None]
        R[:, 1] *= -1  # Bundler looks down -z with +y up
        R[:, 2] *= -1
        c2w = np.concatenate([R, c], -1)
        c2w = (pre @ np.concatenate([c2w, [[0, 0, 0, 1]]], 0))[:3]
        focals.append(focal)
        c2ws.append(c2w)
    return np.array(focals), np.stack(c2ws)


def extract_reality_capture(data_dir: str, output_dir: str, width: int = 1000,
                            height: int = 680, crop_left: int = 40, crop_top: int = 30) -> int:
    """bundler/bundler.out and bundler/%05d.png -> ``coarse_camera.log`` and
    the cropped ``images/{i}.png`` in ``output_dir``. Returns the number of
    cameras."""
    focals, c2ws = read_bundler(os.path.join(data_dir, "bundler", "bundler.out"))
    img_dir = os.path.join(data_dir, "bundler")
    out_img = os.path.join(output_dir, "images")
    os.makedirs(out_img, exist_ok=True)
    with open(os.path.join(output_dir, "coarse_camera.log"), "w") as f:
        for i, (focal, c2w) in enumerate(zip(focals, c2ws)):
            src = os.path.join(img_dir, "%05d.png" % i)
            cx, cy = width / 2.0, height / 2.0
            if os.path.exists(src):
                img = png.read_png(src)
                png.write_png(os.path.join(out_img, f"{i}.png"),
                              img[crop_top: crop_top + height, crop_left: crop_left + width])
            f.write(f"{i}\n")
            f.write(f"{focal:.2f} {focal:.2f} {cx} {cy}\n")
            f.write(f"{width} {height} 0 1000\n")
            for r in range(3):
                f.write(f"{c2w[r,0]:.8f} {c2w[r,1]:.8f} {c2w[r,2]:.8f} {c2w[r,3]:.8f}\n")
            f.write("0 0 0 1\n")
    return len(focals)


def main():
    import sys

    extract_reality_capture(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
