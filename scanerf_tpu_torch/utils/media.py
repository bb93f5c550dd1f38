"""Demo media from rendered frames (counterpart of
``scanerf_tpu/utils/media.py``): an mp4 through OpenCV's video writer, a
gif through imageio, and frame directories of ``{idx}.png`` through the
port's own PNG codec (``data/png.py``), so that writing and reading
frames needs neither package. Frames are RGB, uint8 or float in [0, 1].
"""

from __future__ import annotations

import os

import numpy as np

from scanerf_tpu_torch.data import png


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def generate_video(save_path: str, frames, fps: int = 20) -> None:
    """Write an mp4 (mp4v) from RGB frames. Needs OpenCV (``cv2``)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("generate_video needs the 'opencv-python' package (cv2) for its "
                           "mp4 encoder; the frames stay in their PNG files") from e
    frames = [_to_u8(f) for f in frames]
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    finally:
        out.release()


def generate_gif(save_path: str, frames, fps: int = 20) -> None:
    """Write a gif from RGB frames. Needs the ``imageio`` package."""
    try:
        import imageio
    except ImportError as e:
        raise RuntimeError("generate_gif needs the 'imageio' package; generate_video "
                           "writes an mp4 instead") from e
    imageio.mimsave(save_path, [_to_u8(f) for f in frames], fps=fps)


def save_img_list(save_dir: str, frames) -> None:
    """Write RGB frames as ``{idx}.png``, the bytes ``cv2.imwrite`` writes."""
    os.makedirs(save_dir, exist_ok=True)
    for i, f in enumerate(frames):
        png.write_png(os.path.join(save_dir, f"{i}.png"), _to_u8(f)[..., ::-1])


def frames_from_dir(frame_dir: str) -> list[np.ndarray]:
    """The ``{idx}.png`` frames of a directory in index order, RGB uint8."""
    names = sorted((f for f in os.listdir(frame_dir) if f.endswith(".png")),
                   key=lambda n: int(os.path.splitext(n)[0]))
    return [png.read_png(os.path.join(frame_dir, n))[..., ::-1] for n in names]
