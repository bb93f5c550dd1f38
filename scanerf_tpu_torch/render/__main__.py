"""Render CLI of the port (counterpart of ``rendering.py``):

    python -m scanerf_tpu_torch.render config.yaml LOGDIR MODE [start end] [--device cpu]

LOGDIR is a training log directory holding the ``tile-*`` exports.
MODE ``VAL`` renders the cameras of LOGDIR/refined_camera.log (else
DATADIR/camera.log) at their own size and, where DATADIR/images holds
the view's ground truth, appends its PSNR, SSIM and (with LPIPS weights,
``eval/lpips.py``) LPIPS to LOGDIR/val/metric.txt, then their means.
MODE ``DEMO`` renders the path of DATADIR/renderPath.log at 720x1280
with the principal point at the centre into LOGDIR/demo, and assembles
``demo.mp4`` (OpenCV) when it renders more than one frame. Frames
``{i}.png`` hold the render in the BGR order the model trains in.
``SCANERF_EARLY_TERM=1`` renders windowed scenes with early ray
termination. Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

DEMO_H, DEMO_W = 720, 1280  # the DEMO frame size
CHUNK = 2**13  # rays a render_rays call


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m scanerf_tpu_torch.render",
        description="Render validation views or a demo path from a run's tile exports.")
    parser.add_argument("config", help="scene yaml (overlaid on its SCENE base config)")
    parser.add_argument("logdir", help="training log directory with the tile-* exports")
    parser.add_argument("mode", type=str.upper, choices=("VAL", "DEMO"))
    parser.add_argument("start", nargs="?", type=int, default=0)
    parser.add_argument("end", nargs="?", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' for the plain path")
    args = parser.parse_args(argv)

    from scanerf_tpu_torch import _device
    from scanerf_tpu_torch.config import parse_yaml
    from scanerf_tpu_torch.data import io as data_io
    from scanerf_tpu_torch.data import png
    from scanerf_tpu_torch.eval.lpips import LPIPSMetric
    from scanerf_tpu_torch.render import renderer
    from scanerf_tpu_torch.utils import media, metrics

    dev = _device.resolve(args.device)
    cfg = parse_yaml(args.config)
    tile_dirs = renderer.list_tile_dirs(args.logdir)
    if not tile_dirs:
        sys.exit(f"no exported tiles under {args.logdir}")
    scene = renderer.load_scene(tile_dirs, device=dev)
    demo = args.mode == "DEMO"
    out_dir = os.path.join(args.logdir, "demo" if demo else "val")
    os.makedirs(out_dir, exist_ok=True)
    if demo:
        ks, c2ws = data_io.read_campara(os.path.join(cfg.DATADIR, "renderPath.log"))
        H, W = DEMO_H, DEMO_W
        ks[:, 0, 2] = W / 2.0
        ks[:, 1, 2] = H / 2.0
        gt_dir = None
    else:
        cam_log = os.path.join(args.logdir, "refined_camera.log")
        if not os.path.exists(cam_log):
            cam_log = os.path.join(cfg.DATADIR, "camera.log")
        ks, c2ws, H, W = data_io.read_campara(cam_log, return_shape=True)
        gt_dir = os.path.join(cfg.DATADIR, "images")

    lp = LPIPSMetric(device=dev)
    end = args.end if args.end is not None else len(ks)
    early = (os.environ.get("SCANERF_EARLY_TERM", "") == "1"
             and renderer._resolve_backend(scene, "auto") == "windowed")
    early_stats: dict = {}
    times, psnrs, ssims, lpipss = [], [], [], []
    metric_path = os.path.join(out_dir, "metric.txt")
    for i in range(args.start, end):
        t0 = time.time()
        out = renderer.render_image(
            scene, ks[i], c2ws[i], H, W, chunk=CHUNK, num_sample=cfg.TRAINING.NUM_SAMPLE,
            num_bg_sample=cfg.TRAINING.NUM_BG_SAMPLE,
            invalid_underground=bool(cfg.INVALID_UNDERGROUND), early_term=early,
            early_kwargs={"stats": early_stats} if early else None, device=dev)
        times.append(time.time() - t0)
        img = (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8)
        png.write_png(os.path.join(out_dir, f"{i}.png"), img)
        gt_path = os.path.join(gt_dir, f"{i}.png") if gt_dir is not None else None
        if gt_path is not None and os.path.exists(gt_path):
            gt = png.read_png(gt_path).astype(np.float32) / 255.0
            rgb_t, gt_t = torch.from_numpy(out["rgb"]).to(dev), torch.from_numpy(gt).to(dev)
            p = float(metrics.psnr(rgb_t, gt_t))
            s = float(metrics.ssim(rgb_t, gt_t))
            psnrs.append(p)
            ssims.append(s)
            line = f"{i}\tPSNR {p:.4f}\tSSIM {s:.4f}"
            if lp.available:  # the model's BGR and the BGR ground truth, both to RGB
                v = lp(out["rgb"][..., ::-1], gt[..., ::-1])
                lpipss.append(v)
                line += f"\tLPIPS {v:.4f}"
            with open(metric_path, "a") as f:
                f.write(line + "\n")
        print(f"frame {i}: {times[-1] * 1000:.1f} ms")
    if psnrs:
        line = f"mean\tPSNR {np.mean(psnrs):.4f}\tSSIM {np.mean(ssims):.4f}"
        if lpipss:
            line += f"\tLPIPS {np.mean(lpipss):.4f}"
        with open(metric_path, "a") as f:
            f.write(line + "\n")
    if demo and end - args.start > 1:
        video = os.path.join(out_dir, "demo.mp4")
        media.generate_video(video, media.frames_from_dir(out_dir))
        print(f"wrote {video}")
    print(f"mean render time: {np.mean(times) * 1000:.1f} ms")
    return {"out_dir": out_dir, "times": times, "psnr": psnrs, "ssim": ssims, "lpips": lpipss,
            "early_term": early, "early_stats": early_stats}


if __name__ == "__main__":
    main()
