"""Offline PSNR / SSIM / LPIPS of a directory of renders against the
ground truth (counterpart of ``scanerf_tpu/eval/evaluation.py``):

    python -m scanerf_tpu_torch.eval.evaluation PRED_DIR GT_DIR [--device cpu]

Images pair by file name. PSNR and SSIM are taken on the images as read
(BGR, ``data/png.py``), LPIPS on RGB when its weights are available
(``eval/lpips.py``). Prints one line an image and a mean line, in the
render CLI's ``metric.txt`` format. Runs on the GPU unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from scanerf_tpu_torch import _device


def evaluate_dirs(pred_dir: str, gt_dir: str, device="cuda") -> dict:
    """Mean PSNR, SSIM and LPIPS (NaN without weights) of the images of
    ``pred_dir`` that have a namesake in ``gt_dir``, and their count."""
    from scanerf_tpu_torch.data import png
    from scanerf_tpu_torch.eval.lpips import LPIPSMetric
    from scanerf_tpu_torch.utils import metrics

    dev = _device.resolve(device)
    lp = LPIPSMetric(device=dev)
    names = sorted(f for f in os.listdir(pred_dir) if f.lower().endswith(".png"))
    psnrs, ssims, lpipss = [], [], []
    for name in names:
        gt_path = os.path.join(gt_dir, name)
        if not os.path.exists(gt_path):
            continue
        pred = png.read_png(os.path.join(pred_dir, name)).astype(np.float32) / 255.0
        gt = png.read_png(gt_path).astype(np.float32) / 255.0
        pt, gtt = (torch.from_numpy(a).to(dev) for a in (pred, gt))
        p = float(metrics.psnr(pt, gtt))
        s = float(metrics.ssim(pt, gtt))
        psnrs.append(p)
        ssims.append(s)
        line = f"{name}\tPSNR {p:.4f}\tSSIM {s:.4f}"
        if lp.available:
            v = lp(pred[..., ::-1], gt[..., ::-1])  # BGR -> RGB
            lpipss.append(v)
            line += f"\tLPIPS {v:.4f}"
        print(line)
    result = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "lpips": float(np.mean(lpipss)) if lpipss else float("nan"),
        "count": len(psnrs),
    }
    line = f"mean\tPSNR {result['psnr']:.4f}\tSSIM {result['ssim']:.4f}"
    if lpipss:
        line += f"\tLPIPS {result['lpips']:.4f}"
    print(line)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m scanerf_tpu_torch.eval.evaluation",
        description="PSNR / SSIM / LPIPS of rendered PNGs against the ground truth.")
    parser.add_argument("pred_dir")
    parser.add_argument("gt_dir")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    return evaluate_dirs(args.pred_dir, args.gt_dir, device=args.device)


if __name__ == "__main__":
    main()
