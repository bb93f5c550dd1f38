"""Checkpoint / resume and the inference export of one tile (counterpart
of ``scanerf_tpu/train/checkpoint.py``).

- **Checkpoint**: every array of a tile's ``TrainState`` in a flat
  ``.npz`` under the JAX package's keys (the pytree paths of its
  ``save_checkpoint``; the mapping is ``convert.py``'s): the tables, the
  decoder, ``se3_refine``, each optimizer group's Adam moments and
  counts (per element under sparse Adam) and its schedule's count, the
  field state, the ADMM state and the step. A checkpoint written by either package resumes in the other.
- **Export**, the reference layout: ``feature.npz`` (fp16 tables,
  occupancy grid, doubled bbox, level resolutions, hash layout),
  ``decoder.npz`` (the packed 13994-float decoder) and ``cams.npz``
  (refined camera-to-world poses, intrinsics, view ids).
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from scanerf_tpu_torch import convert
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.train import cameras as cam_lib
from scanerf_tpu_torch.train import tile as tile_lib
from scanerf_tpu_torch.utils import lie


def save_checkpoint(path: str, state: tile_lib.TrainState) -> None:
    """Write ``state`` to ``path`` (``np.savez``: ".npz" is appended if
    missing)."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in convert.state_tensors(state).items()})


def load_checkpoint(path: str, template: tile_lib.TrainState,
                    device="cuda") -> tile_lib.TrainState:
    """A new state on ``device`` (the template's) from the checkpoint at
    ``path``, with the template's structure (whether the cameras are
    optimized) and dtypes. A table stored as [L, H, F], as before the flat
    [L, H*F] form, is reshaped to the template's; where sizes truly
    differ the stored shape wins (an occupancy grid re-split by pruning)."""
    tile_lib._check_device(template.params.field.features, device)
    cam_enable = any(g["name"] == "cam" for g in template.optimizer.param_groups)
    with np.load(path, allow_pickle=False) as data:
        return convert.state_from_arrays(data.__getitem__, cam_enable, device,
                                         like=convert.state_like(template),
                                         sparse_adam=template.hash_optimizer is not None)


def latest_checkpoint(ckp_dir: str, tile_idx: int) -> str | None:
    """The newest ``checkpoint-{step}-{tile}.npz`` in ``ckp_dir``, by step."""
    files = glob.glob(os.path.join(ckp_dir, f"checkpoint-*-{tile_idx}.npz"))
    if not files:
        return None

    def step_of(f):
        m = re.search(r"checkpoint-(\d+)-", os.path.basename(f))
        return int(m.group(1)) if m else -1

    return max(files, key=step_of)


def checkpoint_path(out_dir: str, step: int, tile_idx: int) -> str:
    return os.path.join(out_dir, f"checkpoint-{step}-{tile_idx}.npz")


@torch.no_grad()
def export_tile(out_dir: str, state: tile_lib.TrainState, cams: cam_lib.Cameras,
                visible_poses: list[int], *, hash_layout: str) -> None:
    """Write a tile's inference export to ``out_dir``. ``hash_layout`` is
    the table layout the tile was trained with, ``tc.hash_backend``:
    "windowed" (the port's) or "global" (the JAX package's xla backend);
    the renderer looks features up with that hash. It has no default: an
    export in the wrong layout renders garbage."""
    if hash_layout not in ("global", "windowed"):
        raise ValueError(f"unknown hash layout {hash_layout!r}")
    os.makedirs(out_dir, exist_ok=True)
    fs = state.field_state

    def np_(t):
        return t.detach().cpu().numpy()

    np.savez(os.path.join(out_dir, "feature.npz"),
             features=np_(state.params.field.features).astype(np.float16),
             occupied_grid=np_(fs.occupied_grid), block_corner=np_(fs.min_bbox),
             block_size=np_(fs.bbox_size),
             grid_log2dim=np.log2(np.array(fs.occupied_grid.shape)).astype(np.int32),
             resolution=np_(fs.resolutions), hash_layout=np.array(hash_layout))
    np.savez(os.path.join(out_dir, "decoder.npz"),
             params=np_(decoder_lib.pack_params(state.params.field.decoder)))
    c2ws = lie.invert(cam_lib.get_rts(cams, state.params.se3_refine))
    np.savez(os.path.join(out_dir, "cams.npz"), c2ws=np_(c2ws), ks=np_(cams.ks),
             idxs=np.array(visible_poses))


def load_tile_export(tile_dir: str) -> dict:
    """numpy arrays of one tile export; features as [L, H, F]."""
    with np.load(os.path.join(tile_dir, "feature.npz")) as feat, \
            np.load(os.path.join(tile_dir, "decoder.npz")) as dec, \
            np.load(os.path.join(tile_dir, "cams.npz")) as cams:
        f = feat["features"]
        return {
            "hash_layout": str(feat["hash_layout"]) if "hash_layout" in feat
            else "global",
            "features": f.reshape(f.shape[0], -1, 2) if f.ndim == 2 else f,
            "occupied_grid": feat["occupied_grid"],
            "block_corner": feat["block_corner"],
            "block_size": feat["block_size"],
            "grid_log2dim": feat["grid_log2dim"],
            "resolution": feat["resolution"],
            "decoder_params": dec["params"],
            "c2ws": cams["c2ws"],
            "ks": cams["ks"],
            "idxs": cams["idxs"],
        }
