"""Reading one exported tile in the reference layout (counterpart of
``scanerf_tpu/train/checkpoint.py:131-155``): ``feature.npz`` (fp16
tables, occupancy grid, doubled bbox, level resolutions, hash layout),
``decoder.npz`` (the packed 13994-float decoder) and ``cams.npz``."""

from __future__ import annotations

import os

import numpy as np


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
