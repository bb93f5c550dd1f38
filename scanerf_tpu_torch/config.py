"""Config system: YAML with one level of inheritance (the port's own copy
of ``scanerf_tpu/config.py``).

Mirrors the reference loader ``tools/utils.py:193-203`` (``parse_yaml``):
the scene yaml is loaded first, then ``config/{SCENE}.yaml`` is loaded as a
base and updated with the scene file (scene keys win). Key names are kept
identical to the reference (``config/default.yaml``) so reference configs
port unchanged.

The carrier is :class:`ConfigDict`, an attribute-access dict (the reference
uses ``easydict``), deep-merging nested dicts. PyYAML is imported by
``parse_yaml`` only: a config built in code (``default_config().deep_update``)
needs nothing beyond the standard library.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                ConfigDict(v) if isinstance(v, Mapping) else v for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def deep_update(self, other: Mapping[str, Any]) -> "ConfigDict":
        """Recursively merge ``other`` into self (``other`` wins)."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], ConfigDict)
                and isinstance(v, Mapping)
            ):
                self[k].deep_update(v)
            else:
                self[k] = v
        return self


# Defaults mirroring the reference config/default.yaml so tiny test configs
# do not need to spell everything out.
DEFAULTS: dict[str, Any] = {
    "SEED": 0,
    "SCENE": None,
    "DATADIR": "",
    "PREFIX": "",
    "DESCRIPTION": "",
    "RHO": 100.0,
    "SYN_ITERS": 100,
    "SYN_START": 0,
    "MAX_POSES": 400,
    "UPDATE_MASK_STEP": 10000,
    # resume directory (reference tile.py:37-45: glob cfg.CKP for
    # checkpoint-*-{tile}); "" = look in DATADIR
    "CKP": "",
    # mid-run checkpoint cadence in steps; 0 = final export only
    # (matches the reference, which only saves at export tile.py:568)
    "CKPT_STEP": 0,
    "INVALID_UNDERGROUND": False,
    "TILES": [0],
    "GPU": [0],
    "HASHGRID": {"LOG2_HASHMAP_SIZE": 24},
    "ALLOCATION": {
        "TILE_SIZE": [1.0, 1.0, 1.0],
        "OVERLAP_RATIO": 0.2,
        "OFFSET": [0.0, 0.0, 0.0],
        "EXPECT_NUM": 4,
        "MIN_NUM_IMAGE": 60,
        "MAX_DIM_TILE": [100000, 1, 1],
        "SCENE_TYPE": "outdoor",
    },
    "TRAINING": {
        "GRID_LOG2DIM": [4, 5, 6, 7, 8, 9],
        "PRUNING_TH": [0.1, 0.2, 0.3, 0.4],
        "ADJUST_STEP": 2000,
        "BS_LOG2DIM": 14,
        "NUM_SAMPLE": 128,
        "NUM_BG_SAMPLE": 128,
        "TOTAL_STEP": 40000,
        "BG_MODE": "IZ",
        # TPU hash backend: "windowed" (sorted-stream Pallas kernel —
        # the production path, exact gradients, PSNR-neutral vs the
        # global hash per the PERF.md quality A/B) or "xla" (global
        # prime-XOR hash via XLA gather, reference semantics oracle)
        "HASH_BACKEND": "windowed",
        # sorted-stream permutation machinery: "sort" | "gather" |
        # "gather_narrow" | "runs" — bitwise-identical outputs; see
        # PERF.md round-3d (per-fabric A/B, scripts/bench_permute_ab.py)
        "PERMUTE_MODE": "sort",
        # static run-table capacity for PERMUTE_MODE="runs" (fraction
        # of the stream length; overflow falls back to the sorted path)
        "RUN_CAP_FRAC": 0.25,
        "ETA": {"HASH_FEATURE": 1e-3, "DECODER": 1e-3, "CAM": 1e-4},
        "CAMOPT": {"ENABLE": True, "NOISE": 0.0, "START_STEPS": 0},
        "LOSS": {
            "WEIGHT_RGB_LOSS": 1.0,
            "WEIGHT_WARP_LOSS": 1.0,
            "WEIGHT_DEPTH_LOSS": 0.01,
            "WEIGHT_DEPTH_SMOOTH_LOSS": 0.001,
            "WARP_WARPING": True,
            "RGB_LOSS_START": 0,
            "WARP_LOSS_START": 0,
            "DEPTH_LOSS_START": 0,
            "DEPTH_SMOOTH_LOSS_START": 0,
            "ALPHA": 10.0,
            "GAMMA": 20.0,
        },
    },
}


def default_config() -> ConfigDict:
    return ConfigDict(copy.deepcopy(DEFAULTS))


def parse_yaml(path: str, config_dir: str | None = None) -> ConfigDict:
    """Load a scene yaml, overlaying it on its ``SCENE`` base config.

    Reference: ``tools/utils.py:193-203`` — scene file first, then
    ``config/{SCENE}.yaml`` as base, ``base.update(scene)``.
    """
    scene_cfg = _load_yaml(path)
    cfg = default_config()
    scene = scene_cfg.get("SCENE")
    if scene:
        if config_dir is None:
            config_dir = os.path.dirname(os.path.abspath(path))
        base_path = os.path.join(config_dir, f"{scene}.yaml")
        if os.path.exists(base_path):
            cfg.deep_update(_load_yaml(base_path))
    cfg.deep_update(scene_cfg)
    return cfg


def _load_yaml(path: str) -> dict:
    """A yaml file's mapping, through PyYAML. Where PyYAML is not
    installed, a file in JSON syntax (a subset of YAML) is read with the
    json module; any other file raises, naming PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text) or {}
        except json.JSONDecodeError as e:
            raise RuntimeError(f"reading {path} needs PyYAML; without it only YAML "
                               "files in JSON syntax are read") from e
    return yaml.safe_load(text) or {}
