"""Tiny versions of the cells, for driving whole runs on the CPU: the
same configurations and mixes with every size cut so that a run takes
seconds (tables of 2^14 entries, 4 cameras of 32x32, 64 rays a step,
8 + 8 samples, 12x20 frames), and limits of their own.

At this size a bias's gradient (sigma's, spatial1's) is a sum of about a
thousand terms that nearly cancel, so the order in which the port and the
reference add them moves its norm by up to ~1e-4 of the leaf's (seen: 8e-5
on one seed of nine on the CPU); the tiny limits sit an order above that
and still orders below every fault (half a batch reads 3e-2 and more on
the loss, an unchanged state 1 on the change, an altered pixel 2e-2)."""

import copy

from benchmark import generator, harness

_load_json = harness.load_json
_load_traffic = generator.load


def config(name: str) -> dict:
    cfg = copy.deepcopy(_load_json("configs", name))
    if cfg["driver"] == "train":
        cfg["config"]["HASHGRID"]["LOG2_HASHMAP_SIZE"] = 14
        cfg["config"]["TRAINING"].update(NUM_SAMPLE=8, NUM_BG_SAMPLE=8, NUM_MARCH=16)
        cfg["config"]["TRAINING"]["LOSS"].update(WARP_VIS_SAMPLE=4, WARP_VIS_BG_SAMPLE=4,
                                                 WARP_VIS_MARCH=16, WARP_TOP_K=2)
        cfg["scene"].update(cameras=4, height=32, width=32, grid_log2dim=4)
        cfg["reference"]["block_rays"] = 32
    else:
        cfg["log2_table"] = 14
        cfg["tiles"]["grid_log2dim"] = 4
        cfg["reference"]["pixels_per_frame"] = 100
    return cfg


def traffic(name: str) -> dict:
    mix = copy.deepcopy(_load_traffic(name))
    if mix["kind"] == "train":
        mix["batch_log2"] = 6
    else:
        mix.update(height=12, width=20, chunk=64, num_sample=8, num_bg_sample=8, num_march=16)
    return mix


LIMITS = {"loss": 1e-4, "grad": 1e-3, "change": 1e-3, "rgb": 1e-4, "depth": 1e-4}


def cell(name: str) -> dict:
    c = copy.deepcopy(_load_json("workloads", name))
    c["limits"] = {k: LIMITS[k] for k in c["limits"]}
    return c


def patch(monkeypatch):
    """Make the harness read the tiny configurations, mixes and limits."""
    def load_json(kind, name):
        return {"configs": config, "workloads": cell}[kind](name)

    monkeypatch.setattr(harness, "load_json", load_json)
    monkeypatch.setattr(generator, "load", traffic)
