"""On the card: the lower-precision control (the reference with TF32
products in the program's place) comes out not correct against each
cell's limits, at a size a test run holds. ``benchmark/control.py`` reads
the same at the cells' own sizes."""

import copy

import pytest
import torch

from benchmark import control, generator, harness
from benchmark.tests import tiny


def small(name: str) -> dict:
    cfg = tiny.config(name)
    if cfg["driver"] == "train":
        cfg["config"]["HASHGRID"]["LOG2_HASHMAP_SIZE"] = 18
        cfg["config"]["TRAINING"].update(NUM_SAMPLE=32, NUM_BG_SAMPLE=32, NUM_MARCH=128)
        cfg["scene"].update(cameras=8, height=64, width=64, grid_log2dim=5)
        cfg["reference"]["block_rays"] = 1024
    else:
        cfg["log2_table"] = 18
        cfg["reference"]["pixels_per_frame"] = 2048
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(w["name"] for w in harness.manifest()["workloads"]))
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on the card")
    entry = {w["name"]: w for w in harness.manifest()["workloads"]}[cell]
    cfg = small(entry["config"])
    mix = copy.deepcopy(generator.load(entry["traffic"]))
    if mix["kind"] == "train":
        mix["batch_log2"] = 12
    else:
        mix.update(height=72, width=128, num_sample=32, num_bg_sample=32, num_march=128)
    limits = harness.load_json("workloads", cell)["limits"]
    for seed in (1, 2, 3):
        job = harness.Job(cell={}, config=cfg, traffic=mix, seed=seed, seconds=0.0,
                          trace=False, device="cuda", t_start=0.0)
        got = control.readings(job, frames=2)["tf32"]
        assert any(got[k] > limits[k] for k in limits), (seed, got, limits)
