"""The port's multi-tile trainer (scanerf_tpu_torch/train/trainer.py) on
the CPU, cheapest first: the city scene writer against the JAX one, the
occlusion refresh's dilation against ``cv2.dilate``, one tiny 2-tile
ADMM run (log formats, the occlusion refresh, a prune, evals, exports,
``refined_camera.log``) whose mid-run checkpoint a second ``Trainer``
resumes, and the CLI with ``--device cpu``. No JAX ``Trainer`` runs: its
compile costs minutes (tests/test_trainer_e2e.py is the JAX package's
own, marked slow); the JAX writer is numpy."""

import glob
import os
import re
import shutil

import cv2
import numpy as np
import pytest
import torch

from scanerf_tpu.data import city as jcity
from scanerf_tpu_torch.config import default_config
from scanerf_tpu_torch.data import city as tcity
from scanerf_tpu_torch.data import io as tio
from scanerf_tpu_torch.train import checkpoint as tckpt
from scanerf_tpu_torch.train import trainer as ttrainer
from scanerf_tpu_torch.train.__main__ import main as cli_main


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CITY = dict(nx_tiles=2, nz_tiles=2, n_cameras=10, H=16, W=16)


def test_city_scene_dir_matches_jax(tmp_path):
    """``write_city_scene_dir`` (images through the port's PNG writer)
    against the JAX writer (cv2): the same summary, every text file and
    the PLY byte for byte, the mono priors equal, the images equal once
    decoded by cv2."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcity.write_city_scene_dir(a, **CITY) == tcity.write_city_scene_dir(b, **CITY)
    files = sorted(os.path.relpath(p, a) for p in glob.glob(os.path.join(a, "**", "*"),
                                                              recursive=True)
                   if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        os.path.join(b, "**", "*"), recursive=True) if os.path.isfile(p))
    assert len(files) == 6 + 3 * CITY["n_cameras"]
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(pa), cv2.imread(pb))
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f


def test_dilate_matches_cv2():
    """The mask refresh's box dilation equals ``cv2.dilate`` with a
    ones kernel (width 91 and 5) on random sparse masks, borders included."""
    rng = np.random.RandomState(0)
    for size, shape in ((91, (100, 130)), (5, (17, 9))):
        m = (rng.rand(*shape) < 0.01).astype(np.uint8)
        np.testing.assert_array_equal(cv2.dilate(m, np.ones((size, size), np.uint8)),
                                      ttrainer.dilate(m, size))


def _city(root):
    """The tiny city with its tile boxes raised 0.2, so that the drone
    path (eyes at 1.0-1.7) passes through them and the occlusion refresh
    has depths to publish, and its hash resolutions at (16, 256)."""
    tcity.write_city_scene_dir(root, **CITY)
    path = os.path.join(root, "tiles", "tile_info.txt")
    infos = list(tio.read_tile_info(path).values())
    for info in infos:
        info.corner = info.corner + np.array([0.0, 0.2, 0.0], np.float32)
        info.resolution = (16, 256)
    tio.write_tile_info(path, infos)


def _cfg(root, total=4, **kw):
    return default_config().deep_update(_overrides(root, total, **kw))


def _overrides(root, total=4, **kw):
    return {
        "DATADIR": root, "TILES": [0, 1], "RHO": 100.0, "SYN_ITERS": 2,
        "HASHGRID": {"LOG2_HASHMAP_SIZE": 10}, "EVAL_STEP": 4, "UPDATE_MASK_STEP": 4,
        "CKPT_STEP": 2,
        "TRAINING": {"TOTAL_STEP": total, "BS_LOG2DIM": 6, "NUM_SAMPLE": 8,
                     "NUM_BG_SAMPLE": 4, "NUM_MARCH": 32, "GRID_LOG2DIM": [3, 4],
                     "PRUNING_TH": [0.2], "ADJUST_STEP": 2, "CAMOPT": {"NOISE": 0.01},
                     "LOSS": {"WEIGHT_WARP_LOSS": 0.0}}, **kw}


def test_trainer_runs_admm_and_resumes(tmp_path):
    """Two tiles of the city, 2 rounds of 2 steps with ADMM (rho 100) on
    the CPU, a prune at the ladder's next rung, one more round, exports.
    Checks: each round's training.log line and each ADMM round's
    admm_error.txt line in the JAX trainer's formats, the occlusion
    refresh from shared depths, the eval and pose-error lines, the grids
    split to 16^3, four checkpoints, ``tile-*`` exports and
    ``refined_camera.log``; then a second ``Trainer`` resumed from the
    step-2 checkpoints starts at step 2 with the saved tables and ends at
    step 4."""
    root = str(tmp_path / "city")
    _city(root)
    tr = ttrainer.Trainer(_cfg(root), device="cpu")
    assert tr.cam_maps.shape == (2, max(len(v) for v in tr.view_lists))
    assert len(set(tr.view_lists[0]) & set(tr.view_lists[1])) > 0
    published = []
    refresh = tr._refresh_occlusion_masks
    tr._refresh_occlusion_masks = lambda: published.append(refresh()) or published[-1]
    tr.run()
    assert [s.step for s in tr.states] == [4, 4] and published == [3]
    tr._prune(4)
    assert all(s.field_state.occupied_grid.shape == (16, 16, 16) for s in tr.states)
    tr.train_round()
    tr._export()
    log = open(os.path.join(tr.logdir, "training.log")).read().splitlines()
    rounds = [line for line in log if re.fullmatch(r"step \d+\tloss \d+\.\d{6}\t\d+\.\ds/round",
                                                   line)]
    assert [int(r.split("\t")[0][5:]) for r in rounds] == [2, 4, 6]
    assert all(np.isfinite(float(r.split("\t")[1][5:])) for r in rounds)
    assert sum(bool(re.fullmatch(r"step 4 tile \d eval_psnr \d+\.\d{4} eval_ssim -?\d\.\d{6}",
                                 line)) for line in log) == 2
    assert sum("pose_err R" in line for line in log) == 2
    admm = open(os.path.join(tr.logdir, "admm_error.txt")).read().splitlines()
    assert len(admm) == 3 and all(re.fullmatch(
        r"primal_residual: \d+\.\d{8}\tdual_residual: \d+\.\d{8}", a) for a in admm)
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(tr.logdir, "ch*"))) \
        == [f"checkpoint-{s}-{t}.npz" for s in (2, 4, 6) for t in (0, 1)]
    for t, views in zip((0, 1), tr.view_lists):
        ex = tckpt.load_tile_export(os.path.join(tr.logdir, f"tile-{t}"))
        assert ex["hash_layout"] == "global" and list(ex["idxs"]) == views
        assert ex["occupied_grid"].shape == (16, 16, 16)
    ks, c2ws = tio.read_campara(os.path.join(tr.logdir, "refined_camera.log"))
    assert c2ws.shape == (CITY["n_cameras"], 3, 4) and np.isfinite(c2ws).all()

    ckp = str(tmp_path / "ckp")
    os.makedirs(ckp)
    for f in glob.glob(os.path.join(tr.logdir, "checkpoint-2-*.npz")):
        shutil.copy(f, ckp)
    tr2 = ttrainer.Trainer(_cfg(root, CKP=ckp, EVAL_STEP=1000, UPDATE_MASK_STEP=1000),
                           device="cpu")
    saved = np.load(os.path.join(ckp, "checkpoint-2-1.npz"))[".params/.field/.features"]
    assert [s.step for s in tr2.states] == [2, 2]
    np.testing.assert_array_equal(saved, tr2.states[1].params.field.features.numpy())
    tr2.run()
    assert [s.step for s in tr2.states] == [4, 4]
    assert os.path.exists(os.path.join(tr2.logdir, "refined_camera.log"))


def test_cli_trains_on_the_cpu_and_needs_cuda(tmp_path):
    """``python -m scanerf_tpu_torch.train cfg.yaml --device cpu`` trains
    both tiles and exports them; without ``--device`` the CLI asks for
    CUDA and raises on a machine without it."""
    import yaml

    root = str(tmp_path / "city")
    _city(root)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_overrides(root, total=2, EVAL_STEP=1000), f)
    cli_main([path, "--device", "cpu"])
    (logdir,) = glob.glob(os.path.join(root, "logs", "*"))
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(logdir, "tile-*"))) \
        == ["tile-0", "tile-1"]
    assert open(os.path.join(logdir, "training.log")).read().startswith("step 2\tloss ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli_main([path])
