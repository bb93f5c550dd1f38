"""Parity of the port's serving tools (scanerf_tpu_torch, slice 9) with the
JAX package on the CPU: camera paths (``utils/pose_paths.py``, bit for
bit), demo media (``utils/media.py``: frames through the port's PNG codec,
the mp4 and gif writers), LPIPS (``eval/lpips.py``) with random weights,
and ``eval/evaluation.py::evaluate_dirs`` on a directory of PNG pairs.
Cheapest first. The official LPIPS weights are not in the repository;
random ones test the metric's arithmetic.
"""

import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from scanerf_tpu.eval import evaluation as jeval
from scanerf_tpu.eval import lpips as jlpips
from scanerf_tpu.utils import media as jmedia
from scanerf_tpu.utils import pose_paths as jpaths
from scanerf_tpu_torch.data import png
from scanerf_tpu_torch.eval import evaluation as teval
from scanerf_tpu_torch.eval import lpips as tlpips
from scanerf_tpu_torch.utils import media as tmedia
from scanerf_tpu_torch.utils import pose_paths as tpaths


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parse_yaml_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML is missing (the GPU machine), ``parse_yaml`` reads a
    config in JSON syntax as PyYAML reads it, and raises naming PyYAML on
    any other YAML."""
    import json

    from scanerf_tpu_torch.config import parse_yaml

    cfg = {"DATADIR": "/data/scene", "INVALID_UNDERGROUND": True,
           "TRAINING": {"NUM_SAMPLE": 64, "GRID_LOG2DIM": [6, 7]}}
    (tmp_path / "a.yaml").write_text(json.dumps(cfg))
    (tmp_path / "b.yaml").write_text("DATADIR: /data/scene\n")
    want = parse_yaml(str(tmp_path / "a.yaml"))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert parse_yaml(str(tmp_path / "a.yaml")) == want
    assert want.TRAINING.NUM_SAMPLE == 64 and want.TRAINING.NUM_BG_SAMPLE == 128
    with pytest.raises(RuntimeError, match="PyYAML"):
        parse_yaml(str(tmp_path / "b.yaml"))


def _poses(seed, n):
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        out[i, :, :3] = q
        out[i, :, 3] = rng.randn(3)
    return out


def test_pose_paths_bit_for_bit(tmp_path):
    """Every path helper equals the JAX module's bit for bit, and
    ``write_render_path`` writes the same file (shared and per-pose
    intrinsics), which the port's camera.log reader reads back."""
    from scanerf_tpu_torch.data import io as tio

    keys = _poses(0, 3)
    for got, want in (
            (tpaths.interpolate_poses(keys[0], keys[1], 5),
             jpaths.interpolate_poses(keys[0], keys[1], 5)),
            (tpaths.interpolate_path(keys, 4), jpaths.interpolate_path(keys, 4)),
            (tpaths.pose_spherical(30.0, -45.0, 4.0), jpaths.pose_spherical(30.0, -45.0, 4.0)),
            (tpaths.circular_path(keys[2], num=8, scale=2.0),
             jpaths.circular_path(keys[2], num=8, scale=2.0))):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    path = tpaths.interpolate_path(keys, 4)
    k = np.array([[100.0, 0, 32], [0, 100, 24], [0, 0, 1]], np.float32)
    for i, ks in enumerate((k, np.tile(k[None], (len(path), 1, 1)) * 1.5)):
        a, b = str(tmp_path / f"t{i}.log"), str(tmp_path / f"j{i}.log")
        tpaths.write_render_path(a, ks, path, 48, 64)
        jpaths.write_render_path(b, ks, path, 48, 64)
        assert open(a).read() == open(b).read()
        ks2, c2ws2, H, W = tio.read_campara(a, return_shape=True)
        assert (H, W) == (48, 64) and len(ks2) == len(path)
        np.testing.assert_allclose(c2ws2, path, atol=1e-6)


def _frames(seed, n=3, h=10, w=14):
    rng = np.random.RandomState(seed)
    u8 = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n - 1)]
    return u8 + [rng.rand(h, w, 3).astype(np.float32) * 1.2 - 0.1]  # a float frame, clipped


def test_media_frames_round_trip(tmp_path):
    """``save_img_list`` writes {i}.png that decode as cv2 reads the JAX
    module's (cv2.imwrite) files; ``frames_from_dir`` reads them back in
    index order as RGB, equal to the JAX reader's."""
    frames = _frames(1, n=11)  # 11 frames: "10.png" sorts after "9.png"
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    tmedia.save_img_list(ours, frames)
    jmedia.save_img_list(theirs, frames)
    for i in range(len(frames)):
        np.testing.assert_array_equal(cv2.imread(os.path.join(ours, f"{i}.png")),
                                      cv2.imread(os.path.join(theirs, f"{i}.png")))
    got, want = tmedia.frames_from_dir(ours), jmedia.frames_from_dir(theirs)
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tmedia._to_u8(f))


def test_media_video_and_gif(tmp_path, monkeypatch):
    """``generate_video`` writes an mp4 that OpenCV reads back frame for
    frame as the JAX module's writes; ``generate_gif`` writes the JAX
    module's gif byte for byte; without cv2 / imageio each raises an
    error naming the package."""
    frames = _frames(2, h=16, w=16)
    paths = {}
    for name, mod in (("ours", tmedia), ("theirs", jmedia)):
        paths[name] = str(tmp_path / f"{name}.mp4")
        mod.generate_video(paths[name], frames, fps=5)
        mod.generate_gif(str(tmp_path / f"{name}.gif"), frames, fps=5)
    decoded = {}
    for name, p in paths.items():
        cap = cv2.VideoCapture(p)
        out = []
        ok, f = cap.read()
        while ok:
            out.append(f)
            ok, f = cap.read()
        cap.release()
        decoded[name] = out
    assert len(decoded["ours"]) == len(frames)
    for a, b in zip(decoded["ours"], decoded["theirs"]):
        np.testing.assert_array_equal(a, b)
    assert open(tmp_path / "ours.gif", "rb").read() == open(tmp_path / "theirs.gif", "rb").read()
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(RuntimeError, match="opencv"):
        tmedia.generate_video(str(tmp_path / "x.mp4"), frames)
    with pytest.raises(RuntimeError, match="imageio"):
        tmedia.generate_gif(str(tmp_path / "x.gif"), frames)


def _lpips_params(seed):
    """Random LPIPS weights at the AlexNet variant's shapes, the JAX
    package's test scales."""
    rng = np.random.RandomState(seed)
    params, c_in = {}, 3
    for i, (c_out, k, _, _, _) in enumerate(jlpips._ALEX):
        params[f"conv{i}_w"] = rng.randn(c_out, c_in, k, k).astype(np.float32) * 0.05
        params[f"conv{i}_b"] = rng.randn(c_out).astype(np.float32) * 0.01
        params[f"lin{i}_w"] = np.abs(rng.randn(c_out)).astype(np.float32)
        c_in = c_out
    return params


def test_lpips_matches_jax(tmp_path, monkeypatch):
    """LPIPS with random weights against JAX ``lpips`` within 1e-5
    relative, single images and a batch; zero on an image against itself;
    ``available`` false (and NaN) without a weights file, true with one
    named by SCANERF_LPIPS_WEIGHTS, whose distance equals the dict's."""
    params = _lpips_params(3)
    rng = np.random.RandomState(4)
    a = rng.rand(2, 48, 48, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    m = tlpips.LPIPSMetric(params=params, device="cpu")
    assert m.available
    want = np.asarray(jax.jit(jlpips.lpips)(params, a, b))  # one compile: the batch
    for i in range(2):
        assert m(a[i], b[i]) == pytest.approx(float(want[i]), rel=1e-5)
    np.testing.assert_allclose(tlpips.lpips(m.params, a, b).numpy(), want, rtol=1e-5)
    assert abs(m(a[0], a[0])) < 1e-7
    monkeypatch.setenv(tlpips.ENV_VAR, str(tmp_path / "missing.npz"))
    off = tlpips.LPIPSMetric(device="cpu")
    assert not off.available and np.isnan(off(a[0], b[0]))
    np.savez(tmp_path / "w.npz", **params)
    monkeypatch.setenv(tlpips.ENV_VAR, str(tmp_path / "w.npz"))
    on = tlpips.LPIPSMetric(device="cpu")
    assert on.available and on(a[1], b[1]) == m(a[1], b[1])


def test_evaluate_dirs_matches_jax(tmp_path, monkeypatch, capsys):
    """``evaluate_dirs`` (and the module's ``main`` with ``--device cpu``)
    on a directory of PNG pairs, one prediction without a ground truth,
    against the JAX function, with LPIPS weights named by
    SCANERF_LPIPS_WEIGHTS: the count equal, PSNR within 1e-4 dB, SSIM and
    LPIPS within 1e-5 relative; a line an image and the mean line."""
    np.savez(tmp_path / "w.npz", **_lpips_params(5))
    monkeypatch.setenv(tlpips.ENV_VAR, str(tmp_path / "w.npz"))
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    rng = np.random.RandomState(6)
    for i in range(4):
        g = rng.randint(0, 256, (48, 40, 3)).astype(np.uint8)
        p = np.clip(g.astype(int) + rng.randint(-40, 41, g.shape), 0, 255).astype(np.uint8)
        png.write_png(str(pred / f"{i}.png"), p)
        if i < 3:
            png.write_png(str(gt / f"{i}.png"), g)
    got = teval.main([str(pred), str(gt), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[0].startswith("0.png\tPSNR ") and "LPIPS" in lines[3]
    want = jeval.evaluate_dirs(str(pred), str(gt))
    assert got["count"] == want["count"] == 3
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-4)
    for k in ("ssim", "lpips"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
