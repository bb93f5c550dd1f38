"""Parity of the port's host-side leaves (scanerf_tpu_torch, slice 7) with
the JAX package on the CPU: the config system, ``TrainConfig.from_cfg``,
scene IO (camera.log, tile metadata, ignore.log, Tanks & Temples
cameras, ``load_scene``), the port's PNG codec against OpenCV, the PLY
reader / writer and ``write_scene_dir``. Files written by either package
are read by both; everything is exact. No JAX function is compiled.
"""

import dataclasses
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from scanerf_tpu import config as jconfig
from scanerf_tpu.data import io as jio
from scanerf_tpu.data import synthetic as jsyn
from scanerf_tpu.geometry import ply as jply
from scanerf_tpu.train import tile as jtile
from scanerf_tpu_torch import config as tconfig
from scanerf_tpu_torch.data import io as tio
from scanerf_tpu_torch.data import png
from scanerf_tpu_torch.data import synthetic as tsyn
from scanerf_tpu_torch.geometry import ply as tply
from scanerf_tpu_torch.train import tile as ttile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAYS = {"jax_writes": (jio, tio), "port_writes": (tio, jio)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_default_config_matches_jax():
    cfg = tconfig.default_config()
    assert cfg == jconfig.default_config()
    assert isinstance(cfg.TRAINING.LOSS, tconfig.ConfigDict)
    assert cfg.TRAINING.LOSS.ALPHA == 10.0


def _scene_yaml(tmp_path):
    """A base config and a scene yaml overlaid on it through ``SCENE``."""
    (tmp_path / "mybase.yaml").write_text(
        "RHO: 5.0\nHASHGRID:\n  LOG2_HASHMAP_SIZE: 19\nTRAINING:\n  NUM_SAMPLE: 64\n"
        "  LOSS:\n    WEIGHT_WARP_LOSS: 0.5\n    ALPHA: 3.0\n")
    scene = tmp_path / "scene.yaml"
    scene.write_text("SCENE: mybase\nDATADIR: /data/x\nTRAINING:\n  NUM_SAMPLE: 96\n"
                     "  FUSED_DECODER: false\n  LOSS:\n    ALPHA: 4.0\n    WARP_TOP_K: 10\n")
    return str(scene)


@pytest.mark.parametrize("which", ["paper_2p24_2chip", "scene_with_base"])
def test_parse_yaml_matches_jax(tmp_path, which):
    path = (os.path.join(REPO, "config", "paper_2p24_2chip.yaml") if which == "paper_2p24_2chip"
            else _scene_yaml(tmp_path))
    cfg = tconfig.parse_yaml(path)
    assert cfg == jconfig.parse_yaml(path)
    if which == "scene_with_base":  # the scene wins over its base, the base over DEFAULTS
        assert (cfg.RHO, cfg.TRAINING.NUM_SAMPLE, cfg.TRAINING.LOSS.ALPHA,
                cfg.TRAINING.LOSS.WEIGHT_WARP_LOSS) == (5.0, 96, 4.0, 0.5)


@pytest.mark.parametrize("which", ["default", "paper_2p24_2chip", "scene_with_base"])
def test_train_config_from_cfg_matches_jax(tmp_path, which):
    """Every field the port's TrainConfig has equals the JAX one's; the
    port lacks exactly the TPU-only permutation knobs."""
    if which == "default":
        tcfg, jcfg = tconfig.default_config(), jconfig.default_config()
    else:
        path = (os.path.join(REPO, "config", "paper_2p24_2chip.yaml")
                if which == "paper_2p24_2chip" else _scene_yaml(tmp_path))
        tcfg, jcfg = tconfig.parse_yaml(path), jconfig.parse_yaml(path)
    t, j = ttile.TrainConfig.from_cfg(tcfg), jtile.TrainConfig.from_cfg(jcfg)
    t_fields = {f.name for f in dataclasses.fields(t)}
    j_fields = {f.name for f in dataclasses.fields(j)}
    assert j_fields - t_fields == {"permute_mode", "run_cap_frac"}
    assert t_fields <= j_fields
    for name in sorted(t_fields):
        assert getattr(t, name) == getattr(j, name), name


# ---------------------------------------------------------------------------
# scene metadata, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("way", list(WAYS))
def test_camera_log_and_tile_files_roundtrip(tmp_path, way):
    """camera.log, tiles/training_views.txt, tiles/tile_info.txt and
    ignore.log written by one package read the same in both."""
    writer, reader = WAYS[way]
    rng = np.random.RandomState(3)
    ks = np.tile(np.array([[100.5, 0, 32.25], [0, 99.0, 24.0], [0, 0, 1]], np.float32),
                 (4, 1, 1))
    c2ws = rng.randn(4, 3, 4).astype(np.float32)
    p = str(tmp_path / "camera.log")
    writer.write_campara(p, ks, c2ws, 48, 64, near=0.25, far=50.0)
    for a, b in zip(writer.read_campara(p, return_shape=True),
                    reader.read_campara(p, return_shape=True)):
        np.testing.assert_array_equal(a, b)
    k2, c2, H, W = reader.read_campara(p, return_shape=True)
    np.testing.assert_allclose(c2, c2ws, rtol=1e-6)
    assert (H, W) == (48, 64)

    views = {0: [1, 2, 3], 1: [2, 4], 3: [0]}
    writer.write_training_views(str(tmp_path / "tv.txt"), views)
    assert reader.read_training_views(str(tmp_path / "tv.txt")) == views

    infos = [writer.TileInfo(0, np.array([0.0, 1, 2], np.float32),
                             np.array([3.0, 4, 5.5], np.float32), (32, 4096), True),
             writer.TileInfo(2, np.array([-1.5, 0, 2], np.float32),
                             np.array([1.0, 2, 3], np.float32), (16, 256), False)]
    writer.write_tile_info(str(tmp_path / "ti.txt"), infos)
    got = reader.read_tile_info(str(tmp_path / "ti.txt"))
    assert sorted(got) == [0, 2]
    for info in infos:
        g = got[info.index]
        assert (g.resolution, g.init_outside) == (info.resolution, info.init_outside)
        np.testing.assert_array_equal(g.corner, info.corner)
        np.testing.assert_array_equal(g.size, info.size)

    (tmp_path / "ignore.log").write_text("3\n5 8\n\n11\n")
    assert reader.read_ignore(str(tmp_path)) == writer.read_ignore(str(tmp_path)) \
        == [3, 5, 6, 7, 11]
    assert tio.read_ignore(str(tmp_path / "nowhere")) == []


def test_load_cameras_tat_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    os.makedirs(tmp_path / "pose")
    os.makedirs(tmp_path / "intrinsics")
    for i in (0, 1, 2, 10):  # numeric order: 10 comes last
        c2w = np.eye(4)
        c2w[:3] = rng.randn(3, 4)
        K = np.diag([100.0 + i, 90.0, 1.0, 1.0])
        (tmp_path / "pose" / f"{i}.txt").write_text(" ".join(str(v) for v in c2w.ravel()))
        (tmp_path / "intrinsics" / f"{i}.txt").write_text(" ".join(str(v) for v in K.ravel()))
    ks, c2ws = tio.load_cameras_tat(str(tmp_path))
    jks, jc2ws = jio.load_cameras_tat(str(tmp_path))
    np.testing.assert_array_equal(ks, jks)
    np.testing.assert_array_equal(c2ws, jc2ws)
    assert ks.shape == (4, 3, 3) and ks[-1, 0, 0] == 110.0


# ---------------------------------------------------------------------------
# the PNG codec against OpenCV
# ---------------------------------------------------------------------------

def _image(rng, shape):
    """Seeded noise over a gradient: rows that filter differently."""
    H, W = shape[:2]
    base = (np.arange(H)[:, None] * 7 + np.arange(W)[None, :] * 3) % 256
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return ((base + rng.randint(0, 48, shape)) % 256).astype(np.uint8)


SHAPES = {"gray": (17, 23), "bgr": (19, 21, 3), "bgra": (13, 29, 4)}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_reads_what_cv2_writes(tmp_path, kind):
    img = _image(np.random.RandomState(len(kind)), SHAPES[kind])
    p = str(tmp_path / "a.png")
    assert cv2.imwrite(p, img)
    got = png.read_png(p)
    np.testing.assert_array_equal(got, cv2.imread(p))
    assert got.shape == SHAPES[kind][:2] + (3,) and got.dtype == np.uint8


@pytest.mark.parametrize("kind", list(SHAPES))
def test_cv2_reads_what_png_writes(tmp_path, kind):
    img = _image(np.random.RandomState(10 + len(kind)), SHAPES[kind])
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    png.write_png(ours, img)
    assert cv2.imwrite(theirs, img)
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        np.testing.assert_array_equal(cv2.imread(ours, flag), cv2.imread(theirs, flag))
    np.testing.assert_array_equal(png.read_png(ours), cv2.imread(theirs))


def _filtered_png(path, px, kinds):
    """An 8-bit PNG of file-order pixels px [H, W, C] (C 1-4), row y
    filtered with row filter kinds[y] (PNG spec section 9)."""
    H, W, C = px.shape
    raw = px.reshape(H, W * C).astype(np.int64)
    prior = np.zeros(W * C, np.int64)
    body = []
    for y in range(H):
        cur = raw[y]
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prior[:-C]])
        if kinds[y] == 0:
            pred = 0
        elif kinds[y] == 1:
            pred = left
        elif kinds[y] == 2:
            pred = prior
        elif kinds[y] == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        body.append(np.concatenate([[kinds[y]], (cur - pred) & 255]).astype(np.uint8))
        prior = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)))
        data = zlib.compress(np.concatenate(body).tobytes())
        f.write(chunk(b"IDAT", data[:len(data) // 2]))  # two IDAT chunks
        f.write(chunk(b"IDAT", data[len(data) // 2:]))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_row_filters_match_cv2(tmp_path, channels):
    """Rows under each of the five filters (each twice, in turn) read as
    cv2.imread reads them, and as the pixels they encode."""
    px = _image(np.random.RandomState(channels), (10, 9, channels))
    p = str(tmp_path / "f.png")
    _filtered_png(p, px, [y % 5 for y in range(10)])
    got = png.read_png(p)
    np.testing.assert_array_equal(got, cv2.imread(p))
    want = np.repeat(px[..., :1], 3, axis=-1) if channels <= 2 else px[..., 2::-1]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# PLY, scene directories, load_scene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("way", ["jax_writes", "port_writes"])
def test_ply_roundtrip_both_ways(tmp_path, way):
    verts, faces = tsyn._sphere_ground_mesh(6)
    writer, reader = (jply, tply) if way == "jax_writes" else (tply, jply)
    p = str(tmp_path / "m.ply")
    writer.write_ply(p, verts, faces)
    for v, f in (reader.read_ply(p), writer.read_ply(p)):
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
    q = str(tmp_path / "other.ply")
    reader.write_ply(q, verts, faces)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_ply_ascii_matches_jax(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\ncomment made by hand\nelement vertex 4\n"
                 "property float y\nproperty float x\nproperty float z\n"
                 "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0.5\n0 1 0\n1 1 2\n3 0 1 2\n3 1 3 2\n")
    v, f = tply.read_ply(str(p))
    jv, jf = jply.read_ply(str(p))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v[1], [0, 1, 0.5])


def test_write_scene_dir_matches_jax(tmp_path):
    """The port's write_scene_dir writes the JAX one's files: text and
    arrays equal, the mesh byte for byte, the images' pixels equal."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_cameras=3, H=12, W=16, n_tiles=2, unequal_views=True)
    jsyn.write_scene_dir(a, **kw)
    tsyn.write_scene_dir(b, **kw)
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(pa), cv2.imread(pb), err_msg=name)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb), err_msg=name)
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read(), name


@pytest.mark.parametrize("way", ["jax_writes", "port_writes"])
def test_load_scene_matches_jax(tmp_path, way):
    """A scene directory written by either package's write_scene_dir (one
    camera in ignore.log) loads the same in both, mono priors included."""
    d = str(tmp_path / "scene")
    (jsyn if way == "jax_writes" else tsyn).write_scene_dir(d, n_cameras=4, H=10, W=14)
    with open(os.path.join(d, "ignore.log"), "w") as f:
        f.write("2\n")
    t = tio.load_scene(d, [0, 1, 2, 3], mono_depth=True, mono_normal=True)
    j = jio.load_scene(d, [0, 1, 2, 3], mono_depth=True, mono_normal=True)
    assert t.idx_list == j.idx_list == [0, 1, 3]
    assert (t.H, t.W) == (j.H, j.W) == (10, 14)
    for name in ("images", "c2ws", "ks", "mono_depths", "mono_normals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t.images.dtype == np.float32 and t.images.shape == (3, 10, 14, 3)
    assert tio.load_scene(d).mono_depths is None
