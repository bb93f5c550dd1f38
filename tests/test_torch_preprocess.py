"""The port's preprocess tools (``scanerf_tpu_torch/preprocess/``,
``utils/obj.py``) against the JAX package's on the same inputs, on the
CPU, cheapest first: every file either package writes is compared with
the other's (text and arrays equal; PNG images pixel for pixel, since the
port's PNG writer stores other bytes than OpenCV's), each package working
in its own copy of the inputs. Mirrors tests/test_preprocess_tools.py
(:34, :46, :62, :150, :173), tests/test_cmvs.py (:22, :48, :61) and the
``build_tiles`` test of tests/test_trainer_e2e.py (:74-91). No JAX
computation is compiled but the JAX ``build_tiles``'s ray-box test, op
by op."""

import json
import os
import shutil
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from scanerf_tpu.config import default_config as j_default_config
from scanerf_tpu.data.synthetic import write_scene_dir
from scanerf_tpu.preprocess import build_tiles as jbt
from scanerf_tpu.preprocess import cmvs as jcmvs
from scanerf_tpu.preprocess import colmap as jcolmap
from scanerf_tpu.preprocess import llff as jllff
from scanerf_tpu.preprocess import reality_capture as jrc
from scanerf_tpu.preprocess import rectify_mesh as jrm
from scanerf_tpu.utils import obj as jobj
from scanerf_tpu_torch.config import default_config as t_default_config
from scanerf_tpu_torch.data import png
from scanerf_tpu_torch.geometry import ply as tply
from scanerf_tpu_torch.preprocess import build_tiles as tbt
from scanerf_tpu_torch.preprocess import cmvs as tcmvs
from scanerf_tpu_torch.preprocess import colmap as tcolmap
from scanerf_tpu_torch.preprocess import llff as tllff
from scanerf_tpu_torch.preprocess import reality_capture as trc
from scanerf_tpu_torch.preprocess import rectify_mesh as trm
from scanerf_tpu_torch.utils import obj as tobj


def _files(root):
    """{relative path: absolute path} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = os.path.join(d, n)
    return out


def _same_tree(a, b):
    """Both trees hold the same files: PNGs equal pixel for pixel (read by
    OpenCV), .npy arrays equal, everything else byte for byte."""
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys()
    for rel in fa:
        if rel.endswith(".png"):
            ia, ib = cv2.imread(fa[rel]), cv2.imread(fb[rel])
            assert ia is not None and np.array_equal(ia, ib), rel
        elif rel.endswith(".npy"):
            x, y = np.load(fa[rel]), np.load(fb[rel])
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        else:
            with open(fa[rel], "rb") as f, open(fb[rel], "rb") as g:
                assert f.read() == g.read(), rel
    return len(fa)


def _twins(tmp_path, make):
    """``make(dir)`` run into one directory, copied for the other package:
    -> (the JAX package's dir, the port's)."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    make(a)
    shutil.copytree(a, b, symlinks=True)
    return a, b


# ---------------------------------------------------------------------------
# utils/obj.py, Bundler / SKE files
# ---------------------------------------------------------------------------

def test_obj_writers_match(tmp_path):
    """``draw_aabbs``, ``cameras_scatter`` and ``write_obj`` of both
    packages on the same boxes and cameras: arrays and files equal."""
    rng = np.random.RandomState(0)
    centers, sizes = rng.randn(5, 3), rng.rand(5, 3) + 0.5
    vj, fj = jobj.draw_aabbs(centers, sizes)
    vt, ft = tobj.draw_aabbs(centers, sizes)
    assert np.array_equal(vj, vt) and np.array_equal(fj, ft)
    Rs, ts = rng.randn(3, 3, 3), rng.randn(3, 3)
    assert np.array_equal(jobj.cameras_scatter(Rs, ts), tobj.cameras_scatter(Rs, ts))
    jobj.write_obj(str(tmp_path / "j.obj"), vj, fj)
    tobj.write_obj(str(tmp_path / "t.obj"), vt, ft)
    jobj.points_to_obj(str(tmp_path / "jp.obj"), vj)
    tobj.points_to_obj(str(tmp_path / "tp.obj"), vt)
    for a, b in (("j.obj", "t.obj"), ("jp.obj", "tp.obj")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def _rand_w2c(rng, n):
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out.append(np.concatenate([q, rng.normal(size=(3, 1))], axis=1))
    return np.asarray(out, np.float32)


def test_bundle_files_and_w2c_match(tmp_path):
    """A Bundler v0.3 file written by each package is the same file, and
    each package reads the other's to the same arrays and visibility;
    ``w2c_to_c2w`` equal (tests/test_cmvs.py:22, :48)."""
    rng = np.random.default_rng(0)
    n_cam, n_pts = 5, 11
    intr = np.abs(rng.normal(size=(n_cam, 3))).astype(np.float32) * 100
    w2c = _rand_w2c(rng, n_cam)
    pts = np.concatenate([rng.normal(size=(n_pts, 3)), rng.integers(0, 255, (n_pts, 3))],
                         axis=1).astype(np.float32)
    tracks = [[(int(rng.integers(0, n_cam)), j, 1.5, -2.5) for j in range(2)]
              for _ in range(n_pts)]
    pj, pt = str(tmp_path / "j.out"), str(tmp_path / "t.out")
    jcmvs.write_bundle(pj, intr, w2c, pts, tracks)
    tcmvs.write_bundle(pt, intr, w2c, pts, tracks)
    assert open(pj).read() == open(pt).read()
    for a, b in ((jcmvs.read_bundle(pt), tcmvs.read_bundle(pj)),
                 (jcmvs.read_bundle(pj, only_cam=True), tcmvs.read_bundle(pt, only_cam=True))):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert x == y
    assert np.array_equal(jcmvs.w2c_to_c2w(w2c), tcmvs.w2c_to_c2w(w2c))


def test_bundler_reader_matches(tmp_path):
    """RealityCapture's ``read_bundler`` on a two-camera file: focals and
    c2ws equal (tests/test_preprocess_tools.py:46)."""
    p = tmp_path / "bundler.out"
    p.write_text("# Bundle file v0.3\n2 0\n800.0 0 0\n1 0 0\n0 1 0\n0 0 1\n0 0 -2\n"
                 "650.5 0 0\n0 0 1\n0 1 0\n-1 0 0\n0.5 -1 3\n")
    for x, y in zip(jrc.read_bundler(str(p)), trc.read_bundler(str(p))):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# COLMAP models
# ---------------------------------------------------------------------------

def _write_colmap(root, n_views=3, with_images=True):
    """A COLMAP model with rotated poses and 40 sparse points visible in
    every view (tests/test_preprocess_tools.py's LLFF model) and, with
    ``with_images``, a 48x64 PNG for each view."""
    rng = np.random.default_rng(0)
    sp = os.path.join(root, "sparse", "0")
    os.makedirs(sp)
    with open(os.path.join(sp, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, 64, 48))
        f.write(struct.pack("<3d", 80.0, 32.0, 24.0))
    with open(os.path.join(sp, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            ang = 2 * np.pi * i / n_views
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0))
            f.write(struct.pack("<3d", 0.1 * i, 0.05, 2.0))
            f.write(struct.pack("<i", 1))
            f.write(f"im{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 1.0, 2.0, -1))
    with open(os.path.join(sp, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 40))
        for p in range(40):
            f.write(struct.pack("<QdddBBBd", p + 1, *rng.normal(0, 0.3, 3), 10, 20, 30, 0.5))
            f.write(struct.pack("<Q", n_views))
            for v in range(n_views):
                f.write(struct.pack("<2i", v + 1, 0))
    if with_images:
        os.makedirs(os.path.join(root, "images"))
        for i in range(n_views):
            cv2.imwrite(os.path.join(root, "images", f"im{i}.png"),
                        rng.integers(0, 255, (48, 64, 3), np.uint8))


def test_colmap_readers_and_extractor_match(tmp_path):
    """The binary readers give the same cameras, images and points; the
    ``camera.log`` extractor writes the same file and the same renumbered
    images in each package's copy (tests/test_preprocess_tools.py:34)."""
    a, b = _twins(tmp_path, _write_colmap)
    sp = os.path.join(a, "sparse", "0")
    for name, rj, rt in (("cameras", jcolmap.read_cameras_binary, tcolmap.read_cameras_binary),
                         ("images", jcolmap.read_images_binary, tcolmap.read_images_binary),
                         ("points3D", jcolmap.read_points3d_binary,
                          tcolmap.read_points3d_binary)):
        dj, dt = rj(os.path.join(sp, f"{name}.bin")), rt(os.path.join(sp, f"{name}.bin"))
        assert dj.keys() == dt.keys()
        for k in dj:
            for f, v in vars(dj[k]).items():
                w = getattr(dt[k], f)
                assert np.array_equal(v, w) if isinstance(v, np.ndarray) else v == w, (name, f)
    q = np.array([0.9, 0.1, -0.3, 0.2])
    assert np.array_equal(jcolmap.qvec2rotmat(q / np.linalg.norm(q)),
                          tcolmap.qvec2rotmat(q / np.linalg.norm(q)))
    assert jcolmap.extract_colmap_camera(a) == tcolmap.extract_colmap_camera(b) == 3
    assert _same_tree(a, b) == 3 + 3 + 3 + 1  # sparse/0, images, new_images, camera.log


def test_llff_tools_match(tmp_path):
    """``gen_poses`` writes the same ``poses_bounds.npy``; ``llff_to_cameras``
    gives the same cameras; ``load_llff_data`` with ``factor=2`` writes
    the same minified images (pixels) and returns the same poses, bounds
    and images (tests/test_preprocess_tools.py:150, :173); a JPEG image
    without OpenCV raises, naming it."""
    a, b = _twins(tmp_path, _write_colmap)
    arr_j, arr_t = jllff.gen_poses(a), tllff.gen_poses(b)
    assert np.array_equal(arr_j, arr_t) and arr_t.shape == (3, 17)
    poses = arr_t[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    for x, y in zip(jllff.llff_to_cameras(poses), tllff.llff_to_cameras(poses)):
        assert np.array_equal(x, y)
    out_j = jllff.load_llff_data(a, factor=2)
    out_t = tllff.load_llff_data(b, factor=2)
    assert out_t[2].shape == (24, 32, 3, 3)
    for x, y in zip(out_j, out_t):
        assert np.array_equal(x, y)
    assert _same_tree(a, b) == 3 + 3 + 1 + 3  # sparse/0, images, poses_bounds, images_2
    for x, y in zip(jllff.load_llff_data(a, load_imgs=False),
                    tllff.load_llff_data(b, load_imgs=False)):
        assert np.array_equal(x, y)
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, np.zeros((4, 4, 3), np.uint8))
    assert tllff._imread_rgb(jpg).shape == (4, 4, 3)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        with pytest.raises(RuntimeError, match="cv2"):
            tllff._imread_rgb(jpg)
        assert png.read_png(os.path.join(b, "images", "im0.png")).shape == (48, 64, 3)
        tllff._imread_rgb(os.path.join(b, "images", "im0.png"))
    finally:
        sys.modules["cv2"] = saved


def test_colmap_to_cmvs_and_clusters_match(tmp_path):
    """``colmap_to_cmvs`` writes the same PMVS layout, and, given an SKE
    file, ``cmvs_to_training`` the same cluster directories (arrays equal,
    the same image links; tests/test_cmvs.py:61)."""
    a, b = _twins(tmp_path, _write_colmap)
    out_j, out_t = jcmvs.colmap_to_cmvs(a), tcmvs.colmap_to_cmvs(b)
    for out in (out_j, out_t):
        with open(os.path.join(out, "ske.dat"), "w") as f:
            f.write("SKE\n3 2\n2 0\n0 1\n1 0\n2\n")
    assert jcmvs.read_ske(os.path.join(out_j, "ske.dat")) == \
        tcmvs.read_ske(os.path.join(out_t, "ske.dat"))
    cj, ct = jcmvs.cmvs_to_training(out_j), tcmvs.cmvs_to_training(out_t)
    assert os.path.relpath(cj, a) == os.path.relpath(ct, b)
    for name in ("0", "1", "all"):
        links_j = sorted(os.listdir(os.path.join(cj, name, "images")))
        links_t = sorted(os.listdir(os.path.join(ct, name, "images")))
        assert links_j == links_t and links_t
    assert _same_tree(out_j, out_t) > 12 + 3 * 3


# ---------------------------------------------------------------------------
# RealityCapture, rectify_mesh, build_tiles
# ---------------------------------------------------------------------------

def test_reality_capture_extract_matches(tmp_path):
    """``extract_reality_capture`` on a two-camera Bundler file and its
    PNG frames: the same ``coarse_camera.log`` and the same cropped images
    (pixels)."""
    def make(root):
        os.makedirs(os.path.join(root, "bundler"))
        with open(os.path.join(root, "bundler", "bundler.out"), "w") as f:
            f.write("# Bundle file v0.3\n2 0\n800.0 0 0\n1 0 0\n0 1 0\n0 0 1\n0 0 -2\n"
                    "650.5 0 0\n0 0 1\n0 1 0\n-1 0 0\n0.5 -1 3\n")
        rng = np.random.default_rng(1)
        for i in range(2):
            cv2.imwrite(os.path.join(root, "bundler", "%05d.png" % i),
                        rng.integers(0, 255, (60, 80, 3), np.uint8))

    a, b = _twins(tmp_path, make)
    kw = dict(width=50, height=40, crop_left=7, crop_top=5)
    assert jrc.extract_reality_capture(a, os.path.join(a, "out"), **kw) == \
        trc.extract_reality_capture(b, os.path.join(b, "out"), **kw) == 2
    assert png.read_png(os.path.join(b, "out", "images", "1.png")).shape == (40, 50, 3)
    assert _same_tree(a, b) == 1 + 2 + 1 + 2


def test_rectify_mesh_matches(tmp_path):
    """``rectify_mesh`` with the default angles and centre, and with the
    JAX test's: the same aligned mesh (read back equal), camera file and
    alignment note (tests/test_preprocess_tools.py:62)."""
    from scanerf_tpu.data import io as jio

    def make(root):
        os.makedirs(root)
        rng = np.random.RandomState(2)
        tply.write_ply(os.path.join(root, "mesh.ply"), rng.randn(30, 3).astype(np.float32),
                       rng.randint(0, 30, (20, 3)).astype(np.int32))
        ks = np.tile(np.array([[100.0, 0, 32], [0, 100, 24], [0, 0, 1]], np.float32), (3, 1, 1))
        c2ws = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
                               rng.randn(3, 3, 1).astype(np.float32)], -1)
        jio.write_campara(os.path.join(root, "camera.log"), ks, c2ws, 48, 64)

    a, b = _twins(tmp_path, make)
    for kw in ({}, dict(angle=(0, 0, 0), mesh_center=(0, 0, 0), scale=2.0)):
        jrm.rectify_mesh(os.path.join(a, "mesh.ply"), os.path.join(a, "camera.log"), **kw)
        trm.rectify_mesh(os.path.join(b, "mesh.ply"), os.path.join(b, "camera.log"), **kw)
        for x, y in zip(tply.read_ply(os.path.join(a, "mesh_align.ply")),
                        tply.read_ply(os.path.join(b, "mesh_align.ply"))):
            assert np.array_equal(x, y)
        for name in ("camera_align.log", "align_info.txt"):
            assert open(os.path.join(a, name)).read() == open(os.path.join(b, name)).read()
    assert np.array_equal(jrm.euler_rotation((10, -20, 30)), trm.euler_rotation((10, -20, 30)))


ALLOCATION = {"TILE_SIZE": [2.0, 2.0, 2.0], "OVERLAP_RATIO": 0.2, "OFFSET": [0.0, 0.0, 0.0],
              "EXPECT_NUM": 2, "MIN_NUM_IMAGE": 2, "MAX_DIM_TILE": [4, 1, 4],
              "SCENE_TYPE": "indoor"}


def test_build_tiles_matches(tmp_path):
    """``build_tiles`` on the same 6-camera scene directory, each package
    in its own copy (it overwrites the scene's tiles/ files), with the
    JAX e2e test's allocation (tests/test_trainer_e2e.py:74-91) and, in
    other copies, outdoor with 0.3 overlap: the same tiles and views and
    the same tile_info.txt, training_views.txt and tiles.obj; the port's
    CLI on a config in JSON syntax (the card's machine has no PyYAML)
    writes them again."""
    results = []
    for name, alloc in (("indoor", ALLOCATION),
                        ("outdoor", dict(ALLOCATION, SCENE_TYPE="outdoor", OVERLAP_RATIO=0.3,
                                         MIN_NUM_IMAGE=1, EXPECT_NUM=3))):
        a, b = _twins(tmp_path / name, lambda root: write_scene_dir(
            root, n_cameras=6, H=24, W=24, n_tiles=1))
        cj, ct = j_default_config(), t_default_config()
        for cfg, root in ((cj, a), (ct, b)):
            cfg.DATADIR = root
            cfg.ALLOCATION.update(alloc)
        oj, ot = jbt.build_tiles(cj), tbt.build_tiles(ct, device="cpu")
        assert oj["views"] == ot["views"] and len(ot["tiles"]) >= 1
        for x, y in zip(oj["tiles"], ot["tiles"]):
            assert vars(x).keys() == vars(y).keys()
            for k in vars(x):
                assert np.array_equal(np.asarray(getattr(x, k)), np.asarray(getattr(y, k))), k
        assert _same_tree(os.path.join(a, "tiles"), os.path.join(b, "tiles")) == 3
        results.append(len(ot["tiles"]))
    cfg_path = str(tmp_path / "scene.yaml")
    with open(cfg_path, "w") as f:
        json.dump({"DATADIR": b, "ALLOCATION": dict(ALLOCATION, SCENE_TYPE="outdoor",
                                                    OVERLAP_RATIO=0.3, MIN_NUM_IMAGE=1,
                                                    EXPECT_NUM=3)}, f)
    os.remove(os.path.join(b, "tiles", "tiles.obj"))
    tbt.main([cfg_path, "--device", "cpu"])
    assert _same_tree(os.path.join(a, "tiles"), os.path.join(b, "tiles")) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbt.build_tiles(ct)
