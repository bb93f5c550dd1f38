"""CMVS camera-clustering interchange, the Bundler / PMVS scene layout
(counterpart of ``scanerf_tpu/preprocess/cmvs.py``).

A COLMAP reconstruction is exported to the Bundler v0.3 + PMVS directory
layout (``colmap_to_cmvs``), an external CMVS run clusters the cameras
(``ske.dat``), and ``cmvs_to_training`` turns the clusters into
per-cluster training directories (``c2ws.npy``, ``focals.npy``,
``bds.npy``) for large-scene tile allocation. Host-side numpy only.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from scanerf_tpu_torch.preprocess import colmap as cm


# ---------------------------------------------------------------------------
# Bundler v0.3
# ---------------------------------------------------------------------------

def read_bundle(path: str, only_cam: bool = False):
    """Parse a Bundler v0.3 file.

    Returns (intrinsics [N,3] = (f, k1, k2), w2c [N,3,4], pts [P,6] =
    (xyz, rgb), vis: per-camera lists of visible point indices). With
    ``only_cam`` the point block is skipped.
    """
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens.append(line)
    n_cam, n_pts = (int(v) for v in tokens[0].split())
    vals = np.array(" ".join(tokens[1:1 + 5 * n_cam]).split(),
                    np.float64)
    cams = vals.reshape(n_cam, 15)
    intr = cams[:, 0:3].astype(np.float32)
    w2c = cams[:, 3:15].reshape(n_cam, 4, 3)
    w2c = np.concatenate(
        [w2c[:, 0:3, :], w2c[:, 3:4, :].transpose(0, 2, 1)], axis=2
    ).astype(np.float32)  # [N, 3, 4] rows R then column t
    if only_cam:
        return intr, w2c

    pts = np.zeros((n_pts, 6), np.float32)
    vis = [[] for _ in range(n_cam)]
    cursor = 1 + 5 * n_cam
    for i in range(n_pts):
        xyz = np.array(tokens[cursor].split(), np.float64)
        rgb = np.array(tokens[cursor + 1].split(), np.float64)
        pts[i, 0:3], pts[i, 3:6] = xyz, rgb
        view = tokens[cursor + 2].split()
        for j in range(int(view[0])):
            vis[int(view[1 + 4 * j])].append(i)
        cursor += 3
    return intr, w2c, pts, vis


def write_bundle(path: str, intrinsics, w2c, pts=None, vis_tracks=None):
    """Write a Bundler v0.3 file. ``vis_tracks``: per-point list of
    (camera_idx, point2d_idx, x, y) tuples (empty tracks allowed)."""
    n_cam = len(intrinsics)
    n_pts = 0 if pts is None else len(pts)
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{n_cam} {n_pts}\n")
        for i in range(n_cam):
            fc, k1, k2 = intrinsics[i]
            R, t = np.asarray(w2c[i])[:, :3], np.asarray(w2c[i])[:, 3]
            f.write(f"{fc} {k1} {k2}\n")
            for r in range(3):
                f.write(f"{R[r, 0]} {R[r, 1]} {R[r, 2]}\n")
            f.write(f"{t[0]} {t[1]} {t[2]}\n")
        for i in range(n_pts):
            x, y, z, r, g, b = pts[i]
            f.write(f"{x} {y} {z}\n")
            f.write(f"{int(r)} {int(g)} {int(b)}\n")
            track = vis_tracks[i] if vis_tracks is not None else []
            f.write(str(len(track)))
            for cam_i, p2d, px, py in track:
                f.write(f" {cam_i} {p2d} {px} {py}")
            f.write("\n")


def w2c_to_c2w(w2c: np.ndarray) -> np.ndarray:
    """[N,3,4] world->cam to cam->world (R^T, -R^T t)."""
    R = w2c[:, :, :3]
    t = w2c[:, :, 3:]
    Rt = np.swapaxes(R, 1, 2)
    return np.concatenate([Rt, -Rt @ t], axis=2)


# ---------------------------------------------------------------------------
# SKE cluster file (CMVS output)
# ---------------------------------------------------------------------------

def read_ske(path: str):
    """Parse CMVS ``ske.dat``: header "SKE", "<n_cameras> <n_clusters>",
    then per cluster a "<size> <?>" line followed by the member-id line.
    Returns (clusters: list[list[int]], n_cameras, n_clusters)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    if not lines or lines[0] != "SKE":
        raise ValueError(f"{path}: not an SKE file")
    n_cam, n_clu = (int(v) for v in lines[1].split())
    clusters = []
    i = 2
    while i < len(lines):
        if lines[i] and len(lines[i].split()) == 2:
            clusters.append([int(v) for v in lines[i + 1].split()])
            i += 2
        else:
            i += 1
    if len(clusters) != n_clu:
        raise ValueError(f"{path}: {len(clusters)} clusters, header {n_clu}")
    return clusters, n_cam, n_clu


# ---------------------------------------------------------------------------
# COLMAP -> PMVS/CMVS scene directory
# ---------------------------------------------------------------------------

def colmap_to_cmvs(data_dir: str, out_dir: str | None = None) -> str:
    """Export ``data_dir/sparse/0`` (binary COLMAP model) to the PMVS
    layout CMVS consumes: ``bundle.rd.out``, ``visualize/%08d.jpg``,
    ``txt/`` (K[R|t] projections), ``poses/`` ([R|t]), ``perview/``
    (visible point3D ids). Images are hard-linked/copied from
    ``data_dir/images``. Returns the output directory.
    """
    out_dir = out_dir or os.path.join(data_dir, "cmvs_format")
    camdata = cm.read_cameras_binary(
        os.path.join(data_dir, "sparse/0/cameras.bin"))
    imdata = cm.read_images_binary(
        os.path.join(data_dir, "sparse/0/images.bin"))
    pts3d = cm.read_points3d_binary(
        os.path.join(data_dir, "sparse/0/points3D.bin"))

    for sub in ("visualize", "txt", "poses", "perview"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    cam = next(iter(camdata.values()))
    f, cx, cy = cam.params[0], cam.params[1], cam.params[2]
    k1 = float(cam.params[3]) if len(cam.params) > 3 else 0.0
    k2 = float(cam.params[4]) if len(cam.params) > 4 else 0.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)

    image_ids = sorted(imdata)  # stable index order
    idx_of = {iid: i for i, iid in enumerate(image_ids)}
    intr, w2c = [], []
    img_dir = os.path.join(data_dir, "images")
    for i, iid in enumerate(image_ids):
        im = imdata[iid]
        R = cm.qvec2rotmat(im.qvec)
        rt = np.concatenate([R, im.tvec.reshape(3, 1)], axis=1)
        intr.append([f, k1, k2])
        w2c.append(rt)
        src = os.path.join(img_dir, im.name)
        dst = os.path.join(out_dir, "visualize", "%08d.jpg" % i)
        if os.path.exists(src) and not os.path.exists(dst):
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
        proj = K @ rt
        for sub, M in (("poses", rt), ("txt", proj)):
            with open(os.path.join(out_dir, sub, "%08d.txt" % i), "w") as fh:
                fh.write("CONTOUR\n")
                for r in range(3):
                    fh.write(f"{M[r, 0]} {M[r, 1]} {M[r, 2]} {M[r, 3]}\n")

    pids = sorted(pts3d)
    pid_row = {pid: r for r, pid in enumerate(pids)}
    pts = np.array(
        [[*pts3d[p].xyz, *pts3d[p].rgb] for p in pids], np.float32
    ) if pids else np.zeros((0, 6), np.float32)
    tracks = [
        [(idx_of[iid], 0, 0.0, 0.0) for iid in pts3d[p].image_ids
         if iid in idx_of]
        for p in pids
    ]
    # per-view visible point ids (CMVS "perview" sidecar)
    perview = [[] for _ in image_ids]
    for p in pids:
        for iid in pts3d[p].image_ids:
            if iid in idx_of:
                perview[idx_of[iid]].append(pid_row[p])
    for i in range(len(image_ids)):
        with open(os.path.join(out_dir, "perview", "%08d.txt" % i), "w") as fh:
            fh.write(" ".join(str(v) for v in perview[i]) + "\n")

    write_bundle(os.path.join(out_dir, "bundle.rd.out"),
                 np.array(intr, np.float32), np.array(w2c, np.float32),
                 pts, tracks)
    return out_dir


# ---------------------------------------------------------------------------
# CMVS clusters -> per-cluster training data
# ---------------------------------------------------------------------------

def cmvs_to_training(data_dir: str, out_dir: str | None = None) -> str:
    """Split a CMVS scene dir into per-cluster training directories.

    Reads ``bundle.rd.out`` + ``ske.dat``; for every cluster (plus an
    extra "all" cluster, matching the reference) writes ``c2ws.npy``,
    ``focals.npy`` and ``bds.npy`` (depth bounds from the cluster's
    visible sparse points, widened 0.9x/1.1x) and links its images.
    """
    out_dir = out_dir or os.path.join(data_dir, "clusters")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)

    intr, w2c, pts, vis = read_bundle(os.path.join(data_dir, "bundle.rd.out"))
    clusters, n_cam, n_clu = read_ske(os.path.join(data_dir, "ske.dat"))
    if n_cam != len(w2c):
        raise ValueError(f"ske cameras {n_cam} != bundle cameras {len(w2c)}")
    c2ws = w2c_to_c2w(w2c)
    focals = intr[:, 0]
    clusters = clusters + [list(range(n_cam))]

    for idx, cluster in enumerate(clusters):
        cluster = sorted(cluster)
        cdir = os.path.join(out_dir, "all" if idx == n_clu else str(idx))
        imdir = os.path.join(cdir, "images")
        os.makedirs(imdir)
        depths = []
        for ci in cluster:
            src = os.path.join(data_dir, "visualize", "%08d.jpg" % ci)
            if os.path.exists(src):
                os.symlink(os.path.abspath(src),
                           os.path.join(imdir, "%08d.jpg" % ci))
            if vis[ci]:
                p = pts[np.asarray(vis[ci], np.int64), :3]
                ph = np.concatenate([p, np.ones((len(p), 1), p.dtype)], 1)
                # Bundler cameras look down -z: depth = -(w2c @ p).z
                depths.append(-(ph @ w2c[ci].T)[:, 2])
        if depths:
            d = np.concatenate(depths)
            bds = np.array([d.min() * 0.9, d.max() * 1.1], np.float32)
        else:
            bds = np.array([0.1, 100.0], np.float32)
        np.save(os.path.join(cdir, "c2ws.npy"), c2ws[cluster])
        np.save(os.path.join(cdir, "focals.npy"), focals[cluster])
        np.save(os.path.join(cdir, "bds.npy"), bds)
    return out_dir
