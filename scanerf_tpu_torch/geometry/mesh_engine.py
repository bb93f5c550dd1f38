"""Proxy-mesh engine: a numpy facade over the native C++ grid tracer
(counterpart of ``scanerf_tpu/geometry/mesh_engine.py``).

The proxy mesh serves host-side preprocessing only (the first occupancy
grids, occlusion masks, BS background depths), never the training step,
so it stays on the host as in the JAX package. ``native/mesh_engine.cpp``
(a copy of the JAX package's) is compiled by g++ at first use into
``build/scanerf_tpu_torch/`` beside the CUDA libraries, under a name that
hashes its source and flags; a failed build raises. The numpy
brute-force tracer and voxelizer are the plain versions, taken only when
asked for (``plain=True``), as the tests do.

Facade semantics:
- ``render_depth``: first-hit depth (0 = miss).
- ``render_mask``: ``((enter > t_near of the tile) & hit) | miss |
  origin inside the tile``, True = trainable.
- ``compute_bgdepth_batch``: depth of the mesh behind the tile's exit,
  1000 where the ray sees sky.
- ``background_sampling``: a uniform window ``[max(exit, bg - r/2),
  ...)`` of ``num_sample`` steps of r / num_sample.
- ``voxelize``: occupancy of a target grid from 1.5x-dilated triangle
  AABBs, optionally with everything outside the geometry's box occupied.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np
import torch

from scanerf_tpu_torch import _build
from scanerf_tpu_torch.geometry.ply import read_ply
from scanerf_tpu_torch.ops.intersect import ray_aabb

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "mesh_engine.cpp")
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_lib = None


def library_path() -> str:
    """Content-addressed path of the tracer's library: its source, flags
    and the host's architecture (``-march=native``)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(platform.machine().encode())
    return str(_build.BUILD_DIR / f"libmesh_engine-{h.hexdigest()[:16]}.so")


def _load():
    """The tracer's library, built with g++ if missing; raises with the
    compiler's output if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mesh_build.restype = ctypes.c_void_p
    lib.mesh_build.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int]
    lib.mesh_free.argtypes = [ctypes.c_void_p]
    lib.mesh_scene_bound.argtypes = [ctypes.c_void_p, f32p]
    lib.mesh_trace.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int, f32p, ctypes.c_int]
    lib.mesh_voxelize.argtypes = [ctypes.c_void_p, i32p, f32p, f32p, u8p, ctypes.c_int, u8p]
    _lib = lib
    return lib


def _cptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class ProxyMesh:
    """Uniform-grid ray engine over a triangle mesh (a PLY path or
    (verts, faces)). ``plain=True`` takes the numpy tracer instead of the
    native one."""

    def __init__(self, path_or_mesh, grid_res: int = 64, plain: bool = False):
        self._lib = self._handle = None
        verts, faces = read_ply(path_or_mesh) if isinstance(path_or_mesh, str) \
            else path_or_mesh
        self.verts = np.ascontiguousarray(verts, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.grid_res = grid_res
        if not plain:
            self._lib = _load()
            self._handle = self._lib.mesh_build(
                _cptr(self.verts, ctypes.c_float), len(self.verts),
                _cptr(self.faces, ctypes.c_int), len(self.faces), grid_res)
        self.bbox_center: np.ndarray | None = None
        self.bbox_half: np.ndarray | None = None

    def __del__(self):
        if self._handle is not None:
            self._lib.mesh_free(self._handle)
            self._handle = None

    def set(self, bbox_center, bbox_half) -> None:
        """The tile box (center, half-size) of mask and background queries."""
        self.bbox_center = np.asarray(bbox_center, np.float32)
        self.bbox_half = np.asarray(bbox_half, np.float32)

    def get_sceneinfo(self) -> tuple[np.ndarray, np.ndarray]:
        """(scene bbox min, max)."""
        if self._handle is not None:
            out = np.zeros(6, np.float32)
            self._lib.mesh_scene_bound(self._handle, _cptr(out, ctypes.c_float))
            return out[:3], out[3:]
        pad = (self.verts.max(0) - self.verts.min(0)) * 1e-4 + 1e-6
        return self.verts.min(0) - pad, self.verts.max(0) + pad

    # -- queries --------------------------------------------------------

    def _trace(self, rays_o, rays_d, mode: int) -> np.ndarray:
        rays_o = np.ascontiguousarray(rays_o, np.float32)
        rays_d = np.ascontiguousarray(rays_d, np.float32)
        if self._handle is None:
            return self._trace_plain(rays_o, rays_d, mode)
        out = np.zeros(rays_o.shape[0], np.float32)
        self._lib.mesh_trace(self._handle, _cptr(rays_o, ctypes.c_float),
                             _cptr(rays_d, ctypes.c_float), rays_o.shape[0],
                             _cptr(out, ctypes.c_float), mode)
        return out

    def _trace_plain(self, rays_o, rays_d, mode: int) -> np.ndarray:
        """Brute-force Moller-Trumbore over every triangle: the plain
        version of the native tracer's first hit (mode 0, 0 on a miss;
        mode 1 returns the same hit, -1 on a miss)."""
        v0 = self.verts[self.faces[:, 0]][None]
        v1 = self.verts[self.faces[:, 1]][None]
        v2 = self.verts[self.faces[:, 2]][None]
        o = rays_o[:, None, :]
        d = rays_d[:, None, :]
        e1, e2 = v1 - v0, v2 - v0
        p = np.cross(d, e2)
        det = np.sum(e1 * p, -1)
        inv = np.where(np.abs(det) > 1e-7, 1.0 / np.where(det == 0, 1, det), 0.0)
        tv = o - v0
        u = np.sum(tv * p, -1) * inv
        q = np.cross(tv, e1)
        v = np.sum(d * q, -1) * inv
        t = np.sum(e2 * q, -1) * inv
        hit = (np.abs(det) > 1e-7) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        tmin = np.where(hit, t, np.inf).min(axis=1)
        miss = -1.0 if mode == 1 else 0.0
        return np.where(np.isfinite(tmin), tmin, miss).astype(np.float32)

    def render_depth(self, rays_o, rays_d) -> np.ndarray:
        """First-hit depth [N]; 0 = miss."""
        return self._trace(rays_o, rays_d, 0)

    def first_enter(self, rays_o, rays_d) -> np.ndarray:
        """Conservative first-entry t [N]; miss < 0."""
        return self._trace(rays_o, rays_d, 1)

    def _tile_bounds(self, rays_o, rays_d) -> np.ndarray:
        return ray_aabb(torch.as_tensor(np.asarray(rays_o, np.float32)),
                        torch.as_tensor(np.asarray(rays_d, np.float32)),
                        torch.as_tensor(self.bbox_center),
                        torch.as_tensor(self.bbox_half)).numpy()

    def render_mask(self, rays_o, rays_d, trust_mesh: bool = False) -> np.ndarray:
        """Per-ray occlusion mask [N] bool, True = trainable: the ray meets
        the tile before the mesh, misses the mesh, or starts inside the
        tile."""
        depth = self.render_depth(rays_o, rays_d) if trust_mesh \
            else np.maximum(self.first_enter(rays_o, rays_d), 0.0)
        bounds = self._tile_bounds(rays_o, rays_d)
        inside = np.all(np.abs(rays_o - self.bbox_center) < self.bbox_half, axis=-1)
        t_near = bounds[:, 0]
        return ((depth > t_near) & (t_near != -1)) | (depth == 0) | inside

    def compute_bgdepth_batch(self, rays_o, rays_d):
        """(bg_z [N], has_bg [N], bounds [N, 2]): the depth of the mesh
        behind the tile's exit, 1000 where the ray misses the mesh."""
        rays_o = np.array(rays_o, np.float32)
        depth_z = self.render_depth(rays_o, rays_d)
        bounds = self._tile_bounds(rays_o, rays_d)
        valid = bounds[:, 1] != -1
        o2 = rays_o.copy()
        o2[valid] = o2[valid] + bounds[valid, 1:2] * np.asarray(rays_d)[valid]
        bg_z = self.render_depth(o2, rays_d)
        bg_z = np.where(depth_z == 0, 1000.0, bg_z)
        has_bg = (bg_z > 0) & valid
        bg_z = np.where(valid, bg_z + bounds[:, 1], bg_z)
        return bg_z, has_bg, bounds

    def background_sampling(self, rays_o, rays_d, num_sample: int, sample_range: float):
        """Mesh-guided background samples: (z [N, S], -1 where invalid;
        valid [N])."""
        bg_z, valid, bounds = self.compute_bgdepth_batch(rays_o, rays_d)
        start = np.maximum(bounds[:, 1], bg_z - sample_range / 2.0)
        i = np.arange(num_sample, dtype=np.float32)
        z = start[:, None] + i[None, :] * (sample_range / num_sample)
        return np.where(valid[:, None], z, -1.0).astype(np.float32), valid

    def compute_bgdepth(self, rays_o_all, rays_d_all, H: int, W: int) -> np.ndarray:
        """Per-camera background depth maps [N_cam, H, W] (0 = none)."""
        out = np.zeros((rays_o_all.shape[0], H, W), np.float32)
        for i in range(rays_o_all.shape[0]):
            bg_z, has_bg, _ = self.compute_bgdepth_batch(rays_o_all[i].reshape(-1, 3),
                                                         rays_d_all[i].reshape(-1, 3))
            out[i] = np.where(has_bg, bg_z, 0.0).reshape(H, W)
        return out

    # -- voxelization ---------------------------------------------------

    def voxelize(self, log2dim, corner, size,
                 init_outside: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(occupied [Rx, Ry, Rz] bool, outside [same]) of the grid of
        2^log2dim cells over [corner, corner + size]."""
        res = (2 ** np.asarray(log2dim)).astype(np.int32)
        corner = np.asarray(corner, np.float32)
        size = np.asarray(size, np.float32)
        occ = np.zeros(tuple(res), np.uint8)
        outside = np.zeros(tuple(res), np.uint8)
        if self._handle is not None:
            self._lib.mesh_voxelize(self._handle, _cptr(res, ctypes.c_int),
                                    _cptr(corner, ctypes.c_float), _cptr(size, ctypes.c_float),
                                    _cptr(occ, ctypes.c_uint8), int(init_outside),
                                    _cptr(outside, ctypes.c_uint8))
        else:
            self._voxelize_plain(res, corner, size, occ, init_outside, outside)
        return occ.astype(bool), outside.astype(bool)

    def _voxelize_plain(self, res, corner, size, occ, init_outside, outside):
        cell = size / res
        bmax = corner + size
        tri = self.verts[self.faces]
        tmin, tmax = tri.min(1), tri.max(1)
        ctr = (tmin + tmax) / 2
        half = (tmax - tmin) * 0.75
        tmin, tmax = ctr - half, ctr + half
        keep = ~np.any((tmax <= corner) | (tmin >= bmax), axis=-1)
        tmin_k, tmax_k = tmin[keep], tmax[keep]
        geo_min = tmin_k.min(0) if len(tmin_k) else np.full(3, np.inf)
        geo_max = tmax_k.max(0) if len(tmax_k) else np.full(3, -np.inf)
        lo = np.clip(((tmin_k - corner) / cell).astype(int), 0, res - 1)
        hi = np.clip(((tmax_k - corner) / cell).astype(int), 0, res - 1)
        for a, b in zip(lo, hi):
            occ[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1] = 1
        if init_outside:
            xs = corner[0] + (np.arange(res[0]) + 0.5) * cell[0]
            ys = corner[1] + (np.arange(res[1]) + 0.5) * cell[1]
            zs = corner[2] + (np.arange(res[2]) + 0.5) * cell[2]
            X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
            out = ((X < geo_min[0]) | (Y < geo_min[1]) | (Z < geo_min[2])
                   | (X > geo_max[0]) | (Y > geo_max[1]) | (Z > geo_max[2]))
            occ |= out.astype(np.uint8)
            outside |= out.astype(np.uint8)


def voxelize_mesh(log2dim, corner, size, model_path: str, init_outside: bool = False,
                  grid_res: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """The reference's ``voxelize_mesh``: an empty ``model_path`` gives an
    all-occupied grid."""
    res = tuple(int(2**d) for d in np.asarray(log2dim))
    if not model_path:
        return np.ones(res, bool), np.zeros(res, bool)
    return ProxyMesh(model_path, grid_res=grid_res).voxelize(log2dim, corner, size,
                                                             init_outside)
