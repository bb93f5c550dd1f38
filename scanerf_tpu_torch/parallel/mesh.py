"""Ranks, named meshes and the collectives of the multi-device paths
(counterpart of the ``jax.sharding.Mesh`` that
``scanerf_tpu/parallel/ray_parallel.py::make_ray_mesh`` and
``tile_parallel.py::make_tile_mesh`` build).

The JAX package runs one SPMD program over a mesh of devices; the port
runs one process per rank under ``torch.distributed``. A ``Mesh`` names
its axes in the JAX order ``(tiles, rays, table)``, ranks laid out
row-major over them (the table axis innermost), and gives each axis the
process group of the ranks that differ only in that axis, with this
rank's coordinate on it.

The collective backend is the caller's: ``"nccl"`` when every rank has a
card of its own, ``"gloo"`` for the CPU and for ranks that share one
card (NCCL refuses two ranks on one device; gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through the host).
Only ``all_reduce``, ``broadcast`` and ``barrier`` are used, the
``psum`` / ``pmean`` of the JAX code: a gather is an ``all_reduce`` of
disjoint, zero-filled slices, which is exact. One process (world size
1) needs no process group: every axis then has size 1 and every
collective returns its input.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("tiles", "rays", "table")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it and the process group along it (None when the size is 1)."""

    name: str
    size: int
    index: int
    group: object = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of a mesh: its axes (``Axis``, in AXIS_ORDER) and the
    groups' collective backend (None in one process)."""

    axes: tuple
    backend: str | None = None

    @property
    def axis_names(self) -> tuple:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> dict:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> Axis | None:
        """The named axis, or None if the mesh has no such axis."""
        for a in self.axes:
            if a.name == name:
                return a
        return None

    def size(self, name: str) -> int:
        a = self.axis(name)
        return 1 if a is None else a.size

    def index(self, name: str) -> int:
        a = self.axis(name)
        return 0 if a is None else a.index


def init_ranks(backend: str, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None) -> tuple[int, int]:
    """Join the process group with the caller's ``backend`` -> (rank,
    world size). Rank and world come from the arguments, else from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    ``init_method`` (e.g. ``tcp://localhost:29500``) replaces the
    environment's address. A world of one joins no group. Joining twice
    returns the group already joined."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    if world_size == 1:
        return 0, 1
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return rank, world_size


def world() -> tuple[int, int]:
    """(rank, world size) of the joined group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``"cuda"`` without an index is card
    LOCAL_RANK modulo the cards present (ranks beyond the cards share
    them), anything else as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                            % torch.cuda.device_count())
    return dev


def make_mesh(shape: dict, backend: str | None = None) -> Mesh:
    """A mesh of the named axis sizes (keys of ``AXIS_ORDER``, in any
    order; their product must be the world size) over the joined group.
    Every rank must call it with the same arguments (each axis group is
    made collectively). ``backend`` is the groups' (default: the joined
    group's)."""
    names = [n for n in AXIS_ORDER if n in shape]
    if set(shape) - set(AXIS_ORDER):
        raise ValueError(f"unknown axes {sorted(set(shape) - set(AXIS_ORDER))}")
    sizes = [int(shape[n]) for n in names]
    rank, n_world = world()
    n_mesh = int(np.prod(sizes))
    if n_mesh != n_world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {n_mesh} ranks, the world "
                         f"has {n_world}")
    if n_world > 1 and backend is None:
        backend = dist.get_backend()
    coords = []
    r = rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = coords[::-1]
    axes = []
    for k, (name, size) in enumerate(zip(names, sizes)):
        group = None
        if size > 1:
            others = [range(s) for j, s in enumerate(sizes) if j != k]
            for fixed in itertools.product(*others):
                ranks = []
                for i in range(size):
                    c = list(fixed)
                    c.insert(k, i)
                    ranks.append(_rank_of(c, sizes))
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    group = g
        axes.append(Axis(name, size, coords[k], group))
    return Mesh(tuple(axes), backend)


def _rank_of(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def all_reduce(t: torch.Tensor, axis: Axis | None, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``axis`` (``op`` "sum" or "max");
    unchanged without the axis or at size 1."""
    if axis is None or axis.size == 1:
        return t
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=axis.group)
    return t


def all_reduce_mean(tensors: list, axis: Axis | None) -> list:
    """Each tensor's mean over ``axis`` (one flat all_reduce of their
    concatenation, in f32) -> new tensors of the inputs' shapes and
    dtypes."""
    if axis is None or axis.size == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    all_reduce(flat, axis)
    flat /= axis.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def gather_slices(local: torch.Tensor, axis: Axis | None, dim: int) -> torch.Tensor:
    """The whole tensor of which each rank of ``axis`` holds the
    ``index``-th of ``size`` equal slices along ``dim``: an all_reduce of
    zero-filled copies, each holding its rank's slice (exact)."""
    if axis is None or axis.size == 1:
        return local
    shape = list(local.shape)
    n = shape[dim]
    shape[dim] = n * axis.size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.narrow(dim, axis.index * n, n).copy_(local)
    return all_reduce(full, axis)


def local_slice(full: torch.Tensor, axis: Axis | None, dim: int) -> torch.Tensor:
    """This rank's slice (a contiguous copy) of ``full`` along ``dim``,
    which ``axis.size`` divides; ``full`` itself without the axis."""
    if axis is None or axis.size == 1:
        return full
    n = full.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of size {n} does not split {axis.size} ways")
    k = n // axis.size
    return full.narrow(dim, axis.index * k, k).contiguous()


def broadcast_object(obj, src: int = 0):
    """A picklable object from rank ``src`` of the joined group to every
    rank (the object itself in a world of one)."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if world()[1] > 1:
        dist.barrier()
