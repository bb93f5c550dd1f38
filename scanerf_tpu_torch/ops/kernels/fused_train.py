"""B5 and B6: fused windowed hash + ShallowMLP decode of the training stream,
forward and backward.

Replaces the Pallas kernels ``scanerf_tpu/ops/pallas/fused_train.py::
_ft_fwd_kernel`` (B5, launched at fused_train.py:348) and ``_ft_bwd_kernel``
(B6, launched at fused_train.py:389). ``hash_decode_train`` is a
``torch.autograd.Function`` whose forward is B5 and whose backward is B6
(``csrc/fused_train.cu``):

- B5, per stream row: the 16-level windowed gather, then the decoder with
  the training slab -> 8 columns (sigma, diffuse x3, tint * specular x3,
  mean specular^2) and the features [NC, L, 2, CHUNK] as the backward's
  residual (skipped when no gradient is wanted, as in the warp loss's
  visibility re-render). One block of 16 warps an SM walks the chunks;
  each warp decodes 16 rows at a time with its activations in registers:
  the gather straight into the first layer's operands, the four large
  layers on the tensor cores in 3xTF32 (about f32's accuracy), the narrow
  heads on the CUDA cores. On the H100 the tensor-core products and the
  residual's bytes set the floor; feeding the tensor cores and the
  gather's L2 latency set the time, and warps that share no barrier
  overlap the one with the other.
- B6, two launches: B6a, per live chunk in tiles of 64 rows, recomputes
  the decoder forward from the features and runs its hand-derived
  pullback, the four large matrices on the tensor cores in 3xTF32 (about
  f32's accuracy): the features' cotangent (kept in a scratch [NC, L*2,
  CHUNK] buffer), dL/d dirs (dpts rows 4-6), and the slab gradient summed
  per block in registers and added once per block. Then B4's kernel
  (``hash_encode.scatter_bwd``) scatters the features' cotangent into a
  zeroed dense [L, H*2] table gradient, summed per chunk and level in
  shared memory (entries no row touches stay zero, as the JAX kernel zeroes
  unvisited blocks), and writes dL/du (dpts rows 0-2).
  ``decoder_bwd_plain`` then ``lookup_bwd_plain`` is the same composition
  in plain PyTorch. With ``bwd_bf16`` (the JAX ``onehot_bf16``,
  fused_train.py:383-468) B4's kernel runs in its bf16 mode: each
  contribution to the table gradient is rounded to bf16 before it is
  summed.

The atomics add in an order that changes from run to run, so B6's table
and slab gradients differ between runs in the last bits of f32.

BARF's per-level annealing is folded into spatial0's input columns by
``pack_train_slab`` (written in differentiable torch code, so autograd
maps the slab's gradient back to the decoder's parameter dict); the
kernel's feature cotangent is then w.r.t. the unannealed features the
table scatter needs. The view direction is normalised as
``apply_decoder`` does, d / (|d| + 1e-8). Training tables are f32 only.
"""

from __future__ import annotations

import ctypes

import torch

from scanerf_tpu_torch import _build
from scanerf_tpu_torch.models.decoder import gaussian_act, softplus
from scanerf_tpu_torch.ops.kernels.fused_render import (
    B_DIR0, B_DIR1, B_DIR2, B_HEAD, B_SP0, B_SP1, DIR0_W, DIR1_W, DIR2_W,
    HEAD_W, PSLAB, SP0_W, SP1_W)
from scanerf_tpu_torch.ops.kernels.hash_encode import (
    CHUNK, W, check_tensor, lookup_bwd_plain, lookup_fwd_plain, scatter_bwd)
from scanerf_tpu_torch.utils.sh import sh_encoding

# (offset, [out, in] shape) of each weight matrix in the slab, then biases
_W_LAYOUT = ((SP0_W, 64, 32), (SP1_W, 64, 64), (HEAD_W, 7, 32), (DIR0_W, 64, 48),
             (DIR1_W, 64, 64), (DIR2_W, 3, 64))
_B_LAYOUT = ((B_SP0, 64), (B_SP1, 64), (B_HEAD, 7), (B_DIR0, 64), (B_DIR1, 64),
             (B_DIR2, 3))


def pack_train_slab(decoder: dict, wf: torch.Tensor) -> torch.Tensor:
    """Decoder param dict + per-level annealing weights wf [L] -> [PSLAB]
    f32 slab (B7's layout) with wf folded into spatial0's input columns.
    Differentiable in the decoder's parameters."""
    d = decoder
    wf2 = torch.repeat_interleave(wf.to(torch.float32), 2)
    mats = [d["spatial0"]["w"].t() * wf2[None, :], d["spatial1"]["w"].t(),
            torch.cat([d["sigma"]["w"], d["diffuse"]["w"], d["tint"]["w"]], 1).t(),
            d["dir0"]["w"].t(), d["dir1"]["w"].t(), d["dir2"]["w"].t()]
    biases = [d["spatial0"]["b"], d["spatial1"]["b"],
              torch.cat([d["sigma"]["b"], d["diffuse"]["b"], d["tint"]["b"]]),
              d["dir0"]["b"], d["dir1"]["b"], d["dir2"]["b"]]
    parts, pos = [], 0
    for (off, _, _), piece in list(zip(_W_LAYOUT, mats)) + list(
            zip([(o, n, 1) for o, n in _B_LAYOUT], biases)):
        if off > pos:
            parts.append(piece.new_zeros(off - pos))
        parts.append(piece.reshape(-1))
        pos = off + piece.numel()
    parts.append(parts[-1].new_zeros(PSLAB - pos))
    return torch.cat(parts)


def _slab_layers(pslab: torch.Tensor):
    """Views of the slab's matrices [out, in] and biases, in layer order."""
    ws = [pslab[o:o + n * i].view(n, i) for o, n, i in _W_LAYOUT]
    bs = [pslab[o:o + n] for o, n in _B_LAYOUT]
    return ws, bs


def decode_train_rows(pslab, feats, dirs) -> torch.Tensor:
    """The decoder on rows: feats [R, 32] (unannealed), dirs [R, 3]
    (not normalised) -> the 8 training columns [R, 8]."""
    (w0, w1, wh, wd0, wd1, wd2), (b0, b1, bh, bd0, bd1, bd2) = _slab_layers(pslab)
    h = gaussian_act(feats @ w0.t() + b0)
    hid = h @ w1.t() + b1
    heads = hid[:, :32] @ wh.t() + bh
    n = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
    din = torch.cat([hid[:, 32:], sh_encoding(3, n)], dim=-1)
    d1 = gaussian_act(din @ wd0.t() + bd0)
    d2 = gaussian_act(d1 @ wd1.t() + bd1)
    spec = torch.sigmoid(d2 @ wd2.t() + bd2)
    tint = torch.sigmoid(heads[:, 4:7])
    return torch.cat([softplus(heads[:, 0:1]), torch.sigmoid(heads[:, 1:4]), tint * spec,
                      (spec * spec).mean(dim=-1, keepdim=True)], dim=-1)


def train_fwd_plain(pts, meta, features, resolutions, pslab, NW: int):
    """Plain PyTorch version of B5 -> (cols [Np, 8], feats [NC, L, 2,
    CHUNK]). ``NW`` is the table's window count (the sentinel window)."""
    NC = pts.shape[0]
    L = resolutions.shape[0]
    live = (meta[:, :, 2].sum(dim=1) > 0).repeat_interleave(CHUNK)  # [Np]
    feats = lookup_fwd_plain(pts, features, resolutions, NW)
    dirs = pts[:, 4:7, :].permute(0, 2, 1).reshape(-1, 3)
    cols = decode_train_rows(pslab, feats, dirs)
    cols = torch.where(live[:, None], cols, torch.zeros_like(cols))
    return cols, feats.reshape(NC, CHUNK, L, 2).permute(0, 2, 3, 1)


def train_bwd_plain(pts, meta, features, resolutions, pslab, feats, g, NW: int,
                    bwd_bf16: bool = False):
    """Plain PyTorch version of B6 -> (dpts [NC, 8, CHUNK], d_features like
    ``features``, d_pslab [PSLAB]): the cotangents of ``train_fwd_plain``'s
    columns under ``g`` [Np, 8], by autograd through it (``feats``, the
    forward's residual, is recomputed rather than read). With
    ``bwd_bf16``, ``decoder_bwd_plain`` then ``lookup_bwd_plain`` in its
    bf16 mode."""
    if bwd_bf16:
        d_feats, dpts, d_pslab = decoder_bwd_plain(pts, meta, pslab, feats, g)
        dpts_u, d_features = lookup_bwd_plain(pts, features, resolutions, d_feats, NW, "bf16")
        return dpts + dpts_u, d_features, d_pslab
    with torch.enable_grad():
        p = pts.detach().requires_grad_()
        f = features.detach().requires_grad_()
        s = pslab.detach().requires_grad_()
        cols, _ = train_fwd_plain(p, meta, f, resolutions, s, NW)
        return torch.autograd.grad(cols, (p, f, s), g)


def decoder_bwd_plain(pts, meta, pslab, feats, g):
    """Plain PyTorch version of B6a, the decoder half of B6 -> (d_feats
    [Np, L*2], dpts [NC, 8, CHUNK] with dL/d dirs in rows 4-6 and zeros
    elsewhere, d_pslab [PSLAB]): the cotangents of the decoder's columns
    under ``g`` [Np, 8] on live chunks, by autograd, from the forward's
    residual ``feats`` [NC, L, 2, CHUNK]. ``lookup_bwd_plain`` on d_feats
    gives the rest of ``train_bwd_plain``: the table gradient and rows 0-2."""
    NC, L = feats.shape[0], feats.shape[1]
    live = (meta[:, :, 2].sum(dim=1) > 0).repeat_interleave(CHUNK)
    with torch.enable_grad():
        f = feats.detach().permute(0, 3, 1, 2).reshape(NC * CHUNK, 2 * L).requires_grad_()
        d = pts[:, 4:7, :].detach().permute(0, 2, 1).reshape(-1, 3).requires_grad_()
        s = pslab.detach().requires_grad_()
        cols = decode_train_rows(s, f, d)
        cols = torch.where(live[:, None], cols, torch.zeros_like(cols))
        d_feats, d_dirs, d_pslab = torch.autograd.grad(cols, (f, d, s), g)
    dpts = torch.zeros_like(pts)
    dpts[:, 4:7, :] = d_dirs.reshape(NC, CHUNK, 3).permute(0, 2, 1)
    return d_feats, dpts, d_pslab


def _check_stream(pts, meta, features, resolutions, pslab, NW):
    dev = pts.device
    NC, L = pts.shape[0], resolutions.shape[0]
    check_tensor("pts", pts, torch.float32, (NC, 8, CHUNK), dev)
    check_tensor("meta", meta, torch.int32, (NC, CHUNK // 128, 4), dev)
    check_tensor("resolutions", resolutions, torch.int32, (L, 3), dev)
    check_tensor("pslab", pslab, torch.float32, (PSLAB,), dev)
    check_tensor("features", features, torch.float32, (L, features.shape[1]), dev)
    if features.shape[1] != NW * W * 2 or L != 16:
        raise ValueError(f"features {tuple(features.shape)}: want [16, {NW * W * 2}] "
                         "(training tables are f32, 16 levels)")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(name, argtypes):
    f = getattr(_build.load("fused_train"), name)
    f.restype = ctypes.c_int
    f.argtypes = argtypes
    return f



def train_fwd(pts, meta, features, resolutions, pslab, NW: int, want_feats: bool = True):
    """B5 wrapper -> (cols [Np, 8], feats [NC, L, 2, CHUNK] or None). CPU
    tensors take ``train_fwd_plain``; CUDA tensors launch the kernel."""
    if pts.device.type == "cpu":
        cols, feats = train_fwd_plain(pts, meta, features, resolutions, pslab, NW)
        return cols, feats if want_feats else None
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check_stream(pts, meta, features, resolutions, pslab, NW)
    NC, L = pts.shape[0], resolutions.shape[0]
    cols = torch.empty((NC * CHUNK, 8), dtype=torch.float32, device=pts.device)
    feats = torch.empty((NC, L, 2, CHUNK), dtype=torch.float32, device=pts.device) \
        if want_feats else None
    f = _fn("scanerf_train_fwd", [_P, _P, _P, _LL, _I, _P, _P, _I, _I, _P, _P, _P])
    P = _build.ptr
    err = f(P(pts), P(meta), P(features), features.shape[1], L, P(resolutions), P(pslab),
            NW, NC, P(cols), P(feats) if want_feats else None, _build.stream_ptr(pts))
    _build.check(err, "scanerf_train_fwd")
    train_fwd.launches += 1
    return cols, feats


train_fwd.launches = 0


def decoder_bwd(pts, meta, pslab, feats, g):
    """Launch B6a, the decoder half of B6, on CUDA tensors -> (d_feats
    [NC, L*2, CHUNK] (live chunks only: dead chunks' are not written),
    dpts [NC, 8, CHUNK] with rows 3-7 written, d_pslab [PSLAB]). Counts no
    launch: ``train_bwd`` does."""
    NC, L = pts.shape[0], feats.shape[1]
    check_tensor("pts", pts, torch.float32, (NC, 8, CHUNK), pts.device)
    check_tensor("meta", meta, torch.int32, (NC, CHUNK // 128, 4), pts.device)
    check_tensor("pslab", pslab, torch.float32, (PSLAB,), pts.device)
    check_tensor("feats", feats, torch.float32, (NC, L, 2, CHUNK), pts.device)
    check_tensor("g", g, torch.float32, (NC * CHUNK, 8), pts.device)
    dpts = torch.empty_like(pts)
    d_feats = torch.empty((NC, 2 * L, CHUNK), dtype=torch.float32, device=pts.device)
    d_pslab = torch.zeros_like(pslab)
    f = _fn("scanerf_train_bwd", [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P])
    P = _build.ptr
    err = f(P(pts), P(meta), P(pslab), P(feats), P(g), L, NC, P(d_feats), P(dpts),
            P(d_pslab), _build.stream_ptr(pts))
    _build.check(err, "scanerf_train_bwd")
    return d_feats, dpts, d_pslab


def train_bwd(pts, meta, features, resolutions, pslab, feats, g, NW: int, adds=None,
              bwd_bf16: bool = False):
    """B6 wrapper -> (dpts [NC, 8, CHUNK], d_features [L, H*2], d_pslab
    [PSLAB]). CPU tensors take ``train_bwd_plain``; CUDA tensors launch
    B6a (``decoder_bwd``), then B4's kernel for the table gradient and
    dL/du (``hash_encode.scatter_bwd``, in its bf16 mode with
    ``bwd_bf16``; ``adds``: see there)."""
    if pts.device.type == "cpu":
        return train_bwd_plain(pts, meta, features, resolutions, pslab, feats, g, NW,
                               bwd_bf16)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check_stream(pts, meta, features, resolutions, pslab, NW)
    d_feats, dpts, d_pslab = decoder_bwd(pts, meta, pslab, feats, g)
    d_features = scatter_bwd(pts, meta, features, resolutions, d_feats, NW, dpts, 3, adds,
                             g_layout="chunks", mode="bf16" if bwd_bf16 else "exact")
    train_bwd.launches += 1
    return dpts, d_features, d_pslab


train_bwd.launches = 0


class _HashDecodeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, meta, features, resolutions, pslab, bwd_bf16):
        NW = features.shape[1] // (2 * W)
        cols, feats = train_fwd(pts, meta, features, resolutions, pslab, NW)
        ctx.save_for_backward(pts, meta, features, resolutions, pslab, feats)
        ctx.nw, ctx.bwd_bf16 = NW, bwd_bf16
        return cols

    @staticmethod
    def backward(ctx, g):
        pts, meta, features, resolutions, pslab, feats = ctx.saved_tensors
        dpts, d_features, d_pslab = train_bwd(pts, meta, features, resolutions, pslab,
                                              feats, g.contiguous(), ctx.nw,
                                              bwd_bf16=ctx.bwd_bf16)
        return dpts, None, d_features, None, d_pslab, None


def hash_decode_train(pts, meta, features, resolutions, pslab,
                      bwd_bf16: bool = False) -> torch.Tensor:
    """Fused lookup + decode of a padded sorted stream (one table, flat
    [L, H*2] f32) -> cols [Np, 8], differentiable in pts (rows 0-2 and
    4-6), the table and the slab from ``pack_train_slab``; ``bwd_bf16``
    rounds the table gradient's contributions to bf16 (the JAX
    ``onehot_bf16``). Unlike the JAX function it takes no ``visited``
    blocks: the scatter into a zeroed gradient leaves unvisited blocks
    zero by itself."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (pts, features, pslab)):
        return _HashDecodeTrain.apply(pts, meta, features, resolutions, pslab, bwd_bf16)
    NW = features.shape[1] // (2 * W)
    return train_fwd(pts, meta, features, resolutions, pslab, NW, want_feats=False)[0]
