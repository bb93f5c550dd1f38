"""B7: fused windowed hash lookup + ShallowMLP decode over the sorted stream.

Replaces the Pallas kernel ``scanerf_tpu/ops/pallas/fused_render.py::_fused_kernel``
(launched by ``hash_decode_fused``, fused_render.py:303). For every
stream row the CUDA kernel (``csrc/fused_render.cu``) gathers 16 levels x
8 corners x 2 features from the flat [L, T*H*2] tables (f32 or bf16,
widened to f32) and runs the whole ShallowMLP; only (sigma, diffuse +
tint*specular) reach device memory. One block of 16 warps an SM walks the
chunks; each warp decodes 16 rows at a time with its activations in
registers: the four large layers on the tensor cores in 3xTF32 (about
f32's accuracy), the narrow heads on the CUDA cores, with the decoder slab
of the chunk's tile (chunk tile ids are non-decreasing along the stream,
so a block restages the slab only when the tile changes); chunks whose
rows are all sentinels write zeros and do no work.

What bounds it on the H100: the tensor-core products set the floor;
feeding the tensor cores and the table gathers' L2 latency (they stay
inside one 2 MB block of windows per chunk) set the time, and warps that
share no barrier overlap one's gather with the others' products. The
output is the reference's: rows of live chunks with the sentinel window
get the decoder of zero features; the view direction is normalized as
``apply_decoder`` does, d / (|d| + 1e-8).
"""

from __future__ import annotations

import ctypes

import torch

from scanerf_tpu_torch import _build
from scanerf_tpu_torch.models import decoder as decoder_lib
from scanerf_tpu_torch.ops.kernels.hash_encode import CHUNK, W, lookup_fwd_plain

# decoder slab layout (f32 offsets; every matrix row-major [out, in]).
# Mirrored in csrc/decoder.cuh.
SP0_W, SP1_W, HEAD_W, DIR0_W, DIR1_W, DIR2_W = 0, 2048, 6144, 6400, 9472, 13568
B_SP0, B_SP1, B_HEAD, B_DIR0, B_DIR1, B_DIR2 = 13824, 13888, 13952, 13960, 14024, 14088
PSLAB = 14092


def pack_decoder_slabs(decoders: dict) -> torch.Tensor:
    """Stacked decoder params (leaves [T, ...]) -> [T, PSLAB] f32 slabs."""
    T = decoders["spatial0"]["w"].shape[0]
    dev = decoders["spatial0"]["w"].device
    slab = torch.zeros((T, PSLAB), dtype=torch.float32, device=dev)

    def put_w(off, w):  # w [T, in, out] -> rows [out, in] at off
        wt = w.transpose(1, 2).reshape(T, -1)
        slab[:, off:off + wt.shape[1]] = wt

    def put_b(off, b):
        slab[:, off:off + b.shape[1]] = b

    d = decoders
    put_w(SP0_W, d["spatial0"]["w"])
    put_w(SP1_W, d["spatial1"]["w"])
    put_w(HEAD_W, torch.cat([d["sigma"]["w"], d["diffuse"]["w"], d["tint"]["w"]], 2))
    put_w(DIR0_W, d["dir0"]["w"])
    put_w(DIR1_W, d["dir1"]["w"])
    put_w(DIR2_W, d["dir2"]["w"])
    put_b(B_SP0, d["spatial0"]["b"])
    put_b(B_SP1, d["spatial1"]["b"])
    put_b(B_HEAD, torch.cat([d["sigma"]["b"], d["diffuse"]["b"], d["tint"]["b"]], 1))
    put_b(B_DIR0, d["dir0"]["b"])
    put_b(B_DIR1, d["dir1"]["b"])
    put_b(B_DIR2, d["dir2"]["b"])
    return slab


def hash_decode_fused_plain(stream, chunk_tids, features, resolutions,
                            decoders, NW: int) -> torch.Tensor:
    """Plain PyTorch version of B7 -> [Np, 4] (sigma, premultiplied rgb).

    ``decoders`` is the stacked param dict (leaves [T, ...]); ``NW`` the
    window count of the stacked tables (the sentinel window id)."""
    NC = stream.pts.shape[0]
    feats = lookup_fwd_plain(stream.pts, features, resolutions, NW)
    dirs = stream.pts[:, 4:7, :].permute(0, 2, 1)  # [NC, CHUNK, 3]
    tid = chunk_tids.to(torch.int64)
    dec = {name: {"w": p["w"][tid], "b": p["b"][tid][:, None, :]}
           for name, p in decoders.items()}
    out = decoder_lib.apply_decoder(dec, feats.reshape(NC, CHUNK, -1), dirs)
    cols = torch.cat([out["sigma"], out["diffuse"] + out["tint"] * out["specular"]], -1)
    live = stream.meta[:, :, 2].sum(dim=1) > 0  # chunks with real rows
    cols = torch.where(live[:, None, None], cols, torch.zeros_like(cols))
    return cols.reshape(NC * CHUNK, 4)


def _fn():
    f = _build.load("fused_render").scanerf_fused_render
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
    return f


def hash_decode_fused(stream, chunk_tids, features, resolutions, decoders,
                      NW: int, slabs=None) -> torch.Tensor:
    """B7 wrapper -> [Np, 4]. CPU tensors take ``hash_decode_fused_plain``;
    CUDA tensors launch the kernel, which needs ``slabs`` from
    ``pack_decoder_slabs(decoders)`` (``MultiTileScene.dec_slabs``).

    features: flat [L, T*H*2] f32 or bf16 table stack; resolutions [L, 3];
    chunk_tids [NC] tile id of each chunk."""
    pts = stream.pts
    if pts.device.type == "cpu":
        return hash_decode_fused_plain(stream, chunk_tids, features,
                                       resolutions, decoders, NW)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    NC = pts.shape[0]
    L = features.shape[0]
    if slabs is None:
        raise ValueError("the CUDA kernel needs slabs=pack_decoder_slabs(decoders)")
    checks = (
        ("pts", pts, torch.float32, (NC, 8, CHUNK)),
        ("meta", stream.meta, torch.int32, (NC, CHUNK // 128, 4)),
        ("chunk_tids", chunk_tids, torch.int32, (NC,)),
        ("resolutions", resolutions, torch.int32, (L, 3)),
        ("slabs", slabs, torch.float32, (slabs.shape[0], PSLAB)),
    )
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != pts.device:
            raise ValueError(f"{name}: want contiguous {dt} {shape} on {pts.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if features.dtype not in (torch.float32, torch.bfloat16) or features.ndim != 2 \
            or not features.is_contiguous() or features.device != pts.device:
        raise ValueError("features must be a contiguous flat [L, T*H*2] f32/bf16 "
                         "table stack on the stream's device")
    if features.shape[1] < NW * W * 2 or L > 16:
        raise ValueError(f"features {tuple(features.shape)} too small for {NW} "
                         "windows, or more than 16 levels")
    out = torch.empty((NC * CHUNK, 4), dtype=torch.float32, device=pts.device)
    P = _build.ptr
    err = _fn()(P(pts), P(stream.meta), P(chunk_tids), P(features),
                int(features.dtype == torch.bfloat16), features.shape[1], L,
                P(resolutions), P(slabs), NW, NC, P(out),
                _build.stream_ptr(pts))
    _build.check(err, "scanerf_fused_render")
    hash_decode_fused.launches += 1
    return out


hash_decode_fused.launches = 0
