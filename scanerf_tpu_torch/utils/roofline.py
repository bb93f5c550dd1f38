"""Analytic operation and byte accounting of the training step, for a
roofline share (counterpart of ``scanerf_tpu/utils/roofline.py``).

- ``step_cost``: itemised *useful* operations and device-memory bytes of
  one full-recipe training step at a given workload (model operations in
  the usual MFU sense; index arithmetic is not counted as useful work).
  The counts equal the JAX function's for the same arguments, term by
  term. Two byte terms model the JAX package's XLA sorts, not the port's
  ``torch.sort``: "sorts" (log2(n) full passes over the 32-byte stream
  rows, a bitonic sort and the unsort) and the log2(n) in it; "table_slabs"
  counts every window block once per kernel pass, as the TPU kernels copy
  their slabs. They are kept so that one cost model serves both packages.
- ``ideal_time_s``: the least time for it, the larger of operations /
  peak rate and bytes / memory rate;
- ``summarize``: an MFU estimate and the roofline share of a measured
  step time.

Peaks are an NVIDIA H100 SXM's (dense, at its 700 W limit, the data
sheet's; the figures ``chip_smoke.py`` bounds its kernels with): 3.35
TB/s of HBM3, 67 TFLOP/s in f32 on the CUDA cores and 495 TFLOP/s in
TF32 on the tensor cores. The default operation peak is f32's: the
unfused decoder's products run in full f32, and the fused kernels'
3xTF32 products do three tensor-core products for each f32 one.
"""

from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12

# ShallowMLP useful operations per point (2 * in * out per product; the
# spatial 32->64->64 and heads 32->8, the dir (32+16)->64->64->8, and
# about 300 for the activations)
_DEC_FWD_FLOPS = (
    2 * 32 * 64 + 2 * 64 * 64 + 2 * 32 * 8
    + 2 * 48 * 64 + 2 * 64 * 64 + 2 * 64 * 8 + 300
)

# hash encode useful operations per point per level: 8 corners x (hash
# ~6, trilinear weight 3, the 2-feature fma 4, corner coords ~7) = ~160
_HASH_FWD_FLOPS_PER_LEVEL = 160


def step_cost(batch: int = 2**14, num_sample: int = 128, num_bg_sample: int = 128,
              levels: int = 16, log2_hashmap_size: int = 21, warp_top_k: int = 10,
              warp_vis: tuple[int, int] = (16, 8), features: int = 2) -> dict:
    """Itemised (flops, hbm_bytes) of one full-recipe training step."""
    n_main = batch * (num_sample + num_bg_sample)  # forward + backward points
    n_vis = batch * warp_top_k * sum(warp_vis)  # the no-grad re-render's points

    hash_fwd = _HASH_FWD_FLOPS_PER_LEVEL * levels
    dec_fwd = _DEC_FWD_FLOPS
    flops = {
        # the backward ~ 2x the forward (the usual accounting)
        "hash_main": n_main * hash_fwd * 3,
        "decoder_main": n_main * dec_fwd * 3,
        "hash_vis": n_vis * hash_fwd,
        "decoder_vis": n_vis * dec_fwd,
        # compositing / losses: ~60 a point; Adam: 3 passes over the table
        "composite": n_main * 60,
        "adam": 3 * levels * (2**log2_hashmap_size) * features * 4,
    }

    H = 2**log2_hashmap_size
    table_bytes = levels * H * features * 4
    row_bytes = 8 * 4  # one packed stream row (u, wid, dir, pid)
    sort_passes = max(int(n_main).bit_length(), 1)
    bytes_ = {
        # every window block once a kernel pass (forward, backward read,
        # gradient write) for the main stream, forward only for the re-render
        "table_slabs": 4 * table_bytes,
        # stream rows through the pack and the kernels (forward and backward)
        "stream_rows": (2 * n_main + n_vis) * row_bytes,
        # the decode's 8 columns out, the features residual written and read
        "cols_and_residual": n_main * (8 * 4 + 2 * levels * 4 * 2),
        # XLA's sorts: log2(n) passes over the 8 columns (sort and unsort)
        "sorts": 2 * (n_main * row_bytes * sort_passes
                      + n_vis * row_bytes * sort_passes // 2),
        # the optimizer: params and moments read and written
        "adam": table_bytes * 3 * 2,
    }
    return {
        "flops": flops,
        "hbm_bytes": bytes_,
        "flops_total": float(sum(flops.values())),
        "hbm_bytes_total": float(sum(bytes_.values())),
        "points_main": n_main,
        "points_vis": n_vis,
    }


def ideal_time_s(cost: dict, peak_flops: float = H100_F32_FLOPS,
                 hbm_bps: float = H100_HBM_BYTES_PER_S) -> dict:
    """The least time of ``cost`` on a device of these peaks (an H100's
    f32 by default) and which side bounds it."""
    t_f = cost["flops_total"] / peak_flops
    t_b = cost["hbm_bytes_total"] / hbm_bps
    return {"t_flops_s": t_f, "t_bytes_s": t_b, "t_ideal_s": max(t_f, t_b),
            "bound": "bytes" if t_b > t_f else "operations"}


def summarize(step_time_s: float, peak_flops: float = H100_F32_FLOPS, **workload) -> dict:
    """Roofline summary of a measured step time (seconds) on an H100 ->
    a flat JSON-ready dict: the step's Gflop and GB, the MFU estimate
    against ``peak_flops``, the ideal time and the roofline share."""
    cost = step_cost(**workload)
    ideal = ideal_time_s(cost, peak_flops)
    return {
        "flops_g": round(cost["flops_total"] / 1e9, 1),
        "hbm_gb": round(cost["hbm_bytes_total"] / 1e9, 2),
        "mfu_est": round(cost["flops_total"] / (step_time_s * peak_flops), 5),
        "t_ideal_ms": round(ideal["t_ideal_s"] * 1e3, 3),
        "bound": ideal["bound"],
        "roofline_frac": round(ideal["t_ideal_s"] / step_time_s, 4),
        "device": "NVIDIA H100 SXM",
    }
