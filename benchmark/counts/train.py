"""Operation and byte counts of the training step, from its sizes alone.

``step_flops`` is the model's operation count of one full-recipe step, in
the usual MFU sense (index arithmetic is not useful work): per point the
hash encode (8 corners x ~20 operations a level) and the ShallowMLP
(2 * in * out a product, ~300 for the activations), three times for the
points that are trained (forward and a backward of twice the forward),
once for the warp loss's no-grad re-render along the top-k neighbour
rays, ~60 a point for the composite and losses, and Adam's three passes
over the table.

``backward_work`` is what the backward's decode has to do, whatever
kernels do it: the decoder's pullback (twice its forward) on every live
row of the main stream, each row's 32 bytes read once, and every table
entry those rows touch written once to the gradient.
"""

from benchmark.counts import peaks

DECODER_FWD = (2 * 32 * 64 + 2 * 64 * 64 + 2 * 32 * 8
               + 2 * 48 * 64 + 2 * 64 * 64 + 2 * 64 * 8 + 300)
HASH_FWD_PER_LEVEL = 160
ROW_BYTES = 32  # a stream row: position, window, direction, pad (8 x f32)


def step_flops(batch: int, num_sample: int, num_bg_sample: int, levels: int, log2_table: int,
               warp_top_k: int, warp_vis: tuple, features: int = 2) -> dict:
    """Itemised operations of one step and their total."""
    n_main = batch * (num_sample + num_bg_sample)
    n_vis = batch * warp_top_k * (warp_vis[0] + warp_vis[1])
    hash_fwd = HASH_FWD_PER_LEVEL * levels
    items = {
        "hash_main": n_main * hash_fwd * 3,
        "decoder_main": n_main * DECODER_FWD * 3,
        "hash_vis": n_vis * hash_fwd,
        "decoder_vis": n_vis * DECODER_FWD,
        "composite": n_main * 60,
        "adam": 3 * levels * 2**log2_table * features * 4,
    }
    return {"items": items, "total": float(sum(items.values()))}


def backward_work(rows: int, touched_entries: int, features: int = 2) -> dict:
    """(operations, bytes, least seconds) of the backward's decode."""
    ops = 2.0 * DECODER_FWD * rows
    nbytes = float(rows * ROW_BYTES + touched_entries * features * 4)
    return {"ops": ops, "bytes": nbytes,
            "min_s": max(ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)}
