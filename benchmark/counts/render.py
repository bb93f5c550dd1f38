"""Operation and byte counts of a rendered frame, from the rows its rays
need: one row for each (fg sample, containing tile) whose cell is
occupied on a ray that meets occupied cells, and one for each (bg sample,
exit tile with a non-zero blend weight).

A row's model operations are the hash encode's (8 corners x ~20 a level)
and the ShallowMLP forward's (2 * in * out a product, ~300 for the
activations). The decode's least time takes those operations at the
TF32 peak and, at the memory's, each row's 32 bytes read once, its 4
output columns written once and every table entry the rows touch read
once.
"""

from benchmark.counts import peaks
from benchmark.counts.train import DECODER_FWD, HASH_FWD_PER_LEVEL, ROW_BYTES


def row_flops(levels: int) -> int:
    return HASH_FWD_PER_LEVEL * levels + DECODER_FWD


def decode_work(rows: int, touched_entries: int, levels: int, features: int = 2) -> dict:
    """(operations, bytes, least seconds) of decoding ``rows`` rows."""
    ops = float(rows * row_flops(levels))
    nbytes = float(rows * (ROW_BYTES + 4 * 4) + touched_entries * features * 4)
    return {"ops": ops, "bytes": nbytes,
            "min_s": max(ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)}
