"""The benchmark's operation and byte counts against hand counts at small
shapes."""

import torch

from benchmark.counts import peaks
from benchmark.counts import render as rc
from benchmark.counts import train as tc
from benchmark.reference import field as F

# ShallowMLP forward by hand: spatial 32->64->64, heads 32->8 (sigma,
# diffuse, tint padded to 8), dir 48->64->64->8, ~300 for the activations
DEC = 2 * (32 * 64 + 64 * 64 + 32 * 8 + 48 * 64 + 64 * 64 + 64 * 8) + 300


def test_decoder_and_hash_per_point():
    assert tc.DECODER_FWD == DEC == 28460
    assert tc.HASH_FWD_PER_LEVEL == 8 * 20


def test_step_flops_by_hand():
    # 4 rays, 2 + 1 samples, 2 levels, a 2^3 table, top-2 neighbours, 1 + 1 re-render samples
    got = tc.step_flops(4, 2, 1, 2, 3, 2, (1, 1))
    n_main, n_vis = 4 * 3, 4 * 2 * 2
    want = {"hash_main": n_main * 320 * 3, "decoder_main": n_main * DEC * 3,
            "hash_vis": n_vis * 320, "decoder_vis": n_vis * DEC, "composite": n_main * 60,
            "adam": 3 * 2 * 8 * 2 * 4}
    assert got["items"] == want
    assert got["total"] == sum(want.values())


def test_backward_and_decode_work_by_hand():
    b = tc.backward_work(rows=10, touched_entries=7)
    assert b["ops"] == 2 * DEC * 10 and b["bytes"] == 10 * 32 + 7 * 2 * 4
    assert b["min_s"] == max(b["ops"] / 495e12, b["bytes"] / 3.35e12)
    d = rc.decode_work(rows=10, touched_entries=7, levels=16)
    assert d["ops"] == 10 * (16 * 160 + DEC) and d["bytes"] == 10 * 48 + 7 * 8
    assert d["min_s"] == max(d["ops"] / peaks.TF32_FLOPS, d["bytes"] / peaks.HBM_BYTES_PER_S)


def test_touched_entries_against_a_set():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((300, 3), generator=g) * 4 - 2
    res = torch.tensor(F.level_resolutions([4] * 3, [64] * 3, 3), dtype=torch.int64)
    H = 2**14
    seen = torch.zeros((3, H), dtype=torch.bool)
    F.mark_touched(x, res, seen)
    u = (x + 2) * 0.25
    wid = F.window_of(u, H)
    for lvl in range(3):
        want = set()
        for i in range(x.shape[0]):
            v = u[i] * (res[lvl].float() - 1)
            b = torch.floor(v).long()
            for c in range(8):
                ix, iy, iz = (int(b[a]) + ((c >> (2 - a)) & 1) for a in range(3))
                h = (ix * F.PRIMES[0] & 0xFFFFFFFF) ^ (iy * F.PRIMES[1] & 0xFFFFFFFF) \
                    ^ (iz * F.PRIMES[2] & 0xFFFFFFFF)
                want.add(int(wid[i]) * 512 + ((h ^ (h >> 9) ^ (h >> 18)) & 511))
        assert int(seen[lvl].sum()) == len(want)
