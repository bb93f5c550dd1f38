"""The staging geometry of the port's hash lookup kernel B3
(``csrc/hash_encode.cu``), emulated in torch on the CPU, where the kernel
cannot run.

A block of B3 takes 512 rows of a chunk. From ``meta`` it takes the window
span [wlo, whi] of those rows' subtiles, and level by level copies the
span's windows into shared memory in passes of a few windows; each row
whose window a pass holds gathers its 8 corners at their offsets in the
staged copy. The emulation does the same with tensor slices and is held
against the JAX package's windowed lookup on a small table in which
chunks span 1, 2 and more windows than one pass holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.ops.hash_encode import make_level_resolutions
from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu_torch.ops.kernels import hash_encode as thw

H = 2**14  # 32 windows: one block
L = 16
BLOCK_ROWS = 512  # rows a block of B3 takes
WCAP = 4  # windows a staged pass holds (FWD_WCAP)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def staged_lookup(pts, meta, features, res, NW):
    """B3's passes: per block of 512 rows, the window span from meta, per
    level and pass the staged windows, each row gathered at its offset in
    them -> (feats [Np, L*2], (windows, passes) per block)."""
    f3 = features.reshape(L, NW * thw.W, 2)
    u, wid, real = thw._stream_rows(pts, NW)
    feats = torch.zeros((u.shape[0], 2 * L))
    passes = []
    for r0 in range(0, u.shape[0], BLOCK_ROWS):
        m = meta.reshape(-1, 4)[r0 // 128:(r0 + BLOCK_ROWS) // 128]
        live = m[:, 2] > 0
        if not live.any():
            passes.append((0, 0))
            continue
        wlo = int(m[live, 1].min())
        whi = int((m[live, 1] + m[live, 2] - 1).max())
        rows = slice(r0, r0 + BLOCK_ROWS)
        w = wid[rows]
        assert ((w >= wlo) & (w <= whi) | ~real[rows]).all(), "a real row outside its span"
        passes.append((whi - wlo + 1, -(-(whi - wlo + 1) // WCAP)))
        for lvl in range(L):
            idx, fac = thw._level_corners(u[rows], w, res[lvl])  # global entries [R, 8]
            wgt = torch.prod(fac, dim=-1)
            for wb in range(wlo, whi + 1, WCAP):
                n = min(WCAP, whi - wb + 1)
                staged = f3[lvl, wb * thw.W:(wb + n) * thw.W]  # the pass's copy
                mine = real[rows] & (w >= wb) & (w < wb + n)
                off = idx[mine] - wb * thw.W  # the corners' offsets in the copy
                assert ((off >= 0) & (off < n * thw.W)).all()
                pair = (wgt[mine][..., None] * staged[off].float()).sum(dim=1)
                feats[r0 + torch.nonzero(mine)[:, 0], 2 * lvl:2 * lvl + 2] = pair
    return feats, passes


def _stream(seed):
    """Points whose window-sorted stream has blocks of 512 rows in one
    window and in two, blocks spanning 12 and 14 windows (3 and 4 passes),
    and a part-filled last chunk; the stream, the points and a random
    table."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, (60000, 3)).astype(np.float32)
    wid = thw.window_id(torch.from_numpy((x + 2.0) * 0.25), H).numpy()
    take = [(1, 1024), (3, 256), (4, 768)] + [(w, 46) for w in range(6, 28)] + [(30, 100)]
    pick = np.concatenate([np.nonzero(wid == w)[0][:n] for w, n in take])
    x = x[rng.permutation(pick)]
    st = thw.sort_pack_tables(torch.from_numpy(x), torch.zeros_like(torch.from_numpy(x)),
                              torch.zeros(len(x), dtype=torch.int32), H, 1)
    feats = (rng.standard_normal((L, H * 2)) * 0.5).astype(np.float32)
    return st, x, feats


def test_staged_lookup_matches_jax():
    """f32 table: every real row's features, gathered pass by pass from the
    staged windows, equal the JAX windowed lookup within 1e-6; blocks span
    1, 2, 12 and 14 windows (1, 1, 3 and 4 passes); pad rows are zero."""
    st, x, feats = _stream(0)
    res = make_level_resolutions([16] * 3, [512] * 3, L)
    NW = H // thw.W
    got, passes = staged_lookup(st.pts, st.meta, torch.from_numpy(feats),
                                torch.from_numpy(res), NW)
    assert {(1, 1), (2, 1), (12, 3), (14, 4)} <= set(passes), passes
    ref = jax.jit(jhw.hash_encode_windowed_ref)(jnp.asarray(x), jnp.asarray(feats),
                                                jnp.asarray(res))
    N = len(x)
    mine = thw.unsort_rows(got, st.pidp, N)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert not got[st.pidp == N].any()
    # and the plain version of B3 on the same stream
    plain = thw.lookup_fwd_plain(st.pts, torch.from_numpy(feats), torch.from_numpy(res), NW)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6)
