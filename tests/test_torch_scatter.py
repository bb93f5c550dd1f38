"""The redesigned B4 and B6 of the port (scanerf_tpu_torch) on the CPU:
what their CUDA versions rely on, held with plain PyTorch and numpy.

(a) The per-chunk scatter sums a chunk's table gradient in a shared slab
    that covers the windows ``meta`` gives the chunk, so every real row of
    a chunk must lie in them; the port's meta must equal the JAX package's
    for the same stream.
(b) B6 is the decoder backward (B6a) followed by B4's scatter; the plain
    composition equals ``train_bwd_plain``.
(c) B6a's products run on the tensor cores split into three TF32
    products (3xTF32), because one TF32 product cannot meet the checks
    against the plain version.

Each test takes well under a second; each tolerance is stated where it is
used.
"""

import jax
import numpy as np
import pytest
import torch

from scanerf_tpu.ops.pallas import hash_encode as jhw
from scanerf_tpu_torch.ops.kernels import fused_train as tft
from scanerf_tpu_torch.ops.kernels import hash_encode as thw

H = 2**14
_j_stream_meta = jax.jit(jhw._stream_meta, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, N, T, dead_share):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(N, 3) * 4 - 2).astype(np.float32))
    dirs = torch.from_numpy(rng.randn(N, 3).astype(np.float32))
    tids = torch.from_numpy(rng.randint(0, T, N).astype(np.int32))
    dead = torch.from_numpy(rng.rand(N) < dead_share) if dead_share else None
    return thw.sort_pack_tables(x, dirs, tids, H, T, dead=dead)


@pytest.mark.parametrize("T,dead_share", [(1, 0.0), (3, 0.0), (2, 0.4)],
                         ids=["one_table", "three_tables", "dead_rows"])
def test_meta_bounds_every_real_row(T, dead_share):
    """(a) every real row of chunk c lies in block meta[c, 0, 0] and in
    [wmin, wmin + span) of its subtile; all-sentinel subtiles have span 0;
    meta equals the JAX ``_stream_meta`` of the same stream (exact)."""
    st = _stream(T, 900, T, dead_share)
    NW = thw.geometry(H)[0] * T
    NC = st.pts.shape[0]
    np.testing.assert_array_equal(
        st.meta.numpy(), np.asarray(_j_stream_meta(st.pts.numpy(), NC, NW)))
    wid = st.pts[:, 3, :].to(torch.int64).reshape(NC, thw.SUBT, 128)
    real = wid < NW
    wmin, span = st.meta[:, :, 1:2].long(), st.meta[:, :, 2:3].long()
    assert bool(((wid >= wmin) & (wid < wmin + span))[real].all())
    assert bool((st.meta[:, :, 2][~real.any(dim=2)] == 0).all())
    block = st.meta[:, 0:1, 0:1].long()
    assert bool((wid // thw.WB == block)[real].all())
    assert int(real.sum()) > 0 and int((~real).sum()) > 0


def test_split_b6_plain_composition():
    """(b) the plain decoder backward, then ``lookup_bwd_plain`` on its
    feature cotangent, with dpts rows 0-2 from the lookup and 3-7 from
    the decoder, gives ``train_bwd_plain``'s table, dpts and slab
    gradients within 1e-6 relative L2 (the same f32 arithmetic in
    another order: the table gradient by index_add, not by autograd)."""
    st = _stream(7, 600, 1, 0.3)
    NW = thw.geometry(H)[0]
    rng = np.random.default_rng(7)
    table = torch.tensor(rng.standard_normal((16, H * 2)) * 0.5, dtype=torch.float32)
    res = torch.tensor(np.repeat(np.geomspace(16, 512, 16).astype(np.int32)[:, None], 3, 1))
    pslab = torch.tensor(rng.uniform(-0.3, 0.3, tft.PSLAB), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((st.pts.shape[0] * thw.CHUNK, 8)),
                     dtype=torch.float32)
    _, feats = tft.train_fwd_plain(st.pts, st.meta, table, res, pslab, NW)
    dpts_ref, dtab_ref, dslab_ref = tft.train_bwd_plain(st.pts, st.meta, table, res, pslab,
                                                        feats, g, NW)
    d_feats, dpts_dec, dslab = tft.decoder_bwd_plain(st.pts, st.meta, pslab, feats, g)
    dpts_lu, dtab = thw.lookup_bwd_plain(st.pts, table, res, d_feats, NW)
    dpts = torch.cat([dpts_lu[:, 0:3], dpts_dec[:, 3:8]], dim=1)
    for name, a, b in (("dtab", dtab, dtab_ref), ("dpts", dpts, dpts_ref),
                       ("dslab", dslab, dslab_ref)):
        assert float(b.norm()) > 0, name
        rel = float((a.double() - b.double()).norm() / b.double().norm())
        assert rel <= 1e-6, (name, rel)
    assert not dpts_dec[:, 0:4].any() and not dpts_dec[:, 7].any()


def _tf32(x, nearest=True):
    """f32 to TF32 (10 stored mantissa bits): to nearest, ties away from
    zero (cvt.rna.tf32.f32, and B6a's integer rounding of hi), or toward
    zero (what the tensor core reads of an f32 register, B6a's lo)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        b = b + np.uint32(0x1000)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("fan_in", [32, 64, 48])
def test_tf32_split_product(fan_in):
    """(c) on a 64-row tile of each of B6a's tensor-core layers (fan_in
    -> 64), in all three roles (forward, input cotangent, weight gradient),
    against f64: three TF32 products of the split x = hi + lo (hi rounded
    to nearest, lo truncated) summed in f32 stay within 1e-6 of the
    largest entry (f32's own rounding), one TF32 product does not stay
    within 1e-4, the checks' tolerance."""
    rng = np.random.default_rng(fan_in)
    X = rng.standard_normal((64, fan_in)).astype(np.float32)
    W = rng.uniform(-fan_in ** -0.5, fan_in ** -0.5, (64, fan_in)).astype(np.float32)
    dY = rng.standard_normal((64, 64)).astype(np.float32)
    for role, a, b in (("forward", X, W.T), ("input cotangent", dY, W),
                       ("weight gradient", dY.T, X)):
        ref = a.astype(np.float64) @ b.astype(np.float64)
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi, nearest=False), _tf32(b - b_hi, nearest=False)
        three = (a_lo @ b_hi) + (a_hi @ b_lo) + (a_hi @ b_hi)
        one = a_hi @ b_hi
        scale = np.abs(ref).max()
        assert np.abs(three - ref).max() <= 1e-6 * scale, role
        assert np.abs(one - ref).max() > 1e-4 * scale, role
