"""The CDF inversion of the port's sampler kernel B1 (``csrc/sampler.cu``),
emulated step for step in numpy on the CPU, where the kernel cannot run.

For each CDF value cum[m] the kernel finds J(m), the least quantile j with
cum[m] <= s_j (S if none), by a binary search of a fixed number of steps;
it counts the J in a histogram and takes the histogram's inclusive prefix
sum as k_j = #{m : cum[m] <= s_j}. The emulation is held bit for bit
against the plain sampler (``sample_plain``) and the JAX package's XLA
branch, including a ray with total 0 and quantiles that tie a CDF value,
and against the plain count on a hand-made cum array that dips by an ulp
at a block boundary of the blocked scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanerf_tpu.ops import sampling as jsampling
from scanerf_tpu_torch.ops import sampling as tsampling
from scanerf_tpu_torch.ops.intersect import ray_aabb
from scanerf_tpu_torch.ops.kernels.sampler import blocked_cumsum, linspace01

F32 = np.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run (the suite runs on
    several workers at once), and the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def merge_counts(cum, total, S):
    """k [N, S] = #{m : cum[m] <= s_j}, s_j = f32(j) * f32(total / S), as the
    kernel computes it: where step is finite and >= 0, J(m) by a binary
    search over j of bit_length(S) steps, a histogram of J and its
    inclusive prefix sum; elsewhere every quantile against every value."""
    cum = np.asarray(cum, F32)
    step = (np.asarray(total, F32) / F32(S)).astype(F32)
    k = np.empty((cum.shape[0], S), np.int64)
    for i, (c, st) in enumerate(zip(cum, step)):
        s = (np.arange(S, dtype=F32) * st).astype(F32)
        if not (st >= 0 and np.isfinite(st)):
            k[i] = (c[None, :] <= s[:, None]).sum(-1)
            continue
        lo = np.zeros(c.shape, np.int64)
        hi = np.full(c.shape, S, np.int64)
        for _ in range(S.bit_length()):
            mid = (lo + hi) >> 1
            go = lo < hi
            le = c <= (mid.astype(F32) * st).astype(F32)
            hi = np.where(go & le, mid, hi)
            lo = np.where(go & ~le, mid + 1, lo)
        k[i] = np.cumsum(np.bincount(lo[lo < S], minlength=S))
    return k


def merge_z(cum, total, t_near, t_far, S, M):
    """z [N, S] from the counts, with the kernel's (and the plain
    version's) roundings: left = tn + span * frac[k], z = left + (s - cum[k-1])."""
    k = np.minimum(merge_counts(cum, total, S), M - 1)
    step = (np.asarray(total, F32) / F32(S)).astype(F32)
    s = (np.arange(S, dtype=F32)[None, :] * step[:, None]).astype(F32)
    frac = linspace01(M + 1, "cpu").numpy()
    before = np.where(k > 0, np.take_along_axis(cum, np.maximum(k - 1, 0), 1), F32(0))
    span = (t_far - t_near).astype(F32)
    left = (t_near[:, None] + (span[:, None] * frac[k]).astype(F32)).astype(F32)
    return (left + (s - before).astype(F32)).astype(F32)


def plain_cum(o, d, tn, tf, grid, corner, size, M):
    """The plain sampler's cum array [N, M] (its march and blocked scan)."""
    t = [torch.from_numpy(a) for a in (o, d, tn, tf, corner, size)]
    o_t, d_t, tn_t, tf_t, c_t, s_t = t
    frac = linspace01(M + 1, "cpu")
    edges = tn_t[:, None] + (tf_t - tn_t)[:, None] * frac[None, :]
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    occ = tsampling.occupancy_lookup(o_t[:, None, :] + mids[..., None] * d_t[:, None, :],
                                     torch.from_numpy(grid), c_t, s_t)
    seg = (tf_t - tn_t)[:, None] / M
    return blocked_cumsum(torch.where(occ, seg, torch.zeros_like(seg))).numpy()


def both_samplers(o, d, tn, tf, S, grid, corner, size, M):
    """z and totals of the plain sampler and of the JAX XLA branch, op by
    op (under jit XLA sums the scan in another order)."""
    zt, tott = tsampling.cdf_sample_from_bounds(
        *(torch.from_numpy(a) for a in (o, d, tn, tf)), S, torch.from_numpy(grid),
        torch.from_numpy(corner), torch.from_numpy(size), M)
    zj, totj = jsampling.cdf_sample_from_bounds(
        *(jnp.asarray(a) for a in (o, d, tn, tf)), S, jnp.asarray(grid),
        jnp.asarray(corner), jnp.asarray(size), M, backend="xla")
    return (zt.numpy(), tott.numpy()), (np.asarray(zj), np.asarray(totj))


def test_merge_counts_ulp_dip_at_block_boundary():
    """A cum array that dips by an ulp from m = 15 to m = 16 (the first
    value of the scan's second block of 16): where s_8 falls on the dipped
    value, m = 16 counts and m = 15 does not, as in the plain count; a
    search that assumed cum sorted would stop at m = 15."""
    M, S = 48, 16
    cum = np.empty(M, F32)
    cum[:15] = (np.arange(1, 16) * 0.03125).astype(F32)
    cum[15] = F32(0.5)
    cum[16] = np.nextafter(F32(0.5), F32(0))
    total = np.nextafter(F32(1.0), F32(0))
    cum[17:] = np.linspace(0.52, float(total), M - 17).astype(F32)
    cum[-1] = total
    s = (np.arange(S, dtype=F32) * (total / F32(S)).astype(F32)).astype(F32)
    assert s[8] == cum[16] < cum[15]
    plain = (torch.from_numpy(cum)[None, None, :] <= torch.from_numpy(s)[None, :, None]).sum(-1)
    got = merge_counts(cum[None], np.array([total]), S)
    np.testing.assert_array_equal(got, plain.numpy())
    assert got[0, 8] == 16  # m = 0..14 and m = 16


@pytest.mark.parametrize("S,M", [(12, 32), (7, 300)])
def test_merge_matches_plain_and_xla(S, M):
    """Random rays through a random grid (M = 300: no power of two, two
    levels of block totals), one ray that misses it (total 0: every J is
    0, k clips to M - 1) and one along a line of occupied cells with span
    1, where at M = 32 cum[m] = (m + 1) / 32 and the quantiles j = 3, 6, 9
    of S = 12 tie cum values exactly: the emulated kernel's z and totals
    equal the plain sampler's and the XLA branch's bit for bit."""
    rng = np.random.RandomState(S + M)
    grid = rng.rand(16, 12, 20) < 0.35
    grid[:, 6, 10] = True  # the cells of the line x in [-1, 1], y = 0, z = 0
    corner = np.array([-1.0, -1.2, -0.8], F32)
    size = np.array([2.0, 2.4, 1.6], F32)
    o = rng.normal(0, 1.0, (64, 3)).astype(F32)
    d = rng.normal(0, 1.0, (64, 3)).astype(F32)
    b = ray_aabb(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(corner + size / 2),
                 torch.from_numpy(size / 2)).numpy()
    hit = b[:, 0] != -1
    tn = np.where(hit, b[:, 0], 0).astype(F32)
    tf = np.where(hit, b[:, 1], 1).astype(F32)
    o[62], d[62], tn[62], tf[62] = (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), 0.5, 1.5
    o[63], d[63], tn[63], tf[63] = (5.0, 5.0, 5.0), (1.0, 0.0, 0.0), 0.0, 1.0
    cum = plain_cum(o, d, tn, tf, grid, corner, size, M)
    total = cum[:, -1]
    assert total[63] == 0 and (total > 0).sum() > 5
    if M == 32:
        s = (np.arange(S, dtype=F32) * (total[62] / F32(S))).astype(F32)
        assert total[62] == 1 and np.isin(s[[3, 6, 9]], cum[62]).all()
    z = merge_z(cum, total, tn, tf, S, M)
    (zt, tott), (zj, totj) = both_samplers(o, d, tn, tf, S, grid, corner, size, M)
    np.testing.assert_array_equal(total, tott)
    np.testing.assert_array_equal(tott, totj)
    np.testing.assert_array_equal(z, zt)
    np.testing.assert_array_equal(z, zj)
