// B1: fused occupancy-CDF ray sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/sampler.py::_make_kernel
// (launched at sampler.py:240). Computes exactly what the plain PyTorch
// version ops/kernels/sampler.py::sample_plain computes:
//   frac[m] = m * f32(1 / M) for m < M, frac[M] = 1   (linspace01)
//   edges[m] = tn + (tf - tn) * frac[m],  mids = 0.5 * (edges[m] + edges[m+1])
//   occ_len[m] = occupied(o + mid * d) ? (tf - tn) / M : 0
//   cum = inclusive scan of occ_len in XLA's CPU order (blocks of 16)
//   s_j = j * (total / S),  k = #{m : cum[m] <= s_j} clipped to M-1
//   z_j = edges[k] + (s_j - cum[k-1])
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add), so the kernel agrees with the plain version bit for
// bit, ties of a quantile with a CDF value included.
//
// Design: one warp per ray, 4 warps a block. The lanes march the M midpoints
// (stride 32) and read the occupancy grid (one byte a cell, as torch holds a
// bool tensor) through the read-only cache: a ray's lookups are coherent and
// a union grid of ~1 M cells stays in L2. The ray's cum array lives in shared
// memory. frac is computed in the kernel and the grid's box read through the
// caller's own [3] tensors, so a launch needs no tensor but its outputs.
//
// The inversion takes M + S work a ray and is exact by construction. s_j =
// fl(j * step) never decreases in j (j is exact, step >= 0, rounding is
// monotone), so for each m the quantiles with cum[m] <= s_j are exactly the
// j >= J(m), the least such j (S if none), and k_j = #{m : J(m) <= j}: an
// inclusive prefix sum over j of the histogram of J. Each lane finds J of
// its cum values by binary searches over j (bit_length(S) steps, each
// rounding s_j as the plain version does); the lanes of a run of equal J
// add the run's length to the warp's histogram in shared memory with one
// integer atomic (a plateau of equal cum values is one run); a warp scan of
// the histogram gives k. Nothing here needs the cum values in order, so it
// holds where the blocked scan leaves cum non-monotone by an ulp, for ties,
// and for total = 0 (every J is 0, k clips to M - 1). A step that is
// negative, infinite or NaN (t_far < t_near, an overflow) breaks the
// monotonicity: such a ray, warp-uniform, compares every quantile with
// every cum value, as the plain version does. The scan, whose blocks of 16
// each lane adds in order, pads its arrays (one float every 16) so that the
// lanes' blocks lie in distinct banks. What bounds the kernel on the H100
// is its instructions, the march's three IEEE divisions a midpoint (which
// bit-exactness keeps) first: the only device-memory traffic is 32 bytes in
// and 4(S+1) bytes out per ray.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int BLK = 16;  // XLA CPU cumsum block length

// Where element i of a scan array lives: one float of padding after every
// 16, so that the lanes scanning blocks of 16 side by side (lane b reads
// 17b + i) hit distinct banks, where 16b + i would put 16 lanes on a bank.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Floats an array of n takes, padded.
__host__ __device__ inline int padded(int n) { return n + (n >> 4); }

// Floats of scan scratch for an array of n: the levels above 0, padded.
__host__ __device__ inline int scan_levels_size(int n) {
  int total = 0;
  while (n > BLK) {
    n = (n + BLK - 1) / BLK;
    total += padded(n);
  }
  return total;
}

// Blocks of 16 of the padded array lv[0..n), one a lane, each scanned in
// order (elements loaded first, added in registers, stored); each block's
// total into nx[pad(b)]. Past n a block reads zeros, which add nothing.
__device__ __forceinline__ void scan_blocks(float* lv, int n, float* nx, int lane) {
  for (int b = lane; b * BLK < n; b += 32) {
    const int i0 = b * BLK;
    float v[BLK];
#pragma unroll
    for (int i = 0; i < BLK; ++i) v[i] = i0 + i < n ? lv[pad(i0 + i)] : 0.f;
#pragma unroll
    for (int i = 1; i < BLK; ++i) v[i] = __fadd_rn(v[i - 1], v[i]);
#pragma unroll
    for (int i = 0; i < BLK; ++i)
      if (i0 + i < n) lv[pad(i0 + i)] = v[i];
    if (nx) nx[pad(b)] = v[BLK - 1];
  }
}

// In-place inclusive scan of the padded array a[0..n) by one warp, in XLA's
// CPU order: sequential inside blocks of 16, the block totals scanned the
// same way (level by level into up, until one block is left), then every
// element of block k >= 1 gets the inclusive total of blocks 0..k-1 added,
// level by level back down.
__device__ void xla_scan(float* a, int n, float* up, int lane) {
  int depth = 0, m = n;
  float *lv = a, *nx = up;
  for (; m > BLK; ++depth) {
    scan_blocks(lv, m, nx, lane);
    __syncwarp();
    lv = nx;
    nx += padded((m + BLK - 1) / BLK);
    m = (m + BLK - 1) / BLK;
  }
  if (lane == 0) scan_blocks(lv, m, nullptr, 0);
  __syncwarp();
  for (int d = depth - 1; d >= 0; --d) {
    // level d (size m) and its block totals, level d + 1
    lv = a;
    nx = up;
    m = n;
    for (int e = 0; e < d; ++e) {
      lv = nx;
      nx += padded((m + BLK - 1) / BLK);
      m = (m + BLK - 1) / BLK;
    }
    for (int i = BLK + lane; i < m; i += 32)
      lv[pad(i)] = __fadd_rn(lv[pad(i)], nx[pad(i / BLK - 1)]);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(WARPS * 32)
sample_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              const float* __restrict__ t_near, const float* __restrict__ t_far,
              const uint8_t* __restrict__ grid, const float* __restrict__ corner,
              const float* __restrict__ size, float inv_m, int rx, int ry, int rz, int N,
              int S, int M, float* __restrict__ z_out, float* __restrict__ total_out) {
  extern __shared__ float smem[];
  float* frac = smem;  // [M + 1], shared by the block
  const int levels = scan_levels_size(M);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* cum = smem + (M + 1) + warp * (padded(M) + levels + S + 1);  // padded
  float* up = cum + padded(M);
  int* cnt = reinterpret_cast<int*>(up + levels);  // [S + 1]: the histogram of J, then k

  for (int i = threadIdx.x; i <= M; i += blockDim.x)
    frac[i] = i < M ? __fmul_rn((float)i, inv_m) : 1.0f;
  __syncthreads();

  const int ray = blockIdx.x * WARPS + warp;
  if (ray >= N) return;

  const float ox = rays_o[3 * ray], oy = rays_o[3 * ray + 1], oz = rays_o[3 * ray + 2];
  const float dx = rays_d[3 * ray], dy = rays_d[3 * ray + 1], dz = rays_d[3 * ray + 2];
  const float tn = t_near[ray], tf = t_far[ray];
  const float cx = corner[0], cy = corner[1], cz = corner[2];
  const float sx = size[0], sy = size[1], sz = size[2];
  const float span = __fsub_rn(tf, tn);
  const float seg = __fdiv_rn(span, (float)M);
  const float frx = (float)rx, fry = (float)ry, frz = (float)rz;

  // march: occupancy of each segment's midpoint
  for (int m = lane; m < M; m += 32) {
    const float e0 = __fadd_rn(tn, __fmul_rn(span, frac[m]));
    const float e1 = __fadd_rn(tn, __fmul_rn(span, frac[m + 1]));
    const float mid = __fmul_rn(0.5f, __fadd_rn(e0, e1));
    const float ux = __fmul_rn(__fdiv_rn(__fsub_rn(__fadd_rn(ox, __fmul_rn(mid, dx)), cx), sx), frx);
    const float uy = __fmul_rn(__fdiv_rn(__fsub_rn(__fadd_rn(oy, __fmul_rn(mid, dy)), cy), sy), fry);
    const float uz = __fmul_rn(__fdiv_rn(__fsub_rn(__fadd_rn(oz, __fmul_rn(mid, dz)), cz), sz), frz);
    const float fx = floorf(ux), fy = floorf(uy), fz = floorf(uz);
    bool occ = fx >= 0.f && fy >= 0.f && fz >= 0.f && fx < frx && fy < fry && fz < frz;
    if (occ) {
      const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
      occ = __ldg(grid + ((size_t)ix * ry + iy) * rz + iz) != 0;
    }
    cum[pad(m)] = occ ? seg : 0.f;
  }
  __syncwarp();
  xla_scan(cum, M, up, lane);
  const float total = cum[pad(M - 1)];
  if (lane == 0) total_out[ray] = total;
  const float step = __fdiv_rn(total, (float)S);

  // k_j = #{m : cum[m] <= s_j} into cnt[j]
  if (step >= 0.0f && step <= FLT_MAX) {
    for (int j = lane; j <= S; j += 32) cnt[j] = 0;
    __syncwarp();
    // J of 4 cum values a lane at once: independent binary searches of
    // nit steps each (enough to shrink [0, S] to one point)
    const int nit = 32 - __clz(S);
    for (int m0 = 0; m0 < M; m0 += 128) {
      float c[4];
      int lo[4], hi[4];  // J in [lo, hi]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = cum[pad(min(m0 + 32 * q + lane, M - 1))];
        lo[q] = 0;
        hi[q] = S;
      }
      for (int it = 0; it < nit; ++it) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mid = (lo[q] + hi[q]) >> 1;
          const bool go = lo[q] < hi[q], le = c[q] <= __fmul_rn((float)mid, step);
          hi[q] = go && le ? mid : hi[q];
          lo[q] = go && !le ? mid + 1 : lo[q];
        }
      }
      // the histogram: the lanes of a run of equal J (neighbours, as cum
      // rises with m) add the run's length once; a J met in two runs is
      // added twice, so the counts are exact whatever the order of cum
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int J = m0 + 32 * q + lane < M ? lo[q] : S;  // S counts nothing
        const int prev = __shfl_up_sync(0xffffffffu, J, 1);  // every lane shuffles
        const bool head = lane == 0 || J != prev;
        const unsigned heads = __ballot_sync(0xffffffffu, head);
        if (head && J < S) {
          const unsigned next = heads & (0xfffffffeu << lane);  // the heads above
          atomicAdd(cnt + J, (next ? __ffs(next) - 1 : 32) - lane);
        }
      }
    }
    __syncwarp();
    // inclusive prefix sum of cnt[0..S) in place: each lane sums a run of
    // bins, a warp scan offsets the runs
    const int per = (S + 31) / 32;
    const int b0 = min(lane * per, S), b1 = min(b0 + per, S);
    int run = 0;
    for (int j = b0; j < b1; ++j) run += cnt[j];
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int k = incl - run;
    for (int j = b0; j < b1; ++j) {
      k += cnt[j];
      cnt[j] = k;
    }
  } else {
    for (int j = lane; j < S; j += 32) {
      const float s = __fmul_rn((float)j, step);
      int k = 0;
      for (int m = 0; m < M; ++m) k += (cum[pad(m)] <= s);
      cnt[j] = k;
    }
  }
  __syncwarp();
  for (int j = lane; j < S; j += 32) {
    const float s = __fmul_rn((float)j, step);
    const int kk = min(cnt[j], M - 1);
    const float before = kk > 0 ? cum[pad(kk - 1)] : 0.f;
    const float left = __fadd_rn(tn, __fmul_rn(span, frac[kk]));
    z_out[(size_t)ray * S + j] = __fadd_rn(left, __fsub_rn(s, before));
  }
}

}  // namespace

// corner and size: the grid box's [3] f32 arrays; inv_m: f32(1 / M).
extern "C" int scanerf_sample(const float* rays_o, const float* rays_d,
                              const float* t_near, const float* t_far,
                              const uint8_t* grid, const float* corner,
                              const float* size, float inv_m, int rx, int ry, int rz,
                              int N, int S, int M, float* z, float* total, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(M + 1) +
                                       (size_t)WARPS * (padded(M) + scan_levels_size(M) + S + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + WARPS - 1) / WARPS;
  sample_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      rays_o, rays_d, t_near, t_far, grid, corner, size, inv_m, rx, ry, rz, N, S, M, z,
      total);
  return (int)cudaGetLastError();
}
