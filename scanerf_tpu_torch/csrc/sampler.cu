// B1: fused occupancy-CDF ray sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/sampler.py::_make_kernel
// (launched at sampler.py:240). Computes exactly what the plain PyTorch
// version ops/kernels/sampler.py::sample_plain computes:
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
// memory. What bounds the kernel is the S x M comparison count of the
// inversion and the march arithmetic: the only other device-memory traffic
// is 32 bytes in and 4(S+1) bytes out per ray.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int BLK = 16;  // XLA CPU cumsum block length

// Number of floats of scan scratch for an array of n: the levels above 0.
__host__ __device__ inline int scan_levels_size(int n) {
  int total = 0;
  while (n > BLK) {
    n = (n + BLK - 1) / BLK;
    total += n;
  }
  return total;
}

// In-place inclusive scan of a[0..n) by one warp, in XLA's CPU order:
// sequential inside blocks of 16, block totals scanned recursively into
// `up`, then every element of block k >= 1 gets the inclusive total of
// blocks 0..k-1 added.
__device__ void xla_scan(float* a, int n, float* up, int lane) {
  if (n <= BLK) {
    if (lane == 0) {
      for (int i = 1; i < n; ++i) a[i] = __fadd_rn(a[i - 1], a[i]);
    }
    __syncwarp();
    return;
  }
  const int nb = (n + BLK - 1) / BLK;
  for (int b = lane; b < nb; b += 32) {
    const int i0 = b * BLK;
    const int i1 = min(i0 + BLK, n);
    float acc = a[i0];
    for (int i = i0 + 1; i < i1; ++i) {
      acc = __fadd_rn(acc, a[i]);
      a[i] = acc;
    }
    up[b] = acc;  // padding zeros would add exactly nothing
  }
  __syncwarp();
  xla_scan(up, nb, up + nb, lane);
  for (int i = BLK + lane; i < n; i += 32) {
    a[i] = __fadd_rn(a[i], up[i / BLK - 1]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32)
sample_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              const float* __restrict__ t_near, const float* __restrict__ t_far,
              const uint8_t* __restrict__ grid, const float* __restrict__ frac_g,
              const float* __restrict__ box, int rx, int ry, int rz, int N, int S, int M,
              float* __restrict__ z_out, float* __restrict__ total_out) {
  extern __shared__ float smem[];
  float* frac = smem;  // [M + 1], shared by the block
  const int per_warp = M + scan_levels_size(M);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* cum = smem + (M + 1) + warp * per_warp;
  float* up = cum + M;

  for (int i = threadIdx.x; i <= M; i += blockDim.x) frac[i] = frac_g[i];
  __syncthreads();

  const int ray = blockIdx.x * WARPS + warp;
  if (ray >= N) return;

  const float ox = rays_o[3 * ray], oy = rays_o[3 * ray + 1], oz = rays_o[3 * ray + 2];
  const float dx = rays_d[3 * ray], dy = rays_d[3 * ray + 1], dz = rays_d[3 * ray + 2];
  const float tn = t_near[ray], tf = t_far[ray];
  const float cx = box[0], cy = box[1], cz = box[2];  // grid corner
  const float sx = box[3], sy = box[4], sz = box[5];  // grid size
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
    cum[m] = occ ? seg : 0.f;
  }
  __syncwarp();
  xla_scan(cum, M, up, lane);
  const float total = cum[M - 1];
  if (lane == 0) total_out[ray] = total;
  const float step = __fdiv_rn(total, (float)S);

  // inversion: each lane takes quantiles j = lane, lane + 32, ...
  for (int j0 = 0; j0 < S; j0 += 128) {
    float s[4];
    int k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = __fmul_rn((float)(j0 + lane + 32 * q), step);
      k[q] = 0;
    }
    for (int m = 0; m < M; ++m) {
      const float c = cum[m];
#pragma unroll
      for (int q = 0; q < 4; ++q) k[q] += (c <= s[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + lane + 32 * q;
      if (j >= S) continue;
      const int kk = min(k[q], M - 1);
      const float before = kk > 0 ? cum[kk - 1] : 0.f;
      const float left = __fadd_rn(tn, __fmul_rn(span, frac[kk]));
      z_out[(size_t)ray * S + j] = __fadd_rn(left, __fsub_rn(s[q], before));
    }
  }
}

}  // namespace

extern "C" int scanerf_sample(const float* rays_o, const float* rays_d,
                              const float* t_near, const float* t_far,
                              const uint8_t* grid, const float* frac,
                              const float* box, int rx, int ry, int rz, int N,
                              int S, int M, float* z, float* total, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(M + 1) + (size_t)WARPS * (M + scan_levels_size(M)));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + WARPS - 1) / WARPS;
  sample_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      rays_o, rays_d, t_near, t_far, grid, frac, box, rx, ry, rz, N, S, M, z,
      total);
  return (int)cudaGetLastError();
}
