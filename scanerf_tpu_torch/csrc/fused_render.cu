// B7: fused windowed hash lookup + ShallowMLP decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/fused_render.py::_fused_kernel
// (launched at fused_render.py:303). Same results as
// ops/kernels/fused_render.py::hash_decode_fused_plain, up to the order of f32
// sums.
//
// Per stream row: window w = pts[3]; for each of L levels the 8 corner slots
// of the folded prime-XOR hash inside window w, trilinear weights, and one
// 8-byte (f32) or 4-byte (bf16) read of the feature pair at entry
// w * 512 + slot of the flat [L, T*H*2] tables; then the ShallowMLP:
// 32 -> 64 (Gauss) -> 64, heads (softplus sigma, sigmoid diffuse / tint) on
// channels 0-31, SH-16 of the normalized view dir, 48 -> 64 (Gauss) -> 64
// (Gauss) -> 3 (sigmoid specular) on channels 32-63 + SH. Output per row:
// (sigma, diffuse + tint * specular). Rows in the sentinel window (>= nw)
// decode zero features; chunks with no real row write zeros and stop.
//
// Design: one block of 256 threads per 1024-row chunk, 4 rows a thread. The
// chunk's tile decoder slab (56 KB) is staged in shared memory once; every
// weight read is a warp-wide broadcast float4. Features and activations stay
// in registers. The decoder's ~13.7 K multiply-adds per row in f32 bound the
// kernel; the gathers of a chunk stay inside one 32-window block (2 MB of
// f32 tables), which L2 holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 1024;
constexpr int SUBT = CHUNK / 128;
constexpr int THREADS = 256;
constexpr int WIN = 512;
constexpr int MAXL = 16;

// decoder slab layout: mirrors ops/kernels/fused_render.py
constexpr int SP0_W = 0, SP1_W = 2048, HEAD_W = 6144, DIR0_W = 6400,
              DIR1_W = 9472, DIR2_W = 13568;
constexpr int B_SP0 = 13824, B_SP1 = 13888, B_HEAD = 13952, B_DIR0 = 13960,
              B_DIR1 = 14024, B_DIR2 = 14088;
constexpr int PSLAB = 14092;

constexpr float GAUSS_K = -1.0f / (2.0f * 0.1f * 0.1f);

__device__ __forceinline__ float gauss(float x) { return expf(x * x * GAUSS_K); }
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// y[o] = act(sum_i w[o][i] * x[i] + b[o]) for o < OUT_N (w rows of length IN)
template <int IN, int OUT_N, bool GAUSS>
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      const float (&x)[IN], float* y) {
#pragma unroll
  for (int o = 0; o < OUT_N; ++o) {
    const float4* wr = reinterpret_cast<const float4*>(w + o * IN);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < IN / 4; ++i) {
      const float4 q = wr[i];
      acc = fmaf(q.x, x[4 * i], acc);
      acc = fmaf(q.y, x[4 * i + 1], acc);
      acc = fmaf(q.z, x[4 * i + 2], acc);
      acc = fmaf(q.w, x[4 * i + 3], acc);
    }
    acc += b[o];
    y[o] = GAUSS ? gauss(acc) : acc;
  }
}

__device__ __forceinline__ float2 load_pair(const float* t, size_t e) {
  return __ldg(reinterpret_cast<const float2*>(t) + e);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* t, size_t e) {
  const __nv_bfloat162 v = __ldg(reinterpret_cast<const __nv_bfloat162*>(t) + e);
  return __bfloat1622float2(v);
}

template <typename TT>
__device__ void encode(const TT* __restrict__ table, long long row_stride,
                       int L, const int* res, int w, float ux, float uy,
                       float uz, float (&f)[2 * MAXL]) {
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    f[2 * l] = 0.0f;
    f[2 * l + 1] = 0.0f;
    if (l >= L) continue;
    const float vx = ux * ((float)res[3 * l] - 1.0f);
    const float vy = uy * ((float)res[3 * l + 1] - 1.0f);
    const float vz = uz * ((float)res[3 * l + 2] - 1.0f);
    const float bx = floorf(vx), by = floorf(vy), bz = floorf(vz);
    const float ox = vx - bx, oy = vy - by, oz = vz - bz;
    const uint32_t hx0 = (uint32_t)(int)bx;
    const uint32_t hy0 = (uint32_t)(int)by * 2654435761u;
    const uint32_t hz0 = (uint32_t)(int)bz * 805459861u;
    const uint32_t hx1 = hx0 + 1u, hy1 = hy0 + 2654435761u, hz1 = hz0 + 805459861u;
    const TT* tl = table + (size_t)l * row_stride;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
      uint32_t h = (cx ? hx1 : hx0) ^ (cy ? hy1 : hy0) ^ (cz ? hz1 : hz0);
      h = h ^ (h >> 9) ^ (h >> 18);
      const size_t e = (size_t)w * WIN + (h & (WIN - 1));
      const float wt = (cx ? ox : 1.0f - ox) * (cy ? oy : 1.0f - oy) * (cz ? oz : 1.0f - oz);
      const float2 v = load_pair(tl, e);
      a0 = fmaf(wt, v.x, a0);
      a1 = fmaf(wt, v.y, a1);
    }
    f[2 * l] = a0;
    f[2 * l + 1] = a1;
  }
}

template <typename TT>
__global__ void __launch_bounds__(THREADS)
fused_render_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                    const int* __restrict__ chunk_tid, const TT* __restrict__ table,
                    long long row_stride, int L, const int* __restrict__ res_g,
                    const float* __restrict__ slabs, int nw,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);  // [PSLAB]
  __shared__ int res[3 * MAXL];
  const int c = blockIdx.x;

  int nwork = 0;
#pragma unroll
  for (int s = 0; s < SUBT; ++s) nwork += meta[(c * SUBT + s) * 4 + 2];
  float4* out4 = reinterpret_cast<float4*>(out) + (size_t)c * CHUNK;
  if (nwork == 0) {
    for (int t = threadIdx.x; t < CHUNK; t += THREADS)
      out4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const float4* src = reinterpret_cast<const float4*>(slabs + (size_t)chunk_tid[c] * PSLAB);
  for (int i = threadIdx.x; i < PSLAB / 4; i += THREADS) smem4[i] = src[i];
  for (int i = threadIdx.x; i < 3 * L; i += THREADS) res[i] = res_g[i];
  __syncthreads();

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  for (int t = threadIdx.x; t < CHUNK; t += THREADS) {
    const float ux = prow[t], uy = prow[CHUNK + t], uz = prow[2 * CHUNK + t];
    const int w = (int)prow[3 * CHUNK + t];
    const float dx = prow[4 * CHUNK + t], dy = prow[5 * CHUNK + t], dz = prow[6 * CHUNK + t];

    float feat[2 * MAXL];
    if (w < nw) {
      encode<TT>(table, row_stride, L, res, w, ux, uy, uz, feat);
    } else {
#pragma unroll
      for (int i = 0; i < 2 * MAXL; ++i) feat[i] = 0.0f;
    }

    float h[64];
    dense<32, 64, true>(ps + SP0_W, ps + B_SP0, feat, h);
    float hid[64];
    dense<64, 64, false>(ps + SP1_W, ps + B_SP1, h, hid);

    float geo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) geo[i] = hid[i];
    float heads[7];
    dense<32, 7, false>(ps + HEAD_W, ps + B_HEAD, geo, heads);

    const float nrm = sqrtf(dx * dx + dy * dy + dz * dz) + 1e-8f;
    const float x = dx / nrm, y = dy / nrm, z = dz / nrm;
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    float din[48];
#pragma unroll
    for (int i = 0; i < 32; ++i) din[i] = hid[32 + i];
    din[32] = 0.28209479177387814f;
    din[33] = 0.4886025119029199f * y;
    din[34] = 0.4886025119029199f * z;
    din[35] = 0.4886025119029199f * x;
    din[36] = 1.0925484305920792f * xy;
    din[37] = -1.0925484305920792f * yz;
    din[38] = 0.31539156525252005f * (2.0f * zz - xx - yy);
    din[39] = -1.0925484305920792f * xz;
    din[40] = 0.5462742152960396f * (xx - yy);
    din[41] = -0.5900435899266435f * y * (3.0f * xx - yy);
    din[42] = 2.890611442640554f * xy * z;
    din[43] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
    din[44] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    din[45] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
    din[46] = 1.445305721320277f * z * (xx - yy);
    din[47] = -0.5900435899266435f * x * (xx - 3.0f * yy);

    float d1[64];
    dense<48, 64, true>(ps + DIR0_W, ps + B_DIR0, din, d1);
    float d2[64];
    dense<64, 64, true>(ps + DIR1_W, ps + B_DIR1, d1, d2);
    float spec[3];
    dense<64, 3, false>(ps + DIR2_W, ps + B_DIR2, d2, spec);

    const float sigma = softplus(heads[0]);
    float4 o;
    o.x = sigma;
    o.y = sigmoid(heads[1]) + sigmoid(heads[4]) * sigmoid(spec[0]);
    o.z = sigmoid(heads[2]) + sigmoid(heads[5]) * sigmoid(spec[1]);
    o.w = sigmoid(heads[3]) + sigmoid(heads[6]) * sigmoid(spec[2]);
    out4[t] = o;
  }
}

template <typename TT>
int launch(const float* pts, const int* meta, const int* chunk_tid,
           const void* table, long long row_stride, int L, const int* res,
           const float* slabs, int nw, int NC, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * PSLAB;
  cudaError_t e = cudaFuncSetAttribute(fused_render_kernel<TT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (NC > 0) {
    fused_render_kernel<TT><<<NC, THREADS, smem, stream>>>(
        pts, meta, chunk_tid, static_cast<const TT*>(table), row_stride, L, res,
        slabs, nw, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scanerf_fused_render(const float* pts, const int* meta,
                                    const int* chunk_tid, const void* table,
                                    int table_bf16, long long row_stride, int L,
                                    const int* res, const float* slabs, int nw,
                                    int NC, float* out, void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return table_bf16
             ? launch<__nv_bfloat16>(pts, meta, chunk_tid, table, row_stride, L,
                                     res, slabs, nw, NC, out, s)
             : launch<float>(pts, meta, chunk_tid, table, row_stride, L, res,
                             slabs, nw, NC, out, s);
}
