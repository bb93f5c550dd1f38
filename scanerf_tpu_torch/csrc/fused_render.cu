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
// The gather and the decoder forward live in decoder.cuh (shared with the
// training kernels B5/B6 in fused_train.cu; the gather also with B3 in
// hash_encode.cu).
//
// Design: one block of 256 threads per 1024-row chunk, 4 rows a thread. The
// chunk's tile decoder slab (56 KB) is staged in shared memory once; every
// weight read is a warp-wide broadcast float4. Features and activations stay
// in registers. The decoder's ~13.7 K multiply-adds per row in f32 bound the
// kernel; the gathers of a chunk stay inside one 32-window block (2 MB of
// f32 tables), which L2 holds.

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int THREADS = 256;

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

  const int nwork = chunk_work(meta, c);
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

    float heads[7], spec[3];
    decoder_forward(ps, feat, dx, dy, dz, heads, spec);

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
