// B3 and B4: the windowed hash lookup over the sorted stream and its backward,
// for Hopper (sm_90a).
//
// B3 replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/hash_encode.py::
// _fwd_kernel (launched by _run_fwd at hash_encode.py:1231); B4 replaces
// hash_encode.py::_bwd_kernel (launched by _run_bwd at hash_encode.py:1268).
// Same results as ops/kernels/hash_encode.py::lookup_fwd_plain /
// lookup_bwd_plain, up to the order of f32 sums.
//
// B3, per stream row and level: the 8 corner slots of the folded prime-XOR
// hash inside the row's 512-entry window, trilinear weights, one 8-byte (f32)
// or 4-byte (bf16, widened to f32) read of each corner's feature pair
// (decoder.cuh::encode_level, the gather B5 and B7 run) -> feats [Np, L*2]
// f32 in stream order. Rows in the sentinel window (>= nw) get zeros; chunks
// with no real row write zeros and stop. Design: one block of 256 threads per
// 1024-row chunk; a thread takes one (row, level) pair at a time with the
// level fastest, so 16 neighbouring threads write one row's 32 features as
// 128 contiguous bytes and a warp's stores coalesce. Bound on the H100: the
// bytes, not the ~70 operations of a pair: pts rows 0-3 read once, the
// features written once (128 bytes a row), and the table blocks the chunks
// visit (2 MB of f32 per block, which L2 holds while its chunks run).
//
// B4, per live chunk, in tiles of 64 rows: each (row, level) pair reads its
// cotangent pair from d_feats [Np, L*2], adds weight * cotangent at its 8
// corners of the dense, zeroed [L, H*2] table gradient with atomicAdd
// (decoder.cuh::scatter_level, the scatter B6 runs; entries no row touches
// stay zero, as the JAX kernel zeroes unvisited blocks), and computes its
// level's dL/du from the regathered corners; the tile sums the levels of each
// row in shared memory, in level order, into dpts rows 0-2. Rows 3-7 of dpts
// are zero: the view directions' cotangent comes from the decoder's own
// autograd. Chunks with no real row write zero dpts and stop. Bound on the
// H100: the bytes (pts rows 0-3, d_feats and the visited table read, dpts and
// the 268 MB dense gradient written) set the floor, but the 16 f32
// atomics a pair (256 a row, ~1 G a training step) into L2, with many rows of a
// chunk hitting the same coarse-level entries, are expected to set the time.
// The atomics' order changes from run to run, so the table gradient differs
// between runs in the last bits of f32. On an H100 80GB HBM3 at 700 W, on a
// training step's stream (4,224 chunks), chip_smoke.py timed B3 at 1.3 ms (5x
// its byte bound) and B4 at 13.3 ms (35x).

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int THREADS = 256;
constexpr int BR = 64;  // rows per backward tile

template <typename TT>
__global__ void __launch_bounds__(THREADS)
lookup_fwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                  const TT* __restrict__ table, long long row_stride, int L,
                  const int* __restrict__ res_g, int nw, float* __restrict__ out) {
  __shared__ int res[3 * MAXL];
  const int c = blockIdx.x;
  float2* o2 = reinterpret_cast<float2*>(out) + (size_t)c * CHUNK * L;
  if (chunk_work(meta, c) == 0) {
    for (int p = threadIdx.x; p < CHUNK * L; p += THREADS) o2[p] = make_float2(0.f, 0.f);
    return;
  }
  for (int i = threadIdx.x; i < 3 * L; i += THREADS) res[i] = res_g[i];
  __syncthreads();

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  for (int p = threadIdx.x; p < CHUNK * L; p += THREADS) {
    const int t = p / L, l = p - t * L;
    const int w = (int)prow[3 * CHUNK + t];
    float2 f = make_float2(0.f, 0.f);
    if (w < nw)
      f = encode_level<TT>(table + (size_t)l * row_stride, res, l, w, prow[t],
                           prow[CHUNK + t], prow[2 * CHUNK + t]);
    o2[p] = f;
  }
}

__global__ void __launch_bounds__(THREADS)
lookup_bwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                  const float* __restrict__ table, long long row_stride, int L,
                  const int* __restrict__ res_g, const float* __restrict__ g, int nw,
                  float* __restrict__ dtab, float* __restrict__ dpts) {
  __shared__ int res[3 * MAXL];
  __shared__ float du[3][BR][MAXL + 1];  // odd stride: conflict-free both ways
  const int c = blockIdx.x, tid = threadIdx.x;
  float* drow = dpts + (size_t)c * 8 * CHUNK;
  for (int t = tid; t < 5 * CHUNK; t += THREADS) drow[3 * CHUNK + t] = 0.0f;
  if (chunk_work(meta, c) == 0) {
    for (int t = tid; t < 3 * CHUNK; t += THREADS) drow[t] = 0.0f;
    return;
  }
  for (int i = tid; i < 3 * L; i += THREADS) res[i] = res_g[i];
  __syncthreads();

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  const float2* g2 = reinterpret_cast<const float2*>(g) + (size_t)c * CHUNK * L;
  for (int r0 = 0; r0 < CHUNK; r0 += BR) {
    for (int p = tid; p < BR * L; p += THREADS) {
      const int r = p / L, l = p - r * L;
      const int t = r0 + r;
      const int w = (int)prow[3 * CHUNK + t];
      float du0 = 0.0f, du1 = 0.0f, du2 = 0.0f;
      if (w < nw) {
        const float2 gp = g2[(size_t)t * L + l];
        scatter_level(table + (size_t)l * row_stride, dtab + (size_t)l * row_stride, res, l,
                      w, prow[t], prow[CHUNK + t], prow[2 * CHUNK + t], gp.x, gp.y, du0, du1,
                      du2);
      }
      du[0][r][l] = du0;
      du[1][r][l] = du1;
      du[2][r][l] = du2;
    }
    __syncthreads();
    if (tid < 3 * BR) {
      const int k = tid / BR, r = tid % BR;
      float s = 0.0f;
      for (int l = 0; l < L; ++l) s += du[k][r][l];
      drow[k * CHUNK + r0 + r] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int scanerf_lookup_fwd(const float* pts, const int* meta, const void* table,
                                  int table_bf16, long long row_stride, int L,
                                  const int* res, int nw, int NC, float* out,
                                  void* stream) {
  if (L > MAXL || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (NC > 0) {
    if (table_bf16)
      lookup_fwd_kernel<__nv_bfloat16><<<NC, THREADS, 0, s>>>(
          pts, meta, static_cast<const __nv_bfloat16*>(table), row_stride, L, res, nw, out);
    else
      lookup_fwd_kernel<float><<<NC, THREADS, 0, s>>>(
          pts, meta, static_cast<const float*>(table), row_stride, L, res, nw, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int scanerf_lookup_bwd(const float* pts, const int* meta, const float* table,
                                  long long row_stride, int L, const int* res,
                                  const float* g, int nw, int NC, float* dtab, float* dpts,
                                  void* stream) {
  if (L > MAXL || L < 1) return (int)cudaErrorInvalidValue;
  if (NC > 0)
    lookup_bwd_kernel<<<NC, THREADS, 0, (cudaStream_t)stream>>>(
        pts, meta, table, row_stride, L, res, g, nw, dtab, dpts);
  return (int)cudaGetLastError();
}
