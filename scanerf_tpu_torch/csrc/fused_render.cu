// B7: fused windowed hash lookup + ShallowMLP decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/fused_render.py::_fused_kernel
// (launched at fused_render.py:303). Same results as
// ops/kernels/fused_render.py::hash_decode_fused_plain, up to the order of f32
// sums.
//
// Per stream row: window w = pts[3]; for each of L levels the 8 corner slots
// of the folded prime-XOR hash inside window w, trilinear weights, and one
// 8-byte (f32) or 4-byte (bf16, widened to f32) read of the feature pair at
// entry w * 512 + slot of the flat [L, T*H*2] tables; then the ShallowMLP:
// 32 -> 64 (Gauss) -> 64, heads (softplus sigma, sigmoid diffuse / tint) on
// channels 0-31, SH-16 of the normalized view dir, 48 -> 64 (Gauss) -> 64
// (Gauss) -> 3 (sigmoid specular) on channels 32-63 + SH. Output per row:
// (sigma, diffuse + tint * specular). Rows in the sentinel window (>= nw)
// decode zero features; chunks with no real row write zeros and stop.
//
// Design: B5's (fused_train.cu), from decoder_tc.cuh. One block of 16 warps
// an SM walks the chunks (grid-stride); each warp decodes warp tiles of 16
// rows with its activations in registers (warp_tile: the gather straight
// into the A fragments of spatial0, the four large layers on the tensor
// cores in 3xTF32, the heads and dir2 on the CUDA cores), and lanes 0 and 1
// of each row group write (sigma, rgb) of rows g and g + 8 as float4s. Each
// chunk decodes with its tile's slab (chunk_tid), staged with its large
// matrices split. The stream's chunks are in tile order, so the chunks a
// block walks are too, and it restages the slab only when the tile
// changes. Bound on the H100: the ~13.3 K multiply-adds of the large layers
// a live row, three times over on the tensor cores; the gathers of a chunk
// stay inside one 32-window block (2 MB of f32 tables), which L2 holds.
// What sets the time is the feeding of the tensor cores beside the gather's
// latency: the warps share no barrier, so while one waits on its gather the
// others' products run.

#include "decoder_tc.cuh"

namespace {

using namespace scanerf;

constexpr int THREADS = 512;  // 16 warps, one block an SM

template <typename TT>
__global__ void __launch_bounds__(THREADS, 1)
fused_render_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                    const int* __restrict__ chunk_tid, const TT* __restrict__ table,
                    long long row_stride, int L, const int* __restrict__ res_g,
                    const float* __restrict__ slabs, int nw, int NC,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // the tile's slab, staged for the forward
  __shared__ int res[3 * MAXL];
  const int tid = threadIdx.x, t = tid & 3;
  for (int i = tid; i < 3 * L; i += THREADS) res[i] = res_g[i];

  int staged = -1;  // the tile whose slab sW holds
  for (int c = blockIdx.x; c < NC; c += gridDim.x) {
    float4* out4 = reinterpret_cast<float4*>(out) + (size_t)c * CHUNK;
    if (chunk_work(meta, c) == 0) {
      for (int i = tid; i < CHUNK; i += THREADS) out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    // every thread takes the same chunks, so all meet these barriers: the
    // first waits for the warps still decoding with the old slab
    const int tile = chunk_tid[c];
    if (tile != staged) {
      __syncthreads();
      stage_forward<THREADS>(slabs + (size_t)tile * PSLAB, sW);
      __syncthreads();
      staged = tile;
    }
    const float* prow = pts + (size_t)c * 8 * CHUNK;
    for (int r0 = (tid >> 5) * WR; r0 < CHUNK; r0 += THREADS / 32 * WR) {
      float hd0[7], hd8[7], sp0[3], sp8[3];
      warp_tile<TT>(prow, r0, table, row_stride, L, res, nw, sW, nullptr, hd0, hd8, sp0, sp8);
      // (sigma, diffuse + tint * specular) of row g (lane t = 0) or g + 8 (t = 1)
      if (t < 2) {
        float hd[7], sp[3];
#pragma unroll
        for (int o = 0; o < 7; ++o) hd[o] = t ? hd8[o] : hd0[o];
#pragma unroll
        for (int k = 0; k < 3; ++k) sp[k] = t ? sp8[k] : sp0[k];
        out4[r0 + ((tid & 31) >> 2) + 8 * t] = make_float4(
            softplus(hd[0]), sigmoid(hd[1]) + sigmoid(hd[4]) * sigmoid(sp[0]),
            sigmoid(hd[2]) + sigmoid(hd[5]) * sigmoid(sp[1]),
            sigmoid(hd[3]) + sigmoid(hd[6]) * sigmoid(sp[2]));
      }
    }
  }
}

template <typename TT>
int launch(const float* pts, const int* meta, const int* chunk_tid,
           const void* table, long long row_stride, int L, const int* res,
           const float* slabs, int nw, int NC, float* out, cudaStream_t stream) {
  int grid = 0;
  const size_t smem = sizeof(float) * F_FLOATS;
  cudaError_t e = persistent_grid(fused_render_kernel<TT>, THREADS, smem, NC, &grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) {
    fused_render_kernel<TT><<<grid, THREADS, smem, stream>>>(
        pts, meta, chunk_tid, static_cast<const TT*>(table), row_stride, L, res,
        slabs, nw, NC, out);
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

// Blocks an SM holds of the kernel (f32 tables; bf16's is the same) and the
// dynamic shared memory of a block, in bytes.
extern "C" int scanerf_fused_render_occupancy(int* per_sm, int* smem) {
  *smem = (int)(sizeof(float) * F_FLOATS);
  return (int)blocks_per_sm(fused_render_kernel<float>, THREADS, *smem, per_sm);
}
