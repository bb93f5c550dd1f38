// B5 and B6: the fused windowed hash + ShallowMLP training kernels for Hopper
// (sm_90a), forward and backward.
//
// B5 replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/fused_train.py::
// _ft_fwd_kernel (launched at fused_train.py:348); B6 replaces
// fused_train.py::_ft_bwd_kernel (launched at fused_train.py:389). Same
// results as ops/kernels/fused_train.py::train_fwd_plain / train_bwd_plain,
// up to the order of f32 sums.
//
// B5: the training stream's decoder forward in warp tiles of 16 rows
// (decoder_tc.cuh::warp_tile): each lane gathers 8 (row, level) pairs with
// decoder.cuh's encode_level, so the features are bit for bit B3's, straight
// into the A fragments of spatial0; the four large layers run on the tensor
// cores in 3xTF32 with every activation in registers; the heads and dir2 on
// the CUDA cores. The features go out as the backward's residual [NC, L,
// 2, CHUNK] (skipped when no gradient is wanted, as in the warp loss's
// visibility re-render), each store a full 32-byte sector per group of 8
// rows; the 8 training columns (sigma, diffuse x3, tint * specular x3, mean
// specular^2) two float4s a row. The training slab carries BARF's annealing
// weights folded into spatial0's input columns. Rows in the sentinel window
// decode zero features; chunks with no real row write zero columns and zero
// features. One block of 16 warps an SM (128 registers a thread) walks the
// chunks (grid-stride) with the slab staged once in shared memory, its
// large matrices already split (126 KB). Bound on the H100: the ~13.3 K
// multiply-adds of the large layers a live row, three times over on the
// tensor cores, and the features residual (553 MB a step) set the floor.
// What sets the time is the feeding of the tensor cores, the fragments'
// shared-memory reads among it, beside the gather's latency, 128 random
// 8-byte L2 reads a row. The warps share no barrier, so while one waits on
// its gather the others' products run.
//
// B6 is two launches. The first, B6a here, runs per live chunk in tiles of
// 64 rows: the decoder forward is recomputed from the saved features, then
// the hand-derived pullback of the 8 column cotangents (softplus, sigmoid,
// Gaussian and SH-16 derivatives, the direction normalisation d / (|d| +
// 1e-8)) gives the features' cotangent d_feats [NC, L*2, CHUNK], the
// directions' cotangent (dpts rows 4-6; rows 3 and 7 zero) and the slab
// gradient. The second is B4's kernel (hash_encode.cu), which scatters
// d_feats into the dense, zeroed table gradient, summed per chunk in shared
// memory, and writes dL/du into dpts rows 0-2: B6a's tiles could not hold a
// chunk's level slabs beside their activations.
// B6a keeps every activation of the tile in shared memory beside the four
// large weight matrices: 210 KB, one block of 512 threads an SM. Those four
// matrices run on the tensor cores (decoder_tc.cuh) in all three roles:
// the forward, the input cotangents and the weight-gradient sums. For the
// weight gradients each warp owns fixed tiles of each matrix and keeps
// their sums in registers over all the chunks its block visits
// (grid-stride over chunks), adding them to global memory once; a tile's 64
// rows are summed in the tensor core, the tiles in f32 on the CUDA cores.
// The narrow heads (7 x 32, 3 x 64), the activations' derivatives and the
// bias sums stay on the CUDA cores. Chunks with no real row zero dpts rows
// 3-7 and do nothing else. Bound on the H100: the ~41 K multiply-adds a
// live row, three times over on the tensor cores, set the floor; the
// instructions that feed the tensor cores (fragment reads, the splits), the
// narrow layers and the tile's 13 barriers with one block an SM set the
// time.

#include "decoder_tc.cuh"

namespace {

using namespace scanerf;

constexpr int FWD_THREADS = 512;  // 16 warps, one block an SM
constexpr int BWD_THREADS = 512;

// stash rows of the backward tile, each [RS] floats; a row index is the
// vector element, the column the tile row
constexpr int S_F = 0;      // 32 features
constexpr int S_Z0 = 32;    // 64 spatial0 pre-act, then its cotangent
constexpr int S_H0 = 96;    // 64 spatial0 Gauss
constexpr int S_HH = 160;   // 64 spatial1 out (0-31 heads input, 32-63 dir input)
constexpr int S_SH = 224;   // 16 SH (right after S_HH: dir0's input is rows 192..239)
constexpr int S_ZD0 = 240;  // 64 dir0 pre-act, then its cotangent
constexpr int S_D1 = 304;   // 64 dir0 Gauss, then the cotangent of spatial1's out
constexpr int S_ZD1 = 368;  // 64 dir1 pre-act, then its cotangent, then d SH
constexpr int S_D2 = 432;   // 64 dir1 Gauss, then the features' cotangent
constexpr int S_HD = 496;   // 7 head pre-acts, then their cotangents
constexpr int S_SP = 503;   // 3 specular pre-acts, then their cotangents
constexpr int S_G = 506;    // 8 column cotangents
constexpr int S_DIR = 514;  // 3 raw view dirs
constexpr int S_ROWS = 517;
constexpr float GAUSS_2K = 2.0f * GAUSS_K;
// the stash, then the four large matrices (stage_decoder)
constexpr int S_FLOATS = S_ROWS * RS + W_FLOATS;

// ---------------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(FWD_THREADS, 1)
train_fwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                 const float* __restrict__ table, long long row_stride, int L,
                 const int* __restrict__ res_g, const float* __restrict__ ps, int nw,
                 int NC, float* __restrict__ cols, float* __restrict__ feats) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // the slab, staged for the forward
  __shared__ int res[3 * MAXL];
  const int tid = threadIdx.x, t = tid & 3;
  stage_forward<FWD_THREADS>(ps, sW);
  for (int i = tid; i < 3 * L; i += FWD_THREADS) res[i] = res_g[i];
  __syncthreads();

  for (int c = blockIdx.x; c < NC; c += gridDim.x) {
    float4* cols4 = reinterpret_cast<float4*>(cols) + (size_t)c * CHUNK * 2;
    float* fo = feats ? feats + (size_t)c * L * 2 * CHUNK : nullptr;
    if (chunk_work(meta, c) == 0) {
      for (int i = tid; i < 2 * CHUNK; i += FWD_THREADS)
        cols4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (fo)
        for (int i = tid; i < L * 2 * CHUNK / 4; i += FWD_THREADS)
          reinterpret_cast<float4*>(fo)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* prow = pts + (size_t)c * 8 * CHUNK;
    for (int r0 = (tid >> 5) * WR; r0 < CHUNK; r0 += FWD_THREADS / 32 * WR) {
      float hd0[7], hd8[7], sp0[3], sp8[3];
      warp_tile<float>(prow, r0, table, row_stride, L, res, nw, sW, fo, hd0, hd8, sp0, sp8);
      // the 8 columns of the tile's 16 rows, two float4s a row: lane t
      // writes half t & 1 of row g (t < 2) or g + 8
      const bool lower = t >> 1;
      float hd[7], sp[3];
#pragma unroll
      for (int o = 0; o < 7; ++o) hd[o] = lower ? hd8[o] : hd0[o];
#pragma unroll
      for (int k = 0; k < 3; ++k) sp[k] = sigmoid(lower ? sp8[k] : sp0[k]);
      const int row = r0 + ((tid & 31) >> 2) + (lower ? 8 : 0);
      cols4[2 * row + (t & 1)] =
          (t & 1) ? make_float4(sigmoid(hd[4]) * sp[0], sigmoid(hd[5]) * sp[1],
                                sigmoid(hd[6]) * sp[2],
                                (sp[0] * sp[0] + sp[1] * sp[1] + sp[2] * sp[2]) / 3.0f)
                  : make_float4(softplus(hd[0]), sigmoid(hd[1]), sigmoid(hd[2]), sigmoid(hd[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// B6a building blocks on the CUDA cores
// ---------------------------------------------------------------------------

// Input cotangent of a narrow layer: epi(i, r, sum_o dY[o][r] W[o][i]).
template <int O, int I, typename Epi>
__device__ __forceinline__ void narrow_bwd(const float* __restrict__ W, const float* dY,
                                           Epi epi) {
  for (int e = threadIdx.x; e < I * R; e += BWD_THREADS) {
    const int i = e / R, r = e % R;
    float acc = 0.0f;
#pragma unroll
    for (int o = 0; o < O; ++o) acc = fmaf(dY[o * RS + r], __ldg(W + o * I + i), acc);
    epi(i, r, acc);
  }
}

// Cotangent of the unit direction n from the SH-16 cotangent ds.
__device__ __forceinline__ void sh16_bwd(float x, float y, float z, const float* ds,
                                         float& gx, float& gy, float& gz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  gx = SH_C1 * ds[3] + SH_C20 * y * ds[4] - 2.0f * SH_C22 * x * ds[6] +
       SH_C23 * z * ds[7] + 2.0f * SH_C24 * x * ds[8] + 6.0f * SH_C30 * xy * ds[9] +
       SH_C31 * yz * ds[10] - 2.0f * SH_C32 * xy * ds[11] -
       6.0f * SH_C33 * xz * ds[12] + SH_C34 * (4.0f * zz - 3.0f * xx - yy) * ds[13] +
       2.0f * SH_C35 * xz * ds[14] + SH_C36 * (3.0f * xx - 3.0f * yy) * ds[15];
  gy = SH_C1 * ds[1] + SH_C20 * x * ds[4] + SH_C21 * z * ds[5] -
       2.0f * SH_C22 * y * ds[6] - 2.0f * SH_C24 * y * ds[8] +
       SH_C30 * (3.0f * xx - 3.0f * yy) * ds[9] + SH_C31 * xz * ds[10] +
       SH_C32 * (4.0f * zz - xx - 3.0f * yy) * ds[11] - 6.0f * SH_C33 * yz * ds[12] -
       2.0f * SH_C34 * xy * ds[13] - 2.0f * SH_C35 * yz * ds[14] -
       6.0f * SH_C36 * xy * ds[15];
  gz = SH_C1 * ds[2] + SH_C21 * y * ds[5] + 4.0f * SH_C22 * z * ds[6] +
       SH_C23 * x * ds[7] + SH_C31 * xy * ds[10] + 8.0f * SH_C32 * yz * ds[11] +
       SH_C33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * ds[12] +
       8.0f * SH_C34 * xz * ds[13] + SH_C35 * (xx - yy) * ds[14];
}

// Weight-gradient sum of one entry of a narrow [O, I] matrix a thread.
template <int O, int I>
__device__ __forceinline__ void narrow_acc(float& acc, const float* dY, const float* X) {
  static_assert(O * I <= BWD_THREADS, "one entry per thread");
  if (threadIdx.x < O * I) {
    const float* a = dY + (threadIdx.x / I) * RS;
    const float* x = X + (threadIdx.x % I) * RS;
#pragma unroll 16
    for (int r = 0; r < R; ++r) acc = fmaf(a[r], x[r], acc);
  }
}

// Bias-gradient sum of one of O outputs a thread.
template <int O>
__device__ __forceinline__ void bias_acc(float& acc, const float* dY) {
  if (threadIdx.x < O) {
    const float* a = dY + threadIdx.x * RS;
#pragma unroll 16
    for (int r = 0; r < R; ++r) acc += a[r];
  }
}

template <int N>
__device__ __forceinline__ void flush_entry(float acc, float* dst) {
  if (threadIdx.x < N) atomicAdd(dst + threadIdx.x, acc);
}

// ---------------------------------------------------------------------------
// B6a
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BWD_THREADS, 1)
decoder_bwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                   const float* __restrict__ ps, const float* __restrict__ feats,
                   const float* __restrict__ g, int L, int NC, float* __restrict__ dfeat,
                   float* __restrict__ dpts, float* __restrict__ dslab) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // the stash [S_ROWS][RS], then the weights
  const int tid = threadIdx.x;
  float* sW = st + S_ROWS * RS;
  float* sW0 = sW + W_SP0;
  float* sW1 = sW + W_SP1;
  float* sWd0 = sW + W_DIR0;
  float* sWd1 = sW + W_DIR1;
  stage_decoder<BWD_THREADS>(ps, sW);

  // this warp's weight-gradient tiles of spatial0, spatial1, dir0 and dir1;
  // this thread's entry of heads and dir2 and its bias entries
  using A32 = AccTiles<32, BWD_THREADS>;
  using A48 = AccTiles<48, BWD_THREADS>;
  using A64 = AccTiles<64, BWD_THREADS>;
  float a_sp0[A32::TPW][4] = {}, a_sp1[A64::TPW][4] = {}, a_dir0[A48::TPW][4] = {},
        a_dir1[A64::TPW][4] = {};
  float a_head = 0.f, a_dir2 = 0.f;
  float b_sp0 = 0.f, b_sp1 = 0.f, b_head = 0.f, b_dir0 = 0.f, b_dir1 = 0.f, b_dir2 = 0.f;
  __syncthreads();

  float* F = st + S_F * RS;
  float* Z0 = st + S_Z0 * RS;
  float* H0 = st + S_H0 * RS;
  float* HH = st + S_HH * RS;
  float* SH = st + S_SH * RS;
  float* ZD0 = st + S_ZD0 * RS;
  float* D1 = st + S_D1 * RS;
  float* ZD1 = st + S_ZD1 * RS;
  float* D2 = st + S_D2 * RS;
  float* HD = st + S_HD * RS;
  float* SP = st + S_SP * RS;
  float* G = st + S_G * RS;
  float* DIR = st + S_DIR * RS;

  for (int c = blockIdx.x; c < NC; c += gridDim.x) {
    const float* prow = pts + (size_t)c * 8 * CHUNK;
    float* drow = dpts + (size_t)c * 8 * CHUNK;
    if (chunk_work(meta, c) == 0) {
      for (int t = tid; t < 5 * CHUNK; t += BWD_THREADS) drow[3 * CHUNK + t] = 0.0f;
      continue;
    }
    const float* fch = feats + (size_t)c * L * 2 * CHUNK;
    float* dfc = dfeat + (size_t)c * L * 2 * CHUNK;
    for (int r0 = 0; r0 < CHUNK; r0 += R) {
      // -- load the tile: features, column cotangents, raw dirs; SH
      for (int e = tid; e < 2 * MAXL * R; e += BWD_THREADS) {
        const int i = e / R, r = e % R;
        F[i * RS + r] = i < 2 * L ? fch[(size_t)i * CHUNK + r0 + r] : 0.0f;
      }
      for (int e = tid; e < 8 * R; e += BWD_THREADS) {
        const int k = e % 8, r = e / 8;
        G[k * RS + r] = g[((size_t)c * CHUNK + r0 + r) * 8 + k];
      }
      if (tid < R) {
        const float dx = prow[4 * CHUNK + r0 + tid], dy = prow[5 * CHUNK + r0 + tid],
                    dz = prow[6 * CHUNK + r0 + tid];
        DIR[tid] = dx;
        DIR[RS + tid] = dy;
        DIR[2 * RS + tid] = dz;
        const float nrm = sqrtf(dx * dx + dy * dy + dz * dz) + 1e-8f;
        float sh[16];
        sh16(dx / nrm, dy / nrm, dz / nrm, sh);
#pragma unroll
        for (int j = 0; j < 16; ++j) SH[j * RS + tid] = sh[j];
      }
      __syncthreads();

      // -- decoder forward, recomputed from the saved features
      mma_fwd<32, WS0, BWD_THREADS>(sW0, ps + B_SP0, F, Z0, H0);
      __syncthreads();
      mma_fwd<64, WS1, BWD_THREADS>(sW1, ps + B_SP1, H0, HH, nullptr);
      __syncthreads();
      narrow_fwd<7, 32, BWD_THREADS>(ps + HEAD_W, ps + B_HEAD, HH, HD);
      mma_fwd<48, WSD0, BWD_THREADS>(sWd0, ps + B_DIR0, HH + 32 * RS, ZD0, D1);
      __syncthreads();
      mma_fwd<64, WSD1, BWD_THREADS>(sWd1, ps + B_DIR1, D1, ZD1, D2);
      __syncthreads();
      narrow_fwd<3, 64, BWD_THREADS>(ps + DIR2_W, ps + B_DIR2, D2, SP);
      __syncthreads();

      // -- the 8 columns' pullback to the head and specular pre-acts
      if (tid < R) {
        const int r = tid;
        float gc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) gc[k] = G[k * RS + r];
        const float h0 = HD[r];
        HD[r] = gc[0] * sigmoid(h0);  // softplus' = sigmoid
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float dif = sigmoid(HD[(1 + k) * RS + r]);
          HD[(1 + k) * RS + r] = gc[1 + k] * dif * (1.0f - dif);
          const float tint = sigmoid(HD[(4 + k) * RS + r]);
          const float sp = sigmoid(SP[k * RS + r]);
          const float dtint = gc[4 + k] * sp;
          const float dsp = gc[4 + k] * tint + gc[7] * (2.0f / 3.0f) * sp;
          HD[(4 + k) * RS + r] = dtint * tint * (1.0f - tint);
          SP[k * RS + r] = dsp * sp * (1.0f - sp);
        }
      }
      __syncthreads();

      // -- dir2, heads; dir2's input cotangent -> dir1's pre-act cotangent
      narrow_acc<3, 64>(a_dir2, SP, D2);
      bias_acc<3>(b_dir2, SP);
      narrow_acc<7, 32>(a_head, HD, HH);
      bias_acc<7>(b_head, HD);
      narrow_bwd<3, 64>(ps + DIR2_W, SP, [&](int i, int r, float v) {
        ZD1[i * RS + r] = v * GAUSS_2K * ZD1[i * RS + r] * D2[i * RS + r];
      });
      __syncthreads();
      // -- dir1 -> dir0's pre-act cotangent
      mma_acc<64, BWD_THREADS>(a_dir1, ZD1, D1);
      bias_acc<64>(b_dir1, ZD1);
      mma_bwd<64, WSD1, BWD_THREADS>(sWd1, ZD1, [&](int i, int r, float v) {
        ZD0[i * RS + r] = v * GAUSS_2K * ZD0[i * RS + r] * D1[i * RS + r];
      });
      __syncthreads();
      // -- dir0 -> (spatial1 out 32-63, SH); heads -> spatial1 out 0-31
      mma_acc<48, BWD_THREADS>(a_dir0, ZD0, HH + 32 * RS);
      bias_acc<64>(b_dir0, ZD0);
      mma_bwd<48, WSD0, BWD_THREADS>(sWd0, ZD0, [&](int i, int r, float v) {
        if (i < 32) D1[(32 + i) * RS + r] = v;
        else ZD1[(i - 32) * RS + r] = v;
      });
      narrow_bwd<7, 32>(ps + HEAD_W, HD, [&](int i, int r, float v) { D1[i * RS + r] = v; });
      __syncthreads();
      // -- spatial1 -> spatial0's pre-act cotangent
      mma_acc<64, BWD_THREADS>(a_sp1, D1, H0);
      bias_acc<64>(b_sp1, D1);
      mma_bwd<64, WS1, BWD_THREADS>(sW1, D1, [&](int i, int r, float v) {
        Z0[i * RS + r] = v * GAUSS_2K * Z0[i * RS + r] * H0[i * RS + r];
      });
      __syncthreads();
      // -- spatial0 -> features' cotangent (BARF weights are in the slab)
      mma_acc<32, BWD_THREADS>(a_sp0, Z0, F);
      bias_acc<64>(b_sp0, Z0);
      mma_bwd<32, WS0, BWD_THREADS>(sW0, Z0, [&](int i, int r, float v) { D2[i * RS + r] = v; });
      __syncthreads();

      // -- the features' cotangent out; dL/d dirs through the SH and
      // d / (|d| + 1e-8)
      for (int e = tid; e < 2 * L * R; e += BWD_THREADS) {
        const int i = e / R, r = e % R;
        dfc[(size_t)i * CHUNK + r0 + r] = D2[i * RS + r];
      }
      if (tid < R) {
        const int r = tid;
        const float dx = DIR[r], dy = DIR[RS + r], dz = DIR[2 * RS + r];
        const float len = sqrtf(dx * dx + dy * dy + dz * dz);
        const float nrm = len + 1e-8f;
        float ds[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) ds[j] = ZD1[j * RS + r];
        float gx, gy, gz;
        sh16_bwd(dx / nrm, dy / nrm, dz / nrm, ds, gx, gy, gz);
        float ox = gx / nrm, oy = gy / nrm, oz = gz / nrm;
        if (len > 0.0f) {
          const float s = (dx * gx + dy * gy + dz * gz) / (len * nrm * nrm);
          ox -= dx * s;
          oy -= dy * s;
          oz -= dz * s;
        }
        drow[4 * CHUNK + r0 + r] = ox;
        drow[5 * CHUNK + r0 + r] = oy;
        drow[6 * CHUNK + r0 + r] = oz;
        drow[3 * CHUNK + r0 + r] = 0.0f;
        drow[7 * CHUNK + r0 + r] = 0.0f;
      }
      __syncthreads();
    }
  }

  flush_acc<32, BWD_THREADS>(a_sp0, dslab + SP0_W);
  flush_acc<64, BWD_THREADS>(a_sp1, dslab + SP1_W);
  flush_acc<48, BWD_THREADS>(a_dir0, dslab + DIR0_W);
  flush_acc<64, BWD_THREADS>(a_dir1, dslab + DIR1_W);
  flush_entry<7 * 32>(a_head, dslab + HEAD_W);
  flush_entry<3 * 64>(a_dir2, dslab + DIR2_W);
  flush_entry<64>(b_sp0, dslab + B_SP0);
  flush_entry<64>(b_sp1, dslab + B_SP1);
  flush_entry<7>(b_head, dslab + B_HEAD);
  flush_entry<64>(b_dir0, dslab + B_DIR0);
  flush_entry<64>(b_dir1, dslab + B_DIR1);
  flush_entry<3>(b_dir2, dslab + B_DIR2);
}

}  // namespace

extern "C" int scanerf_train_fwd(const float* pts, const int* meta, const float* table,
                                 long long row_stride, int L, const int* res,
                                 const float* slab, int nw, int NC, float* cols,
                                 float* feats, void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const size_t smem = sizeof(float) * F_FLOATS;
  cudaError_t e = persistent_grid(train_fwd_kernel, FWD_THREADS, smem, NC, &grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) {
    train_fwd_kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, table, row_stride, L, res, slab, nw, NC, cols, feats);
  }
  return (int)cudaGetLastError();
}

// B6a: the decoder backward. Writes d_feats [NC, L*2, CHUNK] of live
// chunks, dpts rows 3-7 of every chunk, and adds the slab gradient into
// dslab (zeroed by the caller).
extern "C" int scanerf_train_bwd(const float* pts, const int* meta, const float* slab,
                                 const float* feats, const float* g, int L, int NC,
                                 float* dfeat, float* dpts, float* dslab, void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const size_t smem = sizeof(float) * S_FLOATS;
  cudaError_t e = persistent_grid(decoder_bwd_kernel, BWD_THREADS, smem, NC, &grid);
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) {
    decoder_bwd_kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, slab, feats, g, L, NC, dfeat, dpts, dslab);
  }
  return (int)cudaGetLastError();
}

// Blocks an SM holds of B5 and of B6a (the occupancy their persistent
// grids get), and the dynamic shared memory of a block of each, in bytes.
extern "C" int scanerf_train_occupancy(int* fwd, int* bwd, int* fwd_smem, int* bwd_smem) {
  *fwd_smem = (int)(sizeof(float) * F_FLOATS);
  *bwd_smem = (int)(sizeof(float) * S_FLOATS);
  cudaError_t e = blocks_per_sm(train_fwd_kernel, FWD_THREADS, *fwd_smem, fwd);
  if (e != cudaSuccess) return (int)e;
  return (int)blocks_per_sm(decoder_bwd_kernel, BWD_THREADS, *bwd_smem, bwd);
}
