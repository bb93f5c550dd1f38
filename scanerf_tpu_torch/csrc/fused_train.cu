// B5 and B6: the fused windowed hash + ShallowMLP training kernels for Hopper
// (sm_90a), forward and backward.
//
// B5 replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/fused_train.py::
// _ft_fwd_kernel (launched at fused_train.py:348); B6 replaces
// fused_train.py::_ft_bwd_kernel (launched at fused_train.py:389). Same
// results as ops/kernels/fused_train.py::train_fwd_plain / train_bwd_plain,
// up to the order of f32 sums.
//
// B5, per stream row: the 16-level windowed gather of decoder.cuh, then the
// ShallowMLP forward with the training slab (BARF's annealing weights folded
// into spatial0's input columns). Outputs the 8 training columns (sigma,
// diffuse x3, tint * specular x3, mean specular^2) and, when asked, the
// features as the backward's residual [NC, L, 2, CHUNK]. Rows in the
// sentinel window decode zero features; chunks with no real row write zero
// columns and zero features. Design: B7's, one block of 256 threads per
// 1024-row chunk with the slab (56 KB) in shared memory, features and
// activations in registers. Bound on the H100: the ~13.7 K f32 multiply-adds
// of the decoder per live row (CUDA cores); the gathers stay in one 2 MB
// block of windows per chunk, which L2 holds.
//
// B6, per live chunk, in tiles of 32 rows: the decoder forward is recomputed
// from the saved features, then the hand-derived pullback of the 8 column
// cotangents (softplus, sigmoid, Gaussian and SH-16 derivatives, the
// direction normalisation d / (|d| + 1e-8)) gives the features' cotangent,
// which is scattered into the dense, zeroed table gradient with atomicAdd
// over 8 corners x 16 levels (entries no row touches stay zero; the scatter is
// decoder.cuh::scatter_level, shared with B4 in hash_encode.cu), and the
// positions' cotangent through the trilinear weights (dpts rows 0-2) and
// the directions' (rows 4-6). The whole tile runs each layer as a small
// product over its 32 rows, with every activation in shared memory
// (column-major, stride 33, so both row-wise and column-wise reads are free
// of bank conflicts); a thread computes 4 outputs at a time and reads the
// weights as float4 broadcasts. The decoder-parameter gradient is a sum over
// all live rows: each thread owns a fixed block of every weight matrix (4 x 4
// of the 64 x 64 ones) and keeps its sums in registers over all the chunks
// its block visits (grid-stride over chunks, two blocks per SM), and adds
// them to global memory once per block.
// Chunks with no real row write zero dpts and do nothing else. Bound on the
// H100: the ~41 K f32 multiply-adds per live row (forward, input and weight
// gradients) and the shared-memory reads that feed them; the scatter adds
// 256 atomics per row into L2.

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;
constexpr int R = 32;       // rows per backward tile
constexpr int RS = R + 1;   // stride of a stash row

// stash rows of the backward tile, each [RS] floats; a row index is the
// vector element, the column the tile row
constexpr int S_F = 0;      // 32 features
constexpr int S_Z0 = 32;    // 64 spatial0 pre-act, then its cotangent
constexpr int S_H0 = 96;    // 64 spatial0 Gauss
constexpr int S_HH = 160;   // 64 spatial1 out (0-31 heads input, 32-63 dir input)
constexpr int S_SH = 224;   // 16 SH (right after S_HH: dir0's input is rows 192..239)
constexpr int S_ZD0 = 240;  // 64 dir0 pre-act, then its cotangent, then du staging
constexpr int S_D1 = 304;   // 64 dir0 Gauss, then the cotangent of spatial1's out
constexpr int S_ZD1 = 368;  // 64 dir1 pre-act, then its cotangent, then d SH
constexpr int S_D2 = 432;   // 64 dir1 Gauss, then the features' cotangent
constexpr int S_HD = 496;   // 7 head pre-acts, then their cotangents
constexpr int S_SP = 503;   // 3 specular pre-acts, then their cotangents
constexpr int S_G = 506;    // 8 column cotangents
constexpr int S_DIR = 514;  // 3 raw view dirs
constexpr int S_ROWS = 517;
constexpr float GAUSS_2K = 2.0f * GAUSS_K;

// ---------------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(FWD_THREADS)
train_fwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                 const float* __restrict__ table, long long row_stride, int L,
                 const int* __restrict__ res_g, const float* __restrict__ slab,
                 int nw, float* __restrict__ cols, float* __restrict__ feats) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);  // [PSLAB]
  __shared__ int res[3 * MAXL];
  const int c = blockIdx.x;
  float4* cols4 = reinterpret_cast<float4*>(cols) + (size_t)c * CHUNK * 2;
  float* fo = feats ? feats + (size_t)c * L * 2 * CHUNK : nullptr;

  if (chunk_work(meta, c) == 0) {
    for (int t = threadIdx.x; t < 2 * CHUNK; t += FWD_THREADS)
      cols4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (fo)
      for (int t = threadIdx.x; t < L * 2 * CHUNK; t += FWD_THREADS) fo[t] = 0.0f;
    return;
  }

  const float4* src = reinterpret_cast<const float4*>(slab);
  for (int i = threadIdx.x; i < PSLAB / 4; i += FWD_THREADS) smem4[i] = src[i];
  for (int i = threadIdx.x; i < 3 * L; i += FWD_THREADS) res[i] = res_g[i];
  __syncthreads();

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  for (int t = threadIdx.x; t < CHUNK; t += FWD_THREADS) {
    const float ux = prow[t], uy = prow[CHUNK + t], uz = prow[2 * CHUNK + t];
    const int w = (int)prow[3 * CHUNK + t];
    const float dx = prow[4 * CHUNK + t], dy = prow[5 * CHUNK + t], dz = prow[6 * CHUNK + t];

    float feat[2 * MAXL];
    if (w < nw) {
      encode<float>(table, row_stride, L, res, w, ux, uy, uz, feat);
    } else {
#pragma unroll
      for (int i = 0; i < 2 * MAXL; ++i) feat[i] = 0.0f;
    }
    if (fo) {
#pragma unroll
      for (int i = 0; i < 2 * MAXL; ++i)
        if (i < 2 * L) fo[(size_t)i * CHUNK + t] = feat[i];
    }

    float heads[7], spec[3];
    decoder_forward(ps, feat, dx, dy, dz, heads, spec);
    const float s0 = sigmoid(spec[0]), s1 = sigmoid(spec[1]), s2 = sigmoid(spec[2]);
    cols4[2 * t] = make_float4(softplus(heads[0]), sigmoid(heads[1]),
                               sigmoid(heads[2]), sigmoid(heads[3]));
    cols4[2 * t + 1] = make_float4(sigmoid(heads[4]) * s0, sigmoid(heads[5]) * s1,
                                   sigmoid(heads[6]) * s2,
                                   (s0 * s0 + s1 * s1 + s2 * s2) / 3.0f);
  }
}

// ---------------------------------------------------------------------------
// B6 building blocks: one layer over the 32 rows of a tile
// ---------------------------------------------------------------------------

// Z[o][r] = sum_i W[o][i] X[i][r] + b[o]; with A, also A[o][r] = gauss(Z).
// A thread takes 4 outputs of one row (the 7- and 3-wide heads: one) and
// reads W as float4; a warp takes the 32 rows of one output group, so the
// W reads are broadcasts and the X reads hit 32 banks.
template <int O, int I>
__device__ __forceinline__ void layer_fwd(const float* __restrict__ W,
                                          const float* __restrict__ b,
                                          const float* X, float* Z, float* A) {
  constexpr int OB = O % 4 == 0 ? 4 : 1;
  static_assert(I % 4 == 0, "rows of W are read as float4");
  for (int e = threadIdx.x; e < (O / OB) * R; e += BWD_THREADS) {
    const int o0 = (e / R) * OB, r = e % R;
    float acc[OB];
#pragma unroll
    for (int a = 0; a < OB; ++a) acc[a] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < I; i += 4) {
      const float x0 = X[i * RS + r], x1 = X[(i + 1) * RS + r], x2 = X[(i + 2) * RS + r],
                  x3 = X[(i + 3) * RS + r];
#pragma unroll
      for (int a = 0; a < OB; ++a) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(W + (o0 + a) * I + i));
        acc[a] = fmaf(w.x, x0, acc[a]);
        acc[a] = fmaf(w.y, x1, acc[a]);
        acc[a] = fmaf(w.z, x2, acc[a]);
        acc[a] = fmaf(w.w, x3, acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < OB; ++a) {
      const float v = acc[a] + __ldg(b + o0 + a);
      Z[(o0 + a) * RS + r] = v;
      if (A) A[(o0 + a) * RS + r] = gauss(v);
    }
  }
}

// Input cotangent of a layer for its first NI inputs: epi(i, r,
// sum_o dY[o][r] W[o][i]). A thread takes 4 consecutive inputs of one row
// and reads W as float4.
template <int O, int I, int NI, typename Epi>
__device__ __forceinline__ void layer_bwd(const float* __restrict__ W, const float* dY,
                                          Epi epi) {
  static_assert(NI % 4 == 0 && I % 4 == 0, "W is read as float4");
  for (int e = threadIdx.x; e < (NI / 4) * R; e += BWD_THREADS) {
    const int i0 = (e / R) * 4, r = e % R;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
    for (int o = 0; o < O; ++o) {
      const float d = dY[o * RS + r];
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + o * I + i0));
      a0 = fmaf(d, w.x, a0);
      a1 = fmaf(d, w.y, a1);
      a2 = fmaf(d, w.z, a2);
      a3 = fmaf(d, w.w, a3);
    }
    epi(i0, r, a0);
    epi(i0 + 1, r, a1);
    epi(i0 + 2, r, a2);
    epi(i0 + 3, r, a3);
  }
}

// Weight-gradient sums of an [O, I] matrix over the tile's rows. Thread t
// owns the BO x BI block at row (t / (I / BI)) * BO, column (t % (I / BI)) * BI
// (BO + BI shared reads for BO * BI multiply-adds a row).
template <int O, int I, int BO, int BI>
__device__ __forceinline__ void acc_weights(float (&acc)[BO * BI], const float* dY,
                                            const float* X) {
  static_assert((O / BO) * (I / BI) == BWD_THREADS, "one block per thread");
  const int o0 = (threadIdx.x / (I / BI)) * BO, i0 = (threadIdx.x % (I / BI)) * BI;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    float d[BO], x[BI];
#pragma unroll
    for (int a = 0; a < BO; ++a) d[a] = dY[(o0 + a) * RS + r];
#pragma unroll
    for (int c = 0; c < BI; ++c) x[c] = X[(i0 + c) * RS + r];
#pragma unroll
    for (int a = 0; a < BO; ++a)
#pragma unroll
      for (int c = 0; c < BI; ++c) acc[a * BI + c] = fmaf(d[a], x[c], acc[a * BI + c]);
  }
}

template <int O, int I, int BO, int BI>
__device__ __forceinline__ void flush_weights(const float (&acc)[BO * BI], float* dst) {
  const int o0 = (threadIdx.x / (I / BI)) * BO, i0 = (threadIdx.x % (I / BI)) * BI;
#pragma unroll
  for (int a = 0; a < BO; ++a)
#pragma unroll
    for (int c = 0; c < BI; ++c) atomicAdd(dst + (o0 + a) * I + i0 + c, acc[a * BI + c]);
}

// The same for the narrow heads (7 x 32, 3 x 64): one entry per thread.
template <int O, int I>
__device__ __forceinline__ void acc_weights_narrow(float& acc, const float* dY,
                                                   const float* X) {
  static_assert(O * I <= BWD_THREADS, "one entry per thread");
  const int e = threadIdx.x;
  if (e < O * I) {
    const float* a = dY + (e / I) * RS;
    const float* x = X + (e % I) * RS;
    for (int r = 0; r < R; ++r) acc = fmaf(a[r], x[r], acc);
  }
}

template <int O, int I>
__device__ __forceinline__ void flush_narrow(float acc, float* dst) {
  if (threadIdx.x < O * I) atomicAdd(dst + threadIdx.x, acc);
}

template <int O>
__device__ __forceinline__ void acc_bias(float& acc, const float* dY) {
  if (threadIdx.x < O) {
    const float* a = dY + threadIdx.x * RS;
    for (int r = 0; r < R; ++r) acc += a[r];
  }
}

template <int O>
__device__ __forceinline__ void flush_bias(float acc, float* dst) {
  if (threadIdx.x < O) atomicAdd(dst + threadIdx.x, acc);
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

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BWD_THREADS, 2)
train_bwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                 const float* __restrict__ table, long long row_stride, int L,
                 const int* __restrict__ res_g, const float* __restrict__ ps,
                 const float* __restrict__ feats, const float* __restrict__ g,
                 int nw, int NC, float* __restrict__ dtab, float* __restrict__ dpts,
                 float* __restrict__ dslab) {
  extern __shared__ float st[];  // [S_ROWS][RS]
  __shared__ int res[3 * MAXL];
  for (int i = threadIdx.x; i < 3 * L; i += BWD_THREADS) res[i] = res_g[i];
  const int tid = threadIdx.x;

  // this thread's weight-gradient sums: 4 x 2, 4 x 4, 4 x 3 and 4 x 4 blocks
  // of spatial0, spatial1, dir0 and dir1, one entry of heads and dir2
  float a_sp0[8], a_sp1[16], a_dir0[12], a_dir1[16];
  float a_head = 0.f, a_dir2 = 0.f;
  float b_sp0 = 0.f, b_sp1 = 0.f, b_head = 0.f, b_dir0 = 0.f, b_dir1 = 0.f, b_dir2 = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < 8) a_sp0[k] = 0.f;
    if (k < 12) a_dir0[k] = 0.f;
    a_sp1[k] = a_dir1[k] = 0.f;
  }
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
      for (int t = tid; t < 8 * CHUNK; t += BWD_THREADS) drow[t] = 0.0f;
      continue;
    }
    const float* fch = feats + (size_t)c * L * 2 * CHUNK;
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
      layer_fwd<64, 32>(ps + SP0_W, ps + B_SP0, F, Z0, H0);
      __syncthreads();
      layer_fwd<64, 64>(ps + SP1_W, ps + B_SP1, H0, HH, nullptr);
      __syncthreads();
      layer_fwd<7, 32>(ps + HEAD_W, ps + B_HEAD, HH, HD, nullptr);
      layer_fwd<64, 48>(ps + DIR0_W, ps + B_DIR0, HH + 32 * RS, ZD0, D1);
      __syncthreads();
      layer_fwd<64, 64>(ps + DIR1_W, ps + B_DIR1, D1, ZD1, D2);
      __syncthreads();
      layer_fwd<3, 64>(ps + DIR2_W, ps + B_DIR2, D2, SP, nullptr);
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
      acc_weights_narrow<3, 64>(a_dir2, SP, D2);
      acc_bias<3>(b_dir2, SP);
      acc_weights_narrow<7, 32>(a_head, HD, HH);
      acc_bias<7>(b_head, HD);
      layer_bwd<3, 64, 64>(ps + DIR2_W, SP, [&](int i, int r, float v) {
        ZD1[i * RS + r] = v * GAUSS_2K * ZD1[i * RS + r] * D2[i * RS + r];
      });
      __syncthreads();
      // -- dir1 -> dir0's pre-act cotangent
      acc_weights<64, 64, 4, 4>(a_dir1, ZD1, D1);
      acc_bias<64>(b_dir1, ZD1);
      layer_bwd<64, 64, 64>(ps + DIR1_W, ZD1, [&](int i, int r, float v) {
        ZD0[i * RS + r] = v * GAUSS_2K * ZD0[i * RS + r] * D1[i * RS + r];
      });
      __syncthreads();
      // -- dir0 -> (spatial1 out 32-63, SH); heads -> spatial1 out 0-31
      acc_weights<64, 48, 4, 3>(a_dir0, ZD0, HH + 32 * RS);
      acc_bias<64>(b_dir0, ZD0);
      layer_bwd<64, 48, 48>(ps + DIR0_W, ZD0, [&](int i, int r, float v) {
        if (i < 32) D1[(32 + i) * RS + r] = v;
        else ZD1[(i - 32) * RS + r] = v;
      });
      layer_bwd<7, 32, 32>(ps + HEAD_W, HD, [&](int i, int r, float v) {
        D1[i * RS + r] = v;
      });
      __syncthreads();
      // -- spatial1 -> spatial0's pre-act cotangent
      acc_weights<64, 64, 4, 4>(a_sp1, D1, H0);
      acc_bias<64>(b_sp1, D1);
      layer_bwd<64, 64, 64>(ps + SP1_W, D1, [&](int i, int r, float v) {
        Z0[i * RS + r] = v * GAUSS_2K * Z0[i * RS + r] * H0[i * RS + r];
      });
      __syncthreads();
      // -- spatial0 -> features' cotangent (BARF weights are in the slab)
      acc_weights<64, 32, 4, 2>(a_sp0, Z0, F);
      acc_bias<64>(b_sp0, Z0);
      layer_bwd<64, 32, 32>(ps + SP0_W, Z0, [&](int i, int r, float v) {
        D2[i * RS + r] = v;
      });
      __syncthreads();

      // -- table scatter and dL/du, one (row, level) pair per thread
      for (int p = tid; p < R * L; p += BWD_THREADS) {
        const int r = p % R, l = p / R;
        const int t = r0 + r;
        const int w = (int)prow[3 * CHUNK + t];
        float du0 = 0.0f, du1 = 0.0f, du2 = 0.0f;
        if (w < nw)
          scatter_level(table + (size_t)l * row_stride, dtab + (size_t)l * row_stride, res,
                        l, w, prow[t], prow[CHUNK + t], prow[2 * CHUNK + t],
                        D2[(2 * l) * RS + r], D2[(2 * l + 1) * RS + r], du0, du1, du2);
        ZD0[(3 * l) * RS + r] = du0;
        ZD0[(3 * l + 1) * RS + r] = du1;
        ZD0[(3 * l + 2) * RS + r] = du2;
      }
      // -- dL/d dirs through the SH and d / (|d| + 1e-8)
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
      if (tid < 3 * R) {
        const int k = tid / R, r = tid % R;
        float s = 0.0f;
        for (int l = 0; l < L; ++l) s += ZD0[(3 * l + k) * RS + r];
        drow[k * CHUNK + r0 + r] = s;
      }
      __syncthreads();
    }
  }

  flush_weights<64, 32, 4, 2>(a_sp0, dslab + SP0_W);
  flush_weights<64, 64, 4, 4>(a_sp1, dslab + SP1_W);
  flush_narrow<7, 32>(a_head, dslab + HEAD_W);
  flush_weights<64, 48, 4, 3>(a_dir0, dslab + DIR0_W);
  flush_weights<64, 64, 4, 4>(a_dir1, dslab + DIR1_W);
  flush_narrow<3, 64>(a_dir2, dslab + DIR2_W);
  flush_bias<64>(b_sp0, dslab + B_SP0);
  flush_bias<64>(b_sp1, dslab + B_SP1);
  flush_bias<7>(b_head, dslab + B_HEAD);
  flush_bias<64>(b_dir0, dslab + B_DIR0);
  flush_bias<64>(b_dir1, dslab + B_DIR1);
  flush_bias<3>(b_dir2, dslab + B_DIR2);
}

}  // namespace

extern "C" int scanerf_train_fwd(const float* pts, const int* meta, const float* table,
                                 long long row_stride, int L, const int* res,
                                 const float* slab, int nw, int NC, float* cols,
                                 float* feats, void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * PSLAB;
  cudaError_t e = cudaFuncSetAttribute(
      train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (NC > 0) {
    train_fwd_kernel<<<NC, FWD_THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, table, row_stride, L, res, slab, nw, cols, feats);
  }
  return (int)cudaGetLastError();
}

extern "C" int scanerf_train_bwd(const float* pts, const int* meta, const float* table,
                                 long long row_stride, int L, const int* res,
                                 const float* slab, const float* feats, const float* g,
                                 int nw, int NC, float* dtab, float* dpts, float* dslab,
                                 void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * S_ROWS * RS;
  cudaError_t e = cudaFuncSetAttribute(
      train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, train_bwd_kernel,
                                                         BWD_THREADS, smem)) != cudaSuccess)
    return (int)e;
  const int grid = NC < sms * max(per_sm, 1) ? NC : sms * max(per_sm, 1);
  if (grid > 0) {
    train_bwd_kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, table, row_stride, L, res, slab, feats, g, nw, NC, dtab, dpts, dslab);
  }
  return (int)cudaGetLastError();
}
