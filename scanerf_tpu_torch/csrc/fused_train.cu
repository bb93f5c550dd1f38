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
// B6a keeps every activation of the tile in shared memory (one stash row
// per feature, the tile's rows along it at stride RS = 72) beside the four
// large weight matrices (rows padded by 8 floats): 210 KB, one block of 512
// threads an SM. Those four matrices (32 -> 64, 64 -> 64, 48 -> 64, 64 ->
// 64: 97% of the multiply-adds) run on the tensor cores with mma.sync
// m16n8k8 TF32 in all three roles: the forward, the input cotangents and
// the weight-gradient sums. TF32 keeps 11 bits of each operand, too few for
// the checks against the plain version, so each operand is split, x = hi +
// lo, hi rounded to TF32 with two integer operations (cvt.rna.tf32.f32
// cost more than the products), and lo*hi + hi*lo + hi*hi is summed in f32
// (3xTF32, about f32's accuracy at three tensor-core products for one).
// A warp takes a row of 16 x 8 output tiles, so that it reads each A
// fragment once for its tiles; every fragment is read as 8-byte pairs that
// hit 32 banks (see load_a_rows). For the weight gradients each warp owns
// fixed tiles of each matrix and keeps their sums in registers over all the
// chunks its block visits (grid-stride over chunks), adding them to global
// memory once; a tile's 64 rows are summed in the tensor core, the tiles in
// f32 on the CUDA cores. The narrow heads (7 x 32, 3 x 64), the
// activations' derivatives and the bias sums stay on the CUDA cores. Chunks
// with no real row zero dpts rows 3-7 and do nothing else. Bound on the
// H100: the ~41 K multiply-adds a live row, three times over on the
// tensor cores, set the floor; the instructions that feed the tensor cores
// (fragment reads, the splits), the narrow layers and the tile's 13
// barriers with one block an SM set the time.

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 512;
constexpr int NWARP = BWD_THREADS / 32;
constexpr int R = 64;       // rows per backward tile
constexpr int MT = R / 16;  // mma tiles along the rows
constexpr int RS = R + 8;   // stride of a stash row

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

// the four large matrices in shared memory after the stash, [out][in] with
// rows of in + 8 floats
constexpr int WS0 = 32 + 8, WS1 = 64 + 8, WSD0 = 48 + 8, WSD1 = 64 + 8;
constexpr int SW0 = S_ROWS * RS, SW1 = SW0 + 64 * WS0, SWD0 = SW1 + 64 * WS1,
              SWD1 = SWD0 + 64 * WSD0, S_FLOATS = SWD1 + 64 * WSD1;

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
// B6a building blocks: the large layers on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// x = hi + lo to about f32's precision: hi is x rounded to TF32 (to nearest,
// ties away from zero, as cvt.rna.tf32.f32 does, but with two integer
// operations), lo the rest, whose low 13 bits the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// Fragment loads. The sum over k of a product is the same in any order of
// k, and the rows of A may be taken in any order that the result's rows
// follow, so each operand is read as 8-byte pairs where memory allows:
// lane (g, t) = (lane / 4, lane % 4) takes the fragment's k columns t and
// t + 4 as the pair 2t, 2t + 1 where k runs along memory ("kc"), and the
// fragment's rows g and g + 8 as the tile rows 2g, 2g + 1 where the rows
// run along memory. In the forward, where both happen, lanes t >= 2 take
// their k pair in swapped order, so that the four lanes' first k are 0, 2,
// 5, 7: 0, 16, 8, 24 banks apart at the stash row stride RS = 8 (mod 32).
// With that and the weight rows WS = 8 or 24 (mod 32), every read below
// hits 32 banks.

__device__ __forceinline__ void split4(float2 p, float2 q, uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       int i0, int i1, int i2, int i3) {
  split_tf32(p.x, hi[i0], lo[i0]);
  split_tf32(p.y, hi[i1], lo[i1]);
  split_tf32(q.x, hi[i2], lo[i2]);
  split_tf32(q.y, hi[i3], lo[i3]);
}

// A over the tile's rows: element (row, k) at X[k * RS + row], rows paired;
// with KC the k columns paired too, swapped for t >= 2 (forward), else k
// and k + 4 (input cotangent, whose B cannot pair k).
template <bool KC>
__device__ __forceinline__ FragA load_a_rows(const float* X) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int k0 = KC ? 2 * t + (t >> 1) : t, k1 = KC ? 2 * t + 1 - (t >> 1) : t + 4;
  const float2 p = *reinterpret_cast<const float2*>(X + k0 * RS + 2 * g);
  const float2 q = *reinterpret_cast<const float2*>(X + k1 * RS + 2 * g);
  FragA f;
  split4(p, q, f.hi, f.lo, 0, 1, 2, 3);
  return f;
}

// A with k along memory: element (m, k) at P[m * S + k], k paired
// (weight gradients: k is the tile's row).
template <int S>
__device__ __forceinline__ FragA load_a_kc(const float* P) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 p = *reinterpret_cast<const float2*>(P + g * S + 2 * t);
  const float2 q = *reinterpret_cast<const float2*>(P + (g + 8) * S + 2 * t);
  FragA f;
  split4(p, q, f.hi, f.lo, 0, 2, 1, 3);
  return f;
}

// B with k along memory: element (k, n) at P[n * S + k], k paired; with
// SWAP swapped for t >= 2, as load_a_rows<true> takes them.
template <int S, bool SWAP>
__device__ __forceinline__ FragB load_b_kc(const float* P) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 p = *reinterpret_cast<const float2*>(P + g * S + 2 * t);
  const bool sw = SWAP && t >= 2;
  FragB f;
  split_tf32(sw ? p.y : p.x, f.hi[0], f.lo[0]);
  split_tf32(sw ? p.x : p.y, f.hi[1], f.lo[1]);
  return f;
}

// B with n along memory: element (k, n) at P[k * S + n], k and k + 4.
template <int S>
__device__ __forceinline__ FragB load_b_nc(const float* P) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  FragB f;
  split_tf32(P[t * S + g], f.hi[0], f.lo[0]);
  split_tf32(P[(t + 4) * S + g], f.hi[1], f.lo[1]);
  return f;
}

// d += a b in 3xTF32, the small cross terms first. The tensor core sums in
// f32 with a bias: fine over one product's k (at most 24 terms here), not
// over a weight gradient's millions of rows (see mma_acc).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Element q of a lane's 16 x 8 accumulator tile: column 2t (+ 1 for odd q);
// row g (+ 8 for q >= 2), or, where the rows were paired, the tile row 2g
// (+ 1 for q >= 2).
__device__ __forceinline__ int acc_row(int q) { return ((threadIdx.x & 31) >> 2) + (q >> 1) * 8; }
__device__ __forceinline__ int acc_row_paired(int q) {
  return 2 * ((threadIdx.x & 31) >> 2) + (q >> 1);
}
__device__ __forceinline__ int acc_col(int q) { return 2 * (threadIdx.x & 3) + (q & 1); }

// The tiles of a product with MTILES x NTILES tiles of 16 x 8 that a warp
// takes: one row of tiles, (warp % MTILES), and the columns warp / MTILES +
// j * (NWARP / MTILES) for j < tiles_per_warp, so that the warp loads each A
// fragment once for all its tiles.
template <int MTILES, int NTILES>
struct WarpTiles {
  static_assert(NWARP % MTILES == 0, "the warps split evenly over the tile rows");
  static constexpr int NG = NWARP / MTILES;
  static constexpr int TPW = (NTILES + NG - 1) / NG;
  __device__ static int m0() { return ((threadIdx.x >> 5) % MTILES) * 16; }
  __device__ static int n0(int j) { return ((threadIdx.x >> 5) / MTILES + j * NG) * 8; }
  __device__ static bool has(int j) {
    return NTILES % NG == 0 || (threadIdx.x >> 5) / MTILES + j * NG < NTILES;
  }
};

// Z[o][r] = sum_i W[o][i] X[i][r] + b[o] for the 64 outputs of a layer whose
// weights sW (row stride WS) are in shared memory; with A, also A[o][r] =
// gauss(Z). Tiles of (rows, outputs).
template <int I, int WS>
__device__ __forceinline__ void mma_fwd(const float* sW, const float* __restrict__ b,
                                        const float* X, float* Z, float* A) {
  using T = WarpTiles<MT, 8>;
  const int m0 = T::m0();
  float d[T::TPW][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < I; k0 += 8) {
    const FragA a = load_a_rows<true>(X + k0 * RS + m0);
#pragma unroll
    for (int j = 0; j < T::TPW; ++j)
      if (T::has(j)) mma3(d[j], a, load_b_kc<WS, true>(sW + T::n0(j) * WS + k0));
  }
#pragma unroll
  for (int j = 0; j < T::TPW; ++j) {
    if (!T::has(j)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = m0 + acc_row_paired(q), o = T::n0(j) + acc_col(q);
      const float v = d[j][q] + __ldg(b + o);
      Z[o * RS + r] = v;
      if (A) A[o * RS + r] = gauss(v);
    }
  }
}

// Input cotangent of a 64-output layer for its first NI inputs: epi(i, r,
// sum_o dY[o][r] W[o][i]). Tiles of (rows, inputs).
template <int NI, int WS, typename Epi>
__device__ __forceinline__ void mma_bwd(const float* sW, const float* dY, Epi epi) {
  using T = WarpTiles<MT, NI / 8>;
  const int m0 = T::m0();
  float d[T::TPW][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < 64; k0 += 8) {
    const FragA a = load_a_rows<false>(dY + k0 * RS + m0);
#pragma unroll
    for (int j = 0; j < T::TPW; ++j)
      if (T::has(j)) mma3(d[j], a, load_b_nc<WS>(sW + k0 * WS + T::n0(j)));
  }
#pragma unroll
  for (int j = 0; j < T::TPW; ++j) {
    if (!T::has(j)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) epi(T::n0(j) + acc_col(q), m0 + acc_row_paired(q), d[j][q]);
  }
}

// Weight-gradient sums of a [64, I] matrix over the tile's rows, tiles of
// (outputs, inputs): acc[j] is this warp's tile j, kept over all chunks.
// The tile's sum is taken in a fresh accumulator and added to acc on the
// CUDA cores (round to nearest): summed in the tensor core over all the
// rows a block visits, the gradient drifts beyond the checks' tolerance.
template <int I>
using AccTiles = WarpTiles<4, I / 8>;

template <int I>
__device__ __forceinline__ void mma_acc(float (&acc)[AccTiles<I>::TPW][4], const float* dY,
                                        const float* X) {
  using T = AccTiles<I>;
  const int m0 = T::m0();
  float d[T::TPW][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += 8) {
    const FragA a = load_a_kc<RS>(dY + m0 * RS + k0);
#pragma unroll
    for (int j = 0; j < T::TPW; ++j)
      if (T::has(j)) mma3(d[j], a, load_b_kc<RS, false>(X + T::n0(j) * RS + k0));
  }
#pragma unroll
  for (int j = 0; j < T::TPW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += d[j][q];
}

template <int I>
__device__ __forceinline__ void flush_acc(const float (&acc)[AccTiles<I>::TPW][4],
                                          float* dst) {
  using T = AccTiles<I>;
#pragma unroll
  for (int j = 0; j < T::TPW; ++j) {
    if (!T::has(j)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      atomicAdd(dst + (T::m0() + acc_row(q)) * I + T::n0(j) + acc_col(q), acc[j][q]);
  }
}

// Copy an [O, I] matrix of the slab into shared memory with rows of WS.
template <int O, int I, int WS>
__device__ __forceinline__ void stage_weights(const float* __restrict__ src, float* dst) {
  for (int e = threadIdx.x; e < O * I; e += BWD_THREADS) dst[(e / I) * WS + e % I] = src[e];
}

// ---------------------------------------------------------------------------
// B6a building blocks on the CUDA cores: the narrow heads
// ---------------------------------------------------------------------------

// Z[o][r] = sum_i W[o][i] X[i][r] + b[o] for a narrow layer, one output of
// one row a thread.
template <int O, int I>
__device__ __forceinline__ void narrow_fwd(const float* __restrict__ W,
                                           const float* __restrict__ b, const float* X,
                                           float* Z) {
  for (int e = threadIdx.x; e < O * R; e += BWD_THREADS) {
    const int o = e / R, r = e % R;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < I; ++i) acc = fmaf(__ldg(W + o * I + i), X[i * RS + r], acc);
    Z[o * RS + r] = acc + __ldg(b + o);
  }
}

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
  float* sW0 = st + SW0;
  float* sW1 = st + SW1;
  float* sWd0 = st + SWD0;
  float* sWd1 = st + SWD1;
  stage_weights<64, 32, WS0>(ps + SP0_W, sW0);
  stage_weights<64, 64, WS1>(ps + SP1_W, sW1);
  stage_weights<64, 48, WSD0>(ps + DIR0_W, sWd0);
  stage_weights<64, 64, WSD1>(ps + DIR1_W, sWd1);

  // this warp's weight-gradient tiles of spatial0, spatial1, dir0 and dir1;
  // this thread's entry of heads and dir2 and its bias entries
  float a_sp0[AccTiles<32>::TPW][4] = {}, a_sp1[AccTiles<64>::TPW][4] = {},
        a_dir0[AccTiles<48>::TPW][4] = {}, a_dir1[AccTiles<64>::TPW][4] = {};
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
      mma_fwd<32, WS0>(sW0, ps + B_SP0, F, Z0, H0);
      __syncthreads();
      mma_fwd<64, WS1>(sW1, ps + B_SP1, H0, HH, nullptr);
      __syncthreads();
      narrow_fwd<7, 32>(ps + HEAD_W, ps + B_HEAD, HH, HD);
      mma_fwd<48, WSD0>(sWd0, ps + B_DIR0, HH + 32 * RS, ZD0, D1);
      __syncthreads();
      mma_fwd<64, WSD1>(sWd1, ps + B_DIR1, D1, ZD1, D2);
      __syncthreads();
      narrow_fwd<3, 64>(ps + DIR2_W, ps + B_DIR2, D2, SP);
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
      mma_acc<64>(a_dir1, ZD1, D1);
      bias_acc<64>(b_dir1, ZD1);
      mma_bwd<64, WSD1>(sWd1, ZD1, [&](int i, int r, float v) {
        ZD0[i * RS + r] = v * GAUSS_2K * ZD0[i * RS + r] * D1[i * RS + r];
      });
      __syncthreads();
      // -- dir0 -> (spatial1 out 32-63, SH); heads -> spatial1 out 0-31
      mma_acc<48>(a_dir0, ZD0, HH + 32 * RS);
      bias_acc<64>(b_dir0, ZD0);
      mma_bwd<48, WSD0>(sWd0, ZD0, [&](int i, int r, float v) {
        if (i < 32) D1[(32 + i) * RS + r] = v;
        else ZD1[(i - 32) * RS + r] = v;
      });
      narrow_bwd<7, 32>(ps + HEAD_W, HD, [&](int i, int r, float v) { D1[i * RS + r] = v; });
      __syncthreads();
      // -- spatial1 -> spatial0's pre-act cotangent
      mma_acc<64>(a_sp1, D1, H0);
      bias_acc<64>(b_sp1, D1);
      mma_bwd<64, WS1>(sW1, D1, [&](int i, int r, float v) {
        Z0[i * RS + r] = v * GAUSS_2K * Z0[i * RS + r] * H0[i * RS + r];
      });
      __syncthreads();
      // -- spatial0 -> features' cotangent (BARF weights are in the slab)
      mma_acc<32>(a_sp0, Z0, F);
      bias_acc<64>(b_sp0, Z0);
      mma_bwd<32, WS0>(sW0, Z0, [&](int i, int r, float v) { D2[i * RS + r] = v; });
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

  flush_acc<32>(a_sp0, dslab + SP0_W);
  flush_acc<64>(a_sp1, dslab + SP1_W);
  flush_acc<48>(a_dir0, dslab + DIR0_W);
  flush_acc<64>(a_dir1, dslab + DIR1_W);
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

// B6a: the decoder backward. Writes d_feats [NC, L*2, CHUNK] of live
// chunks, dpts rows 3-7 of every chunk, and adds the slab gradient into
// dslab (zeroed by the caller).
extern "C" int scanerf_train_bwd(const float* pts, const int* meta, const float* slab,
                                 const float* feats, const float* g, int L, int NC,
                                 float* dfeat, float* dpts, float* dslab, void* stream) {
  if (L > MAXL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * S_FLOATS;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_bwd_kernel,
                                                         BWD_THREADS, smem)) != cudaSuccess)
    return (int)e;
  const int grid = NC < sms * max(per_sm, 1) ? NC : sms * max(per_sm, 1);
  if (grid > 0) {
    decoder_bwd_kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, slab, feats, g, L, NC, dfeat, dpts, dslab);
  }
  return (int)cudaGetLastError();
}
