// The ShallowMLP on the tensor cores, shared by B5 and B6a (fused_train.cu)
// and B7 (fused_render.cu): the 3xTF32 product with mma.sync m16n8k8 and
// its fragments; B6a's building blocks over tiles of R = 64 rows whose
// activations live in a shared-memory stash; the forward kernels' warp
// tiles of 16 rows, whose activations stay in registers (warp_tile); and
// the host side of the persistent launches.
//
// The four large matrices (32 -> 64, 64 -> 64, 48 -> 64, 64 -> 64: 97% of
// the multiply-adds) are staged [out][in] with rows padded by 8 floats.
// TF32 keeps 11 bits of each operand, too few for the checks against the
// plain versions, so each operand is split, x = hi + lo, hi rounded to TF32
// with two integer operations (cvt.rna.tf32.f32 cost more than the
// products), and lo*hi + hi*lo + hi*hi is summed in f32 (3xTF32, about
// f32's accuracy at three tensor-core products for one). In B6a's stash a
// row holds one feature or channel, the tile's rows along it at stride RS =
// 72; a warp takes a row of 16 x 8 output tiles, so that it reads each A
// fragment once for its tiles, and every fragment is read as 8-byte pairs
// that hit 32 banks (see load_a_rows). The helpers take the block's thread
// count NT.
#pragma once

#include "decoder.cuh"

namespace scanerf {

constexpr int R = 64;       // rows of a tile
constexpr int MT = R / 16;  // mma tiles along the rows
constexpr int RS = R + 8;   // stride of a stash row

// the four large matrices in shared memory, [out][in] with rows of in + 8
// floats, one after another from the staging base
constexpr int WS0 = 32 + 8, WS1 = 64 + 8, WSD0 = 48 + 8, WSD1 = 64 + 8;
constexpr int W_SP0 = 0, W_SP1 = W_SP0 + 64 * WS0, W_DIR0 = W_SP1 + 64 * WS1,
              W_DIR1 = W_DIR0 + 64 * WSD0, W_FLOATS = W_DIR1 + 64 * WSD1;

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
// of a block of NT threads takes: one row of tiles, (warp % MTILES), and
// the columns warp / MTILES + j * (warps / MTILES) for j < tiles_per_warp,
// so that the warp loads each A fragment once for all its tiles.
template <int MTILES, int NTILES, int NT>
struct WarpTiles {
  static constexpr int NWARP = NT / 32;
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
// weights sW (row stride WS) are in shared memory, and A[o][r] = gauss(Z);
// either may be null. Tiles of (rows, outputs).
template <int I, int WS, int NT>
__device__ __forceinline__ void mma_fwd(const float* sW, const float* __restrict__ b,
                                        const float* X, float* Z, float* A) {
  using T = WarpTiles<MT, 8, NT>;
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
      if (Z) Z[o * RS + r] = v;
      if (A) A[o * RS + r] = gauss(v);
    }
  }
}

// Input cotangent of a 64-output layer for its first NI inputs: epi(i, r,
// sum_o dY[o][r] W[o][i]). Tiles of (rows, inputs).
template <int NI, int WS, int NT, typename Epi>
__device__ __forceinline__ void mma_bwd(const float* sW, const float* dY, Epi epi) {
  using T = WarpTiles<MT, NI / 8, NT>;
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
template <int I, int NT>
using AccTiles = WarpTiles<4, I / 8, NT>;

template <int I, int NT>
__device__ __forceinline__ void mma_acc(float (&acc)[AccTiles<I, NT>::TPW][4], const float* dY,
                                        const float* X) {
  using T = AccTiles<I, NT>;
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

template <int I, int NT>
__device__ __forceinline__ void flush_acc(const float (&acc)[AccTiles<I, NT>::TPW][4],
                                          float* dst) {
  using T = AccTiles<I, NT>;
#pragma unroll
  for (int j = 0; j < T::TPW; ++j) {
    if (!T::has(j)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      atomicAdd(dst + (T::m0() + acc_row(q)) * I + T::n0(j) + acc_col(q), acc[j][q]);
  }
}

// Copy an [O, I] matrix of the slab into shared memory with rows of WS.
template <int O, int I, int WS, int NT>
__device__ __forceinline__ void stage_weights(const float* __restrict__ src, float* dst) {
  for (int e = threadIdx.x; e < O * I; e += NT) dst[(e / I) * WS + e % I] = src[e];
}

// The four large matrices of slab ps into sW (W_FLOATS floats).
template <int NT>
__device__ __forceinline__ void stage_decoder(const float* __restrict__ ps, float* sW) {
  stage_weights<64, 32, WS0, NT>(ps + SP0_W, sW + W_SP0);
  stage_weights<64, 64, WS1, NT>(ps + SP1_W, sW + W_SP1);
  stage_weights<64, 48, WSD0, NT>(ps + DIR0_W, sW + W_DIR0);
  stage_weights<64, 64, WSD1, NT>(ps + DIR1_W, sW + W_DIR1);
}

// Z[o][r] = sum_i W[o][i] X[i][r] + b[o] for a narrow layer on the CUDA
// cores, one output of one row a thread.
template <int O, int I, int NT>
__device__ __forceinline__ void narrow_fwd(const float* __restrict__ W,
                                           const float* __restrict__ b, const float* X,
                                           float* Z) {
  for (int e = threadIdx.x; e < O * R; e += NT) {
    const int o = e / R, r = e % R;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < I; ++i) acc = fmaf(__ldg(W + o * I + i), X[i * RS + r], acc);
    Z[o * RS + r] = acc + __ldg(b + o);
  }
}

// ---------------------------------------------------------------------------
// The forward kernels (B5, B7): warps that own their rows
// ---------------------------------------------------------------------------
//
// A warp decodes a warp tile of WR = 16 stream rows from its gather to its
// outputs with every activation in registers, so the tile needs no barrier
// and no shared-memory stash, and the warps of an SM run apart: one warp's
// gather waits on L2 while the others' products run. Lane (g, t) = (lane /
// 4, lane % 4) holds, for each block j of 8 channels of a layer's output,
// the mma accumulator's elements: tile rows g and g + 8, channels 8j + 2t
// and 8j + 2t + 1, in the order (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1). The next layer takes them as its A fragment for k-block j where
// they are: its fragment's k columns t and t + 4 are read as the inputs 8j +
// 2t and 8j + 2t + 1 (the sum over k is the same in any order, if B's rows
// follow), so A = (c0, c2, c1, c3). The gather fills the first layer's A
// fragments the same way: k-block kb holds levels 4kb .. 4kb + 3, the pair
// 2t, 2t + 1 of it being level 4kb + t, so each lane gathers 8 (row, level)
// pairs. The large matrices are staged split (hi, then lo at F_LO), so the
// products read their B fragments without splitting them; the narrow heads
// and dir2 run on the CUDA cores, each lane summing its channels and the 4
// lanes of a row group adding theirs with shuffles.

constexpr int WR = 16;  // rows of a warp tile

// the staged forward slab: the four large matrices at W_* rounded to TF32
// (hi), their remainders at F_LO + W_* (lo), then the slab's 256 floats
// from HEAD_W (the heads) and its floats from DIR2_W to its end (dir2 and
// the biases)
constexpr int F_LO = W_FLOATS, F_HEAD = 2 * W_FLOATS, F_DIR2 = F_HEAD + 256,
              F_FLOATS = F_DIR2 + PSLAB - DIR2_W;
// where the slab's float at offset off >= DIR2_W is staged
__host__ __device__ constexpr int f_tail(int off) { return F_DIR2 + off - DIR2_W; }

// Copy an [O, I] matrix of the slab into shared memory with rows of WS,
// split: hi at dst, lo at F_LO beyond.
template <int O, int I, int WS, int NT>
__device__ __forceinline__ void stage_split(const float* __restrict__ src, float* dst) {
  for (int e = threadIdx.x; e < O * I; e += NT) {
    uint32_t hi, lo;
    split_tf32(src[e], hi, lo);
    dst[(e / I) * WS + e % I] = __uint_as_float(hi);
    dst[F_LO + (e / I) * WS + e % I] = __uint_as_float(lo);
  }
}

// Slab ps into sW (F_FLOATS floats) for the forward kernels.
template <int NT>
__device__ __forceinline__ void stage_forward(const float* __restrict__ ps, float* sW) {
  stage_split<64, 32, WS0, NT>(ps + SP0_W, sW + W_SP0);
  stage_split<64, 64, WS1, NT>(ps + SP1_W, sW + W_SP1);
  stage_split<64, 48, WSD0, NT>(ps + DIR0_W, sW + W_DIR0);
  stage_split<64, 64, WSD1, NT>(ps + DIR1_W, sW + W_DIR1);
  for (int e = threadIdx.x; e < 256; e += NT) sW[F_HEAD + e] = ps[HEAD_W + e];
  for (int e = threadIdx.x; e < PSLAB - DIR2_W; e += NT) sW[F_DIR2 + e] = ps[DIR2_W + e];
}

// The A fragment of one k-block from its values in accumulator order.
__device__ __forceinline__ FragA frag_a(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of a staged split matrix: element (k, n) at [n * S + k]
// (hi) and F_LO beyond (lo), k the pair 2t, 2t + 1 of the k-block.
template <int S>
__device__ __forceinline__ FragB frag_b(const float* P) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 h = *reinterpret_cast<const float2*>(P + g * S + 2 * t);
  const float2 l = *reinterpret_cast<const float2*>(P + F_LO + g * S + 2 * t);
  FragB f;
  f.hi[0] = __float_as_uint(h.x);
  f.hi[1] = __float_as_uint(h.y);
  f.lo[0] = __float_as_uint(l.x);
  f.lo[1] = __float_as_uint(l.y);
  return f;
}

// out = act(in W^T + b) over the warp tile for a 64-output layer of KB
// k-blocks: in and out in accumulator order, W staged split at sW with row
// stride S, b its staged bias; on the tensor cores in 3xTF32.
template <int KB, int S, bool GAUSS>
__device__ __forceinline__ void warp_layer(const float (&in)[KB][4], const float* sW,
                                           const float* b, float (&out)[8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[j][q] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const FragA a = frag_a(in[kb]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma3(out[j], a, frag_b<S>(sW + 8 * j * S + 8 * kb));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = out[j][q] + ((q & 1) ? bb.y : bb.x);
      out[j][q] = GAUSS ? gauss(v) : v;
    }
  }
}

// O outputs of a narrow layer over the first KB k-blocks of x (accumulator
// order) on the CUDA cores: W [O][I] row-major, b its bias; s0 for tile row
// g, s8 for g + 8, the same on the 4 lanes of the row group.
template <int O, int I, int KB>
__device__ __forceinline__ void warp_narrow(const float (&x)[8][4], const float* W,
                                            const float* b, float (&s0)[O], float (&s8)[O]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int o = 0; o < O; ++o) {
    float a0 = 0.0f, a8 = 0.0f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(W + o * I + 8 * j + 2 * t);
      a0 = fmaf(w.x, x[j][0], a0);
      a0 = fmaf(w.y, x[j][1], a0);
      a8 = fmaf(w.x, x[j][2], a8);
      a8 = fmaf(w.y, x[j][3], a8);
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
    a8 += __shfl_xor_sync(0xffffffffu, a8, 1);
    a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
    a8 += __shfl_xor_sync(0xffffffffu, a8, 2);
    s0[o] = a0 + b[o];
    s8[o] = a8 + b[o];
  }
}

// sh[i], sh[i + 1] for i = 2t + base (t < 4): the SH pair lane t feeds.
__device__ __forceinline__ float2 sh_pair(const float (&sh)[16], int base) {
  const int t = threadIdx.x & 3;
  return t == 0 ? make_float2(sh[base], sh[base + 1])
         : t == 1 ? make_float2(sh[base + 2], sh[base + 3])
         : t == 2 ? make_float2(sh[base + 4], sh[base + 5])
                  : make_float2(sh[base + 6], sh[base + 7]);
}

// The SH-16 of the view dir of stream row t of a chunk (pts rows at prow),
// normalized as d / (|d| + 1e-8).
__device__ __forceinline__ void row_sh(const float* __restrict__ prow, int t, float (&sh)[16]) {
  const float dx = prow[4 * CHUNK + t], dy = prow[5 * CHUNK + t], dz = prow[6 * CHUNK + t];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz) + 1e-8f;
  sh16(dx / nrm, dy / nrm, dz / nrm, sh);
}

// The head pre-activations (hd*: sigma, diffuse x3, tint x3) and the
// specular ones (sp*) of rows g (..0) and g + 8 (..8) of the warp tile at
// rows r0 of a chunk (pts rows at prow): the windowed gather, bit for bit
// decoder.cuh::encode_level's (zero features in the sentinel window, >= nw,
// and above level L), then the decoder with the slab staged at sW
// (stage_forward). With fo, also writes the tile's features into the
// chunk's residual [L, 2, CHUNK] at fo.
template <typename TT>
__device__ __forceinline__ void warp_tile(const float* __restrict__ prow, int r0,
                                          const TT* __restrict__ table, long long row_stride,
                                          int L, const int* res, int nw, const float* sW,
                                          float* __restrict__ fo, float (&hd0)[7],
                                          float (&hd8)[7], float (&sp0)[3], float (&sp8)[3]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  float in0[4][4];  // spatial0's input: the features
  {
    const float ua = prow[ra], va = prow[CHUNK + ra], wa = prow[2 * CHUNK + ra];
    const float ub = prow[rb], vb = prow[CHUNK + rb], wb = prow[2 * CHUNK + rb];
    const int win_a = (int)prow[3 * CHUNK + ra], win_b = (int)prow[3 * CHUNK + rb];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const int l = 4 * kb + t;
      const TT* tl = table + (size_t)l * row_stride;
      float2 fa = make_float2(0.0f, 0.0f), fb = make_float2(0.0f, 0.0f);
      if (l < L) {
        if (win_a < nw) fa = encode_level<TT>(tl, res, l, win_a, ua, va, wa);
        if (win_b < nw) fb = encode_level<TT>(tl, res, l, win_b, ub, vb, wb);
        if (fo) {
          fo[(size_t)2 * l * CHUNK + ra] = fa.x;
          fo[(size_t)(2 * l + 1) * CHUNK + ra] = fa.y;
          fo[(size_t)2 * l * CHUNK + rb] = fb.x;
          fo[(size_t)(2 * l + 1) * CHUNK + rb] = fb.y;
        }
      }
      in0[kb][0] = fa.x;
      in0[kb][1] = fa.y;
      in0[kb][2] = fb.x;
      in0[kb][3] = fb.y;
    }
  }
  float h[8][4], hh[8][4];
  warp_layer<4, WS0, true>(in0, sW + W_SP0, sW + f_tail(B_SP0), h);
  warp_layer<8, WS1, false>(h, sW + W_SP1, sW + f_tail(B_SP1), hh);
  warp_narrow<7, 32, 4>(hh, sW + F_HEAD, sW + f_tail(B_HEAD), hd0, hd8);
  // dir0's input: spatial1's channels 32-63, then the SH-16
  float in2[6][4];
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int q = 0; q < 4; ++q) in2[kb][q] = hh[4 + kb][q];
  {
    float sh[16];
    float2 p[2][2];  // [row a, b][k-block 4, 5]
    row_sh(prow, ra, sh);
    p[0][0] = sh_pair(sh, 0);
    p[0][1] = sh_pair(sh, 8);
    row_sh(prow, rb, sh);
    p[1][0] = sh_pair(sh, 0);
    p[1][1] = sh_pair(sh, 8);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      in2[4 + k][0] = p[0][k].x;
      in2[4 + k][1] = p[0][k].y;
      in2[4 + k][2] = p[1][k].x;
      in2[4 + k][3] = p[1][k].y;
    }
  }
  warp_layer<6, WSD0, true>(in2, sW + W_DIR0, sW + f_tail(B_DIR0), h);
  warp_layer<8, WSD1, true>(h, sW + W_DIR1, sW + f_tail(B_DIR1), hh);
  warp_narrow<3, 64, 8>(hh, sW + F_DIR2, sW + f_tail(B_DIR2), sp0, sp8);
}

// ---------------------------------------------------------------------------
// Host side: persistent launches
// ---------------------------------------------------------------------------

// Blocks of `kernel` (threads a block, smem bytes of dynamic shared memory) an
// SM holds, with the shared-memory carveout at its maximum.
template <typename K>
inline cudaError_t blocks_per_sm(K kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  return e;
}

// The grid of a persistent launch over n chunks: as many blocks as the
// card holds at once, and no more than n.
template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = blocks_per_sm(kernel, threads, smem, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int cap = sms * (per_sm > 1 ? per_sm : 1);
  *grid = n < cap ? n : cap;
  return cudaSuccess;
}

}  // namespace scanerf
