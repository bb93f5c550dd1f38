// The windowed render's stream rows for Hopper (sm_90a): one chunk's
// (sample, slot) rows, each row's window sort key and its payload.
//
// Replaces no TPU kernel. The JAX package builds these rows with XLA ops
// (scanerf_tpu/render/renderer.py::_render_windowed), the port's plain
// composition with ~100 PyTorch ops, each a pass over all Kf*N*S + Kb*N*Sb
// rows (render/renderer.py::_stream_rows_plain: _fg_rows and _bg_rows, then
// ops/kernels/hash_encode.py::window_keys). This kernel computes what that
// composition computes, bit for bit, and materializes no point, direction or
// tile id array:
//
//   fg, one thread a (ray n, sample s), p = o + z * d:
//     the tile LUT's candidates of p's LUT cell; candidate tile t contains p
//     when uu = (p - inner_c[t]) / inner_s[t] lies in [0, 1)^3, with the
//     seam weight of uu (renderer._seam_weight);
//     the Kf containing candidates of largest weight, ties to the lower
//     candidate index (the argmax rounds of renderer._top_k); slots beyond
//     them are parked (m_any false, weight 0, x 0);
//     m_eval = m_any and p's cell of the union grid occupied;
//     x = ((p - corner[t]) / size[t]) * 4 - 2 in an unparked slot;
//     the row is dead unless m_eval and the ray is valid.
//   bg, one thread a (ray n, bg sample s), p = o + z_bg * d: per exit slot
//     k, the L-inf contraction of p under tile bg_tiles[n, k]
//     (renderer._contract_bg), 0 where bg_w[n, k] = 0; the row is dead
//     unless bg_w[n, k] > 0 and bg_valid[n].
//   every row: u = (x + 2) / 4, its key tid * NW1 + window(u) (hash_encode
//     .window_id), or the sentinel NW for a dead row, and its payload
//     (u0, u1, u2, n): B2's gather mode reads the direction from rays_d[n].
//
// Rows are written in the plain composition's order: fg slot-major
// [Kf, N, S], then bg [Kb, N, Sb]. The fg slot tables w_fg, m_any and m_eval
// are [N, S, Kf], as the blend reads them. Every product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn), as PyTorch's separate
// elementwise kernels round them: no fused multiply-add may move a point
// across a window's edge. Casts to int are cvt.rzi (saturating), as
// PyTorch's, and maxima propagate NaN, as torch.amax and clamp_min do.
//
// Design: consecutive threads take consecutive samples of a ray, so for each
// slot a warp writes 32 consecutive keys (128 bytes) and payloads (512
// bytes); the ray's origin and direction, the LUT and the tiles' boxes come
// through the cache. What bounds it on the H100 is device memory: 20 bytes
// written a row and 6 a fg slot entry, against ~4 bytes read a sample and
// one byte of the union grid a fg sample. Given a tally (a null pointer
// turns it off, as the render launches it), the rows built and the live
// (non-sentinel) rows are summed per block and added to two device counters
// with one atomic each; nothing is read back to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LUT_CAND = 8;  // renderer.LUT_CAND: candidate tiles of a LUT cell
constexpr int MAXK = LUT_CAND;  // most fg slots: every candidate

struct Args {
  // the chunk
  const float* rays_o;  // [N, 3]
  const float* rays_d;  // [N, 3]
  const float* z;       // [N, S]
  const unsigned char* valid;  // [N]
  const float* z_bg;    // [N, Sb]
  const int* bg_tiles;  // [N, Kb]
  const float* bg_w;    // [N, Kb]
  const unsigned char* bg_valid;  // [N]
  // the scene
  const int* lut;  // [cells, LUT_CAND], -1 padded
  const float* lut_corner;  // [3]
  const float* lut_cell;    // [3]
  int ld[3];
  const unsigned char* occ;  // [G0, G1, G2]
  const float* occ_corner;   // [3]
  const float* occ_size;     // [3]
  int gd[3];
  const float* corner;  // [T, 3] doubled boxes
  const float* size;    // [T, 3]
  int N, S, Sb, Kf, Kb;
  int win[3];  // window grid (Cx, Cy, Cz) of one table
  int nw1, nw;  // windows a table, the sentinel window
  // outputs
  int* keys;     // [R]
  float4* pay;   // [R]
  float* w_fg;   // [N, S, Kf]
  unsigned char* m_any;   // [N, S, Kf]
  unsigned char* m_eval;  // [N, S, Kf]
  unsigned long long* tally;  // [2]: rows built, live rows; or null
};

// max that propagates NaN, as torch.amax
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// hash_encode.expand_warp
__device__ __forceinline__ float expand_warp(float u) {
  const float lo = __fmul_rn(u, 0.5f);
  const float mid = __fadd_rn(0.125f, __fmul_rn(__fsub_rn(u, 0.25f), 1.5f));
  const float hi = __fadd_rn(0.875f, __fmul_rn(__fsub_rn(u, 0.75f), 0.5f));
  return u < 0.25f ? lo : (u < 0.75f ? mid : hi);
}

// hash_encode.window_id of u in [0, 1]^3
__device__ __forceinline__ int window_id(const float u[3], const Args& a) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[i] = (int)floorf(__fmul_rn(expand_warp(u[i]), (float)a.win[i]));
    c[i] = min(max(c[i], 0), a.win[i] - 1);
  }
  return (c[0] * a.win[1] + c[1]) * a.win[2] + c[2];
}

// (v - corner) / size, rounded as two ops
__device__ __forceinline__ float rel(float v, float corner, float size) {
  return __fdiv_rn(__fsub_rn(v, corner), size);
}

// renderer._contract_fg: ((p - corner) / size) * 4 - 2
__device__ __forceinline__ float contract(float p, float corner, float size) {
  return __fsub_rn(__fmul_rn(rel(p, corner, size), 4.0f), 2.0f);
}

// (x + 2) * 0.25
__device__ __forceinline__ float to_unit(float x) { return __fmul_rn(__fadd_rn(x, 2.0f), 0.25f); }

// One fg (ray, sample): its Kf slot rows and slot-table entries.
__device__ void fg_sample(const Args& a, int i, int& live) {
  const int n = i / a.S;
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = __fadd_rn(a.rays_o[3 * n + c], __fmul_rn(a.z[i], a.rays_d[3 * n + c]));

  // the LUT cell's candidates, containing ones kept by weight, descending
  int lc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    lc[c] = min(max((int)rel(p[c], a.lut_corner[c], a.lut_cell[c]), 0), a.ld[c] - 1);
  const int* cand = a.lut + (((long long)lc[0] * a.ld[1] + lc[1]) * a.ld[2] + lc[2]) * LUT_CAND;
  int tile[MAXK];
  float wt[MAXK];
  int nsel = 0;
#pragma unroll
  for (int j = 0; j < LUT_CAND; ++j) {
    const int t = cand[j];
    if (t < 0) continue;
    float uu[3], is[3];
    bool in = true;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ic = __fadd_rn(a.corner[3 * t + c], __fmul_rn(a.size[3 * t + c], 0.25f));
      is[c] = __fmul_rn(a.size[3 * t + c], 0.5f);
      uu[c] = rel(p[c], ic, is[c]);
      in = in && uu[c] >= 0.0f && uu[c] < 1.0f;
    }
    if (!in) continue;
    // renderer._seam_weight: x and z distances to the boundary
    const float dx = __fmul_rn(__fsub_rn(0.5f, fabsf(__fsub_rn(uu[0], 0.5f))), is[0]);
    const float dz = __fmul_rn(__fsub_rn(0.5f, fabsf(__fsub_rn(uu[2], 0.5f))), is[2]);
    const float w = (dx != 0.0f && dz != 0.0f) ? __fmul_rn(dx, dz)
                    : (dx != 0.0f ? dx : (dz != 0.0f ? dz : 0.0f));
    // after every kept candidate of weight >= w (a lower index wins a tie)
    int pos = 0;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) pos += (k < nsel && wt[k] >= w);
#pragma unroll
    for (int k = MAXK - 1; k > 0; --k)
      if (k > pos && k <= nsel) {
        wt[k] = wt[k - 1];
        tile[k] = tile[k - 1];
      }
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k == pos) {
        wt[k] = w;
        tile[k] = t;
      }
    ++nsel;
  }

  // renderer._union_occupancy_lookup
  bool inb = true;
  int g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float uo = rel(p[c], a.occ_corner[c], a.occ_size[c]);
    inb = inb && uo >= 0.0f && uo < 1.0f;
    g[c] = min(max((int)__fmul_rn(uo, (float)a.gd[c]), 0), a.gd[c] - 1);
  }
  const bool occ = inb && a.occ[((long long)g[0] * a.gd[1] + g[1]) * a.gd[2] + g[2]];

  const bool ok = a.valid[n];
  const size_t NS = (size_t)a.N * a.S;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    if (k >= a.Kf) break;
    const bool any = k < nsel;
    const int t = any ? tile[k] : 0;
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[c] = to_unit(any ? contract(p[c], a.corner[3 * t + c], a.size[3 * t + c]) : 0.0f);
    const bool alive = any && occ && ok;
    const size_t row = k * NS + i;
    a.keys[row] = alive ? t * a.nw1 + window_id(u, a) : a.nw;
    a.pay[row] = make_float4(u[0], u[1], u[2], (float)n);
    const size_t e = (size_t)i * a.Kf + k;
    a.w_fg[e] = any ? wt[k] : 0.0f;
    a.m_any[e] = any;
    a.m_eval[e] = any && occ;
    live += alive;
  }
}

// One bg (ray, sample): its Kb exit-slot rows.
__device__ void bg_sample(const Args& a, int i, int& live) {
  const int n = i / a.Sb;
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = __fadd_rn(a.rays_o[3 * n + c], __fmul_rn(a.z_bg[i], a.rays_d[3 * n + c]));
  const bool ok = a.bg_valid[n];
  const size_t base = (size_t)a.Kf * a.N * a.S, NSb = (size_t)a.N * a.Sb;
  for (int k = 0; k < a.Kb; ++k) {
    const int t = a.bg_tiles[n * a.Kb + k];
    const bool used = a.bg_w[n * a.Kb + k] > 0.0f;
    // renderer._contract_bg
    float x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = contract(p[c], a.corner[3 * t + c], a.size[3 * t + c]);
    float linf = max_nan(max_nan(fabsf(x[0]), fabsf(x[1])), fabsf(x[2]));
    linf = max_nan(linf, 1e-9f);
    const float ratio = __fdiv_rn(__fsub_rn(2.0f, __fdiv_rn(1.0f, linf)), linf);
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[c] = to_unit(used ? (linf > 1.0f ? __fmul_rn(x[c], ratio) : x[c]) : 0.0f);
    const bool alive = used && ok;
    const size_t row = base + k * NSb + i;
    a.keys[row] = alive ? t * a.nw1 + window_id(u, a) : a.nw;
    a.pay[row] = make_float4(u[0], u[1], u[2], (float)n);
    live += alive;
  }
}

__global__ void __launch_bounds__(THREADS) row_build_kernel(const Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int nfg = a.N * a.S, nbg = a.N * a.Sb;
  int live = 0, rows = 0;
  if (i < nfg) {
    fg_sample(a, i, live);
    rows = a.Kf;
  } else if (i < nfg + nbg) {
    bg_sample(a, i - nfg, live);
    rows = a.Kb;
  }
  if (a.tally == nullptr) return;
  // the tally: a warp's sums, then the block's, then one atomic each
  __shared__ int block_rows, block_live;
  if (threadIdx.x == 0) block_rows = block_live = 0;
  __syncthreads();
  const int wr = __reduce_add_sync(0xffffffffu, rows), wl = __reduce_add_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_rows, wr);
    atomicAdd(&block_live, wl);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(a.tally, (unsigned long long)block_rows);
    atomicAdd(a.tally + 1, (unsigned long long)block_live);
  }
}

}  // namespace

extern "C" int scanerf_row_build(
    const float* rays_o, const float* rays_d, const float* z, const unsigned char* valid,
    const float* z_bg, const int* bg_tiles, const float* bg_w, const unsigned char* bg_valid,
    const int* lut, const float* lut_corner, const float* lut_cell, int ld0, int ld1, int ld2,
    const unsigned char* occ, const float* occ_corner, const float* occ_size, int g0, int g1,
    int g2, const float* corner, const float* size, int N, int S, int Sb, int Kf, int Kb,
    int cx, int cy, int cz, int nw1, int nw, int* keys, float* pay, float* w_fg,
    unsigned char* m_any, unsigned char* m_eval, unsigned long long* tally, void* stream) {
  if (Kf < 1 || Kf > MAXK || Kb < 0 || N < 0 || S < 0 || Sb < 0 ||
      (long long)N * (S + Sb) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{rays_o, rays_d, z, valid, z_bg, bg_tiles, bg_w, bg_valid,
               lut, lut_corner, lut_cell, {ld0, ld1, ld2},
               occ, occ_corner, occ_size, {g0, g1, g2},
               corner, size, N, S, Sb, Kf, Kb, {cx, cy, cz}, nw1, nw,
               keys, reinterpret_cast<float4*>(pay), w_fg, m_any, m_eval, tally};
  const long long threads = (long long)N * (S + Sb);
  if (threads > 0) {
    const int blocks = (int)((threads + THREADS - 1) / THREADS);
    row_build_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
