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
// hash inside the row's 512-entry window, trilinear weights, and the sum of
// the corners' feature pairs in decoder.cuh::encode_level's order (the
// gather B5 and B7 run, so the features are bit for bit theirs) -> feats [Np, L*2]
// f32 in stream order. Rows in the sentinel window (>= nw) get zeros;
// chunks with no real row write zeros and stop. f32 or bf16 tables (bf16
// staged as bf16 and widened on read).
// What bounds it on the H100: the bytes (pts rows 0-3 read once, 128 bytes
// of features written a row, the table blocks the chunks visit) set a floor
// of ~0.19 ms on a training step's stream; but the work is 8 scattered
// 8-byte reads a (row, level) pair, 537 M a step, and read from L2 one
// request each (this kernel's first design) they set its time: 1.27 ms on
// an H100 80GB HBM3 at 700 W, 4.9x the floor.
//
// Design: a block takes 512 rows of a chunk, one a thread, and reads each
// row's u and window id once. All real rows of those rows' subtiles lie in
// the window range [wlo, whi] that meta gives them (as B4 reads it), most
// chunks span 1-2 windows, and for one level the span's windows are
// contiguous in the flat table. So the block copies the span, level by
// level, into shared memory with 16-byte cp.async copies, in passes of
// FWD_WCAP windows (a wider span takes more passes, each with the rows
// whose window falls in it), double-buffered with one barrier a stage: the
// next (level, pass)'s copy is in flight while the rows gather this one's
// corners from shared memory. A bank serves a read of a random slot in a
// few cycles, an L2 request takes hundreds. Each row's pairs go into a
// [512, 2L] tile in shared memory (rows 2L + 1 floats apart, so a warp's
// rows fall in distinct banks), and the block writes the tile out whole
// rows at a time: writing each level's 8 bytes of a row straight to device
// memory, 128 bytes apart across the lanes, cost more than all the rest
// (measured). What is left is arithmetic, the hash and the weights of 8
// corners a pair, and the copies; the hash folds each axis term once
// (Folded, below).

// B4, the table scatter and dL/du, is also the second half of B6 (whose
// wrapper launches it after the decoder backward of fused_train.cu). The JAX
// kernel kept a window block's gradient in VMEM across the block's chunks;
// here each chunk sums its own, in shared memory. One block of 256 threads a
// live chunk, 4 rows a thread. From meta the block reads the chunk's window
// range [wlo, whi], as B3 does. Level by level, in passes of WCAP windows
// (a chunk spanning more takes more passes, each with only the rows whose
// window falls in it): each warp zeroes its own slab of WCAP x 512 f32 pairs;
// for each row and corner the lanes of the warp that hit the same entry sum
// their weighted cotangents (__match_any_sync, then a tree of shuffles over
// the group), and the lowest of them adds the sum to the warp's slab. Those
// lanes hold distinct entries and the slab is the warp's own, so the add is
// a plain load and store: the card has no shared-memory f32 add (atomicAdd on
// a shared float is a compare-and-swap loop), and the coarse levels, whose
// rows share few entries, made those loops contend. At the end of the pass
// the block sums the warps' slabs entry by entry and adds each nonzero entry
// to the dense, zeroed [L, H*2] table gradient with one float2 atomicAdd (an
// entry that no row touched, or whose sum is exactly zero, adds nothing, so
// unvisited blocks stay exactly 0, as the JAX kernel zeroes them). Each
// (row, level) pair also regathers its corners from the table for that
// level's dL/du; a thread sums its rows' levels in level order into dpts
// rows 0-2. The rows of dpts a launch owns: B4 also zeroes rows 3-7 (the
// view directions' cotangent comes from the decoder's own autograd); in B6
// they are the decoder backward's. Chunks with no real row write zero dpts
// rows and stop. The cotangent g is read with strides, as [Np, L*2] (B4:
// the unfused decoder's autograd) or [NC, L*2, CHUNK] (B6's decoder
// backward). Bound on the H100: the bytes (pts rows 0-3, g and the visited
// table read, dpts and the 268 MB dense gradient written) set the floor.
// What sets the time is the per-corner work of the warps (the match, the
// shuffles, the slab adds, the regathers), 128 (row, corner) pairs a row.
// The adds to L2 are at most a level's touched entries a chunk, not 16 f32
// atomics a (row, level) pair: with every level on, ~16x fewer. The order
// of the adds changes from run to run, so the table gradient differs
// between runs in the last bits of f32.
//
// Table shards (B3 and B4, every mode). A table sharded over ranks holds a
// contiguous range of window blocks; the stream keeps its global window ids
// and sentinel, and each chunk's meta carries in its 4th field (wbase) the
// global id of the shard's window 0 (0 for a whole table). Both kernels
// subtract wbase from a window id before they address the table or the table
// gradient, one integer read a block. Chunks of another shard come with span 0
// (parallel/table_parallel.py::localize_meta), so they write zero features and
// zero dL/du, as chunks of sentinel rows do.

// B4 has two more modes, template flags of the same kernel (BwdMode). BF16
// rounds each (row, corner, feature) contribution w * g to bf16 before the
// warp sums it (the JAX HASH_BWD_BF16 option; the sums and dL/du stay f32).
// DU computes dL/du alone, for a table that needs no gradient (the autograd
// backward of surface normals): each real row regathers its 8 corners a level
// from the table, with the exact mode's arithmetic in its order, so its dL/du
// is the exact mode's; no slab, no atomics and no table gradient, so its bytes
// are the regathers' and pts / g / dpts, and the scattered reads from L2 set
// its time, as they set B3's first design's.

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int THREADS = 256;  // backward: threads a block
constexpr int ROWS = CHUNK / THREADS;  // backward: rows a thread
constexpr int WARPS = THREADS / 32;
constexpr int WCAP = 2;  // backward: windows a pass holds in each warp's slab (8 KB)
constexpr int FWD_THREADS = 512;  // forward: a block takes 512 rows of a chunk, one a thread
constexpr int FWD_WCAP = 4;  // forward: windows a staged pass holds (16 KB of f32)
constexpr int FWD_NBUF = 2;  // forward: stage buffers, FWD_NBUF - 1 stages in flight
constexpr int TS = 2 * MAXL + 1;  // forward: a row's floats in the block's feature tile (odd:
                                  // the lanes' rows fall in distinct banks)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B3's corners of a row on one level. The slot of a corner is
// decoder.cuh::corner_slot's integer: the fold h ^ (h >> 9) ^ (h >> 18) and
// the mask distribute over the XOR of the three axis terms, so each term is
// folded once (f*0 for the lower corner, f*1 for the upper) and a corner's
// slot is the XOR of its three. o* are the fractional offsets, computed as
// corner_setup computes them from the level's resolution - 1 (s*).
struct Folded {
  uint32_t fx0, fx1, fy0, fy1, fz0, fz1;
  float ox, oy, oz;
};

__device__ __forceinline__ uint32_t fold(uint32_t h) {
  return (h ^ (h >> 9) ^ (h >> 18)) & (WIN - 1);
}

__device__ __forceinline__ Folded folded_setup(float sx, float sy, float sz, float ux, float uy,
                                               float uz) {
  const float vx = ux * sx, vy = uy * sy, vz = uz * sz;
  const float bx = floorf(vx), by = floorf(vy), bz = floorf(vz);
  Folded k;
  k.ox = vx - bx;
  k.oy = vy - by;
  k.oz = vz - bz;
  const uint32_t hx = (uint32_t)(int)bx, hy = (uint32_t)(int)by * 2654435761u,
                 hz = (uint32_t)(int)bz * 805459861u;
  k.fx0 = fold(hx);
  k.fx1 = fold(hx + 1u);
  k.fy0 = fold(hy);
  k.fy1 = fold(hy + 2654435761u);
  k.fz0 = fold(hz);
  k.fz1 = fold(hz + 805459861u);
  return k;
}

// The pair at slot h of a window staged in shared memory, widened to f32.
__device__ __forceinline__ float2 staged_pair(const float* tw, int h) {
  return reinterpret_cast<const float2*>(tw)[h];
}
__device__ __forceinline__ float2 staged_pair(const __nv_bfloat16* tw, int h) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(tw)[h]);
}

// The feature pair of a row from its window staged at tw: encode_level's
// trilinear sum, corner by corner with the same weights and fmaf order, so
// the features are bit for bit those of B5 and B7.
template <typename TT>
__device__ __forceinline__ float2 staged_level(const TT* tw, const Folded& k) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const float wt = (cx ? k.ox : 1.0f - k.ox) * (cy ? k.oy : 1.0f - k.oy) *
                     (cz ? k.oz : 1.0f - k.oz);
    const float2 v = staged_pair(tw, (int)((cx ? k.fx1 : k.fx0) ^ (cy ? k.fy1 : k.fy0) ^
                                           (cz ? k.fz1 : k.fz0)));
    a0 = fmaf(wt, v.x, a0);
    a1 = fmaf(wt, v.y, a1);
  }
  return make_float2(a0, a1);
}

// The window range [wlo, whi] of the real rows of nsub consecutive subtiles
// whose meta starts at m (whi < wlo: none). Every real row lies in it: a
// block's rows start on a chunk, and each subtile's (wmin, span) covers its
// real rows.
__device__ __forceinline__ void subtile_windows(const int* m, int nsub, int& wlo, int& whi) {
  wlo = 1 << 30;
  whi = -1;
  for (int s = 0; s < nsub; ++s, m += 4) {
    if (m[2] > 0) {
      wlo = min(wlo, m[1]);
      whi = max(whi, m[1] + m[2] - 1);
    }
  }
}

template <typename TT>
__global__ void __launch_bounds__(FWD_THREADS, 2)
lookup_fwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                  const TT* __restrict__ table, long long row_stride, int L,
                  const int* __restrict__ res_g, int nw, float* __restrict__ out) {
  constexpr int BUF = FWD_WCAP * WIN * 2;  // elements of TT in one stage buffer
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  TT* stage = reinterpret_cast<TT*>(fwd_smem);                    // [FWD_NBUF][BUF]
  float* tile = reinterpret_cast<float*>(stage + FWD_NBUF * BUF);  // [FWD_THREADS][TS]
  __shared__ float scale[3 * MAXL];  // each level's resolution - 1
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * FWD_THREADS;  // the block's first row
  const int c = (int)(row0 / CHUNK), t = (int)(row0 % CHUNK) + tid;  // chunk, this row in it
  float* ob = out + row0 * 2 * L;
  int wlo, whi;
  subtile_windows(meta + (row0 / 128) * 4, FWD_THREADS / 128, wlo, whi);
  // the global id of the table's window 0: 0, or a shard's first window
  const int wbase = meta[c * SUBT * 4 + 3];
  if (whi < wlo) {
    for (int p = tid; p < FWD_THREADS * L / 2; p += FWD_THREADS)
      reinterpret_cast<float4*>(ob)[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int npass = (whi - wlo + FWD_WCAP) / FWD_WCAP;
  // stage (l, p): level l's windows [wlo + p * FWD_WCAP, ...) of the span, the
  // pass fastest; issue(l, p) copies them into buffer b with 16-byte copies
  // over the block, one commit group a stage (empty past the last level)
  auto issue = [&](int l, int p, int b) {
    if (l < L) {
      const int wb = wlo + p * FWD_WCAP;
      const int n16 = min(FWD_WCAP, whi - wb + 1) * WIN * 2 * (int)sizeof(TT) / 16;
      const int4* src = reinterpret_cast<const int4*>(table + (size_t)l * row_stride +
                                                      (size_t)(wb - wbase) * WIN * 2);
      int4* dst = reinterpret_cast<int4*>(stage + b * BUF);
      for (int i = tid; i < n16; i += FWD_THREADS) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  // the stage FWD_NBUF - 1 ahead of the current one, whose copy goes next
  int nl = 0, np = 0, nb = 0;
  auto advance = [&](int& l, int& p) {
    if (++p == npass) {
      p = 0;
      ++l;
    }
  };
#pragma unroll
  for (int i = 0; i < FWD_NBUF - 1; ++i) {
    issue(nl, np, nb);
    advance(nl, np);
    ++nb;
  }
  for (int i = tid; i < 3 * L; i += FWD_THREADS) scale[i] = (float)res_g[i] - 1.0f;

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  const float ux = prow[t], uy = prow[CHUNK + t], uz = prow[2 * CHUNK + t];
  const int w = (int)prow[3 * CHUNK + t];
  float2 f = make_float2(0.f, 0.f);  // the row's pair of the level being gathered
  for (int l = 0, p = 0, b = 0; l < L;) {
    cp_async_wait<FWD_NBUF - 2>();  // this thread's copies of stage (l, p)
    // every thread's copies of stage (l, p) (and scale) visible; every
    // thread done with the stage before, whose buffer the next issue refills
    __syncthreads();
    issue(nl, np, nb);
    advance(nl, np);
    nb = nb + 1 == FWD_NBUF ? 0 : nb + 1;
    // the row, if this pass holds its window (a sentinel row, > whi, none)
    const int r = w - (wlo + p * FWD_WCAP);
    if (r >= 0 && r < FWD_WCAP && w <= whi)
      f = staged_level(stage + b * BUF + r * WIN * 2,
                       folded_setup(scale[3 * l], scale[3 * l + 1], scale[3 * l + 2], ux, uy, uz));
    if (p == npass - 1) {
      tile[tid * TS + 2 * l] = f.x;
      tile[tid * TS + 2 * l + 1] = f.y;
      f = make_float2(0.f, 0.f);
    }
    advance(l, p);
    b = b + 1 == FWD_NBUF ? 0 : b + 1;
  }
  __syncthreads();
  // the rows' features out in stream order: 2L contiguous floats a row,
  // so a warp writes whole rows
  for (int r = tid >> 5; r < FWD_THREADS; r += FWD_THREADS / 32)
    if (lane < 2 * L) ob[(size_t)r * 2 * L + lane] = tile[r * TS + lane];
}

// Sum of x over this lane's peers (the lanes of the warp with its key, from
// __match_any_sync), complete on the lowest of them: a tree over the peers'
// ranks, log2 of the group's size rounds. All 32 lanes take part.
__device__ __forceinline__ float2 sum_peers(unsigned peers, float2 x) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(0xffffffffu, peers != 0)) {
    const int next = __ffs(peers);  // the next peer still summing, 1-based; 0: none
    const float tx = __shfl_sync(0xffffffffu, x.x, (next - 1) & 31);
    const float ty = __shfl_sync(0xffffffffu, x.y, (next - 1) & 31);
    if (next) {
      x.x += tx;
      x.y += ty;
    }
    peers &= ~__ballot_sync(0xffffffffu, rank & 1u);  // odd ranks hand over and stop
    rank >>= 1;
  }
  return x;
}

// B4's modes, compile-time flags of the one kernel: the exact scatter; the
// same with each (row, corner, feature) contribution w * g rounded to bf16
// before the warp sums it (the JAX kernel's bf16 one-hot operand,
// hash_encode.py:996-1016: the one-hot is exact in bf16, its weighted
// operand rounds, the sums stay f32); or dL/du alone, for a table that
// needs no gradient (surface normals): no slab, no atomics, no table
// gradient at all.
enum BwdMode { BWD_EXACT = 0, BWD_BF16 = 1, BWD_DU = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
lookup_bwd_kernel(const float* __restrict__ pts, const int* __restrict__ meta,
                  const float* __restrict__ table, long long row_stride, int L,
                  const int* __restrict__ res_g, const float* __restrict__ g, int g_row,
                  int g_feat, int nw, int own_rows, float* __restrict__ dtab,
                  float* __restrict__ dpts, unsigned long long* __restrict__ n_adds) {
  extern __shared__ float2 slabs[];  // [WARPS][WCAP * WIN]: each warp's slab
  __shared__ int res[3 * MAXL];
  __shared__ unsigned int block_adds;
  const int c = blockIdx.x, tid = threadIdx.x;
  float* drow = dpts + (size_t)c * 8 * CHUNK;
  if (own_rows > 3)
    for (int t = tid; t < 5 * CHUNK; t += THREADS) drow[3 * CHUNK + t] = 0.0f;
  int wlo, whi;
  subtile_windows(meta + c * SUBT * 4, SUBT, wlo, whi);
  if (whi < wlo) {
    for (int t = tid; t < 3 * CHUNK; t += THREADS) drow[t] = 0.0f;
    return;
  }
  const int wbase = meta[c * SUBT * 4 + 3];  // as B3's: the table's window 0
  for (int i = tid; i < 3 * L; i += THREADS) res[i] = res_g[i];
  if (tid == 0) block_adds = 0;
  __syncthreads();

  const float* prow = pts + (size_t)c * 8 * CHUNK;
  const float* gc = g + (size_t)c * CHUNK * 2 * L;
  float ux[ROWS], uy[ROWS], uz[ROWS], du[ROWS][3];
  int w[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int t = tid + k * THREADS;
    ux[k] = prow[t];
    uy[k] = prow[CHUNK + t];
    uz[k] = prow[2 * CHUNK + t];
    w[k] = (int)prow[3 * CHUNK + t];
    du[k][0] = du[k][1] = du[k][2] = 0.0f;
  }
  if constexpr (MODE == BWD_DU) {
    // each real row regathers its corners level by level, in the order and
    // with the sums of the exact mode below, so dL/du is bit for bit its
    for (int l = 0; l < L; ++l) {
      const float* tl = table + (size_t)l * row_stride;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (w[k] >= nw) continue;
        const size_t gt = (size_t)(tid + k * THREADS) * g_row + (size_t)(2 * l) * g_feat;
        const float g0 = gc[gt], g1 = gc[gt + g_feat];
        const Corners kc = corner_setup(res, l, ux[k], uy[k], uz[k]);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int cn = 0; cn < 8; ++cn) {
          const bool cx = (cn >> 2) & 1, cy = (cn >> 1) & 1, cz = cn & 1;
          const float fx = cx ? kc.ox : 1.0f - kc.ox, fy = cy ? kc.oy : 1.0f - kc.oy,
                      fz = cz ? kc.oz : 1.0f - kc.oz;
          const float2 tv = load_pair(tl, (size_t)(w[k] - wbase) * WIN + corner_slot(kc, cn));
          const float dot = g0 * tv.x + g1 * tv.y;
          s0 += (cx ? 1.0f : -1.0f) * fy * fz * dot;
          s1 += (cy ? 1.0f : -1.0f) * fx * fz * dot;
          s2 += (cz ? 1.0f : -1.0f) * fx * fy * dot;
        }
        du[k][0] += s0 * ((float)res[3 * l] - 1.0f);
        du[k][1] += s1 * ((float)res[3 * l + 1] - 1.0f);
        du[k][2] += s2 * ((float)res[3 * l + 2] - 1.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int t = tid + k * THREADS;
      drow[t] = du[k][0];
      drow[CHUNK + t] = du[k][1];
      drow[2 * CHUNK + t] = du[k][2];
    }
    return;
  }
  unsigned int adds = 0;
  const int lane = tid & 31;
  float2* slab = slabs + (tid >> 5) * WCAP * WIN;
  for (int l = 0; l < L; ++l) {
    const float* tl = table + (size_t)l * row_stride;
    float2* dl = reinterpret_cast<float2*>(dtab + (size_t)l * row_stride);
    for (int wb = wlo; wb <= whi; wb += WCAP) {
      const int n = min(WCAP, whi - wb + 1) * WIN;
      for (int e = lane; e < n; e += 32) slab[e] = make_float2(0.f, 0.f);
      __syncwarp();
      // each real row of the pass: its level's 8 weighted corners into its
      // warp's slab (the lanes on one entry summed first, so that the
      // adding lanes hold distinct entries and need no atomics), and this
      // level's dL/du from the regathered corners
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const bool mine = w[k] >= wb && w[k] < wb + WCAP && w[k] < nw;
        if (!__any_sync(0xffffffffu, mine)) continue;
        float g0 = 0.0f, g1 = 0.0f;
        if (mine) {
          const size_t gt = (size_t)(tid + k * THREADS) * g_row + (size_t)(2 * l) * g_feat;
          g0 = gc[gt];
          g1 = gc[gt + g_feat];
        }
        const Corners kc = corner_setup(res, l, ux[k], uy[k], uz[k]);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int cn = 0; cn < 8; ++cn) {
          const bool cx = (cn >> 2) & 1, cy = (cn >> 1) & 1, cz = cn & 1;
          const int h = corner_slot(kc, cn);
          const float fx = cx ? kc.ox : 1.0f - kc.ox, fy = cy ? kc.oy : 1.0f - kc.oy,
                      fz = cz ? kc.oz : 1.0f - kc.oz;
          const float wt = fx * fy * fz;
          const int se = mine ? (w[k] - wb) * WIN + h : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, se);
          const float2 v = MODE == BWD_BF16
                               ? sum_peers(peers, make_float2(round_bf16(wt * g0),
                                                              round_bf16(wt * g1)))
                               : sum_peers(peers, make_float2(wt * g0, wt * g1));
          if (mine && (peers & ((1u << lane) - 1u)) == 0) {
            float2 cur = slab[se];
            cur.x += v.x;
            cur.y += v.y;
            slab[se] = cur;
          }
          __syncwarp();
          if (mine) {
            const float2 tv = load_pair(tl, (size_t)(w[k] - wbase) * WIN + h);
            const float dot = g0 * tv.x + g1 * tv.y;
            s0 += (cx ? 1.0f : -1.0f) * fy * fz * dot;
            s1 += (cy ? 1.0f : -1.0f) * fx * fz * dot;
            s2 += (cz ? 1.0f : -1.0f) * fx * fy * dot;
          }
        }
        if (mine) {
          du[k][0] += s0 * ((float)res[3 * l] - 1.0f);
          du[k][1] += s1 * ((float)res[3 * l + 1] - 1.0f);
          du[k][2] += s2 * ((float)res[3 * l + 2] - 1.0f);
        }
      }
      __syncthreads();
      for (int e = tid; e < n; e += THREADS) {
        float2 v = slabs[e];
#pragma unroll
        for (int wp = 1; wp < WARPS; ++wp) {
          const float2 o = slabs[wp * WCAP * WIN + e];
          v.x += o.x;
          v.y += o.y;
        }
        if (v.x != 0.0f || v.y != 0.0f) {
          atomicAdd(dl + (size_t)(wb - wbase) * WIN + e, v);
          ++adds;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int t = tid + k * THREADS;
    drow[t] = du[k][0];
    drow[CHUNK + t] = du[k][1];
    drow[2 * CHUNK + t] = du[k][2];
  }
  if (n_adds) {
    atomicAdd(&block_adds, adds);
    __syncthreads();
    if (tid == 0) atomicAdd(n_adds, 2ull * block_adds);
  }
}

}  // namespace

template <typename TT>
cudaError_t launch_lookup_fwd(const float* pts, const int* meta, const TT* table,
                              long long row_stride, int L, const int* res, int nw, int NC,
                              float* out, cudaStream_t s) {
  // the stage buffers and the feature tile
  const int smem =
      (int)(FWD_NBUF * FWD_WCAP * WIN * 2 * sizeof(TT) + FWD_THREADS * TS * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(lookup_fwd_kernel<TT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lookup_fwd_kernel<TT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  lookup_fwd_kernel<TT><<<NC * (CHUNK / FWD_THREADS), FWD_THREADS, smem, s>>>(
      pts, meta, table, row_stride, L, res, nw, out);
  return cudaGetLastError();
}

extern "C" int scanerf_lookup_fwd(const float* pts, const int* meta, const void* table,
                                  int table_bf16, long long row_stride, int L,
                                  const int* res, int nw, int NC, float* out,
                                  void* stream) {
  if (L > MAXL || L < 1 || ((uintptr_t)table & 15) || (row_stride & 7))
    return (int)cudaErrorInvalidValue;
  if (NC <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(table_bf16 ? launch_lookup_fwd(pts, meta, static_cast<const __nv_bfloat16*>(table),
                                              row_stride, L, res, nw, NC, out, s)
                          : launch_lookup_fwd(pts, meta, static_cast<const float*>(table),
                                              row_stride, L, res, nw, NC, out, s));
}

// The table scatter and dL/du (B4, and B6's second launch): g is read at
// g[c * CHUNK * L * 2 + t * g_row + f * g_feat] for row t of chunk c and
// feature f; own_rows 8 also zeroes dpts rows 3-7, 3 leaves them alone.
// mode: BWD_EXACT, BWD_BF16 (contributions rounded to bf16) or BWD_DU (dL/du
// only: dtab and n_adds are not touched and may be null). With n_adds, adds
// to *n_adds the f32 elements it added to dtab with global atomics.
template <int MODE>
cudaError_t launch_lookup_bwd(const float* pts, const int* meta, const float* table,
                              long long row_stride, int L, const int* res, const float* g,
                              int g_row, int g_feat, int nw, int NC, int own_rows, float* dtab,
                              float* dpts, unsigned long long* n_adds, cudaStream_t s) {
  const int smem = MODE == BWD_DU ? 0 : (int)sizeof(float2) * WARPS * WCAP * WIN;
  cudaError_t e = cudaFuncSetAttribute(lookup_bwd_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (NC > 0)
    lookup_bwd_kernel<MODE><<<NC, THREADS, smem, s>>>(pts, meta, table, row_stride, L, res, g,
                                                      g_row, g_feat, nw, own_rows, dtab, dpts,
                                                      n_adds);
  return cudaGetLastError();
}

extern "C" int scanerf_lookup_bwd(const float* pts, const int* meta, const float* table,
                                  long long row_stride, int L, const int* res,
                                  const float* g, int g_row, int g_feat, int nw, int NC,
                                  int own_rows, int mode, float* dtab, float* dpts,
                                  unsigned long long* n_adds, void* stream) {
  if (L > MAXL || L < 1 || (own_rows != 3 && own_rows != 8) || mode < BWD_EXACT ||
      mode > BWD_DU || (mode != BWD_DU && !dtab))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case BWD_EXACT:
      return (int)launch_lookup_bwd<BWD_EXACT>(pts, meta, table, row_stride, L, res, g, g_row,
                                               g_feat, nw, NC, own_rows, dtab, dpts, n_adds, s);
    case BWD_BF16:
      return (int)launch_lookup_bwd<BWD_BF16>(pts, meta, table, row_stride, L, res, g, g_row,
                                              g_feat, nw, NC, own_rows, dtab, dpts, n_adds, s);
    default:
      return (int)launch_lookup_bwd<BWD_DU>(pts, meta, table, row_stride, L, res, g, g_row,
                                            g_feat, nw, NC, own_rows, nullptr, dpts, nullptr,
                                            s);
  }
}
