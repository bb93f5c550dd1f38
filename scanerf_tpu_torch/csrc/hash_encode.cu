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
// B4, the table scatter and dL/du, is also the second half of B6 (whose
// wrapper launches it after the decoder backward of fused_train.cu). The JAX
// kernel kept a window block's gradient in VMEM across the block's chunks;
// here each chunk sums its own, in shared memory. One block of 256 threads a
// live chunk, 4 rows a thread. From meta the block reads the chunk's window
// range [wlo, whi]: every real row lies in it (a block's rows start on a
// chunk, and each subtile's (wmin, span) covers its real rows), and most
// chunks span one or two windows. Level by level, in passes of WCAP windows
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

#include "decoder.cuh"

namespace {

using namespace scanerf;

constexpr int THREADS = 256;
constexpr int ROWS = CHUNK / THREADS;  // backward: rows a thread
constexpr int WARPS = THREADS / 32;
constexpr int WCAP = 2;  // backward: windows a pass holds in each warp's slab (8 KB)

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
  int wlo = 1 << 30, whi = -1;
#pragma unroll
  for (int s = 0; s < SUBT; ++s) {
    const int* m = meta + (c * SUBT + s) * 4;
    if (m[2] > 0) {
      wlo = min(wlo, m[1]);
      whi = max(whi, m[1] + m[2] - 1);
    }
  }
  if (whi < wlo) {
    for (int t = tid; t < 3 * CHUNK; t += THREADS) drow[t] = 0.0f;
    return;
  }
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
          const float2 v = sum_peers(peers, make_float2(wt * g0, wt * g1));
          if (mine && (peers & ((1u << lane) - 1u)) == 0) {
            float2 cur = slab[se];
            cur.x += v.x;
            cur.y += v.y;
            slab[se] = cur;
          }
          __syncwarp();
          if (mine) {
            const float2 tv = load_pair(tl, (size_t)w[k] * WIN + h);
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
          atomicAdd(dl + (size_t)wb * WIN + e, v);
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

// The table scatter and dL/du (B4, and B6's second launch): g is read at
// g[c * CHUNK * L * 2 + t * g_row + f * g_feat] for row t of chunk c and
// feature f; own_rows 8 also zeroes dpts rows 3-7, 3 leaves them alone.
// With n_adds, adds to *n_adds the f32 elements it added to dtab with global
// atomics.
extern "C" int scanerf_lookup_bwd(const float* pts, const int* meta, const float* table,
                                  long long row_stride, int L, const int* res,
                                  const float* g, int g_row, int g_feat, int nw, int NC,
                                  int own_rows, float* dtab, float* dpts,
                                  unsigned long long* n_adds, void* stream) {
  if (L > MAXL || L < 1 || (own_rows != 3 && own_rows != 8)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float2) * WARPS * WCAP * WIN;
  cudaError_t e = cudaFuncSetAttribute(lookup_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (NC > 0)
    lookup_bwd_kernel<<<NC, THREADS, smem, (cudaStream_t)stream>>>(
        pts, meta, table, row_stride, L, res, g, g_row, g_feat, nw, own_rows, dtab, dpts,
        n_adds);
  return (int)cudaGetLastError();
}
