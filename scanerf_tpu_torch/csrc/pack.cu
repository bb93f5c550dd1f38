// B2: ragged-shift stream pack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/hash_encode.py::_pack_kernel
// (launched at hash_encode.py:636). Output chunk c copies rows
// [src_start, src_start + n_real) of the window-sorted rows and fills the
// rest of its CHUNK rows with pad rows (u = 0.5, wid = pad_wid, dirs 0,
// pid = N); row 7 of pts is zero. Same results as
// ops/kernels/hash_encode.py::pack_plain.
//
// Two modes, compile-time flags of the same kernel (PackMode). COPY reads
// the sorted rows from pre-gathered columns (u0 u1 u2 wid d0 d1 d2) and
// their point ids. GATHER reads sorted row i through the sort's permutation:
// its key from the sorted keys, its u from the payload row perm[i] (u0 u1
// u2, then the index of its direction in dirs) and its direction from dirs,
// so that no sorted copy of the payload is made; its pid is perm[i]. GATHER
// also writes the chunk's meta as it packs: per 128-row subtile the least
// and the span of its real (non-sentinel) windows, and the chunk's block,
// what ops/kernels/hash_encode.py::_stream_meta computes from pts (same
// results as pack_gather_plain).
//
// Design: one block per chunk, one thread per row. Neighbouring threads read
// neighbouring sorted rows and write neighbouring output lanes, so every
// access is coalesced but GATHER's payload read, one 16-byte load a row
// (rows of one window keep their build order, as the sort is stable, so
// they come in runs). The kernel only moves bytes: COPY reads 32 and writes
// 36 a row; GATHER reads 28 (key, 64-bit permutation, payload; directions
// stay in cache) and writes 36. Device memory bandwidth bounds it. GATHER's
// meta is a warp min / max of each warp's windows, then the 4 warps of a
// subtile and the 8 subtiles of the chunk combined in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;
constexpr int SUBT = CHUNK / 128;  // subtiles a chunk (rows of meta)
constexpr int WB = 32;  // windows per block
constexpr int NO_WINDOW = 1 << 30;

enum PackMode { PACK_COPY = 0, PACK_GATHER = 1 };

struct Source {
  const float* src;  // COPY: [7, N] sorted columns
  const int* pids;   // COPY: [N]
  const int* keys;   // GATHER: [N] sorted keys
  const long long* perm;  // GATHER: [N] the payload row of each sorted row
  const float4* payload;  // GATHER: [N] u0 u1 u2, the direction's index
  const float* dirs;      // GATHER: [*, 3]
};

template <int MODE>
__global__ void __launch_bounds__(CHUNK)
pack_kernel(const Source s, const int* __restrict__ desc, int N, float pad_wid,
            float* __restrict__ pts, int* __restrict__ pidp, int* __restrict__ meta) {
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int start = desc[2 * c];
  const int n_real = desc[2 * c + 1];
  const int nw = (int)pad_wid;  // the sentinel window
  float* out = pts + (size_t)c * 8 * CHUNK + t;
  int wid = nw;
  if (t < n_real) {
    const size_t i = (size_t)start + t;
    if constexpr (MODE == PACK_COPY) {
#pragma unroll
      for (int f = 0; f < 7; ++f) out[f * CHUNK] = s.src[(size_t)f * N + i];
      pidp[(size_t)c * CHUNK + t] = s.pids[i];
    } else {
      const long long r = s.perm[i];
      const float4 p = s.payload[r];
      const float* d = s.dirs + 3 * (size_t)(int)p.w;
      wid = s.keys[i];
      out[0] = p.x;
      out[CHUNK] = p.y;
      out[2 * CHUNK] = p.z;
      out[3 * CHUNK] = (float)wid;
      out[4 * CHUNK] = d[0];
      out[5 * CHUNK] = d[1];
      out[6 * CHUNK] = d[2];
      pidp[(size_t)c * CHUNK + t] = (int)r;
    }
  } else {
    out[0] = 0.5f;
    out[CHUNK] = 0.5f;
    out[2 * CHUNK] = 0.5f;
    out[3 * CHUNK] = pad_wid;
    out[4 * CHUNK] = 0.f;
    out[5 * CHUNK] = 0.f;
    out[6 * CHUNK] = 0.f;
    pidp[(size_t)c * CHUNK + t] = N;
  }
  out[7 * CHUNK] = 0.f;
  if constexpr (MODE == PACK_GATHER) {
    // _stream_meta: real rows are those below the sentinel window
    __shared__ int lo[CHUNK / 32], hi[CHUNK / 32];
    const bool real = wid < nw;
    const int wlo = __reduce_min_sync(0xffffffffu, real ? wid : NO_WINDOW);
    const int whi = __reduce_max_sync(0xffffffffu, real ? wid : -1);
    if ((t & 31) == 0) {
      lo[t >> 5] = wlo;
      hi[t >> 5] = whi;
    }
    __syncthreads();
    if (t < 32) {  // lane st < SUBT: subtile st, its 4 warps
      int mn = NO_WINDOW, mx = -1;
      if (t < SUBT) {
#pragma unroll
        for (int w = 4 * t; w < 4 * t + 4; ++w) {
          mn = min(mn, lo[w]);
          mx = max(mx, hi[w]);
        }
      }
      const int span = max(mx - mn + 1, 0);
      const int wmin = min(mn, nw - 1);
      const int bmin = __reduce_min_sync(0xffffffffu, t < SUBT ? wmin : NO_WINDOW);
      const int boc = min(max(bmin / WB, 0), nw / WB - 1);
      if (t < SUBT)
        reinterpret_cast<int4*>(meta)[(size_t)c * SUBT + t] = make_int4(boc, wmin, span, 0);
    }
  }
}

}  // namespace

extern "C" int scanerf_pack(const float* src, const int* pids, const int* desc,
                            int N, int NC, float pad_wid, float* pts, int* pidp,
                            void* stream) {
  if (NC > 0) {
    const Source s{src, pids, nullptr, nullptr, nullptr, nullptr};
    pack_kernel<PACK_COPY><<<NC, CHUNK, 0, (cudaStream_t)stream>>>(s, desc, N, pad_wid, pts,
                                                                   pidp, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int scanerf_pack_gather(const int* keys, const long long* perm, const float* payload,
                                   const float* dirs, const int* desc, int N, int NC,
                                   float pad_wid, float* pts, int* pidp, int* meta,
                                   void* stream) {
  if (NC > 0) {
    const Source s{nullptr, nullptr, keys, perm, reinterpret_cast<const float4*>(payload), dirs};
    pack_kernel<PACK_GATHER><<<NC, CHUNK, 0, (cudaStream_t)stream>>>(s, desc, N, pad_wid, pts,
                                                                     pidp, meta);
  }
  return (int)cudaGetLastError();
}
