// B2: ragged-shift stream pack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scanerf_tpu/ops/pallas/hash_encode.py::_pack_kernel
// (launched at hash_encode.py:636). Output chunk c copies rows
// [src_start, src_start + n_real) of the window-sorted columns and fills the
// rest of its CHUNK rows with pad rows (u = 0.5, wid = pad_wid, dirs 0,
// pid = N); row 7 of pts is zero. Same results as
// ops/kernels/hash_encode.py::pack_plain.
//
// Design: one block per chunk, one thread per row. Neighbouring threads read
// neighbouring source columns and write neighbouring output lanes, so every
// access is coalesced. The kernel only moves bytes (32 read, 36 written per
// row): device memory bandwidth bounds it.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;

__global__ void __launch_bounds__(CHUNK)
pack_kernel(const float* __restrict__ src, const int* __restrict__ pids,
            const int* __restrict__ desc, int N, float pad_wid,
            float* __restrict__ pts, int* __restrict__ pidp) {
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int start = desc[2 * c];
  const int n_real = desc[2 * c + 1];
  float* out = pts + (size_t)c * 8 * CHUNK + t;
  if (t < n_real) {
    const size_t i = (size_t)start + t;
#pragma unroll
    for (int f = 0; f < 7; ++f) out[f * CHUNK] = src[(size_t)f * N + i];
    pidp[(size_t)c * CHUNK + t] = pids[i];
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
}

}  // namespace

extern "C" int scanerf_pack(const float* src, const int* pids, const int* desc,
                            int N, int NC, float pad_wid, float* pts, int* pidp,
                            void* stream) {
  if (NC > 0) {
    pack_kernel<<<NC, CHUNK, 0, (cudaStream_t)stream>>>(src, pids, desc, N,
                                                        pad_wid, pts, pidp);
  }
  return (int)cudaGetLastError();
}
