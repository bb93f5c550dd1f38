// Device code shared by the hash and decode kernels (hash_encode.cu: B3 and
// B4, fused_render.cu: B7, fused_train.cu: B5 and B6): the windowed hash
// gather read straight from the flat [L, T*H*2] tables, its corner
// addressing (which B4's table scatter also uses), the decoder slab's
// layout, the activations and the SH-16 of the view direction.
//
// Windowed hash: a stream row in window w reads, per level l, the 8 corner
// slots of the folded prime-XOR hash inside w's 512 entries and sums their
// feature pairs with trilinear weights. Decoder: 32 -> 64 (Gauss) -> 64;
// heads (sigma, diffuse x3, tint x3) on channels 0-31; the SH-16 of the
// normalized view dir d / (|d| + 1e-8) joins channels 32-63 for
// 48 -> 64 (Gauss) -> 64 (Gauss) -> 3 (specular, before its sigmoid).
// What bounds each kernel on the H100, and what its design does about it,
// is in the kernel's own source: the gathers read 8-byte pairs inside one
// 2 MB block of windows a chunk, which L2 holds; B5, B6 and B7 run the
// decoder's large products on the tensor cores (decoder_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scanerf {

constexpr int CHUNK = 1024;
constexpr int SUBT = CHUNK / 128;
constexpr int WIN = 512;
constexpr int MAXL = 16;

// decoder slab layout (f32 offsets; every matrix row-major [out, in] and
// 16-byte aligned): mirrors ops/kernels/fused_render.py
constexpr int SP0_W = 0, SP1_W = 2048, HEAD_W = 6144, DIR0_W = 6400,
              DIR1_W = 9472, DIR2_W = 13568;
constexpr int B_SP0 = 13824, B_SP1 = 13888, B_HEAD = 13952, B_DIR0 = 13960,
              B_DIR1 = 14024, B_DIR2 = 14088;
constexpr int PSLAB = 14092;

constexpr float GAUSS_K = -1.0f / (2.0f * 0.1f * 0.1f);
constexpr float SH_C0 = 0.28209479177387814f, SH_C1 = 0.4886025119029199f;
constexpr float SH_C20 = 1.0925484305920792f, SH_C21 = -1.0925484305920792f,
                SH_C22 = 0.31539156525252005f, SH_C23 = -1.0925484305920792f,
                SH_C24 = 0.5462742152960396f;
constexpr float SH_C30 = -0.5900435899266435f, SH_C31 = 2.890611442640554f,
                SH_C32 = -0.4570457994644658f, SH_C33 = 0.3731763325901154f,
                SH_C34 = -0.4570457994644658f, SH_C35 = 1.445305721320277f,
                SH_C36 = -0.5900435899266435f;

__device__ __forceinline__ float gauss(float x) { return expf(x * x * GAUSS_K); }
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Number of meta spans of chunk c: 0 means every row is a sentinel.
__device__ __forceinline__ int chunk_work(const int* meta, int c) {
  int n = 0;
#pragma unroll
  for (int s = 0; s < SUBT; ++s) n += meta[(c * SUBT + s) * 4 + 2];
  return n;
}

__device__ __forceinline__ float2 load_pair(const float* t, size_t e) {
  return __ldg(reinterpret_cast<const float2*>(t) + e);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* t, size_t e) {
  const __nv_bfloat162 v = __ldg(reinterpret_cast<const __nv_bfloat162*>(t) + e);
  return __bfloat1622float2(v);
}

// Corner c (bit 2: x, bit 1: y, bit 0: z) of one level: its table entry in
// window w and its trilinear weight. hx0.. are the hashed per-axis terms of
// the lower corner, o* the fractional offsets.
struct Corners {
  uint32_t hx0, hy0, hz0;
  float ox, oy, oz;
};

__device__ __forceinline__ Corners corner_setup(const int* res, int l, float ux,
                                                float uy, float uz) {
  const float vx = ux * ((float)res[3 * l] - 1.0f);
  const float vy = uy * ((float)res[3 * l + 1] - 1.0f);
  const float vz = uz * ((float)res[3 * l + 2] - 1.0f);
  const float bx = floorf(vx), by = floorf(vy), bz = floorf(vz);
  Corners k;
  k.ox = vx - bx;
  k.oy = vy - by;
  k.oz = vz - bz;
  k.hx0 = (uint32_t)(int)bx;
  k.hy0 = (uint32_t)(int)by * 2654435761u;
  k.hz0 = (uint32_t)(int)bz * 805459861u;
  return k;
}

// Corner c's slot in its window, in [0, WIN).
__device__ __forceinline__ int corner_slot(const Corners& k, int c) {
  const bool cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
  uint32_t h = (cx ? k.hx0 + 1u : k.hx0) ^ (cy ? k.hy0 + 2654435761u : k.hy0) ^
               (cz ? k.hz0 + 805459861u : k.hz0);
  h = h ^ (h >> 9) ^ (h >> 18);
  return (int)(h & (WIN - 1));
}

__device__ __forceinline__ size_t corner_entry(const Corners& k, int w, int c) {
  return (size_t)w * WIN + corner_slot(k, c);
}

__device__ __forceinline__ float corner_weight(const Corners& k, int c) {
  const bool cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
  return (cx ? k.ox : 1.0f - k.ox) * (cy ? k.oy : 1.0f - k.oy) * (cz ? k.oz : 1.0f - k.oz);
}

// Feature pair of one row in window w at level l: the trilinear sum of the 8
// corner entries of the level's table tl.
template <typename TT>
__device__ __forceinline__ float2 encode_level(const TT* __restrict__ tl, const int* res,
                                               int l, int w, float ux, float uy,
                                               float uz) {
  const Corners k = corner_setup(res, l, ux, uy, uz);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wt = corner_weight(k, c);
    const float2 v = load_pair(tl, corner_entry(k, w, c));
    a0 = fmaf(wt, v.x, a0);
    a1 = fmaf(wt, v.y, a1);
  }
  return make_float2(a0, a1);
}

// Degree-3 SH of the unit direction (x, y, z) into sh[0..15].
__device__ __forceinline__ void sh16(float x, float y, float z, float* sh) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  sh[0] = SH_C0;
  sh[1] = SH_C1 * y;
  sh[2] = SH_C1 * z;
  sh[3] = SH_C1 * x;
  sh[4] = SH_C20 * xy;
  sh[5] = SH_C21 * yz;
  sh[6] = SH_C22 * (2.0f * zz - xx - yy);
  sh[7] = SH_C23 * xz;
  sh[8] = SH_C24 * (xx - yy);
  sh[9] = SH_C30 * y * (3.0f * xx - yy);
  sh[10] = SH_C31 * xy * z;
  sh[11] = SH_C32 * y * (4.0f * zz - xx - yy);
  sh[12] = SH_C33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  sh[13] = SH_C34 * x * (4.0f * zz - xx - yy);
  sh[14] = SH_C35 * z * (xx - yy);
  sh[15] = SH_C36 * x * (xx - 3.0f * yy);
}

}  // namespace scanerf
