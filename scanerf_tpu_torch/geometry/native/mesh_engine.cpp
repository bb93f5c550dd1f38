// Proxy-mesh ray engine: uniform-grid DDA + Moller-Trumbore, on the host.
//
// The port's copy of the JAX package's tracer
// (scanerf_tpu/geometry/native/mesh_engine.cpp), itself a replacement for
// the reference's CUDA "fastMesh" package (fastMesh/src/fastMesh_kernel.cu).
// The proxy mesh serves only host-side preprocessing (occlusion masks,
// background depths, voxelized occupancy), so this is a CPU engine with
// OpenMP. Query semantics:
//   - first_hit:   t of first ray-triangle intersection, 0 on miss
//                  (fastMesh_kernel.cu:230-329)
//   - first_enter: conservative t of first entry into any occupied
//                  cell's triangle-AABB, -1 on miss (:125-227)
//   - voxelize:    mark occupancy of a target grid by 1.5x-dilated
//                  triangle AABBs, optional outside-init
//                  (cuda/include/voxelize.h)
//
// C ABI for ctypes; no Python dependencies. g++ builds it at first use
// (geometry/mesh_engine.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 vmin(V3 a, V3 b) { return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)}; }
static inline V3 vmax(V3 a, V3 b) { return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)}; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct Grid {
  int res;                       // cells per axis
  V3 bbox_min, bbox_max, cell;   // world bounds and cell size
  std::vector<int> cell_start;   // CSR offsets, res^3 + 1
  std::vector<int> cell_faces;   // CSR face ids
  std::vector<uint8_t> occupied; // res^3
  std::vector<V3> face_min, face_max;  // per-cell clipped triangle AABB
  std::vector<V3> verts;
  std::vector<int> faces;        // 3 * n_faces
  int n_faces;
};

static inline int cell_index(const Grid& g, int x, int y, int z) {
  return (x * g.res + y) * g.res + z;
}

// Moller-Trumbore; returns t > eps or -1
static inline float ray_tri(V3 o, V3 d, V3 a, V3 b, V3 c) {
  const float eps = 1e-7f;
  V3 e1 = b - a, e2 = c - a;
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  if (std::fabs(det) < eps) return -1.f;
  float inv = 1.f / det;
  V3 tv = o - a;
  float u = dot(tv, p) * inv;
  if (u < 0.f || u > 1.f) return -1.f;
  V3 q = cross(tv, e1);
  float v = dot(d, q) * inv;
  if (v < 0.f || u + v > 1.f) return -1.f;
  float t = dot(e2, q) * inv;
  return t > eps ? t : -1.f;
}

// slab test against [mn, mx]; entry clamped >= 0; returns false on miss
static inline bool ray_aabb(V3 o, V3 d, V3 mn, V3 mx, float* t0, float* t1) {
  float tn = -1e30f, tf = 1e30f;
  const float* op = &o.x;
  const float* dp = &d.x;
  const float* mnp = &mn.x;
  const float* mxp = &mx.x;
  for (int i = 0; i < 3; i++) {
    float dv = dp[i];
    if (std::fabs(dv) < 1e-12f) dv = dv >= 0 ? 1e-12f : -1e-12f;
    float a = (mnp[i] - op[i]) / dv;
    float b = (mxp[i] - op[i]) / dv;
    if (a > b) std::swap(a, b);
    tn = std::max(tn, a);
    tf = std::min(tf, b);
  }
  if (tf <= std::max(tn, 0.f)) return false;
  *t0 = std::max(tn, 0.f);
  *t1 = tf;
  return true;
}

}  // namespace

extern "C" {

void* mesh_build(const float* verts, int n_verts, const int* faces,
                 int n_faces, int res) {
  Grid* g = new Grid();
  g->res = res;
  g->n_faces = n_faces;
  g->verts.resize(n_verts);
  std::memcpy(g->verts.data(), verts, sizeof(float) * 3 * n_verts);
  g->faces.assign(faces, faces + 3 * n_faces);

  V3 mn = v3(1e30f, 1e30f, 1e30f), mx = v3(-1e30f, -1e30f, -1e30f);
  for (int i = 0; i < n_verts; i++) {
    mn = vmin(mn, g->verts[i]);
    mx = vmax(mx, g->verts[i]);
  }
  // pad slightly so boundary triangles land inside
  V3 pad = (mx - mn) * 1e-4f + v3(1e-6f, 1e-6f, 1e-6f);
  g->bbox_min = mn - pad;
  g->bbox_max = mx + pad;
  V3 ext = g->bbox_max - g->bbox_min;
  g->cell = v3(ext.x / res, ext.y / res, ext.z / res);

  int ncell = res * res * res;
  std::vector<std::vector<int>> lists(ncell);
  g->occupied.assign(ncell, 0);
  g->face_min.assign(ncell, v3(1e30f, 1e30f, 1e30f));
  g->face_max.assign(ncell, v3(-1e30f, -1e30f, -1e30f));

  for (int fi = 0; fi < n_faces; fi++) {
    V3 a = g->verts[g->faces[3 * fi]];
    V3 b = g->verts[g->faces[3 * fi + 1]];
    V3 c = g->verts[g->faces[3 * fi + 2]];
    V3 tmin = vmin(vmin(a, b), c), tmax = vmax(vmax(a, b), c);
    int x0 = std::clamp((int)((tmin.x - g->bbox_min.x) / g->cell.x), 0, res - 1);
    int y0 = std::clamp((int)((tmin.y - g->bbox_min.y) / g->cell.y), 0, res - 1);
    int z0 = std::clamp((int)((tmin.z - g->bbox_min.z) / g->cell.z), 0, res - 1);
    int x1 = std::clamp((int)((tmax.x - g->bbox_min.x) / g->cell.x), 0, res - 1);
    int y1 = std::clamp((int)((tmax.y - g->bbox_min.y) / g->cell.y), 0, res - 1);
    int z1 = std::clamp((int)((tmax.z - g->bbox_min.z) / g->cell.z), 0, res - 1);
    for (int x = x0; x <= x1; x++)
      for (int y = y0; y <= y1; y++)
        for (int z = z0; z <= z1; z++) {
          int ci = cell_index(*g, x, y, z);
          lists[ci].push_back(fi);
          g->occupied[ci] = 1;
          g->face_min[ci] = vmin(g->face_min[ci], tmin);
          g->face_max[ci] = vmax(g->face_max[ci], tmax);
        }
  }
  g->cell_start.resize(ncell + 1);
  g->cell_start[0] = 0;
  for (int i = 0; i < ncell; i++)
    g->cell_start[i + 1] = g->cell_start[i] + (int)lists[i].size();
  g->cell_faces.resize(g->cell_start[ncell]);
  for (int i = 0; i < ncell; i++)
    std::copy(lists[i].begin(), lists[i].end(),
              g->cell_faces.begin() + g->cell_start[i]);
  return g;
}

void mesh_free(void* h) { delete (Grid*)h; }

void mesh_scene_bound(void* h, float* out6) {
  Grid* g = (Grid*)h;
  out6[0] = g->bbox_min.x; out6[1] = g->bbox_min.y; out6[2] = g->bbox_min.z;
  out6[3] = g->bbox_max.x; out6[4] = g->bbox_max.y; out6[5] = g->bbox_max.z;
}

// DDA over the grid; `mode` 0 = first_hit (exact triangle), 1 = first_enter
// (conservative entry into an occupied cell's triangle AABB)
static float trace_one(const Grid& g, V3 o, V3 d, int mode) {
  float t0, t1;
  if (!ray_aabb(o, d, g.bbox_min, g.bbox_max, &t0, &t1)) return mode ? -1.f : 0.f;
  // normalize to cell coordinates
  V3 p = o + d * (t0 + 1e-6f);
  int x = std::clamp((int)((p.x - g.bbox_min.x) / g.cell.x), 0, g.res - 1);
  int y = std::clamp((int)((p.y - g.bbox_min.y) / g.cell.y), 0, g.res - 1);
  int z = std::clamp((int)((p.z - g.bbox_min.z) / g.cell.z), 0, g.res - 1);
  int sx = d.x > 0 ? 1 : -1, sy = d.y > 0 ? 1 : -1, sz = d.z > 0 ? 1 : -1;
  auto safediv = [](float a, float b) {
    if (std::fabs(b) < 1e-12f) b = b >= 0 ? 1e-12f : -1e-12f;
    return a / b;
  };
  float tdx = std::fabs(safediv(g.cell.x, d.x));
  float tdy = std::fabs(safediv(g.cell.y, d.y));
  float tdz = std::fabs(safediv(g.cell.z, d.z));
  float nx = g.bbox_min.x + (x + (sx > 0 ? 1 : 0)) * g.cell.x;
  float ny = g.bbox_min.y + (y + (sy > 0 ? 1 : 0)) * g.cell.y;
  float nz = g.bbox_min.z + (z + (sz > 0 ? 1 : 0)) * g.cell.z;
  float tmx = safediv(nx - o.x, d.x);
  float tmy = safediv(ny - o.y, d.y);
  float tmz = safediv(nz - o.z, d.z);

  while (x >= 0 && x < g.res && y >= 0 && y < g.res && z >= 0 && z < g.res) {
    int ci = cell_index(g, x, y, z);
    if (g.occupied[ci]) {
      if (mode == 1) {
        float a0, a1;
        if (ray_aabb(o, d, g.face_min[ci], g.face_max[ci], &a0, &a1)) return a0;
      } else {
        float best = 1e30f;
        for (int k = g.cell_start[ci]; k < g.cell_start[ci + 1]; k++) {
          int fi = g.cell_faces[k];
          float t = ray_tri(o, d, g.verts[g.faces[3 * fi]],
                            g.verts[g.faces[3 * fi + 1]],
                            g.verts[g.faces[3 * fi + 2]]);
          if (t > 0 && t < best) best = t;
        }
        if (best < 1e30f) {
          // accept only hits inside this cell (avoid cross-cell misses)
          float cell_exit = std::min(std::min(tmx, tmy), tmz);
          if (best <= cell_exit + 1e-4f) return best;
        }
      }
    }
    if (tmx < tmy && tmx <= tmz) {
      x += sx; tmx += tdx;
    } else if (tmy <= tmz) {
      y += sy; tmy += tdy;
    } else {
      z += sz; tmz += tdz;
    }
  }
  return mode ? -1.f : 0.f;
}

void mesh_trace(void* h, const float* rays_o, const float* rays_d, int n,
                float* out_t, int mode) {
  Grid* g = (Grid*)h;
#pragma omp parallel for schedule(dynamic, 256)
  for (int i = 0; i < n; i++) {
    V3 o = v3(rays_o[3 * i], rays_o[3 * i + 1], rays_o[3 * i + 2]);
    V3 d = v3(rays_d[3 * i], rays_d[3 * i + 1], rays_d[3 * i + 2]);
    out_t[i] = trace_one(*g, o, d, mode);
  }
}

// voxelize into an arbitrary target grid (cuda/include/voxelize.h)
void mesh_voxelize(void* h, const int* resolution3, const float* corner3,
                   const float* size3, uint8_t* occ, int init_out,
                   uint8_t* outside) {
  Grid* g = (Grid*)h;
  int rx = resolution3[0], ry = resolution3[1], rz = resolution3[2];
  V3 bmin = v3(corner3[0], corner3[1], corner3[2]);
  V3 bsize = v3(size3[0], size3[1], size3[2]);
  V3 cell = v3(bsize.x / rx, bsize.y / ry, bsize.z / rz);
  V3 bmax = bmin + bsize;
  V3 geo_min = v3(1e30f, 1e30f, 1e30f), geo_max = v3(-1e30f, -1e30f, -1e30f);

  for (int fi = 0; fi < g->n_faces; fi++) {
    V3 a = g->verts[g->faces[3 * fi]];
    V3 b = g->verts[g->faces[3 * fi + 1]];
    V3 c = g->verts[g->faces[3 * fi + 2]];
    V3 mn = vmin(vmin(a, b), c), mx = vmax(vmax(a, b), c);
    V3 ctr = (mn + mx) * 0.5f;
    V3 half = (mx - mn) * 0.75f;  // 1.5x dilation
    mn = ctr - half;
    mx = ctr + half;
    if (mx.x <= bmin.x || mx.y <= bmin.y || mx.z <= bmin.z ||
        mn.x >= bmax.x || mn.y >= bmax.y || mn.z >= bmax.z)
      continue;
    geo_min = vmin(geo_min, mn);
    geo_max = vmax(geo_max, mx);
    int x0 = std::clamp((int)((mn.x - bmin.x) / cell.x), 0, rx - 1);
    int y0 = std::clamp((int)((mn.y - bmin.y) / cell.y), 0, ry - 1);
    int z0 = std::clamp((int)((mn.z - bmin.z) / cell.z), 0, rz - 1);
    int x1 = std::clamp((int)((mx.x - bmin.x) / cell.x), 0, rx - 1);
    int y1 = std::clamp((int)((mx.y - bmin.y) / cell.y), 0, ry - 1);
    int z1 = std::clamp((int)((mx.z - bmin.z) / cell.z), 0, rz - 1);
    for (int x = x0; x <= x1; x++)
      for (int y = y0; y <= y1; y++)
        for (int z = z0; z <= z1; z++) occ[(x * ry + y) * rz + z] = 1;
  }

  if (init_out) {
    for (int x = 0; x < rx; x++)
      for (int y = 0; y < ry; y++)
        for (int z = 0; z < rz; z++) {
          V3 loc = bmin + v3((x + 0.5f) * cell.x, (y + 0.5f) * cell.y,
                             (z + 0.5f) * cell.z);
          if (loc.x < geo_min.x || loc.y < geo_min.y || loc.z < geo_min.z ||
              loc.x > geo_max.x || loc.y > geo_max.y || loc.z > geo_max.z) {
            int n = (x * ry + y) * rz + z;
            occ[n] = 1;
            outside[n] = 1;
          }
        }
  }
}

}  // extern "C"
