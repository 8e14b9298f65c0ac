// The port's copy of nvdiffrecmc_tpu/native/uv_unwrap.cpp (host code, no
// CUDA), built with g++ by nvdiffrecmc_tpu_torch/uv_unwrap.py.
//
// Native UV unwrapper: normal-cone chart growing + per-chart orthographic
// parameterization + shelf packing.  Fills the role of xatlas.parametrize at
// the pass-1 -> pass-2 boundary (reference train.py:108-152): the baked 2D
// textures need an atlas whose charts are locally low-distortion and whose
// seams can be dilated; millimetric xatlas-grade optimization is not needed
// for a bake target that is re-optimized afterwards.
//
// Exported C ABI (ctypes):
//   int uv_unwrap(const float* pos, int n_verts,
//                 const int* tris, int n_tris,
//                 float cone_cos, int max_faces, float gutter,
//                 float* out_uv /*cap 3*n_tris*2*/,
//                 int* out_tidx /*n_tris*3*/,
//                 int* out_nverts);
// Returns 0 on success.  Vertices are deduplicated per (chart, vertex), so
// interpolation is continuous inside a chart and seams appear only at chart
// boundaries.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <queue>
#include <algorithm>
#include <unordered_map>

namespace {

struct V3 { float x, y, z; };

static inline V3 sub(const V3& a, const V3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
static inline float dot(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline V3 normalize(const V3& a) {
  float l = std::sqrt(dot(a, a));
  if (l < 1e-20f) return {0.f, 0.f, 1.f};
  return {a.x / l, a.y / l, a.z / l};
}

struct Chart {
  std::vector<int> faces;
  V3 normal;        // area-weighted accumulated normal
  // filled by parameterization/packing:
  float xlo, ylo, xhi, yhi;   // local-2d bbox (pre-pack)
  float offx, offy;           // pack offset (applied to bbox-shifted uvs)
};

}  // namespace

extern "C" int uv_unwrap(const float* pos, int n_verts,
                         const int* tris, int n_tris,
                         float cone_cos, int max_faces, float gutter,
                         float* out_uv, int* out_tidx, int* out_nverts) {
  if (n_tris <= 0 || n_verts <= 0) return 1;
  auto P = [&](int i) -> V3 {
    return {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  };

  // --- face normals (area-weighted) ---
  std::vector<V3> fn(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    V3 a = P(tris[3 * t]), b = P(tris[3 * t + 1]), c = P(tris[3 * t + 2]);
    fn[t] = cross(sub(b, a), sub(c, a));  // length = 2*area
  }

  // --- edge -> faces adjacency ---
  std::unordered_map<uint64_t, int> edge_first;
  edge_first.reserve(n_tris * 3);
  std::vector<std::vector<int>> nbr(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    for (int e = 0; e < 3; ++e) {
      uint32_t a = (uint32_t)tris[3 * t + e];
      uint32_t b = (uint32_t)tris[3 * t + (e + 1) % 3];
      if (a > b) std::swap(a, b);
      uint64_t key = ((uint64_t)a << 32) | b;
      auto it = edge_first.find(key);
      if (it == edge_first.end()) {
        edge_first.emplace(key, t);
      } else if (it->second >= 0) {
        int o = it->second;
        nbr[t].push_back(o);
        nbr[o].push_back(t);
        it->second = -1;  // non-manifold third face: ignore further pairs
      }
    }
  }

  // --- chart growing (BFS, normal cone + face cap) ---
  std::vector<int> chart_of(n_tris, -1);
  std::vector<Chart> charts;
  for (int seed = 0; seed < n_tris; ++seed) {
    if (chart_of[seed] >= 0) continue;
    Chart ch;
    ch.normal = fn[seed];
    std::queue<int> q;
    q.push(seed);
    chart_of[seed] = (int)charts.size();
    while (!q.empty() && (int)ch.faces.size() < max_faces) {
      int f = q.front();
      q.pop();
      ch.faces.push_back(f);
      ch.normal = {ch.normal.x + fn[f].x, ch.normal.y + fn[f].y,
                   ch.normal.z + fn[f].z};
      V3 cn = normalize(ch.normal);
      for (int g : nbr[f]) {
        if (chart_of[g] >= 0) continue;
        V3 gn = normalize(fn[g]);
        if (dot(gn, cn) > cone_cos) {
          chart_of[g] = (int)charts.size();
          q.push(g);
        }
      }
    }
    // faces left in the queue when the cap hit: release for later seeds
    while (!q.empty()) {
      chart_of[q.front()] = -1;
      q.pop();
    }
    charts.push_back(std::move(ch));
  }

  // --- parameterize: orthographic projection onto the chart plane ---
  int n_charts = (int)charts.size();
  std::unordered_map<uint64_t, int> remap;  // (chart, vid) -> new vertex id
  remap.reserve(n_tris * 2);
  std::vector<float> uvx, uvy;
  std::vector<int> uv_chart;
  uvx.reserve(n_tris * 2);
  int out_n = 0;

  for (int c = 0; c < n_charts; ++c) {
    Chart& ch = charts[c];
    V3 n = normalize(ch.normal);
    // Pixar branchless ONB
    float sign = n.z >= 0.f ? 1.f : -1.f;
    float a = -1.f / (sign + n.z);
    float b = n.x * n.y * a;
    V3 u = {1.f + sign * n.x * n.x * a, sign * b, -sign * n.x};
    V3 v = {b, sign + n.y * n.y * a, -n.y};
    ch.xlo = ch.ylo = 1e30f;
    ch.xhi = ch.yhi = -1e30f;
    for (int f : ch.faces) {
      for (int e = 0; e < 3; ++e) {
        int vid = tris[3 * f + e];
        uint64_t key = ((uint64_t)c << 32) | (uint32_t)vid;
        auto it = remap.find(key);
        int nid;
        if (it == remap.end()) {
          V3 p = P(vid);
          float x = dot(p, u), y = dot(p, v);
          nid = out_n++;
          remap.emplace(key, nid);
          uvx.push_back(x);
          uvy.push_back(y);
          uv_chart.push_back(c);
          ch.xlo = std::min(ch.xlo, x);
          ch.xhi = std::max(ch.xhi, x);
          ch.ylo = std::min(ch.ylo, y);
          ch.yhi = std::max(ch.yhi, y);
        } else {
          nid = it->second;
          // bbox already covers it
        }
        out_tidx[3 * f + e] = nid;
      }
    }
    if (ch.xhi < ch.xlo) { ch.xlo = ch.ylo = 0.f; ch.xhi = ch.yhi = 0.f; }
  }

  // --- shelf packing (heights sorted descending) ---
  std::vector<int> order(n_charts);
  for (int i = 0; i < n_charts; ++i) order[i] = i;
  double total_area = 0.0;
  for (const Chart& ch : charts) {
    total_area += double(ch.xhi - ch.xlo) * double(ch.yhi - ch.ylo);
  }
  float target_w = (float)std::sqrt(std::max(total_area, 1e-12)) * 1.1f;
  for (const Chart& ch : charts)
    target_w = std::max(target_w, ch.xhi - ch.xlo);
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return (charts[a].yhi - charts[a].ylo) > (charts[b].yhi - charts[b].ylo);
  });
  // gutter is expressed in final [0,1] units; approximate the pre-normalize
  // scale so the requested gutter survives normalization
  float pre_scale_est = target_w * 1.2f;
  float g = gutter * pre_scale_est;
  float cur_x = 0.f, cur_y = 0.f, shelf_h = 0.f;
  float used_w = 0.f, used_h = 0.f;
  for (int ci : order) {
    Chart& ch = charts[ci];
    float w = (ch.xhi - ch.xlo) + g;
    float h = (ch.yhi - ch.ylo) + g;
    if (cur_x + w > target_w + g && cur_x > 0.f) {
      cur_x = 0.f;
      cur_y += shelf_h;
      shelf_h = 0.f;
    }
    ch.offx = cur_x;
    ch.offy = cur_y;
    cur_x += w;
    shelf_h = std::max(shelf_h, h);
    used_w = std::max(used_w, cur_x);
    used_h = std::max(used_h, cur_y + shelf_h);
  }
  float norm = 1.f / std::max(std::max(used_w, used_h), 1e-12f);

  for (int i = 0; i < out_n; ++i) {
    const Chart& ch = charts[uv_chart[i]];
    out_uv[2 * i] = (uvx[i] - ch.xlo + ch.offx + 0.5f * g) * norm;
    out_uv[2 * i + 1] = (uvy[i] - ch.ylo + ch.offy + 0.5f * g) * norm;
  }
  *out_nverts = out_n;
  return 0;
}
