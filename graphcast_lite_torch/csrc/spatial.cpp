// Native spatial-query engine for the host-side graph compiler.
//
// The reference delegates its graph-construction inner loops to native code
// inside dependencies (scipy cKDTree for ε-ball/k-NN queries, trimesh+rtree
// for triangle containment — reference src/mesh/grid_mesh_connectivity.py).
// This module provides the same queries as first-party native code, built
// around a uniform 3-D cell grid over the unit sphere (points are unit
// vectors, query radii are chordal distances):
//
//   * ball_query:   all target indices within radius of each query point
//   * knn_query:    k nearest targets per query point (expanding ring search)
//   * closest_face: index of the closest triangle per query point
//                   (cell grid over face centroids + exact Ericson
//                   closest-point-on-triangle test)
//
// C ABI for ctypes; two-pass (count, fill) protocol for variable-size
// results.  Single-threaded by design: graph compilation runs once per
// model build and the grid makes it O(N) — the Python fallback in
// mesh/native.py mirrors the exact same semantics.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct CellGrid {
  float cell;            // cell edge length
  int dim;               // cells per axis (covering [-1-eps, 1+eps])
  float lo;              // grid origin
  std::vector<int32_t> cell_start;  // CSR offsets per cell
  std::vector<int32_t> order;       // point ids grouped by cell

  int clampi(int v) const { return std::max(0, std::min(dim - 1, v)); }

  int cell_of(float x, float y, float z) const {
    int ix = clampi((int)((x - lo) / cell));
    int iy = clampi((int)((y - lo) / cell));
    int iz = clampi((int)((z - lo) / cell));
    return (ix * dim + iy) * dim + iz;
  }

  void build(const float* pts, int n, float cell_size) {
    cell = cell_size;
    lo = -1.05f;
    dim = std::max(1, (int)std::ceil(2.10f / cell));
    // Cap the grid so tiny radii don't explode memory.
    while ((int64_t)dim * dim * dim > (int64_t)8 * 1024 * 1024) {
      cell *= 2.0f;
      dim = std::max(1, (int)std::ceil(2.10f / cell));
    }
    int ncells = dim * dim * dim;
    std::vector<int32_t> counts(ncells + 1, 0);
    std::vector<int32_t> cid(n);
    for (int i = 0; i < n; ++i) {
      cid[i] = cell_of(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
      counts[cid[i] + 1]++;
    }
    for (int c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
    cell_start = counts;
    order.resize(n);
    std::vector<int32_t> cursor(cell_start.begin(), cell_start.end() - 1);
    for (int i = 0; i < n; ++i) order[cursor[cid[i]]++] = i;
  }

  template <typename Fn>
  void for_each_in_range(float x, float y, float z, float r, Fn&& fn) const {
    int ix0 = clampi((int)((x - r - lo) / cell));
    int ix1 = clampi((int)((x + r - lo) / cell));
    int iy0 = clampi((int)((y - r - lo) / cell));
    int iy1 = clampi((int)((y + r - lo) / cell));
    int iz0 = clampi((int)((z - r - lo) / cell));
    int iz1 = clampi((int)((z + r - lo) / cell));
    for (int ix = ix0; ix <= ix1; ++ix)
      for (int iy = iy0; iy <= iy1; ++iy)
        for (int iz = iz0; iz <= iz1; ++iz) {
          int c = (ix * dim + iy) * dim + iz;
          for (int32_t k = cell_start[c]; k < cell_start[c + 1]; ++k)
            fn(order[k]);
        }
  }
};

inline float dist2(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

// Exact closest point on triangle (abc) to p — Ericson, RTCD §5.1.5.
inline float point_triangle_dist2(const float* p, const float* a,
                                  const float* b, const float* c) {
  float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float ac[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  float ap[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  auto dot = [](const float* u, const float* v) {
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
  };
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) {
    return dist2(p, a);
  }
  float bp[3] = {p[0] - b[0], p[1] - b[1], p[2] - b[2]};
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return dist2(p, b);
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float v = d1 / (d1 - d3);
    float q[3] = {a[0] + v * ab[0], a[1] + v * ab[1], a[2] + v * ab[2]};
    return dist2(p, q);
  }
  float cp[3] = {p[0] - c[0], p[1] - c[1], p[2] - c[2]};
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return dist2(p, c);
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float w = d2 / (d2 - d6);
    float q[3] = {a[0] + w * ac[0], a[1] + w * ac[1], a[2] + w * ac[2]};
    return dist2(p, q);
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    float q[3] = {b[0] + w * (c[0] - b[0]), b[1] + w * (c[1] - b[1]),
                  b[2] + w * (c[2] - b[2])};
    return dist2(p, q);
  }
  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  float q[3] = {a[0] + v * ab[0] + w * ac[0], a[1] + v * ab[1] + w * ac[1],
                a[2] + v * ab[2] + w * ac[2]};
  return dist2(p, q);
}

}  // namespace

extern "C" {

// ε-ball query.  Pass counts=nullptr on the fill pass.
// Pass 1: fills counts[n_query] with per-point neighbor counts.
// Pass 2: fills pairs_out (2 * total) as (query_idx, target_idx), grouped by
//         query index ascending, targets sorted ascending within a group.
int ball_query(const float* targets, int n_targets, const float* queries,
               int n_query, float radius, int32_t* counts,
               int32_t* pairs_out) {
  CellGrid grid;
  grid.build(targets, n_targets, std::max(radius, 1e-4f));
  float r2 = radius * radius;
  int64_t total = 0;
  std::vector<int32_t> hits;
  for (int i = 0; i < n_query; ++i) {
    const float* q = queries + 3 * i;
    hits.clear();
    grid.for_each_in_range(q[0], q[1], q[2], radius, [&](int32_t t) {
      if (dist2(q, targets + 3 * t) <= r2) hits.push_back(t);
    });
    std::sort(hits.begin(), hits.end());
    if (counts) counts[i] = (int32_t)hits.size();
    if (pairs_out) {
      for (int32_t t : hits) {
        pairs_out[2 * total] = i;
        pairs_out[2 * total + 1] = t;
        ++total;
      }
    } else {
      total += (int64_t)hits.size();
    }
  }
  return (int)total;
}

// k-NN query: fills idx_out[n_query*k] and dist_out[n_query*k] (sorted by
// distance).  Expanding search radius until k found.
void knn_query(const float* targets, int n_targets, const float* queries,
               int n_query, int k, int32_t* idx_out, float* dist_out) {
  k = std::min(k, n_targets);
  // Heuristic initial radius from target density on the sphere.
  float area_per = 12.57f / std::max(1, n_targets);
  float r0 = std::sqrt(area_per * k / 3.14159f) * 2.0f + 1e-3f;
  CellGrid grid;
  grid.build(targets, n_targets, std::max(r0, 1e-3f));
  std::vector<std::pair<float, int32_t>> cand;
  for (int i = 0; i < n_query; ++i) {
    const float* q = queries + 3 * i;
    float r = r0;
    for (;;) {
      cand.clear();
      float r2 = r * r;
      grid.for_each_in_range(q[0], q[1], q[2], r, [&](int32_t t) {
        float d2 = dist2(q, targets + 3 * t);
        if (d2 <= r2) cand.emplace_back(d2, t);
      });
      if ((int)cand.size() >= k || r > 4.0f) break;
      r *= 2.0f;
    }
    std::sort(cand.begin(), cand.end());
    for (int j = 0; j < k; ++j) {
      idx_out[i * k + j] = cand[j].second;
      dist_out[i * k + j] = std::sqrt(cand[j].first);
    }
  }
}

// Closest triangle per query point.  faces: [n_faces*3] vertex ids into
// vertices [n_vertices*3].  Fills face_out[n_query].
void closest_face(const float* vertices, int n_vertices, const int32_t* faces,
                  int n_faces, const float* queries, int n_query,
                  int32_t* face_out) {
  // Grid over face centroids; candidate radius from max face circumradius.
  std::vector<float> centroids(3 * n_faces);
  float max_r = 0.0f;
  for (int f = 0; f < n_faces; ++f) {
    const float* a = vertices + 3 * faces[3 * f];
    const float* b = vertices + 3 * faces[3 * f + 1];
    const float* c = vertices + 3 * faces[3 * f + 2];
    for (int d = 0; d < 3; ++d)
      centroids[3 * f + d] = (a[d] + b[d] + c[d]) / 3.0f;
    const float* ctr = &centroids[3 * f];
    max_r = std::max({max_r, dist2(ctr, a), dist2(ctr, b), dist2(ctr, c)});
  }
  max_r = std::sqrt(max_r);
  CellGrid grid;
  grid.build(centroids.data(), n_faces, std::max(2.0f * max_r, 1e-3f));

  for (int i = 0; i < n_query; ++i) {
    const float* q = queries + 3 * i;
    float search = 2.0f * max_r + 1e-3f;
    int best = -1;
    float best_d2 = 1e30f;
    for (;;) {
      grid.for_each_in_range(q[0], q[1], q[2], search, [&](int32_t f) {
        // Cheap centroid prefilter before the exact test.
        float cd2 = dist2(q, centroids.data() + 3 * f);
        float bound = std::sqrt(best_d2) + max_r;
        if (best >= 0 && cd2 > bound * bound) return;
        float d2 = point_triangle_dist2(q, vertices + 3 * faces[3 * f],
                                        vertices + 3 * faces[3 * f + 1],
                                        vertices + 3 * faces[3 * f + 2]);
        if (d2 < best_d2) {
          best_d2 = d2;
          best = f;
        }
      });
      if (best >= 0 || search > 4.0f) break;
      search *= 2.0f;
    }
    face_out[i] = best;
  }
}

}  // extern "C"
