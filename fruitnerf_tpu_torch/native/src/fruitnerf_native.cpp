// fruitnerf_native: C++ point-cloud engine for the counting stage.
//
// The reference rides native code for exactly this work: Open3D's C++ radius
// outlier removal / voxel downsample (clustering_base.py:183-207) and
// sklearn's Cython DBSCAN (clustering_base.py:13,200). This library is the
// equivalent: a uniform-grid spatial hash engine exposed over a C ABI
// (loaded via ctypes, fruitnerf_tpu_torch/native/__init__.py). It exists so
// Fuji-scale clouds (millions of points, config_real.py:202) count fast on
// the host WITHOUT touching the accelerator that is busy training/exporting.
//
// Semantics contracts (tested against the pure-Python engines):
//   fn_neighbor_counts  - #points within radius, self included
//   fn_dbscan           - sklearn DBSCAN semantics: core iff count>=min_samples,
//                         BFS expansion from cores in index order, border
//                         points join the first core cluster reaching them,
//                         noise = -1  (mirrors counting/dbscan.py:dbscan_bfs)
//   fn_voxel_downsample - mean position per occupied voxel (open3d
//                         voxel_down_sample), voxel key = floor(p/voxel)
//   fn_radius_outlier   - keep-mask of points with >= nb_points neighbors in
//                         radius (open3d remove_radius_outlier)
//
// Build: g++ -O3 -shared -fPIC (see ../Makefile); no deps beyond libstdc++.

#include <algorithm>
#include <cmath>
#include <functional>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
  // points bucketed into cells of side `cell`; cell -> contiguous index range
  const float* pts;
  int64_t n;
  float cell;
  std::unordered_map<int64_t, int32_t> cell_of;  // packed key -> dense cell id
  std::vector<int64_t> starts;                   // dense cell id -> start
  std::vector<int64_t> order;                    // point indices, cell-grouped
                                                 // (ascending within a cell)

  static int64_t pack(int64_t x, int64_t y, int64_t z) {
    // 21 bits per axis, offset to positive; collisions impossible within
    // +-2^20 cells (~1e6 cells/axis, far beyond any cloud we see)
    const int64_t B = int64_t(1) << 20;
    return ((x + B) << 42) | ((y + B) << 21) | (z + B);
  }

  int64_t key_of(int64_t i) const {
    return pack((int64_t)std::floor(pts[3 * i + 0] / cell),
                (int64_t)std::floor(pts[3 * i + 1] / cell),
                (int64_t)std::floor(pts[3 * i + 2] / cell));
  }

  Grid(const float* p, int64_t n_, float cell_) : pts(p), n(n_), cell(cell_) {
    std::vector<int64_t> keys(n);
    cell_of.reserve(n * 2);
    for (int64_t i = 0; i < n; ++i) {
      keys[i] = key_of(i);
      cell_of.emplace((int64_t)keys[i], 0);
    }
    int32_t next = 0;
    for (auto& kv : cell_of) kv.second = next++;
    std::vector<int64_t> counts(next + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++counts[cell_of[keys[i]] + 1];
    for (int32_t c = 0; c < next; ++c) counts[c + 1] += counts[c];
    starts = counts;  // starts[c]..starts[c+1] after fill
    order.resize(n);
    std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n; ++i)  // ascending i => stable within cell
      order[cursor[cell_of[keys[i]]]++] = i;
  }

  // visit indices of the 27-cell neighborhood of point i
  template <typename F>
  void neighborhood(int64_t i, F&& fn) const {
    int64_t cx = (int64_t)std::floor(pts[3 * i + 0] / cell);
    int64_t cy = (int64_t)std::floor(pts[3 * i + 1] / cell);
    int64_t cz = (int64_t)std::floor(pts[3 * i + 2] / cell);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = cell_of.find(pack(cx + dx, cy + dy, cz + dz));
          if (it == cell_of.end()) continue;
          int64_t s = starts[it->second], e = starts[it->second + 1];
          for (int64_t k = s; k < e; ++k) fn(order[k]);
        }
  }
};

inline float dist2(const float* pts, int64_t a, int64_t b) {
  float dx = pts[3 * a] - pts[3 * b];
  float dy = pts[3 * a + 1] - pts[3 * b + 1];
  float dz = pts[3 * a + 2] - pts[3 * b + 2];
  return dx * dx + dy * dy + dz * dz;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 4, n / 4096));
  if (nt <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

void count_neighbors(const Grid& g, float radius, int32_t* counts) {
  float r2 = radius * radius;
  parallel_for(g.n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t c = 0;
      g.neighborhood(i, [&](int64_t j) {
        if (dist2(g.pts, i, j) <= r2) ++c;  // self included (d=0)
      });
      counts[i] = c;
    }
  });
}

}  // namespace

extern "C" {

int fn_neighbor_counts(const float* pts, int64_t n, float radius,
                       int32_t* counts) {
  if (n == 0) return 0;
  if (radius <= 0) return -1;
  Grid g(pts, n, radius);
  count_neighbors(g, radius, counts);
  return 0;
}

int fn_radius_outlier(const float* pts, int64_t n, float radius,
                      int32_t nb_points, uint8_t* keep) {
  if (n == 0) return 0;
  if (radius <= 0) return -1;
  Grid g(pts, n, radius);
  std::vector<int32_t> counts(n);
  count_neighbors(g, radius, counts.data());
  for (int64_t i = 0; i < n; ++i) keep[i] = counts[i] >= nb_points;
  return 0;
}

int fn_dbscan(const float* pts, int64_t n, float eps, int32_t min_samples,
              int32_t* labels) {
  if (n == 0) return 0;
  if (eps <= 0) return -1;
  Grid g(pts, n, eps);
  float e2 = eps * eps;
  std::vector<int32_t> counts(n);
  count_neighbors(g, eps, counts.data());
  std::vector<uint8_t> core(n);
  for (int64_t i = 0; i < n; ++i) core[i] = counts[i] >= min_samples;

  std::fill(labels, labels + n, -1);
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> stack;
  int32_t cluster = 0;
  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed] || !core[seed]) continue;
    stack.clear();
    stack.push_back(seed);
    visited[seed] = 1;
    labels[seed] = cluster;
    while (!stack.empty()) {
      int64_t p = stack.back();
      stack.pop_back();
      if (!core[p]) continue;  // border: labeled, never expanded
      g.neighborhood(p, [&](int64_t q) {
        if (dist2(g.pts, p, q) > e2) return;
        if (labels[q] == -1) labels[q] = cluster;
        if (!visited[q]) {
          visited[q] = 1;
          stack.push_back(q);
        }
      });
    }
    ++cluster;
  }
  return 0;
}

// out_pts must hold n*3 floats, out_keys n*3 int64s (the integer voxel
// coordinates, so callers can re-establish a deterministic order without
// re-deriving keys from rounded float means); returns #voxels via out_n.
// Voxel order is unspecified (hash order); callers must not rely on it.
int fn_voxel_downsample(const float* pts, int64_t n, float voxel,
                        float* out_pts, int64_t* out_keys, int64_t* out_n) {
  if (voxel <= 0) return -1;
  struct Acc {
    double s[3] = {0, 0, 0};
    int64_t k[3] = {0, 0, 0};
    int64_t c = 0;
  };
  std::unordered_map<int64_t, Acc> acc;
  acc.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t kx = (int64_t)std::floor(pts[3 * i] / voxel);
    int64_t ky = (int64_t)std::floor(pts[3 * i + 1] / voxel);
    int64_t kz = (int64_t)std::floor(pts[3 * i + 2] / voxel);
    Acc& a = acc[Grid::pack(kx, ky, kz)];
    a.s[0] += pts[3 * i];
    a.s[1] += pts[3 * i + 1];
    a.s[2] += pts[3 * i + 2];
    a.k[0] = kx;
    a.k[1] = ky;
    a.k[2] = kz;
    ++a.c;
  }
  int64_t m = 0;
  for (auto& kv : acc) {
    out_pts[3 * m] = (float)(kv.second.s[0] / kv.second.c);
    out_pts[3 * m + 1] = (float)(kv.second.s[1] / kv.second.c);
    out_pts[3 * m + 2] = (float)(kv.second.s[2] / kv.second.c);
    out_keys[3 * m] = kv.second.k[0];
    out_keys[3 * m + 1] = kv.second.k[1];
    out_keys[3 * m + 2] = kv.second.k[2];
    ++m;
  }
  *out_n = m;
  return 0;
}

}  // extern "C"
