// Parallel linear-assignment-style 2D grid sorting (the port's copy of
// gscodec_studio_tpu/csrc/plas.cpp, built apart from the CUDA kernels by
// gscodec_studio_tpu_torch/compression/native.py with g++).
//
// Replaces the external PLAS package that the reference's
// gsplat/compression/sort.py wraps ("Self-Organizing Gaussians"): arrange
// N = grid*grid attribute vectors on a 2D grid so neighboring cells are
// similar, which makes the PNG/video codecs of the test-time compression
// pipeline dramatically more effective. With more than one thread, which
// thread takes which band (and so which random stream) depends on timing:
// only n_threads = 1 gives the same permutation on every run.
//
// Algorithm (coarse-to-fine self-organization):
//   repeat with shrinking blur radius r:
//     targets = separable box-blur(grid values, r)   // local neighborhood mean
//     several sweeps: randomly pair cells within a 2r window; swap the two
//     cells' contents if that reduces sum |v - target|_1 at their positions.
// Swapping toward the blurred field is exactly the self-organizing-map
// dynamic the PLAS paper exploits; the pairing sweeps are embarrassingly
// parallel (disjoint pairs), so the whole thing threads well.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

inline float dist_l1(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int i = 0; i < d; i++) s += std::fabs(a[i] - b[i]);
  return s;
}

// Separable box blur of [g, g, d] with radius r (clamped borders).
void box_blur(const std::vector<float>& in, std::vector<float>& out, int g,
              int d, int r, std::vector<float>& tmp) {
  const int64_t row = (int64_t)g * d;
  // horizontal
  for (int y = 0; y < g; y++) {
    std::vector<double> acc(d, 0.0);
    for (int x = -r; x <= r; x++) {
      int xc = std::clamp(x, 0, g - 1);
      const float* p = &in[y * row + (int64_t)xc * d];
      for (int c = 0; c < d; c++) acc[c] += p[c];
    }
    for (int x = 0; x < g; x++) {
      float* o = &tmp[y * row + (int64_t)x * d];
      for (int c = 0; c < d; c++) o[c] = (float)(acc[c] / (2 * r + 1));
      int xa = std::clamp(x + r + 1, 0, g - 1);
      int xr = std::clamp(x - r, 0, g - 1);
      const float* pa = &in[y * row + (int64_t)xa * d];
      const float* pr = &in[y * row + (int64_t)xr * d];
      for (int c = 0; c < d; c++) acc[c] += pa[c] - pr[c];
    }
  }
  // vertical
  for (int x = 0; x < g; x++) {
    std::vector<double> acc(d, 0.0);
    for (int y = -r; y <= r; y++) {
      int yc = std::clamp(y, 0, g - 1);
      const float* p = &tmp[(int64_t)yc * row + (int64_t)x * d];
      for (int c = 0; c < d; c++) acc[c] += p[c];
    }
    for (int y = 0; y < g; y++) {
      float* o = &out[(int64_t)y * row + (int64_t)x * d];
      for (int c = 0; c < d; c++) o[c] = (float)(acc[c] / (2 * r + 1));
      int ya = std::clamp(y + r + 1, 0, g - 1);
      int yr = std::clamp(y - r, 0, g - 1);
      const float* pa = &tmp[(int64_t)ya * row + (int64_t)x * d];
      const float* pr = &tmp[(int64_t)yr * row + (int64_t)x * d];
      for (int c = 0; c < d; c++) acc[c] += pa[c] - pr[c];
    }
  }
}

}  // namespace

extern "C" {

// data: [n, d] attribute vectors (n = grid*grid), NOT modified.
// perm (out): perm[grid_pos] = original row index.
// Returns 0 on success.
int plas_sort(const float* data, int32_t* perm, int grid, int d,
              int sweeps_per_level, double radius_decay, uint64_t seed,
              int n_threads) {
  const int64_t n = (int64_t)grid * grid;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());

  std::vector<int32_t> pos2row(n);
  for (int64_t i = 0; i < n; i++) pos2row[i] = (int32_t)i;
  std::mt19937_64 rng(seed);
  std::shuffle(pos2row.begin(), pos2row.end(), rng);

  std::vector<float> vals((size_t)n * d), targets((size_t)n * d),
      tmp((size_t)n * d);
  auto refresh_vals = [&]() {
    for (int64_t p = 0; p < n; p++)
      std::memcpy(&vals[(size_t)p * d], &data[(size_t)pos2row[p] * d],
                  sizeof(float) * d);
  };
  refresh_vals();

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;

  int radius = std::max(1, grid / 2);
  while (radius >= 1) {
    for (int sweep = 0; sweep < sweeps_per_level; sweep++) {
      box_blur(vals, targets, grid, d, radius, tmp);
      // Each thread owns a disjoint horizontal band (offset alternates per
      // sweep so content can migrate across band boundaries over time);
      // partners are picked inside the band, so swaps never race.
      uint64_t sweep_seed = rng();
      int band = std::max(2 * radius + 1, (int)((grid + n_threads - 1) / n_threads));
      int y_off = (int)(rng() % band);
      int n_bands = (grid + band - 1) / band + 1;
      std::atomic<int> band_cursor{0};
      auto worker = [&](int tid) {
        std::mt19937_64 trng(sweep_seed + tid);
        for (;;) {
          int b = band_cursor.fetch_add(1);
          if (b >= n_bands) break;
          int y0 = std::max(0, b * band - y_off);
          int y1 = std::min(grid, (b + 1) * band - y_off);
          if (y0 >= y1) continue;
          int64_t cells = (int64_t)(y1 - y0) * grid;
          for (int64_t k = 0; k < cells; k++) {
            int ay = y0 + (int)(trng() % (y1 - y0));
            int ax = (int)(trng() % grid);
            int64_t pa = (int64_t)ay * grid + ax;
            int dx = (int)(trng() % (2 * radius + 1)) - radius;
            int dy = (int)(trng() % (2 * radius + 1)) - radius;
            int bx = std::clamp(ax + dx, 0, grid - 1);
            int by = std::clamp(ay + dy, y0, y1 - 1);
            int64_t pb = (int64_t)by * grid + bx;
            if (pb == pa) continue;
            float* va = &vals[(size_t)pa * d];
            float* vb = &vals[(size_t)pb * d];
            const float* ta = &targets[(size_t)pa * d];
            const float* tb = &targets[(size_t)pb * d];
            float cur = dist_l1(va, ta, d) + dist_l1(vb, tb, d);
            float swp = dist_l1(va, tb, d) + dist_l1(vb, ta, d);
            if (swp + 1e-7f < cur) {
              for (int c = 0; c < d; c++) std::swap(va[c], vb[c]);
              std::swap(pos2row[pa], pos2row[pb]);
            }
          }
        }
      };
      std::vector<std::thread> threads;
      for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
      for (auto& t : threads) t.join();
    }
    if (radius == 1) break;
    radius = std::max(1, (int)(radius * radius_decay));
    if (radius == 1 && radius_decay < 1.0) {
      // final fine level
    }
  }
  std::memcpy(perm, pos2row.data(), sizeof(int32_t) * n);
  return 0;
}

// Total neighbor distance of a grid layout (quality metric for tests).
double plas_grid_cost(const float* data, const int32_t* perm, int grid, int d) {
  double cost = 0;
  for (int y = 0; y < grid; y++)
    for (int x = 0; x < grid; x++) {
      const float* v = &data[(size_t)perm[(int64_t)y * grid + x] * d];
      if (x + 1 < grid)
        cost += dist_l1(v, &data[(size_t)perm[(int64_t)y * grid + x + 1] * d], d);
      if (y + 1 < grid)
        cost += dist_l1(v, &data[(size_t)perm[(int64_t)(y + 1) * grid + x] * d], d);
    }
  return cost;
}

}  // extern "C"
