// Host filters of the port (ctypes, plain C interface): the port's copy
// of the JAX package's box_mean_f32, local_moments_f32 and
// bilateral_row_f32 (yondx/native/kernels.cpp), line for line, so that
// the two builds on one machine agree to the bit:
//   - box_mean_f32: reflect-101 box mean of [C, H, W] planes by row and
//     column running sums, the planes on threads;
//   - local_moments_f32: (mean, max(E[x^2] - mean^2, 0)) of each plane;
//   - bilateral_row_f32: a 1-D bilateral of a row signal (cv2's weights,
//     replicated ends).
// Built with g++ by yondx_torch/native.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline int reflect101(int i, int n) {
  // gfedcb|abcdefgh|gfedcba
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = std::abs(i) % period;
  return i < n ? i : period - i;
}

// Horizontal running-sum box pass with reflect-101 borders.
void box_pass_rows(const float* src, float* dst, int H, int W, int k) {
  const int r = k / 2;
  const float inv = 1.0f / k;
  std::vector<float> row(W + 2 * r);
  for (int y = 0; y < H; ++y) {
    const float* s = src + (size_t)y * W;
    for (int x = -r; x < W + r; ++x) row[x + r] = s[reflect101(x, W)];
    float acc = 0.f;
    for (int x = 0; x < k; ++x) acc += row[x];
    float* d = dst + (size_t)y * W;
    d[0] = acc * inv;
    for (int x = 1; x < W; ++x) {
      acc += row[x + k - 1] - row[x - 1];
      d[x] = acc * inv;
    }
  }
}

// Vertical pass (operates on the output of the horizontal pass).
void box_pass_cols(float* data, int H, int W, int k) {
  const int r = k / 2;
  const float inv = 1.0f / k;
  std::vector<float> col(H + 2 * r), out(H);
  for (int x = 0; x < W; ++x) {
    for (int y = -r; y < H + r; ++y)
      col[y + r] = data[(size_t)reflect101(y, H) * W + x];
    float acc = 0.f;
    for (int y = 0; y < k; ++y) acc += col[y];
    out[0] = acc * inv;
    for (int y = 1; y < H; ++y) {
      acc += col[y + k - 1] - col[y - 1];
      out[y] = acc * inv;
    }
    for (int y = 0; y < H; ++y) data[(size_t)y * W + x] = out[y];
  }
}

void box_mean_plane(const float* src, float* dst, int H, int W, int k) {
  box_pass_rows(src, dst, H, W, k);
  box_pass_cols(dst, H, W, k);
}

void parallel_for(int n, const std::function<void(int)>& fn) {
  unsigned nt = std::min<unsigned>(std::thread::hardware_concurrency(),
                                   (unsigned)n);
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<int> next{0};
  for (unsigned t = 0; t < nt; ++t)
    ts.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// src/dst: [C, H, W] float32 planes.
void box_mean_f32(const float* src, float* dst, int C, int H, int W, int k) {
  parallel_for(C, [&](int c) {
    box_mean_plane(src + (size_t)c * H * W, dst + (size_t)c * H * W, H, W, k);
  });
}

// mean/var: [C, H, W] outputs; one fused pass per plane.
void local_moments_f32(const float* src, float* mean, float* var, int C,
                       int H, int W, int k) {
  parallel_for(C, [&](int c) {
    const size_t off = (size_t)c * H * W;
    std::vector<float> sq((size_t)H * W);
    const float* s = src + off;
    for (size_t i = 0; i < (size_t)H * W; ++i) sq[i] = s[i] * s[i];
    box_mean_plane(s, mean + off, H, W, k);
    box_mean_plane(sq.data(), var + off, H, W, k);
    float* m = mean + off;
    float* v = var + off;
    for (size_t i = 0; i < (size_t)H * W; ++i) {
      v[i] = std::max(v[i] - m[i] * m[i], 0.0f);
    }
  });
}

// 1-D bilateral (cv2.bilateralFilter semantics on a row signal).
void bilateral_row_f32(const float* src, float* dst, int n, int d,
                       float sigma_color, float sigma_space) {
  const int r = d / 2;
  const float ic = -0.5f / (sigma_color * sigma_color);
  const float is = -0.5f / (sigma_space * sigma_space);
  for (int i = 0; i < n; ++i) {
    float num = 0.f, den = 0.f;
    for (int j = -r; j <= r; ++j) {
      int idx = std::clamp(i + j, 0, n - 1);  // replicate border
      float diff = src[idx] - src[i];
      float w = std::exp(ic * diff * diff + is * (float)(j * j));
      num += w * src[idx];
      den += w;
    }
    dst[i] = num / den;
  }
}

}  // extern "C"
