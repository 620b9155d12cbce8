// Host BM3D of the PyTorch port (C++17, no external deps): the two
// stages of block-matching 3-D denoising that the VST-space BM3D
// denoiser runs on one image plane at a time.
//   - bm3d_ht_f32: hard-threshold stage (the pilot estimate);
//   - bm3d_wiener_f32: empirical-Wiener stage on the pilot.
// The same arithmetic as the JAX package's host kernels
// (yondx/native/kernels.cpp), built with the same flags, so that the two
// libraries agree to the bit on one machine. Each call is independent of
// every other, so planes may be denoised on several threads at once.
// Exposed with C linkage for ctypes (yondx_torch/native.py).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <vector>

// Hard-threshold stage: 8x8 blocks, step 4, 16x16 search window, groups of
// up to 16 similar blocks, 2-D DCT per block + 1-D Haar across the group,
// hard threshold at lambda*sigma, inverse, weighted aggregation.

namespace bm3d_detail {

constexpr int B = 8;      // block size
constexpr int STEP = 4;   // reference-block stride
constexpr int WIN = 20;   // search radius
constexpr int GMAX = 16;  // max group size

// The 8-point DCT-II basis, built once by the first caller (a C++11
// function-local static, so concurrent first calls are safe).
struct DctBasis {
  float c[8][8];
  DctBasis() {
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n)
        c[k][n] = std::sqrt((k == 0 ? 1.f : 2.f) / 8.f) *
                  std::cos(M_PI * (2 * n + 1) * k / 16.0f);
  }
};

inline const float (&dct_basis())[8][8] {
  static const DctBasis basis;
  return basis.c;
}

void dct8(const float* in, float* out, int stride_in, int stride_out) {
  const float (&c)[8][8] = dct_basis();
  for (int k = 0; k < 8; ++k) {
    float acc = 0.f;
    for (int n = 0; n < 8; ++n) acc += c[k][n] * in[n * stride_in];
    out[k * stride_out] = acc;
  }
}

void idct8(const float* in, float* out, int stride_in, int stride_out) {
  const float (&c)[8][8] = dct_basis();
  for (int n = 0; n < 8; ++n) {
    float acc = 0.f;
    for (int k = 0; k < 8; ++k) acc += c[k][n] * in[k * stride_in];
    out[n * stride_out] = acc;
  }
}

void dct2d(float* blk) {
  float tmp[B * B];
  for (int y = 0; y < B; ++y) dct8(blk + y * B, tmp + y * B, 1, 1);
  for (int x = 0; x < B; ++x) dct8(tmp + x, blk + x, B, B);
}

void idct2d(float* blk) {
  float tmp[B * B];
  for (int x = 0; x < B; ++x) idct8(blk + x, tmp + x, B, B);
  for (int y = 0; y < B; ++y) idct8(tmp + y * B, blk + y * B, 1, 1);
}

}  // namespace bm3d_detail

extern "C" {

void bm3d_ht_f32(const float* src, float* dst, int H, int W, float sigma,
                 float lambda3d) {
  using namespace bm3d_detail;
  std::vector<float> num((size_t)H * W, 0.f), den((size_t)H * W, 0.f);
  const int ny = (H - B) / STEP + 1;
  const int nx = (W - B) / STEP + 1;

  std::vector<int> match_dy(GMAX), match_dx(GMAX);
  std::vector<float> group(GMAX * B * B);

  for (int by = 0; by < ny; ++by) {
    int y0 = std::min(by * STEP, H - B);
    for (int bx = 0; bx < nx; ++bx) {
      int x0 = std::min(bx * STEP, W - B);
      // --- block matching in the search window (stride 2 for speed)
      struct Cand { float d; int y, x; };
      std::vector<Cand> cands;
      for (int dy = -WIN; dy <= WIN; dy += 2) {
        int yy = y0 + dy;
        if (yy < 0 || yy + B > H) continue;
        for (int dx = -WIN; dx <= WIN; dx += 2) {
          int xx = x0 + dx;
          if (xx < 0 || xx + B > W) continue;
          float d = 0.f;
          for (int i = 0; i < B; ++i)
            for (int j = 0; j < B; ++j) {
              float t = src[(size_t)(y0 + i) * W + x0 + j] -
                        src[(size_t)(yy + i) * W + xx + j];
              d += t * t;
            }
          cands.push_back({d, yy, xx});
        }
      }
      int G = std::min<int>(GMAX, (int)cands.size());
      std::partial_sort(cands.begin(), cands.begin() + G, cands.end(),
                        [](const Cand& a, const Cand& b) { return a.d < b.d; });
      // power-of-two group size for the Haar transform
      int g = 1;
      while (g * 2 <= G) g *= 2;
      G = g;
      // --- build group, 2-D DCT each block
      for (int m = 0; m < G; ++m) {
        float* blk = group.data() + m * B * B;
        for (int i = 0; i < B; ++i)
          for (int j = 0; j < B; ++j)
            blk[i * B + j] = src[(size_t)(cands[m].y + i) * W + cands[m].x + j];
        dct2d(blk);
      }
      // --- 1-D Haar across the group + hard threshold
      const float th = lambda3d * sigma;
      int nnz = 0;
      std::vector<float> spec(G);
      for (int p = 0; p < B * B; ++p) {
        for (int m = 0; m < G; ++m) spec[m] = group[m * B * B + p];
        // full Haar decomposition
        for (int len = G; len > 1; len /= 2) {
          std::vector<float> tmp(len);
          for (int i = 0; i < len / 2; ++i) {
            tmp[i] = (spec[2 * i] + spec[2 * i + 1]) * (float)M_SQRT1_2;
            tmp[len / 2 + i] =
                (spec[2 * i] - spec[2 * i + 1]) * (float)M_SQRT1_2;
          }
          std::copy(tmp.begin(), tmp.end(), spec.begin());
        }
        for (int m = 0; m < G; ++m) {
          if (std::fabs(spec[m]) <= th) {
            spec[m] = 0.f;
          } else {
            ++nnz;
          }
        }
        // inverse Haar
        for (int len = 2; len <= G; len *= 2) {
          std::vector<float> tmp(len);
          for (int i = 0; i < len / 2; ++i) {
            tmp[2 * i] = (spec[i] + spec[len / 2 + i]) * (float)M_SQRT1_2;
            tmp[2 * i + 1] = (spec[i] - spec[len / 2 + i]) * (float)M_SQRT1_2;
          }
          std::copy(tmp.begin(), tmp.end(), spec.begin());
        }
        for (int m = 0; m < G; ++m) group[m * B * B + p] = spec[m];
      }
      // --- inverse DCT + weighted aggregation
      float w = nnz > 0 ? 1.0f / nnz : 1.0f;
      for (int m = 0; m < G; ++m) {
        float* blk = group.data() + m * B * B;
        idct2d(blk);
        for (int i = 0; i < B; ++i)
          for (int j = 0; j < B; ++j) {
            size_t idx = (size_t)(cands[m].y + i) * W + cands[m].x + j;
            num[idx] += w * blk[i * B + j];
            den[idx] += w;
          }
      }
    }
  }
  for (size_t i = 0; i < (size_t)H * W; ++i)
    dst[i] = den[i] > 0 ? num[i] / den[i] : src[i];
}

// Wiener refinement stage (the second half of full BM3D): block matching
// runs on the hard-threshold pilot estimate; groups are built from BOTH
// the pilot and the noisy image; the 3-D spectrum of the noisy group is
// shrunk by the empirical Wiener attenuation w = p^2 / (p^2 + sigma^2)
// computed from the pilot spectrum; aggregation weight = 1 / sum(w^2).
void bm3d_wiener_f32(const float* noisy, const float* pilot, float* dst,
                     int H, int W, float sigma) {
  using namespace bm3d_detail;
  std::vector<float> num((size_t)H * W, 0.f), den((size_t)H * W, 0.f);
  const int ny = (H - B) / STEP + 1;
  const int nx = (W - B) / STEP + 1;
  const float s2 = sigma * sigma;

  std::vector<float> group_n(GMAX * B * B), group_p(GMAX * B * B);

  for (int by = 0; by < ny; ++by) {
    int y0 = std::min(by * STEP, H - B);
    for (int bx = 0; bx < nx; ++bx) {
      int x0 = std::min(bx * STEP, W - B);
      struct Cand { float d; int y, x; };
      std::vector<Cand> cands;
      for (int dy = -WIN; dy <= WIN; dy += 2) {
        int yy = y0 + dy;
        if (yy < 0 || yy + B > H) continue;
        for (int dx = -WIN; dx <= WIN; dx += 2) {
          int xx = x0 + dx;
          if (xx < 0 || xx + B > W) continue;
          float d = 0.f;
          for (int i = 0; i < B; ++i)
            for (int j = 0; j < B; ++j) {
              float t = pilot[(size_t)(y0 + i) * W + x0 + j] -
                        pilot[(size_t)(yy + i) * W + xx + j];
              d += t * t;
            }
          cands.push_back({d, yy, xx});
        }
      }
      int G = std::min<int>(GMAX, (int)cands.size());
      std::partial_sort(cands.begin(), cands.begin() + G, cands.end(),
                        [](const Cand& a, const Cand& b) { return a.d < b.d; });
      int g = 1;
      while (g * 2 <= G) g *= 2;
      G = g;
      for (int m = 0; m < G; ++m) {
        float* bn = group_n.data() + m * B * B;
        float* bp = group_p.data() + m * B * B;
        for (int i = 0; i < B; ++i)
          for (int j = 0; j < B; ++j) {
            size_t idx = (size_t)(cands[m].y + i) * W + cands[m].x + j;
            bn[i * B + j] = noisy[idx];
            bp[i * B + j] = pilot[idx];
          }
        dct2d(bn);
        dct2d(bp);
      }
      float wsum2 = 0.f;
      std::vector<float> spec_n(G), spec_p(G);
      for (int p = 0; p < B * B; ++p) {
        for (int m = 0; m < G; ++m) {
          spec_n[m] = group_n[m * B * B + p];
          spec_p[m] = group_p[m * B * B + p];
        }
        for (int len = G; len > 1; len /= 2) {
          std::vector<float> tn(len), tp(len);
          for (int i = 0; i < len / 2; ++i) {
            tn[i] = (spec_n[2 * i] + spec_n[2 * i + 1]) * (float)M_SQRT1_2;
            tn[len / 2 + i] =
                (spec_n[2 * i] - spec_n[2 * i + 1]) * (float)M_SQRT1_2;
            tp[i] = (spec_p[2 * i] + spec_p[2 * i + 1]) * (float)M_SQRT1_2;
            tp[len / 2 + i] =
                (spec_p[2 * i] - spec_p[2 * i + 1]) * (float)M_SQRT1_2;
          }
          std::copy(tn.begin(), tn.end(), spec_n.begin());
          std::copy(tp.begin(), tp.end(), spec_p.begin());
        }
        for (int m = 0; m < G; ++m) {
          float p2 = spec_p[m] * spec_p[m];
          float w = p2 / (p2 + s2);
          spec_n[m] *= w;
          wsum2 += w * w;
        }
        for (int len = 2; len <= G; len *= 2) {
          std::vector<float> tn(len);
          for (int i = 0; i < len / 2; ++i) {
            tn[2 * i] = (spec_n[i] + spec_n[len / 2 + i]) * (float)M_SQRT1_2;
            tn[2 * i + 1] =
                (spec_n[i] - spec_n[len / 2 + i]) * (float)M_SQRT1_2;
          }
          std::copy(tn.begin(), tn.end(), spec_n.begin());
        }
        for (int m = 0; m < G; ++m) group_n[m * B * B + p] = spec_n[m];
      }
      float w = wsum2 > 0.f ? 1.0f / wsum2 : 1.0f;
      for (int m = 0; m < G; ++m) {
        float* blk = group_n.data() + m * B * B;
        idct2d(blk);
        for (int i = 0; i < B; ++i)
          for (int j = 0; j < B; ++j) {
            size_t idx = (size_t)(cands[m].y + i) * W + cands[m].x + j;
            num[idx] += w * blk[i * B + j];
            den[idx] += w;
          }
      }
    }
  }
  for (size_t i = 0; i < (size_t)H * W; ++i)
    dst[i] = den[i] > 0 ? num[i] / den[i] : pilot[i];
}

}  // extern "C"
