// K1: NLE box moments on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel yondx/nle/pallas_ops.py::_moments_kernel
// (launched by _pallas_moments_planes, entry fused_moments). Per plane of
// a channels-last stack [L, H, W, C], with x centered by its plane mean:
//   mean = box_k(x) + plane_mean
//   var  = max(box_k(x^2) - box_k(x)^2, 0)
//   tex  = sqrt(max(box_k(t1^2) - box_k(t1)^2, 0)),  t1 = box_inner(x)
// with reflect-101 borders (cv2.blur semantics). Centering matches the
// plain version (yondx_torch/nle/boxfilter.py); the Pallas kernel's
// uncentered E[x^2] - E[x]^2 is deliberately not copied.
//
// Design: one block per (plane, row tile, column tile); the halo'd tile is
// staged in shared memory with reflect-101 indexing done here (no padded
// copy in device memory), then separable DIRECT window sums run in shared
// memory (no running sums, so rounding does not drift along a row). The
// channel index varies fastest over blocks, so the C blocks of one tile
// share the cache lines of the channels-last input. At the main path's
// shape the bytes bound the function (one read, three writes: ~20 us at
// 3.35 TB/s; its ~36 operations per output with sliding sums take ~2 us
// at 67 TFLOP/s). The direct sums here do ~328 per output, ~21 us of fp32
// issue: a cost of this design, which a sliding-sum kernel would not pay.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int TH = 32;          // output rows per block
constexpr int TW = 32;          // output columns per block
constexpr int NTHREADS = 256;

__device__ __forceinline__ int reflect101(int i, int n) {
  const int period = 2 * (n - 1);           // n >= 2 (checked by the wrapper)
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

struct Params {
  const float* x;
  const float* plane_mean;                  // [L, C]
  float* mean_out;                          // contiguous [L, H, W, C]
  float* var_out;
  float* tex_out;
  int L, H, W, C;
  long long sl, sy, sx, sc;                 // input strides, in elements
  int k, inner;
  int want_mean, want_tex;
  int tiles_x, tiles_y;
};

__host__ __device__ inline int halo(int k, int inner, int want_tex) {
  return k / 2 + (want_tex ? inner / 2 : 0);
}

size_t smem_floats(int k, int inner, int want_tex) {
  const int kh = k / 2, P = halo(k, inner, want_tex);
  const size_t RH = TH + 2 * P, RW = TW + 2 * P, MH = TH + 2 * kh;
  size_t n = RH * RW + 2 * MH * TW;
  if (want_tex) {
    const size_t TWK = TW + 2 * kh;
    n += RH * TWK + MH * TWK + 2 * MH * TW;
  }
  return n;
}

__global__ void __launch_bounds__(NTHREADS) nle_moments_kernel(Params p) {
  extern __shared__ float smem[];
  const int kh = p.k / 2;
  const int P = halo(p.k, p.inner, p.want_tex);
  const int RH = TH + 2 * P, RW = TW + 2 * P;   // staged input tile
  const int MH = TH + 2 * kh;                   // rows of the horizontal k-sums
  const int TWK = TW + 2 * kh;                  // columns of t1

  int b = blockIdx.x;
  const int c = b % p.C;
  b /= p.C;
  const int tx = b % p.tiles_x;
  b /= p.tiles_x;
  const int ty = b % p.tiles_y;
  const int l = b / p.tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const float cmean = p.plane_mean[(long long)l * p.C + c];
  const float* src = p.x + (long long)l * p.sl + (long long)c * p.sc;

  float* sX = smem;                   // RH x RW   centered input
  float* hX = sX + RH * RW;           // MH x TW   horizontal k-sums of x
  float* hX2 = hX + MH * TW;          // MH x TW   ... of x^2
  float* hI = hX2 + MH * TW;          // RH x TWK  horizontal inner sums
  float* t1 = hI + RH * TWK;          // MH x TWK  box_inner(x)
  float* hT = t1 + MH * TWK;          // MH x TW   horizontal k-sums of t1
  float* hT2 = hT + MH * TW;          // MH x TW   ... of t1^2
  const int tid = threadIdx.x;

  for (int i = tid; i < RH * RW; i += NTHREADS) {
    const int r = i / RW, q = i - r * RW;
    const int gy = reflect101(y0 - P + r, p.H);
    const int gx = reflect101(x0 - P + q, p.W);
    sX[i] = src[gy * p.sy + gx * p.sx] - cmean;
  }
  __syncthreads();

  const int off = P - kh;             // tile offset of the x/x^2 windows
  for (int i = tid; i < MH * TW; i += NTHREADS) {
    const int r = i / TW, q = i - r * TW;
    const float* row = sX + (r + off) * RW + q + off;
    float s = 0.f, s2 = 0.f;
    for (int d = 0; d < p.k; ++d) {
      const float v = row[d];
      s += v;
      s2 += v * v;
    }
    hX[i] = s;
    hX2[i] = s2;
  }

  if (p.want_tex) {
    for (int i = tid; i < RH * TWK; i += NTHREADS) {
      const int r = i / TWK, q = i - r * TWK;
      const float* row = sX + r * RW + q;
      float s = 0.f;
      for (int d = 0; d < p.inner; ++d) s += row[d];
      hI[i] = s;
    }
    __syncthreads();
    const float inv_i2 = 1.f / (float)(p.inner * p.inner);
    for (int i = tid; i < MH * TWK; i += NTHREADS) {
      const int r = i / TWK, q = i - r * TWK;
      float s = 0.f;
      for (int d = 0; d < p.inner; ++d) s += hI[(r + d) * TWK + q];
      t1[i] = s * inv_i2;
    }
    __syncthreads();
    for (int i = tid; i < MH * TW; i += NTHREADS) {
      const int r = i / TW, q = i - r * TW;
      const float* row = t1 + r * TWK + q;
      float s = 0.f, s2 = 0.f;
      for (int d = 0; d < p.k; ++d) {
        const float v = row[d];
        s += v;
        s2 += v * v;
      }
      hT[i] = s;
      hT2[i] = s2;
    }
  }
  __syncthreads();

  const float inv_k2 = 1.f / (float)(p.k * p.k);
  for (int i = tid; i < TH * TW; i += NTHREADS) {
    const int r = i / TW, q = i - r * TW;
    const int gy = y0 + r, gx = x0 + q;
    if (gy >= p.H || gx >= p.W) continue;
    float s = 0.f, s2 = 0.f;
    for (int d = 0; d < p.k; ++d) {
      s += hX[(r + d) * TW + q];
      s2 += hX2[(r + d) * TW + q];
    }
    const float m = s * inv_k2;
    const long long o = (((long long)l * p.H + gy) * p.W + gx) * p.C + c;
    if (p.want_mean) p.mean_out[o] = m + cmean;
    p.var_out[o] = fmaxf(s2 * inv_k2 - m * m, 0.f);
    if (p.want_tex) {
      float u = 0.f, u2 = 0.f;
      for (int d = 0; d < p.k; ++d) {
        u += hT[(r + d) * TW + q];
        u2 += hT2[(r + d) * TW + q];
      }
      const float tm = u * inv_k2;
      p.tex_out[o] = sqrtf(fmaxf(u2 * inv_k2 - tm * tm, 0.f));
    }
  }
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Outputs are contiguous [L, H, W, C]; mean_out / tex_out may be null when
// want_mean / want_tex is 0.
extern "C" int yondx_nle_moments(const void* x, const void* plane_mean,
                                 void* mean_out, void* var_out, void* tex_out,
                                 int L, int H, int W, int C,
                                 long long sl, long long sy, long long sx,
                                 long long sc, int k, int inner,
                                 int want_mean, int want_tex, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.plane_mean = static_cast<const float*>(plane_mean);
  p.mean_out = static_cast<float*>(mean_out);
  p.var_out = static_cast<float*>(var_out);
  p.tex_out = static_cast<float*>(tex_out);
  p.L = L; p.H = H; p.W = W; p.C = C;
  p.sl = sl; p.sy = sy; p.sx = sx; p.sc = sc;
  p.k = k; p.inner = inner;
  p.want_mean = want_mean; p.want_tex = want_tex;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  const size_t smem = smem_floats(k, inner, want_tex) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nle_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)L * C * p.tiles_x * p.tiles_y;
  if (blocks <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  nle_moments_kernel<<<(unsigned)blocks, NTHREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
