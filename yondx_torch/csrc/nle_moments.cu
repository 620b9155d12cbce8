// K1: NLE box moments on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel yondx/nle/pallas_ops.py::_moments_kernel
// (launched by _pallas_moments_planes, entry fused_moments). Per plane of
// a channels-last stack [L, H, W, C]:
//   mean = box_k(x)
//   var  = max(box_k(x^2) - box_k(x)^2, 0)
//   tex  = sqrt(max(box_k(t1^2) - box_k(t1)^2, 0)),  t1 = box_inner(x)
// with reflect-101 borders (cv2.blur semantics), periodic where a window
// is wider than the plane, as jnp.pad(mode='reflect') in the reference.
//
// What bounds it: bytes. At the main path's shape (bands of a 3072x4096
// Bayer frame: [2, 256, 2048, 4] fp32, 8 planes of 256x2048) the function
// reads 16.8 MB and writes 16.8 MB per map: 67.1 MB for the self fit
// (mean, var, tex), 0.0200 ms at 3.35 TB/s; 50.3 MB for the collab fit of
// dn (mean, var), 0.0150 ms; 33.5 MB for that of lr (var), 0.0100 ms. With
// sliding sums it needs ~36 fp32 operations per output, 0.0023 ms at
// 67 TFLOP/s.
//
// Design. One block per (plane, row tile, column tile, channel), the
// channel fastest, so the C blocks of a tile share the cache lines of the
// channels-last input in L2. A block stages its TH x TW tile with a halo
// of P = k/2 (+ inner/2 with texture) straight from the strided input,
// with periodic reflect-101 index arithmetic (no padded copy), centered on
// one sample of the tile: var and tex do not change under a shift and mean
// adds it back, so no pass over the plane precedes the kernel. The box
// sums then run as separable passes over shared memory, each a sliding
// sum in registers: a thread owns a run of at most MAX_RUN consecutive
// outputs along the pass's axis, opens it with one direct window sum and
// slides (adds the entering sample, subtracts the leaving one). Restarting
// every run bounds the fp32 drift; a run costs ~2 + K/run shared reads per
// output instead of K. Horizontal runs go one row per thread over rows of
// odd pitch, so a warp's 32 rows fall in 32 banks; vertical runs go one
// column per thread, neighbouring threads on neighbouring addresses, and
// the last, vertical, pass writes the outputs. The host picks each pass's
// run length (run_length) so one block's runs fill its 256 threads.
//
// Shared memory, floats, with k = 29, inner = 19 and texture (P = 23):
//   A: staged tile (TH+2P) x odd(TW+2P) = 110 x 111 = 12210, later t1,
//      (TH+2kh) x odd(TW+2kh) = 92 x 93 = 8556
//   B: index tables, then the k-sums of x and x^2 along rows,
//      2 x (TH+2kh) x odd(TW) = 2 x 92 x 65 = 11960, then the vertical
//      inner sums 92 x 111 = 10212, then the k-sums of t1 and t1^2 (11960)
// 24170 floats = 96.7 KB a block, so 2 blocks of 256 threads share an SM
// (228 KB); without texture (P = 14) 8556 + 11960 floats = 82.1 KB. A
// block stages (TH+2P)(TW+2P)/(TH*TW) = 2.95x its outputs (2.07x without
// texture).
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int TH = 64;          // output rows per block
constexpr int TW = 64;          // output columns per block
constexpr int NTHREADS = 256;
constexpr int MAX_RUN = 32;     // longest sliding run
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// Tile geometry of one flavour; pitches of arrays read one row per thread
// are odd.
struct Geom {
  int kh, P;            // k-window half width; staged halo
  int RH, RW, pX;       // staged rows, columns, row pitch
  int MH;               // rows the k-windows reach: TH + 2 kh
  int pH;               // pitch of the k-sums along rows (TW columns)
  int TWK, pT;          // columns of t1: TW + 2 kh, and its pitch
  int a, b;             // floats in regions A and B
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Geom geometry(int k, int inner, int tex) {
  Geom g;
  g.kh = k / 2;
  g.P = g.kh + (tex ? inner / 2 : 0);
  g.RH = TH + 2 * g.P;
  g.RW = TW + 2 * g.P;
  g.pX = g.RW | 1;
  g.MH = TH + 2 * g.kh;
  g.pH = TW | 1;
  g.TWK = TW + 2 * g.kh;
  g.pT = g.TWK | 1;
  g.a = imax(g.RH * g.pX, tex ? g.MH * g.pT : 0);
  g.b = imax(imax(2 * g.MH * g.pH, tex ? g.MH * g.pX : 0), g.RH + g.RW);
  return g;
}

// Run length of a sliding pass over `lanes` lines of n outputs with a
// K-wide window: the one (at most MAX_RUN) that minimises the block's
// passes over its runs times the cost of one run (K reads to open it, 2
// per slide); ties keep the longer run.
int run_length(int lanes, int n, int K) {
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int R = n < MAX_RUN ? n : MAX_RUN; R >= 1; --R) {
    const long long runs = (long long)lanes * ((n + R - 1) / R);
    const long long cost = (runs + NTHREADS - 1) / NTHREADS * (K + 2 * (R - 1));
    if (cost < best_cost) {
      best_cost = cost;
      best = R;
    }
  }
  return best;
}

struct Params {
  const float* x;
  float* mean_out;                          // contiguous [L, H, W, C]
  float* var_out;
  float* tex_out;
  int H, W, C;
  long long sl, sy, sx, sc;                 // input strides, in elements
  int k, inner;
  int want_mean, want_tex;
  int tiles_x, tiles_y;
  int run_hk, run_vk, run_vi, run_hi;       // run lengths of the passes
};

// A compensated (Kahan) fp32 sum.
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

// Sliding sums along rows: for r < lanes, q < n,
//   o1[r*po + q] = scale * sum_{d<K} in[r*pi + q + d] - sub
// and, with SQ, o2 the sum of squares. One thread per (row, run). With SQ
// (the k-window moments, whose squares cancel in var and tex) both sums
// are compensated.
template <bool SQ>
__device__ __forceinline__ void hpass(const float* __restrict__ in, int pi,
                                      int lanes, int n, int K, int R,
                                      float scale, float sub,
                                      float* __restrict__ o1,
                                      float* __restrict__ o2, int po) {
  const int items = lanes * ((n + R - 1) / R);
  for (int it = threadIdx.x; it < items; it += NTHREADS) {
    const int r = it % lanes, q0 = it / lanes * R;
    const int len = min(R, n - q0);
    const float* row = in + r * pi + q0;
    float* d1 = o1 + r * po + q0;
    if constexpr (SQ) {
      float* d2 = o2 + r * po + q0;
      Kahan s, s2;
      for (int d = 0; d < K; ++d) {
        const float v = row[d];
        s.add(v);
        s2.add(v * v);
      }
      d1[0] = fmaf(s.s, scale, -sub);
      d2[0] = s2.s;
#pragma unroll 4
      for (int t = 1; t < len; ++t) {
        const float a = row[t + K - 1], b = row[t - 1];
        s.add(a - b);
        s2.add(fmaf(a, a, -b * b));
        d1[t] = fmaf(s.s, scale, -sub);
        d2[t] = s2.s;
      }
    } else {
      float s = 0.f;
      for (int d = 0; d < K; ++d) s += row[d];
      d1[0] = fmaf(s, scale, -sub);
#pragma unroll 4
      for (int t = 1; t < len; ++t) {
        s += row[t + K - 1] - row[t - 1];
        d1[t] = fmaf(s, scale, -sub);
      }
    }
  }
}

// Sliding sums along columns: for q < lanes, r < n,
//   o[r*po + q] = sum_{d<K} in[(r + d)*pi + q]. One thread per (column, run).
__device__ __forceinline__ void vpass(const float* __restrict__ in, int pi,
                                      int lanes, int n, int K, int R,
                                      float* __restrict__ o, int po) {
  const int items = lanes * ((n + R - 1) / R);
  for (int it = threadIdx.x; it < items; it += NTHREADS) {
    const int q = it % lanes, r0 = it / lanes * R;
    const int len = min(R, n - r0);
    const float* col = in + r0 * pi + q;
    float* dst = o + r0 * po + q;
    float s = 0.f;
    for (int d = 0; d < K; ++d) s += col[d * pi];
    dst[0] = s;
#pragma unroll 4
    for (int t = 1; t < len; ++t) {
      s += col[(t + K - 1) * pi] - col[(t - 1) * pi];
      dst[t * po] = s;
    }
  }
}

// The last pass: sliding k-sums along columns of two arrays (a sum and a
// sum of squares, pitch pi) for the TH x TW outputs that lie in the plane;
// epi(r, q, s, s2) writes output (y0 + r, x0 + q). Compensated, as the
// moments of hpass<true>: these sums reach k^2 samples.
template <class Epi>
__device__ __forceinline__ void vlast(const float* __restrict__ u,
                                      const float* __restrict__ u2, int pi,
                                      int K, int R, int rows, int cols,
                                      Epi epi) {
  const int items = TW * ((TH + R - 1) / R);
  for (int it = threadIdx.x; it < items; it += NTHREADS) {
    const int q = it % TW, r0 = it / TW * R;
    if (q >= cols || r0 >= rows) continue;
    const int len = min(R, rows - r0);
    const float* c1 = u + r0 * pi + q;
    const float* c2 = u2 + r0 * pi + q;
    Kahan s, s2;
    for (int d = 0; d < K; ++d) {
      s.add(c1[d * pi]);
      s2.add(c2[d * pi]);
    }
    epi(r0, q, s.s, s2.s);
#pragma unroll 4
    for (int t = 1; t < len; ++t) {
      s.add(c1[(t + K - 1) * pi] - c1[(t - 1) * pi]);
      s2.add(c2[(t + K - 1) * pi] - c2[(t - 1) * pi]);
      epi(r0 + t, q, s.s, s2.s);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 2) nle_moments_kernel(Params p) {
  extern __shared__ float smem[];
  const Geom g = geometry(p.k, p.inner, p.want_tex);
  float* A = smem;
  float* B = smem + g.a;
  int* y_off = reinterpret_cast<int*>(B);  // staged row -> input offset
  int* x_off = y_off + g.RH;               // staged column -> input offset

  int b = blockIdx.x;
  const int c = b % p.C;
  b /= p.C;
  const int tx = b % p.tiles_x;
  b /= p.tiles_x;
  const int ty = b % p.tiles_y;
  const int l = b / p.tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int rows = min(TH, p.H - y0), cols = min(TW, p.W - x0);
  const float* src = p.x + (long long)l * p.sl + (long long)c * p.sc;
  const int tid = threadIdx.x;

  // the block's shift: one sample of its own tile
  const float shift = src[(long long)(y0 + rows / 2) * p.sy
                          + (long long)(x0 + cols / 2) * p.sx];

  for (int i = tid; i < g.RH; i += NTHREADS)
    y_off[i] = (int)(reflect101(y0 - g.P + i, p.H) * p.sy);
  for (int i = tid; i < g.RW; i += NTHREADS)
    x_off[i] = (int)(reflect101(x0 - g.P + i, p.W) * p.sx);
  __syncthreads();

  // stage: a warp takes SR rows x SC column chunks of 32 at a time, so
  // each lane has SR * SC loads in flight (the staging is latency-bound:
  // one round trip per group, not per row); neighbouring lanes on
  // neighbouring columns
  constexpr int WARPS = NTHREADS / 32, SR = 4, SC = 4;
  const int lane = tid % 32;
  for (int q0 = 0; q0 < g.RW; q0 += 32 * SC) {
    for (int r0 = tid / 32; r0 < g.RH; r0 += WARPS * SR) {
      float v[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = r0 + i * WARPS;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int q = q0 + j * 32 + lane;
          v[i][j] = r < g.RH && q < g.RW ? src[y_off[r] + x_off[q]] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = r0 + i * WARPS;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int q = q0 + j * 32 + lane;
          if (r < g.RH && q < g.RW) A[r * g.pX + q] = v[i][j] - shift;
        }
      }
    }
  }
  __syncthreads();

  // k-sums of x and x^2 along rows (MH rows x TW columns), then along
  // columns into mean and var
  const int off = g.P - g.kh;
  float* hx = B;
  float* hx2 = B + g.MH * g.pH;
  hpass<true>(A + off * g.pX + off, g.pX, g.MH, TW, p.k, p.run_hk, 1.f, 0.f,
              hx, hx2, g.pH);
  __syncthreads();
  const float inv_k2 = 1.f / (float)(p.k * p.k);
  const long long pix0 = ((long long)l * p.H + y0) * p.W + x0;
  const int W = p.W, C = p.C;
  auto out_at = [=](int r, int q) {
    return (pix0 + (long long)r * W + q) * C + c;
  };
  float* const mean_out = p.want_mean ? p.mean_out : nullptr;
  float* const var_out = p.var_out;
  vlast(hx, hx2, g.pH, p.k, p.run_vk, rows, cols,
        [=](int r, int q, float s, float s2) {
          const float m = s * inv_k2;
          const long long o = out_at(r, q);
          if (mean_out) mean_out[o] = m + shift;
          var_out[o] = fmaxf(s2 * inv_k2 - m * m, 0.f);
        });
  if (!p.want_tex) return;
  __syncthreads();

  // t1 = box_inner(x) over MH rows x TWK columns: sums along columns of
  // the staged tile into B, then along rows into A (sX is dead). t1 is
  // smooth, so it is shifted again, by its own value at the tile's
  // sample: tex does not change, and t1^2 stays near the variance it
  // measures instead of near (t1 - shift)^2
  vpass(A, g.pX, g.RW, g.MH, p.inner, p.run_vi, B, g.pX);
  __syncthreads();
  const float inv_i2 = 1.f / (float)(p.inner * p.inner);
  const float* vc = B + (rows / 2 + g.kh) * g.pX + cols / 2 + g.kh;
  float t_shift = 0.f;
  for (int d = 0; d < p.inner; ++d) t_shift += vc[d];
  hpass<false>(B, g.pX, g.MH, g.TWK, p.inner, p.run_hi, inv_i2,
               t_shift * inv_i2, A, nullptr, g.pT);
  __syncthreads();
  // k-sums of t1 and t1^2 along rows into B, then along columns into tex
  hpass<true>(A, g.pT, g.MH, TW, p.k, p.run_hk, 1.f, 0.f, hx, hx2, g.pH);
  __syncthreads();
  float* const tex_out = p.tex_out;
  vlast(hx, hx2, g.pH, p.k, p.run_vk, rows, cols,
        [=](int r, int q, float s, float s2) {
          const float m = s * inv_k2;
          tex_out[out_at(r, q)] = sqrtf(fmaxf(s2 * inv_k2 - m * m, 0.f));
        });
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// Outputs are contiguous [L, H, W, C]; mean_out / tex_out may be null when
// want_mean / want_tex is 0. The shared-memory limit of the kernel is
// raised once per device, when a launch first needs more.
extern "C" int yondx_nle_moments(const void* x, void* mean_out, void* var_out,
                                 void* tex_out, int L, int H, int W, int C,
                                 long long sl, long long sy, long long sx,
                                 long long sc, int k, int inner,
                                 int want_mean, int want_tex, void* stream) {
  static int smem_set[MAX_DEVICES];
  if (L <= 0 || H <= 0 || W <= 0 || C <= 0 || k <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  // offsets inside a plane are 32-bit in the kernel
  if ((long long)(H - 1) * sy + (long long)(W - 1) * sx > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.mean_out = static_cast<float*>(mean_out);
  p.var_out = static_cast<float*>(var_out);
  p.tex_out = static_cast<float*>(tex_out);
  p.H = H; p.W = W; p.C = C;
  p.sl = sl; p.sy = sy; p.sx = sx; p.sc = sc;
  p.k = k; p.inner = inner;
  p.want_mean = want_mean; p.want_tex = want_tex;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  const Geom g = geometry(k, inner, want_tex);
  p.run_hk = run_length(g.MH, TW, k);
  p.run_vk = run_length(TW, TH, k);
  p.run_vi = run_length(g.RW, g.MH, inner);
  p.run_hi = run_length(g.MH, g.TWK, inner);
  const int smem = (g.a + g.b) * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(nle_moments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const long long blocks = (long long)L * C * p.tiles_x * p.tiles_y;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  nle_moments_kernel<<<(unsigned)blocks, NTHREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
