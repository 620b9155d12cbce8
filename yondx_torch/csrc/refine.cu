// The method-noise Wiener refine on Hopper (sm_90a), plain C interface for
// ctypes: the CUDA path of yondx_torch/pipeline/refine.py::wiener_refine
// (wrapper yondx_torch/pipeline/refine_kernels.py).
//
// Replaces no TPU kernel: the JAX package leaves the refine to XLA's
// fusion. These kernels were added because the refine was the port's
// largest stage on the card: ~555 eager launches and 22 ms of device time
// a 16.05 MP frame, the residual, its box means (float64 prefix sums), the
// a-trous planes and the coherence's shifted slices each written to device
// memory, and one blocking copy for the floor's erfinv constant.
//
// What bounds it: bytes. The refine reads z_dn and z_noisy and writes one
// output (x01 is z_dn in the product); at the product's shape each is
// [1, 1736, 2312, 4] fp32, 64.2 MB: 192.6 MB, 0.057 ms at 3.35 TB/s. Its
// few hundred fp32 operations an output (~5 GFLOP) take ~0.07 ms at
// 67 TFLOP/s.
//
// Design. One output depends on ~30 px of input around it (14 px of B3
// blurs to c3, then up to 16 px of level-3 coherence), too wide for one
// halo'd 4-channel tile in shared memory, so the refine streams once per
// a-trous level, each pass reading and writing a few frame-sized planes:
//   floor:  three small kernels build the bucket floor's table on the
//           device (max |Haar detail| per block; the 64 x 128 count
//           histogram, integer atomics, exact in any order; one block turns
//           each bucket's counts into its floor), so no value reaches the
//           host;
//   FIRST:  r = z_noisy - z_dn; the k-box mean of r^2, the floor and the
//           Wiener weight alpha (written out, or the blend z_dn + alpha r
//           when there is no shrink); level 1 of the shrink on r;
//   MID:    level 2 on c1;
//   LAST:   level 3 on c2, then the blend.
// A level pass writes c_{j+1}, the shrunk residual sum and the structure
// sum (read back and added to by the next pass at the same pixel). A block
// of 512 threads (a warp an output row, two rows a thread, two blocks an
// SM) takes a 32 x 32 output tile and all 4 channels. It stages, by
// reflect-101 index tables (periodic where a pad is wider than the plane,
// as jnp.pad(mode='reflect')), (1) the channel mean of c_j over the tile
// and the halo the coherence reads, and blurs it into the band's channel
// mean dm = mean(c_j) - blur(mean(c_j)) (the blur is linear, so this is
// the plain version's mean(c_j - c_{j+1})); and (2) c_j itself, float4 a
// pixel, over the tile and the +-(2t + 1) that d = c_j - blur(c_j) (a
// direct 5 x 5 sum) and the 3x3 gain box read; c_{j+1} = c_j - d. Every
// box and blur is a direct sum over shared memory in fp32: no prefix sums
// and no float64. Reflected samples of every intermediate are the
// reflected samples of the plane's (the filters are symmetric), so one
// index table per block reproduces the plain version's per-stage padding.
// Traffic at the product's shape: 19 plane reads and writes (1.22 GB,
// 0.36 ms at 3.35 TB/s); the halos are re-read from L2. The passes are
// bound by latency, not bytes: each block's phases (staging, the far
// blurs, the coherence, the near blur, the outputs' loads and IEEE
// divisions) follow one another between barriers, and 32 warps an SM hide
// part of it; the variance at a thread's outputs is loaded before the
// shared-memory phases so that its two dependent loads overlap them.
#include <cuda_runtime.h>
#include <limits.h>

// A [L, h, w, 4] fp32 operand of any strides; with sc = 1 its pixels are
// 16-byte aligned (the wrapper copies one that is not) and load as float4.
struct YRefinePlane {
  const float* p;
  long long sl, sy, sx, sc;    // strides, in floats
};

// One level pass (yondx_refine_pass). Outputs are contiguous [L, h, w, 4].
struct YRefinePassArgs {
  YRefinePlane zn, zd, x01, vmap, cin;
  float* cout;                 // c_{j+1} (FIRST, MID)
  float* rs;                   // shrunk-residual sum
  float* st;                   // structure sum (oriented, full alpha)
  float* alpha;                // Wiener weight (FIRST writes, LAST reads)
  float* out;                  // the refined planes (LAST, or FIRST alone)
  const float* vptr;           // the variance as a device scalar
  const float* table;          // bucket floor [64] (vmode 3)
  int L, h, w;
  int kind;                    // 0 FIRST, 1 MID, 2 LAST
  int level;                   // a-trous level j: dilation 2^j
  int m_ax;                    // coherence taps each side at this level
  int k;                       // box of the residual power (FIRST)
  int shrink, oriented, ramp, has_x01;
  int vmode;                   // 0 vval, 1 *vptr, 2 vmap, 3 table[z_dn]
  float vval;
  float dv;                    // lam * the band's white-noise variance
  float nu_ax, nu_dg;          // directional-mean noise factors / C
  float beta, allow_f;         // sigma_d^2 = beta max(pow - allow_f V, 0)
  float sat_lo, inv_sat;       // sat = clamp((x01 - sat_lo) inv_sat, 0, 1)
  float fa, inv_1mfa;          // the shrink_full_alpha < 1 ramp
  float c0, c1;                // coherence gate
};

// The bucket floor (yondx_refine_floor, stages 0-2).
struct YRefineFloorArgs {
  YRefinePlane zn, zd;
  unsigned* counts;            // [64 x 128] bucket x log|detail| counts
  float* part;                 // [nparts] block maxima of |detail|
  float* dmax;                 // [1]
  float* table;                // [64] floor of each bucket
  const float* vptr;           // model variance as a device scalar, or null
  long long n, s, ns;          // Haar samples, thinning step, samples kept
  int hh, wh;                  // Haar cells of a plane: hh x wh
  int band, step;              // source row of sampled row p:
                               //   p / band * step + p % band
  int nparts, min_count;
  float vval;                  // model variance when vptr is null
  float q, trust_lo, inv_trust, den, span, inv_span;
};

namespace {

constexpr int TH = 32;               // output rows per block
constexpr int TW = 32;               // output columns per block
constexpr int NT = 512;
constexpr int WARPS = NT / 32;       // a warp per output row, lanes on columns
constexpr int OPT = TH / WARPS;      // output rows per thread
constexpr int NBK = 64;              // intensity buckets of the floor
constexpr int NBIN = 128;            // log|detail| bins of the floor
constexpr int GAIN_BOX = 3;          // the gain's box: a ring of 1 px
constexpr int LEVELS = 3;            // a-trous levels: FIRST, MID, LAST
constexpr int MAX_DEVICES = 64;
constexpr int FIRST = 0, MID = 1, LAST = 2;
static_assert(TH == TW, "one index-table extent serves rows and columns");

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 operator/(float4 a, float4 b) {
  return make_float4(a.x / b.x, a.y / b.y, a.z / b.z, a.w / b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float s) { return a * f4(s); }
__device__ __forceinline__ float4 fmax4(float4 a, float b) {
  return make_float4(fmaxf(a.x, b), fmaxf(a.y, b), fmaxf(a.z, b), fmaxf(a.w, b));
}
__device__ __forceinline__ float4 clamp01(float4 a) {
  return make_float4(fminf(fmaxf(a.x, 0.f), 1.f), fminf(fmaxf(a.y, 0.f), 1.f),
                     fminf(fmaxf(a.z, 0.f), 1.f), fminf(fmaxf(a.w, 0.f), 1.f));
}

// The B3-spline taps at -2t..2t, in the plain version's order.
__device__ __forceinline__ float blur5(float a, float b, float c, float d, float e) {
  return ((((a + 4.f * b) + 6.f * c) + 4.f * d) + e) * 0.0625f;
}
__device__ __forceinline__ float4 blur5(float4 a, float4 b, float4 c, float4 d, float4 e) {
  return ((((a + b * 4.f) + c * 6.f) + d * 4.f) + e) * 0.0625f;
}

__device__ __forceinline__ float4 ld4(const YRefinePlane& a, int l, int y, int x) {
  const float* p = a.p + l * a.sl + (long long)y * a.sy + (long long)x * a.sx;
  if (a.sc == 1) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + a.sc), __ldg(p + 2 * a.sc),
                     __ldg(p + 3 * a.sc));
}
__device__ __forceinline__ float4 ld4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p + i));
}
__device__ __forceinline__ void st4(float* p, long long i, float4 v) {
  *reinterpret_cast<float4*>(p + i) = v;
}

// Tile geometry of one pass; every size in pixels (float4 in the near
// phase, float in the far one).
struct Geom {
  int t;                 // dilation 2^level
  int hd;                // half-width of the dm region: the coherence reach
  int rf, fh, fw;        // far halo; staged channel-mean rows, columns
  int vh, dw;            // rows of both far blurs; columns of dm
  int rn, nh, nw;        // near halo; staged rows, columns
  int kh;                // box half-width (FIRST)
  int far_f, near_f;     // floats of each phase
  int ext;               // index-table length
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Geom geometry(int kind, int level, int m_ax, int k,
                                         int shrink, int oriented) {
  Geom g;
  g.t = 1 << level;
  g.hd = imax(m_ax * g.t, 1);
  const int far = shrink && oriented;
  g.rf = far ? g.hd + 2 * g.t : 0;
  g.fh = TH + 2 * g.rf;
  g.fw = TW + 2 * g.rf;
  g.vh = TH + 2 * g.hd;
  g.dw = TW + 2 * g.hd;
  g.far_f = far ? g.fh * g.fw + g.vh * g.fw + g.vh * g.dw : 0;
  g.kh = k / 2;
  g.rn = imax(shrink ? 1 + 2 * g.t : 0, kind == FIRST ? g.kh : 0);
  g.nh = TH + 2 * g.rn;
  g.nw = TW + 2 * g.rn;
  const int box = kind == FIRST ? TH * g.nw : 0;
  const int blur = shrink ? (TH + 2) * (TW + 2) : 0;
  g.near_f = 4 * (g.nh * g.nw + imax(box, blur));
  g.ext = TH + 2 * imax(g.rf, g.rn);
  return g;
}

__host__ __device__ inline int table_ints(const Geom& g) {
  return (2 * g.ext + 3) & ~3;           // keeps the arena 16-byte aligned
}

int smem_bytes(const Geom& g) {
  return (table_ints(g) + imax(g.far_f, g.near_f)) * 4;
}

// Loads a rows x cols region, four rows of a warp's loads in flight:
// load(r, c) -> float4, then store(r, c, value).
template <class Load, class Store>
__device__ __forceinline__ void stage(int rows, int cols, Load load, Store store) {
  constexpr int U = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp; r0 < rows; r0 += WARPS * U)
    for (int c = lane; c < cols; c += 32) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u * WARPS < rows) v[u] = load(r0 + u * WARPS, c);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u * WARPS < rows) store(r0 + u * WARPS, c, v[u]);
    }
}

// f(r, c) over a rows x cols region: a warp a row, lanes on columns.
template <class F>
__device__ __forceinline__ void region(int rows, int cols, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += WARPS)
    for (int c = lane; c < cols; c += 32) f(r, c);
}

// The mean of 2m + 1 samples of dm along a line through p, step s apart,
// summed in the plain version's order.
__device__ __forceinline__ float line_mean(const float* p, int s, int m, float inv) {
  float acc = p[0];
#pragma unroll 4
  for (int i = 1; i <= m; ++i) acc = (acc + p[i * s]) + p[-i * s];
  return acc * inv;
}

__device__ __forceinline__ float bucket_floor(const float* table, float z) {
  int i = (int)(fminf(fmaxf(z, 0.f), 1.f) * (float)(NBK - 1));
  i = i < 0 ? 0 : (i > NBK - 1 ? NBK - 1 : i);
  return __ldg(table + i);
}

// max(ca / (na V + 1e-30), cd / (nd V + 1e-30)) per channel, with one
// division: the larger quotient is picked by cross products (a tie within
// a rounding moves the result by an ulp).
__device__ __forceinline__ float snr1(float ca, float cd, float v, float na, float nd) {
  const float ba = na * v + 1e-30f, bd = nd * v + 1e-30f;
  return ca * bd >= cd * ba ? ca / ba : cd / bd;
}
__device__ __forceinline__ float4 coherence_snr(float ca, float cd, float4 v,
                                                float na, float nd) {
  return make_float4(snr1(ca, cd, v.x, na, nd), snr1(ca, cd, v.y, na, nd),
                     snr1(ca, cd, v.z, na, nd), snr1(ca, cd, v.w, na, nd));
}

// The noise variance at a pixel, per channel.
__device__ __forceinline__ float4 variance(const YRefinePassArgs& a, float v0,
                                           int l, int y, int x) {
  if (a.vmode == 2) return ld4(a.vmap, l, y, x);
  if (a.vmode == 3) {
    const float4 z = ld4(a.zd, l, y, x);
    return make_float4(bucket_floor(a.table, z.x), bucket_floor(a.table, z.y),
                       bucket_floor(a.table, z.z), bucket_floor(a.table, z.w));
  }
  return f4(v0);
}

__global__ void __launch_bounds__(NT, 2) yondx_refine_level(YRefinePassArgs a) {
  extern __shared__ float4 smem4[];
  const Geom g = geometry(a.kind, a.level, a.m_ax, a.k, a.shrink, a.oriented);
  int* yi = reinterpret_cast<int*>(smem4);
  int* xi = yi + g.ext;
  float* arena = reinterpret_cast<float*>(smem4) + table_ints(g);

  const int tiles_x = (a.w + TW - 1) / TW, tiles_y = (a.h + TH - 1) / TH;
  int b = blockIdx.x;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  const int l = b / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = (g.ext - TH) / 2;
  for (int i = tid; i < g.ext; i += NT) {
    yi[i] = reflect101(y0 - R + i, a.h);
    xi[i] = reflect101(x0 - R + i, a.w);
  }
  const float v0 = a.vmode == 1 ? __ldg(a.vptr) : a.vval;
  __syncthreads();

  // c_j at table row i, column j: the residual in the first pass
  auto cval = [&](int i, int j) {
    const int y = yi[i], x = xi[j];
    if (a.kind == FIRST) return ld4(a.zn, l, y, x) - ld4(a.zd, l, y, x);
    return ld4(a.cin, l, y, x);
  };
  const int t = g.t;

  // far phase: the band's channel mean and its orientation coherence at
  // this thread's outputs
  float coh_ax[OPT], coh_dg[OPT];
  if (a.shrink && a.oriented) {
    float* cm = arena;                       // fh x fw
    float* vb = cm + g.fh * g.fw;            // vh x fw
    float* dm = vb + g.vh * g.fw;            // vh x dw
    const int o = R - g.rf;
    stage(g.fh, g.fw, [&](int r, int c) { return cval(r + o, c + o); },
          [&](int r, int c, float4 v) {
            cm[r * g.fw + c] = (((v.x + v.y) + v.z) + v.w) * 0.25f;
          });
    __syncthreads();
    const int fw = g.fw;
    region(g.vh, fw, [&](int r, int c) {
      const float* p = cm + r * fw + c;
      vb[r * fw + c] = blur5(p[0], p[t * fw], p[2 * t * fw], p[3 * t * fw],
                             p[4 * t * fw]);
    });
    __syncthreads();
    region(g.vh, g.dw, [&](int r, int c) {
      const float* p = vb + r * fw + c;
      dm[r * g.dw + c] = cm[(r + 2 * t) * fw + c + 2 * t]
                         - blur5(p[0], p[t], p[2 * t], p[3 * t], p[4 * t]);
    });
    __syncthreads();
    const float inv = 1.f / (float)(2 * a.m_ax + 1);
#pragma unroll
    for (int o2 = 0; o2 < OPT; ++o2) {
      const float* p = dm + (warp + o2 * WARPS + g.hd) * g.dw + lane + g.hd;
      if (a.m_ax < 1) {
        coh_ax[o2] = coh_dg[o2] = p[0] * p[0];
        continue;
      }
      const int sy = t * g.dw;
      const float hx = line_mean(p, t, a.m_ax, inv);
      const float vy = line_mean(p, sy, a.m_ax, inv);
      const float d1 = line_mean(p, sy + t, a.m_ax, inv);
      const float d2 = line_mean(p, sy - t, a.m_ax, inv);
      coh_ax[o2] = fmaxf(hx * hx, vy * vy);
      coh_dg[o2] = fmaxf(d1 * d1, d2 * d2);
    }
    __syncthreads();                         // the near phase reuses the arena
  } else {
#pragma unroll
    for (int o2 = 0; o2 < OPT; ++o2) coh_ax[o2] = coh_dg[o2] = 0.f;
  }

  // near phase: c_j, float4 a pixel
  float4* P = reinterpret_cast<float4*>(arena);   // nh x nw
  float4* W = P + g.nh * g.nw;
  const int nw = g.nw;
  {
    const int o = R - g.rn;
    stage(g.nh, nw, [&](int r, int c) { return cval(r + o, c + o); },
          [&](int r, int c, float4 v) { P[r * nw + c] = v; });
  }
  __syncthreads();

  // the noise variance at this thread's outputs, loaded while the
  // shared-memory passes below run
  float4 Vo[OPT];
#pragma unroll
  for (int o2 = 0; o2 < OPT; ++o2) {
    const int y = y0 + warp + o2 * WARPS, x = x0 + lane;
    Vo[o2] = y < a.h && x < a.w ? variance(a, v0, l, y, x) : f4(1.f);
  }

  if (a.kind == FIRST) {
    // the k-box mean of r^2, the floor and alpha
    const int top = g.rn - g.kh, k = a.k;
    const float inv_k = 1.f / (float)k;
    region(TH, nw, [&](int r, int c) {
      const float4* p = P + (r + top) * nw + c;
      float4 s = f4(0.f);
      for (int i = 0; i < k; ++i) {
        const float4 v = p[i * nw];
        s = s + v * v;
      }
      W[r * nw + c] = s * inv_k;
    });
    __syncthreads();
#pragma unroll
    for (int o2 = 0; o2 < OPT; ++o2) {
      const int oy = warp + o2 * WARPS, y = y0 + oy, x = x0 + lane;
      if (y >= a.h || x >= a.w) continue;
      const float4* p = W + oy * nw + lane + top;
      float4 s = f4(0.f);
      for (int i = 0; i < k; ++i) s = s + p[i];
      const float4 lp = s * inv_k;
      const float4 V = Vo[o2];
      const float4 sd2 = fmax4(lp - V * a.allow_f, 0.f) * a.beta;
      float4 al = sd2 / (sd2 + V);
      if (a.has_x01) {
        const float4 sat = clamp01((ld4(a.x01, l, y, x) - f4(a.sat_lo)) * a.inv_sat);
        al = al * (f4(1.f) - sat);
      }
      const long long pix = (((long long)l * a.h + y) * a.w + x) * 4;
      if (a.shrink) {
        st4(a.alpha, pix, al);
      } else {
        const float4 r = P[(oy + g.rn) * nw + lane + g.rn];
        st4(a.out, pix, ld4(a.zd, l, y, x) + al * r);
      }
    }
    if (!a.shrink) return;
    __syncthreads();                         // W is reused below
  }

  // level j of the shrink: d = c_j - blur(c_j) over the tile and a 1-px
  // ring (the 3x3 gain box), each a direct 5 x 5 sum (its vertical taps
  // first, as the plain version's); c_{j+1} = c_j - d
  float4* D = W;                             // (TH + 2) x DW
  constexpr int DW = TW + 2;
  const int top = g.rn - 1 - 2 * t;
  region(TH + 2, DW, [&](int r, int c) {
    const float4* p = P + (r + top) * nw + c + top;
    const int sv = t * nw;
    float4 col[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float4* q = p + j * t;
      col[j] = blur5(q[0], q[sv], q[2 * sv], q[3 * sv], q[4 * sv]);
    }
    D[r * DW + c] = p[2 * sv + 2 * t] - blur5(col[0], col[1], col[2], col[3], col[4]);
  });
  __syncthreads();

  const bool keep_st = a.oriented && !a.ramp;
#pragma unroll
  for (int o2 = 0; o2 < OPT; ++o2) {
    const int oy = warp + o2 * WARPS, y = y0 + oy, x = x0 + lane;
    if (y >= a.h || x >= a.w) continue;
    const float4* dp = D + (oy + 1) * DW + lane + 1;
    float4 e = f4(0.f);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float4 v = dp[dy * DW + dx];
        e = e + v * v;
      }
    e = e * (1.f / 9.f);
    const float4 d = dp[0];
    const float4 cj = P[(oy + g.rn) * nw + lane + g.rn] - d;
    const float4 V = Vo[o2];
    float4 gn = fmax4(e - V * a.dv, 0.f) / fmax4(e, 1e-20f);
    float4 s = f4(0.f);
    if (a.oriented) {
      const float4 qe = fmax4(coherence_snr(coh_ax[o2], coh_dg[o2], V, a.nu_ax,
                                            a.nu_dg) - f4(a.c0), 0.f);
      s = qe / (qe + f4(a.c1));
      gn = gn + (f4(1.f) - gn) * s;
    }
    const long long pix = (((long long)l * a.h + y) * a.w + x) * 4;
    float4 rs = gn * d, st = s * d;
    if (a.kind != FIRST) {
      rs = ld4(a.rs, pix) + rs;
      if (keep_st) st = ld4(a.st, pix) + st;
    }
    if (a.kind != LAST) {
      st4(a.cout, pix, cj);
      st4(a.rs, pix, rs);
      if (keep_st) st4(a.st, pix, st);
      continue;
    }
    // the blend
    rs = rs + cj;
    const float4 al = ld4(a.alpha, pix);
    const float4 zd = ld4(a.zd, l, y, x);
    float4 z;
    if (!a.ramp) {
      float4 ws = f4(1.f) - al;
      if (a.has_x01)
        ws = ws * (f4(1.f) - clamp01((ld4(a.x01, l, y, x) - f4(a.sat_lo)) * a.inv_sat));
      z = zd + al * rs;
      if (keep_st) z = z + ws * st;
    } else {
      const float4 r = ld4(a.zn, l, y, x) - zd;
      const float4 wr = clamp01((al - f4(a.fa)) * a.inv_1mfa);
      z = zd + al * (rs + wr * (r - rs));
    }
    st4(a.out, pix, z);
  }
}

// ---------------------------------------------------------------- the floor

// |Haar diagonal detail| of z_noisy at kept sample k, and the cell mean of
// z_dn there (robust.py::_haar_hh over _band_subsample_rows, thinned by s).
__device__ __forceinline__ float haar(const YRefineFloorArgs& a, long long k,
                                      float* mean) {
  long long i = k * a.s;
  const int ch = (int)(i & 3);
  i >>= 2;
  const int hx = (int)(i % a.wh);
  i /= a.wh;
  const int hy = (int)(i % a.hh);
  const int l = (int)(i / a.hh);
  const int p0 = 2 * hy, p1 = p0 + 1;
  const int ya = p0 / a.band * a.step + p0 % a.band;
  const int yb = p1 / a.band * a.step + p1 % a.band;
  const int xa = 2 * hx, xb = xa + 1;
  auto at = [&](const YRefinePlane& p, int y, int x) {
    return __ldg(p.p + l * p.sl + (long long)y * p.sy + (long long)x * p.sx
                 + ch * p.sc);
  };
  // a = x[0::2, 0::2], b = x[1::2, 1::2], c = x[0::2, 1::2], d = x[1::2, 0::2]
  if (mean) {
    const float A = at(a.zd, ya, xa), B = at(a.zd, yb, xb);
    const float C = at(a.zd, ya, xb), D = at(a.zd, yb, xa);
    *mean = (((A + B) + C) + D) * 0.25f;
  }
  const float A = at(a.zn, ya, xa), B = at(a.zn, yb, xb);
  const float C = at(a.zn, ya, xb), D = at(a.zn, yb, xa);
  return fabsf((((A + B) - C) - D) * 0.5f);
}

__device__ __forceinline__ float block_max(float m, float* red) {
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = NT / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

// Stage 0: zero the counts; each block's max |detail|.
__global__ void __launch_bounds__(NT) yondx_refine_floor_max(YRefineFloorArgs a) {
  __shared__ float red[NT];
  const long long g0 = (long long)blockIdx.x * NT + threadIdx.x;
  const long long gs = (long long)gridDim.x * NT;
  for (long long i = g0; i < NBK * NBIN; i += gs) a.counts[i] = 0u;
  float m = 0.f;
  for (long long k = g0; k < a.ns; k += gs) m = fmaxf(m, haar(a, k, nullptr));
  m = block_max(m, red);
  if (threadIdx.x == 0) a.part[blockIdx.x] = m;
}

// Stage 1: the bucket x log|detail| counts, per block in shared memory.
__global__ void __launch_bounds__(NT) yondx_refine_floor_hist(YRefineFloorArgs a) {
  __shared__ unsigned hist[NBK * NBIN];
  __shared__ float red[NT];
  for (int i = threadIdx.x; i < NBK * NBIN; i += NT) hist[i] = 0u;
  float m = 0.f;
  for (int i = threadIdx.x; i < a.nparts; i += NT) m = fmaxf(m, a.part[i]);
  const float dmax = block_max(m, red) + 1e-30f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.dmax = dmax;
  const long long g0 = (long long)blockIdx.x * NT + threadIdx.x;
  const long long gs = (long long)gridDim.x * NT;
  for (long long k = g0; k < a.ns; k += gs) {
    float mc;
    const float d = haar(a, k, &mc);
    const float lr = logf(fminf(fmaxf(d / dmax, 1e-4f), 1.f));
    // the plain version's (lr + span) / span * nbin as torch computes it
    // on the card: a multiply by inv_span, the reciprocal of the Python
    // number span taken in double and rounded to float32 (the wrapper's
    // _inv), then by nbin
    int db = (int)(__fmul_rn(__fmul_rn(lr + a.span, a.inv_span), (float)NBIN));
    db = db < 0 ? 0 : (db > NBIN - 1 ? NBIN - 1 : db);
    int bk = (int)(fminf(fmaxf(mc, 0.f), 1.f) * (float)(NBK - 1));
    bk = bk < 0 ? 0 : (bk > NBK - 1 ? NBK - 1 : bk);
    atomicAdd(&hist[bk * NBIN + db], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NBK * NBIN; i += NT)
    if (hist[i]) atomicAdd(&a.counts[i], hist[i]);
}

// Stage 2: a thread a bucket: the q-quantile |detail| by the counts' cdf,
// as a noise variance, trusted below trust_hi x the model variance. The
// roundings follow the plain version's separate tensor operations.
__global__ void __launch_bounds__(NBK) yondx_refine_floor_table(YRefineFloorArgs a) {
  const int b = threadIdx.x;
  if (b >= NBK) return;
  const unsigned* c = a.counts + b * NBIN;
  float n = 0.f;
  for (int j = 0; j < NBIN; ++j) n += (float)c[j];
  const float rank = a.q * n;
  float cdf = 0.f, below = 0.f;
  int qbin = 0;
  for (int j = 0; j < NBIN; ++j) {
    cdf += (float)c[j];
    qbin += cdf < rank;
  }
  if (qbin > NBIN - 1) qbin = NBIN - 1;
  for (int j = 0; j < qbin; ++j) below += (float)c[j];
  const float cnt = (float)c[qbin];
  const float frac = fminf(fmaxf((rank - below) / fmaxf(cnt, 1e-30f), 0.f), 1.f);
  const float ex = __fsub_rn(
      __fmul_rn(__fmul_rn(__fadd_rn((float)qbin, frac), 1.f / NBIN), a.span), a.span);
  const float sig = __fmul_rn(*a.dmax, expf(ex)) / a.den;
  const float qb = sig * sig;
  const float V = a.vptr ? *a.vptr : a.vval;
  const float ratio = qb / fmaxf(V, 1e-12f);
  const float tr = fminf(fmaxf(__fmul_rn(ratio - a.trust_lo, a.inv_trust), 0.f), 1.f);
  float f = fminf(V, __fadd_rn(__fmul_rn(qb, 1.f - tr), __fmul_rn(V, tr)));
  if (!(n >= (float)a.min_count)) f = V;
  a.table[b] = fmaxf(f, 1e-12f);
}

int set_smem(int smem) {
  static int smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(yondx_refine_level,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  return 0;
}

}  // namespace

// Sizes of the argument structs, for the binding's layout check.
extern "C" int yondx_refine_sizeof(int which) {
  return which == 0 ? (int)sizeof(YRefinePlane)
       : which == 1 ? (int)sizeof(YRefinePassArgs)
                    : (int)sizeof(YRefineFloorArgs);
}

// The settings compiled in: 0 the floor's buckets, 1 its log|detail| bins,
// 2 the gain box, 3 the a-trous levels (checked against refine.py's).
extern "C" int yondx_refine_setting(int which) {
  return which == 0 ? NBK : which == 1 ? NBIN : which == 2 ? GAIN_BOX : LEVELS;
}

// Launches one level pass on `stream`; returns the cudaError_t of the
// launch (0 = ok).
extern "C" int yondx_refine_pass(const YRefinePassArgs* a, void* stream) {
  if (a->L <= 0 || a->h <= 0 || a->w <= 0 || a->k <= 0 || a->level < 0
      || a->level > 2
      || (a->kind != FIRST && a->kind != MID && a->kind != LAST))
    return (int)cudaErrorInvalidValue;
  const Geom g = geometry(a->kind, a->level, a->m_ax, a->k, a->shrink,
                          a->oriented);
  const int smem = smem_bytes(g);
  int err = set_smem(smem);
  if (err) return err;
  const long long blocks = (long long)a->L * ((a->h + TH - 1) / TH)
                           * ((a->w + TW - 1) / TW);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  yondx_refine_level<<<(unsigned)blocks, NT, smem,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// Launches stage 0, 1 or 2 of the bucket floor on `stream`, with `blocks`
// blocks (stage 0's count is the args' nparts; stage 2 takes one).
extern "C" int yondx_refine_floor(const YRefineFloorArgs* a, int stage,
                                  int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->ns <= 0 || a->nparts <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (stage == 0)
    yondx_refine_floor_max<<<a->nparts, NT, 0, s>>>(*a);
  else if (stage == 1)
    yondx_refine_floor_hist<<<blocks, NT, 0, s>>>(*a);
  else if (stage == 2)
    yondx_refine_floor_table<<<1, NBK, 0, s>>>(*a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
