// Spectral multiply-accumulate on split planes, for Hopper (sm_90a).
//
// Replaces cuda_fft_convolution_tpu/ops/spectral_mac.py::
// spectral_mac_pallas_planes (its body _mac_kernel) on fp32 planes, and
// runs the bf16 serving tier's MAC too (bf16 planes, fp32 accumulation and
// fp32 outputs: the function of the JAX package's einsum at the tier, whose
// Pallas MAC is fp32 only):
//
//   out[b, n, p] = sum_f (Kr Dr - Ki Di, Kr Di + Ki Dr)[f, p]
//
// for data (B, F, S) and kernels (N, F, S) with S = H * Wc pixels, into
// (B, N, S) real and imaginary planes.
//
// What bounds it: device memory. Each (b, n, f, p) is 8 flops, and the
// least traffic is every operand read once and every output written once:
//   bytes = (B + N) * F * S * 2 * sizeof(plane) + B * N * S * 8,
// 3.21 GB at the trainer's forward (B 8, F 31, N 64, S 540 x 271): 0.96 ms at
// 3.35 TB/s against 0.28 ms for its 18.6 GFLOP at the fp32 peak. The
// contraction over F is a separate tiny product at every pixel, so the
// tensor cores have nothing to do here and fp32 FMAs are enough.
//
// Design: registers, no shared memory in the register tiles; each output's
// arithmetic is the same in every register tile (f ascending, two fmaf
// chains), so every register tile gives the same bits. Three forms of one
// kernel, by the tile (TB, TN): TB images x TN filters a thread, or (0, 8)
// for the split form:
//
//  - (1, 1), the B = 1 tile, is the kernel of before tiles: 4 pixels a
//    thread, spaced kThreads apart (coalesced), loads and products a pixel
//    at a time (32 registers, 8 CTAs an SM), launch order image, pixel
//    chunk, filter. At B = 1 there is nothing to re-read: each CTA reads
//    its filter's rows once and the data chunk, shared by the filters
//    launched next to it, hits L2.
//  - (8, 4), for batches: 1 pixel a thread; for each f it loads TB data
//    and TN kernel values (re and im) and does the TB * TN complex
//    multiply-adds into registers, then writes each output once. A tile
//    cuts the kernel operand's reads by TB and the data operand's by TN.
//    The launch order puts the pixel chunk outermost, then the image tile,
//    with the filter tile fastest, so the CTAs that share a chunk's
//    F-slices run at about the same time and the re-reads the tiles leave
//    (the data rows across filter tiles, the kernel rows across image
//    tiles) hit L2: one f-slice of a chunk for all images and filters is
//    (B + N) * kThreads * 8 bytes (147 KB at the trainer's forward), so each
//    operand leaves device memory about once whatever B is. On fp32 planes
//    the loads of two f-steps are issued before their products (2 (TB + TN)
//    * 2 loads in flight a thread); bf16 planes take one step, as two spill
//    at the 128-register cap that keeps two CTAs on an SM. Rows past B or N
//    in a ragged last tile load the last row again (a duplicate, from L1)
//    and store nothing; pixels past S do neither.
//  - (0, 8), the split form, for calls whose (1, 1) grid leaves SMs idle
//    and is short beside the channel count, where the (1, 1) tile's
//    dependent channel steps cost more than the split form's CTAs
//    (MOSSE's respond: B 1, N 1, F 31, S 64 x 33 = 2112
//    pixels is 3 CTAs of 1024 pixels on 132 SMs, each thread walking 31
//    dependent channel steps). A CTA takes 32 consecutive pixels, one a
//    lane (coalesced), and its 8 warps split the contraction: warp w sums
//    the channels f = w, w + 8, ... (f ascending, the same two fmaf chains
//    an output), the loads of 4 steps issued before their products; the 8
//    partial sums meet in shared memory and warp 0 (re) and warp 1 (im)
//    add them in warp order, so a launch gives the same bits every run.
//    It sums in another order than the chain over f ascending, so it is
//    not bitwise the register tiles: it is held to 1e-5 of the plain
//    version. MOSSE's respond becomes 66 CTAs of at most 4 channel steps.
//    Launch order: filter fastest, then the pixel chunk, then the image.
//
// Registers rather than a cp.async ring through shared memory: the loads a
// thread keeps in flight bring the trainer's MACs over half their bound,
// with no barriers to wait on. Wider tiles ((8, 8)), narrower ones ((4, 4),
// (2, 4)) at the batches the port runs (8 images or more), a (1, 4) tile at
// B = 1 and more loads in flight at B = 1 were level or slower on the card: a
// wider tile costs occupancy, a narrower one reads the kernel rows more
// often. The form for a call is chosen in Python (ops/spectral_mac.py
// mac_tile, from B, N, F, S and the card's SM count) and passed in; a pair
// outside FFTCONV_MAC_TILES is refused with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The instantiated (TB, TN) tiles, and the split form (0, kWarps).
#define FFTCONV_MAC_TILES(X) X(1, 1) X(8, 4) X(0, 8)

// Pixels a CTA: kThreads times a thread's pixels in the register tiles
// (4 in the (1, 1) tile, else 1), one a lane in the split form.
__host__ __device__ constexpr int pixels_per_cta(int tb, int tn) {
  return tb == 0 ? 32 : tb * tn == 1 ? 4 * kThreads : kThreads;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The split form (0, kWarps): 32 pixels a CTA, the channels split across
// its warps, the partial sums added in warp order.
template <class TS>
__global__ void __launch_bounds__(kThreads) spectral_mac_split_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    float* __restrict__ o_re, float* __restrict__ o_im, int f, int n, long long s,
    long long chunks) {
  __shared__ float part[2][kWarps][32];
  long long bid = blockIdx.x;
  const int ni = static_cast<int>(bid % n);
  bid /= n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p = (bid % chunks) * 32 + lane;
  const long long bb = bid / chunks;
  float ar = 0.f, ai = 0.f;
  if (p < s) {
    const TS* dr = d_re + bb * f * s + p;
    const TS* di = d_im + bb * f * s + p;
    const TS* kr = k_re + static_cast<long long>(ni) * f * s + p;
    const TS* ki = k_im + static_cast<long long>(ni) * f * s + p;
#pragma unroll 4
    for (int ff = warp; ff < f; ff += kWarps) {
      const long long o = static_cast<long long>(ff) * s;
      const float xr = to_f32(dr[o]), xi = to_f32(di[o]);
      const float yr = to_f32(kr[o]), yi = to_f32(ki[o]);
      ar = fmaf(yr, xr, fmaf(-yi, xi, ar));
      ai = fmaf(yr, xi, fmaf(yi, xr, ai));
    }
  }
  part[0][warp][lane] = ar;
  part[1][warp][lane] = ai;
  __syncthreads();
  if (warp < 2 && p < s) {
    float v = part[warp][0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += part[warp][w][lane];
    (warp == 0 ? o_re : o_im)[(bb * n + ni) * s + p] = v;
  }
}

template <class TS, int TB, int TN>
__global__ void __launch_bounds__(kThreads, TB * TN == 1 ? 8 : 2) spectral_mac_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    float* __restrict__ o_re, float* __restrict__ o_im, int b, int f, int n,
    long long s, long long chunks, int tiles_n, int tiles) {
  if constexpr (TB * TN == 1) {
    constexpr int kPix = pixels_per_cta(1, 1), kPer = kPix / kThreads;
    long long bid = blockIdx.x;
    const int ni = static_cast<int>(bid % n);
    bid /= n;
    const long long p0 = (bid % chunks) * kPix + threadIdx.x;
    const long long bb = bid / chunks;
    const TS* dr = d_re + bb * f * s;
    const TS* di = d_im + bb * f * s;
    const TS* kr = k_re + static_cast<long long>(ni) * f * s;
    const TS* ki = k_im + static_cast<long long>(ni) * f * s;

    float ar[kPer], ai[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) ar[q] = ai[q] = 0.f;
    for (int ff = 0; ff < f; ++ff) {
      const long long base = static_cast<long long>(ff) * s;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const long long p = p0 + q * kThreads;
        if (p < s) {
          const float xr = to_f32(dr[base + p]), xi = to_f32(di[base + p]);
          const float yr = to_f32(kr[base + p]), yi = to_f32(ki[base + p]);
          ar[q] = fmaf(yr, xr, fmaf(-yi, xi, ar[q]));
          ai[q] = fmaf(yr, xi, fmaf(yi, xr, ai[q]));
        }
      }
    }
    const long long out0 = (bb * n + ni) * s;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long p = p0 + q * kThreads;
      if (p < s) {
        o_re[out0 + p] = ar[q];
        o_im[out0 + p] = ai[q];
      }
    }
  } else {
    constexpr int kSteps = sizeof(TS) == 4 ? 2 : 1;  // f-steps of loads in flight
    const unsigned bid = blockIdx.x;
    const int tile = static_cast<int>(bid % static_cast<unsigned>(tiles));
    const long long p =
        static_cast<long long>(bid / static_cast<unsigned>(tiles)) * kThreads + threadIdx.x;
    const int b0 = (tile / tiles_n) * TB;
    const int n0 = (tile % tiles_n) * TN;
    // Row r's f-slice ff starts at element (r * f + ff) * s.
    int drow[TB], krow[TN];
#pragma unroll
    for (int t = 0; t < TB; ++t) drow[t] = min(b0 + t, b - 1) * f;
#pragma unroll
    for (int u = 0; u < TN; ++u) krow[u] = min(n0 + u, n - 1) * f;

    float ar[TB][TN], ai[TB][TN];
#pragma unroll
    for (int t = 0; t < TB; ++t)
#pragma unroll
      for (int u = 0; u < TN; ++u) ar[t][u] = ai[t][u] = 0.f;
    for (int f0 = 0; f0 < f; f0 += kSteps) {
      float xr[kSteps][TB], xi[kSteps][TB], yr[kSteps][TN], yi[kSteps][TN];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int ff = f0 + st;
        if ((kSteps == 1 || ff < f) && p < s) {
#pragma unroll
          for (int t = 0; t < TB; ++t) {
            const long long o = static_cast<long long>(drow[t] + ff) * s + p;
            xr[st][t] = to_f32(d_re[o]);
            xi[st][t] = to_f32(d_im[o]);
          }
#pragma unroll
          for (int u = 0; u < TN; ++u) {
            const long long o = static_cast<long long>(krow[u] + ff) * s + p;
            yr[st][u] = to_f32(k_re[o]);
            yi[st][u] = to_f32(k_im[o]);
          }
        }
      }
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if ((kSteps == 1 || f0 + st < f) && p < s) {
#pragma unroll
          for (int t = 0; t < TB; ++t)
#pragma unroll
            for (int u = 0; u < TN; ++u) {
              ar[t][u] = fmaf(yr[st][u], xr[st][t], fmaf(-yi[st][u], xi[st][t], ar[t][u]));
              ai[t][u] = fmaf(yr[st][u], xi[st][t], fmaf(yi[st][u], xr[st][t], ai[t][u]));
            }
        }
      }
    }
    if (p >= s) return;
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      if (b0 + t >= b) break;
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        if (n0 + u >= n) break;
        const long long o = (static_cast<long long>(b0 + t) * n + n0 + u) * s + p;
        o_re[o] = ar[t][u];
        o_im[o] = ai[t][u];
      }
    }
  }
}

template <class TS, int TB, int TN>
int launch_tile(const TS* d_re, const TS* d_im, const TS* k_re, const TS* k_im,
                float* o_re, float* o_im, int b, int f, int n, long long s,
                cudaStream_t stream) {
  const long long pix = pixels_per_cta(TB, TN);
  const long long chunks = (s + pix - 1) / pix;
  const int tiles_n = TB == 0 ? n : (n + TN - 1) / TN;
  const long long tiles = static_cast<long long>(TB == 0 ? b : (b + TB - 1) / TB) * tiles_n;
  const long long grid = chunks * tiles;
  if (grid > INT_MAX || static_cast<long long>(b) * f > INT_MAX ||
      static_cast<long long>(n) * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (TB == 0) {
    static_assert(TN == kWarps, "the split form takes the CTA's warps");
    spectral_mac_split_kernel<TS><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        d_re, d_im, k_re, k_im, o_re, o_im, f, n, s, chunks);
  } else {
    spectral_mac_kernel<TS, TB, TN><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        d_re, d_im, k_re, k_im, o_re, o_im, b, f, n, s, chunks, tiles_n,
        static_cast<int>(tiles));
  }
  return static_cast<int>(cudaGetLastError());
}

template <class TS>
int launch(const TS* d_re, const TS* d_im, const TS* k_re, const TS* k_im,
           float* o_re, float* o_im, int b, int f, int n, long long s, int tb,
           int tn, void* stream) {
  if (b <= 0 || f <= 0 || n <= 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define FFTCONV_MAC_LAUNCH(TB, TN)                                        \
  if (tb == TB && tn == TN)                                               \
    return launch_tile<TS, TB, TN>(d_re, d_im, k_re, k_im, o_re, o_im, b, \
                                   f, n, s, st);
  FFTCONV_MAC_TILES(FFTCONV_MAC_LAUNCH)
#undef FFTCONV_MAC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fp32 outputs from fp32 (_f32) or bf16 (_bf16) planes, with a (tb, tn)
// form of the instantiated set (a register tile, or (0, 8): the split
// form). Launch on `stream`; do not
// synchronise. Return cudaGetLastError() after the launch (0 = launched),
// or the error that stopped it (cudaErrorInvalidValue for a tile outside
// the set).
extern "C" int fftconv_spectral_mac_f32(
    const float* d_re, const float* d_im, const float* k_re, const float* k_im,
    float* o_re, float* o_im, int b, int f, int n, long long s, int tb, int tn,
    void* stream) {
  return launch(d_re, d_im, k_re, k_im, o_re, o_im, b, f, n, s, tb, tn, stream);
}

extern "C" int fftconv_spectral_mac_bf16(
    const __nv_bfloat16* d_re, const __nv_bfloat16* d_im,
    const __nv_bfloat16* k_re, const __nv_bfloat16* k_im, float* o_re,
    float* o_im, int b, int f, int n, long long s, int tb, int tn, void* stream) {
  return launch(d_re, d_im, k_re, k_im, o_re, o_im, b, f, n, s, tb, tn, stream);
}
