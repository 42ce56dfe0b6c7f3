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
// What bounds it: 8 flops per 16 bytes of kernel spectra read (8 at bf16)
// and 8 bytes written per (b, n, f, p), so device-memory bandwidth. Design: one thread
// owns kPer pixels spaced kThreads apart (coalesced, kPer independent loads
// of each plane in flight), loops over F and writes each output once. The
// TPU grid kept n innermost so a data tile stayed in VMEM across the bank;
// here n is the fastest launch index, so CTAs resident together read the
// same data pixels and those reads hit L2: the data planes leave device
// memory about once, the kernel planes once, and the outputs are written
// once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // pixels per thread
constexpr int kPix = kThreads * kPer;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class TS>
__global__ void __launch_bounds__(kThreads) spectral_mac_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    float* __restrict__ o_re, float* __restrict__ o_im, int f, int n,
    long long s, long long chunks) {
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
}

template <class TS>
int launch(const TS* d_re, const TS* d_im, const TS* k_re, const TS* k_im,
           float* o_re, float* o_im, int b, int f, int n, long long s,
           void* stream) {
  if (b <= 0 || f <= 0 || n <= 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (s + kPix - 1) / kPix;
  const long long grid = static_cast<long long>(b) * chunks * n;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  spectral_mac_kernel<TS><<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      d_re, d_im, k_re, k_im, o_re, o_im, f, n, s, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 outputs from fp32 (_f32) or bf16 (_bf16) planes. Launch on `stream`;
// do not synchronise. Return cudaGetLastError() after the launch
// (0 = launched), or the error that stopped it.
extern "C" int fftconv_spectral_mac_f32(
    const float* d_re, const float* d_im, const float* k_re, const float* k_im,
    float* o_re, float* o_im, int b, int f, int n, long long s, void* stream) {
  return launch(d_re, d_im, k_re, k_im, o_re, o_im, b, f, n, s, stream);
}

extern "C" int fftconv_spectral_mac_bf16(
    const __nv_bfloat16* d_re, const __nv_bfloat16* d_im,
    const __nv_bfloat16* k_re, const __nv_bfloat16* k_im, float* o_re,
    float* o_im, int b, int f, int n, long long s, void* stream) {
  return launch(d_re, d_im, k_re, k_im, o_re, o_im, b, f, n, s, stream);
}
