// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel.
//
// Replaces cuda_fft_convolution_tpu/ops/block_conv.py::block_conv_pallas
// (the v3 body, _make_kernel_v3), in its four dtype modes: fp32 or bf16
// spectra (BF16IO, see block_conv.cuh), fp32 or bf16 maps (out_dtype). It
// computes the same function, not the same factorization: the transforms of
// block_conv.cuh (which also says what bounds the kernel and how it is laid
// out), then a clipped store of each cell's tile into
// out[b, n, i*Vh : (i+1)*Vh, j*Vw : (j+1)*Vw], at (out_h, out_w) — the
// 'full'-window linear-convolution maps, assembled in place with no
// reassembly pass. bf16 maps round each fp32 accumulator once, just before
// its store, as the JAX kernel casts each tile in the kernel.

#include "block_conv.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Epilogue: write the tile into the (B, N, out_h, out_w) maps of type TO,
// clipped.
template <class TO>
struct StoreMaps {
  using Out = TO*;
  TO* out_c;
  int gy0, gx0, vh, vw, out_h, out_w;

  __device__ StoreMaps(TO* out, const Cell& c, const OutGeom& g)
      : out_c(out + (c.bb * g.n + c.ni) * static_cast<long long>(g.out_h) * g.out_w),
        gy0(c.bi * g.vh), gx0(c.bj * g.vw), vh(g.vh), vw(g.vw),
        out_h(g.out_h), out_w(g.out_w) {}

  template <int TR>
  __device__ void tile(const float (&acc)[TR][4], int row0, int col0) {
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int row = row0 + a;
      const int gy = gy0 + row;
      if (row >= vh || gy >= out_h) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + c;
        const int gx = gx0 + col;
        if (col < vw && gx < out_w) store(out_c + static_cast<long long>(gy) * out_w + gx, acc[a][c]);
      }
    }
  }

  __device__ void finish(float*) {}
};

}  // namespace

// Shared-memory bytes the kernels need for packed width wc, and the window
// rows a CTA owns there; the Python legality rule (ops/block_conv.py
// smem_bytes, tile_rows) mirrors both.
extern "C" long long fftconv_block_conv_f32_smem_bytes(int wc) { return smem_bytes(wc); }
extern "C" int fftconv_block_conv_f32_rows(int wc) { return tile_rows(wc); }

// One entry per (spectra, maps) dtype pair: fftconv_block_conv_<spectra>
// with a _bf16maps suffix for bf16 maps. Each launches on `stream` and does
// not synchronise. Returns cudaGetLastError() after the launch
// (0 = launched), or the error that stopped it.
#define FFTCONV_BLOCK_CONV_ENTRY(NAME, TS, TO)                                   \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* m_re, const float* m_im, TO* out, int b,     \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,   \
                      int vw, int out_h, int out_w, void* stream) {             \
    return launch_block_conv<TS, StoreMaps<TO>>(                               \
        d_re, d_im, k_re, k_im, gt_re, gt_im, m_re, m_im, out, b, nbh, nbw, f, \
        n, lh, wc, vh, vw, out_h, out_w, stream);                              \
  }

FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32, float, float)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps, float, __nv_bfloat16)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16, __nv_bfloat16, float)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps, __nv_bfloat16, __nv_bfloat16)
