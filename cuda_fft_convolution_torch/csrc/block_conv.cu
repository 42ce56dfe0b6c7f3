// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel.
//
// Replaces cuda_fft_convolution_tpu/ops/block_conv.py::block_conv_pallas
// (the v3 body, _make_kernel_v3), in its four dtype modes: fp32 or bf16
// spectra (BF16IO, see block_conv.cuh), fp32 or bf16 maps (out_dtype). It
// computes the same function, not the same factorization: the transforms of
// block_conv.cuh (which also says what bounds the kernel, how it is laid
// out and how short windows stack blocks in a CTA), then a clipped store of
// each cell's tile into
// out[b, n, i*Vh : (i+1)*Vh, j*Vw : (j+1)*Vw], at (out_h, out_w) — the
// 'full'-window linear-convolution maps, assembled in place with no
// reassembly pass. bf16 maps round each fp32 accumulator once, just before
// its store, as the JAX kernel casts each tile in the kernel.

#include "block_conv.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Epilogue: write the tile into the (B, N, out_h, out_w) maps of type TO,
// clipped. STACKED: row R of the tile is window row R % vh of the group's
// block R / vh; rows of blocks past the group's count are not written.
template <class TO, bool STACKED>
struct StoreMaps {
  using Out = TO*;
  TO* out_c;
  int gy0, gx0, vh, vw, out_h, out_w;
  int nbw, blk0, count;  // the stacked group: first block (row-major), blocks

  __device__ StoreMaps(TO* out, const Cell& c, const OutGeom& g)
      : out_c(out + (c.bb * g.n + c.ni) * static_cast<long long>(g.out_h) * g.out_w),
        gy0(c.bi * g.vh), gx0(c.bj * g.vw), vh(g.vh), vw(g.vw),
        out_h(g.out_h), out_w(g.out_w), nbw(g.nbw), blk0(c.bi * g.nbw + c.bj),
        count(c.count) {}

  template <int TR>
  __device__ void tile(const float (&acc)[TR][4], int row0, int col0) {
    if constexpr (STACKED) {
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const int t = (row0 + a) / vh;
        if (t >= count) continue;
        const int bi = (blk0 + t) / nbw;
        const int gy = bi * vh + row0 + a - t * vh;
        const int gxb = (blk0 + t - bi * nbw) * vw;
        if (gy >= out_h) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = col0 + c;
          const int gx = gxb + col;
          if (col < vw && gx < out_w) store(out_c + static_cast<long long>(gy) * out_w + gx, acc[a][c]);
        }
      }
    } else {
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
  }

  __device__ void finish(float*) {}
};

template <bool S>
using StoreF32 = StoreMaps<float, S>;
template <bool S>
using StoreBF16 = StoreMaps<__nv_bfloat16, S>;

}  // namespace

// Shared-memory bytes the kernels need at packed width wc and window height
// vh, the rows a CTA holds there, and the blocks it stacks (1: one block
// per CTA); the Python legality rule (ops/block_conv.py smem_bytes,
// tile_rows, blocks_per_cta) mirrors all three.
extern "C" long long fftconv_block_conv_f32_smem_bytes(int wc, int vh) { return smem_bytes(wc, vh); }
extern "C" int fftconv_block_conv_f32_rows(int wc, int vh) { return tile_rows(wc, vh); }
extern "C" int fftconv_block_conv_f32_blocks(int wc, int vh) { return blocks_per_cta(wc, vh); }

// One entry per (spectra, maps) dtype pair: fftconv_block_conv_<spectra>
// with a _bf16maps suffix for bf16 maps. `ktile` is the stacked
// configuration's launch order (block_conv.cuh launch_block_conv). Each
// launches on `stream` and does not synchronise. Returns cudaGetLastError()
// after the launch (0 = launched), or the error that stopped it.
#define FFTCONV_BLOCK_CONV_ENTRY(NAME, TS, TO, EPI)                              \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* m_re, const float* m_im, TO* out, int b,     \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,   \
                      int vw, int out_h, int out_w, int ktile, void* stream) {  \
    return launch_block_conv<TS, EPI>(                                         \
        d_re, d_im, k_re, k_im, gt_re, gt_im, m_re, m_im, out, b, nbh, nbw, f, \
        n, lh, wc, vh, vw, out_h, out_w, ktile, stream);                       \
  }

FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32, float, float, StoreF32)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps, float, __nv_bfloat16, StoreBF16)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16, __nv_bfloat16, float, StoreF32)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps, __nv_bfloat16, __nv_bfloat16, StoreBF16)
