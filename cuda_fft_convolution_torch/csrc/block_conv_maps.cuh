// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's epilogue and the macros of its C entries, shared by the v3
// entries (block_conv.cu), the radix bodies' (block_conv_r4.cu,
// block_conv_r5.cu, block_conv_r5x.cu) and the Karatsuba form's
// (block_conv_k.cu), and the v2 entries (beside v3's of the same form).

#pragma once

#include "block_conv.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// Two adjacent values, to an address aligned to the pair.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Epilogue: write the tile into the (B, N, out_h, out_w) maps of type TO,
// clipped. STACKED: row R of the tile is window row R % vh of the group's
// block R / vh; rows of blocks past the group's count are not written.
template <class TO, bool STACKED>
struct StoreMaps {
  using Out = TO*;
  TO* out_c;  // one block: the block's first map position; stacked: the map
  int rows, cols, out_w;  // one block: its window rows and columns in the maps
  int vh, vw, out_h, nbw, blk0, count;  // stacked: the group (first block, blocks)

  __device__ StoreMaps(TO* out, const Cell& c, const OutGeom& g)
      : out_c(out + (c.bb * g.n + c.ni) * static_cast<long long>(g.out_h) * g.out_w),
        rows(min(g.vh, g.out_h - c.bi * g.vh)), cols(min(g.vw, g.out_w - c.bj * g.vw)),
        out_w(g.out_w), vh(g.vh), vw(g.vw), out_h(g.out_h), nbw(g.nbw),
        blk0(c.bi * g.nbw + c.bj), count(c.count) {
    if constexpr (!STACKED) out_c += static_cast<long long>(c.bi * g.vh) * g.out_w + c.bj * g.vw;
  }

  template <int MT, int NT>
  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mt + 8 * h;
        TO* out_row;  // the row's first window position in the maps
        int lim;      // its window columns inside the maps
        if constexpr (STACKED) {
          const int t = row / vh;
          if (t >= count) continue;
          const int bi = (blk0 + t) / nbw;
          const int gy = bi * vh + row - t * vh;
          if (gy >= out_h) continue;
          const int gxb = (blk0 + t - bi * nbw) * vw;
          out_row = out_c + static_cast<long long>(gy) * out_w + gxb;
          lim = min(vw, out_w - gxb);
        } else {
          if (row >= rows || row >= row_end) continue;
          out_row = out_c + static_cast<long long>(row) * out_w;
          lim = cols;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // A thread's two columns are adjacent: one store where both are
          // in the window and the maps and the address is pair-aligned, so
          // a warp's store fills whole 32-byte sectors.
          const int col = col0 + 8 * nt;
          TO* p = out_row + col;
          // (h is a loop variable, not unrolled: select, do not index)
          const float a = h ? acc[mt][nt][2] : acc[mt][nt][0];
          const float b = h ? acc[mt][nt][3] : acc[mt][nt][1];
          if (col + 1 < lim && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(TO)) == 0) {
            store2(p, a, b);
          } else {
            if (col < lim) store(p, a);
            if (col + 1 < lim) store(p + 1, b);
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

// One C entry of the maps kernel: fftconv_block_conv_<spectra>[_bf16maps]
// [_x6 | _x1 | _io][_r4 | _r5 | _r5x][_v2][_k] (block_conv.cu says what the dtype
// and tier suffixes select, block_conv.cuh the bodies). The radix bodies'
// entries take RadixOps' three pointers after m_tc. Each launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 = launched), or the error that stopped it.
#define FFTCONV_BLOCK_CONV_ENTRY(NAME, TS, TO, EPI, SPLITS)                      \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* g_pad, const float* m_tc, TO* out, int b,    \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,   \
                      int vw, int out_h, int out_w, int ktile, void* stream) {  \
    return launch_block_conv<TS, EPI, SPLITS>(                                 \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, RadixOps{}, out, b, \
        nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w, ktile, stream);          \
  }
#define FFTCONV_BLOCK_CONV_RADIX_ENTRY(NAME, TS, TO, EPI, SPLITS, BODY, KARA)    \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,            \
                      const TS* k_im, const float* gt_re, const float* gt_im,    \
                      const float* g_pad, const float* m_tc, const float* u_pad, \
                      const float* tw, const float* slv, TO* out, int b,         \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,    \
                      int vw, int out_h, int out_w, int ktile, void* stream) {   \
    return launch_block_conv<TS, EPI, SPLITS, BODY, KARA>(                       \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc,                       \
        RadixOps{u_pad, tw, slv}, out, b, nbh, nbw, f, n, lh, wc, vh, vw,        \
        out_h, out_w, ktile, stream);                                            \
  }
// An entry of the other H-stage forms (block_conv_k.cu,
// block_conv_k_tiers.cu): the v3 entries' operands, body BODY, KARA the
// Karatsuba H stage.
#define FFTCONV_BLOCK_CONV_FORM_ENTRY(NAME, TS, TO, EPI, SPLITS, BODY, KARA)    \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* g_pad, const float* m_tc, TO* out, int b,    \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,   \
                      int vw, int out_h, int out_w, int ktile, void* stream) {  \
    return launch_block_conv<TS, EPI, SPLITS, BODY, KARA>(                     \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, RadixOps{}, out, b, \
        nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w, ktile, stream);          \
  }
// The maps kernel's ten dtype-and-tier entries of one radix body, in the H
// stage's 4-product form or (KARA) its Karatsuba form.
#define FFTCONV_BLOCK_CONV_RADIX_ENTRIES(SUFFIX, BODY, KARA)                                                              \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32##SUFFIX, float, float, StoreF32, 3, BODY, KARA)                   \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32_bf16maps##SUFFIX, float, __nv_bfloat16, StoreBF16, 3, BODY, KARA) \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_bf16##SUFFIX, __nv_bfloat16, float, StoreF32, 3, BODY, KARA)          \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_bf16_bf16maps##SUFFIX, __nv_bfloat16, __nv_bfloat16,                  \
                                 StoreBF16, 3, BODY, KARA)                                                                \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32_x6##SUFFIX, float, float, StoreF32, 6, BODY, KARA)                \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32_bf16maps_x6##SUFFIX, float, __nv_bfloat16, StoreBF16, 6,          \
                                 BODY, KARA)                                                                              \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32_x1##SUFFIX, float, float, StoreF32, 1, BODY, KARA)                \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_f32_bf16maps_x1##SUFFIX, float, __nv_bfloat16, StoreBF16, 1,          \
                                 BODY, KARA)                                                                              \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_bf16_io##SUFFIX, __nv_bfloat16, float, StoreF32, kBF16IO,             \
                                 BODY, KARA)                                                                              \
  FFTCONV_BLOCK_CONV_RADIX_ENTRY(fftconv_block_conv_bf16_bf16maps_io##SUFFIX, __nv_bfloat16, __nv_bfloat16,               \
                                 StoreBF16, kBF16IO, BODY, KARA)
