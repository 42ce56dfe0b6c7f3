// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel.
//
// Replaces cuda_fft_convolution_tpu/ops/block_conv.py::block_conv_pallas
// (the v3 body, _make_kernel_v3), in its four dtype modes: fp32 or bf16
// spectra, fp32 or bf16 maps (out_dtype); at fp32 spectra in its three
// precisions (BF16X3, HIGHEST, DEFAULT) as the 3xTF32, 6xTF32 and one-pass
// synthesis tiers, and at bf16 spectra in BF16IO (kBF16IO, the default)
// and BF16X3 (3xTF32) (block_conv.cuh). It
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
  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0) {
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
          if (row >= rows) continue;
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

// Shared-memory bytes the kernels need at packed width wc, window height
// vh and tier `splits` (1, 3 or 6 tensor-core products, or 0 for kBF16IO;
// -1 for another),
// the rows a CTA holds there, and the blocks it stacks (1: one block per
// CTA); the Python legality rule (ops/block_conv.py smem_bytes, tile_rows,
// blocks_per_cta) mirrors all three.
extern "C" long long fftconv_block_conv_f32_smem_bytes(int wc, int vh, int splits) {
  return valid_splits(splits) ? smem_bytes(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_rows(int wc, int vh, int splits) {
  return valid_splits(splits) ? tile_rows(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_blocks(int wc, int vh, int splits) {
  return valid_splits(splits) ? blocks_per_cta(wc, vh, splits) : -1;
}

// One entry per (spectra, maps) dtype pair and tier:
// fftconv_block_conv_<spectra>, with a _bf16maps suffix for bf16 maps and,
// for fp32 spectra, _x6 (6xTF32, fused_precision='highest') or _x1 (one
// TF32 pass, 'highest' with matmul_precision='default'), for bf16 spectra
// _io (kBF16IO, their default tier), for the tiers other than 3xTF32
// (block_conv.cuh). `ktile` is the stacked
// configuration's launch order (launch_block_conv). Each launches on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 = launched), or the error that stopped it.
#define FFTCONV_BLOCK_CONV_ENTRY(NAME, TS, TO, EPI, SPLITS)                      \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* g_pad, const float* m_tc, TO* out, int b,    \
                      int nbh, int nbw, int f, int n, int lh, int wc, int vh,   \
                      int vw, int out_h, int out_w, int ktile, void* stream) {  \
    return launch_block_conv<TS, EPI, SPLITS>(                                 \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, out, b, nbh, nbw, f,\
        n, lh, wc, vh, vw, out_h, out_w, ktile, stream);                       \
  }

FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32, float, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps, float, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16, __nv_bfloat16, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps, __nv_bfloat16, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x6, float, float, StoreF32, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x6, float, __nv_bfloat16, StoreBF16, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x1, float, float, StoreF32, 1)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x1, float, __nv_bfloat16, StoreBF16, 1)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_io, __nv_bfloat16, float, StoreF32, kBF16IO)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps_io, __nv_bfloat16, __nv_bfloat16, StoreBF16, kBF16IO)
