// Fused overlap-save block convolution for Hopper (sm_90a): the peaks
// kernel's epilogue and the macros of its C entries, shared by the v3
// entries (block_conv_peaks.cu), the radix bodies' (block_conv_r4.cu,
// block_conv_r5.cu, block_conv_r5x.cu) and the Karatsuba entries'
// (block_conv_peaks_k.cu). block_conv_peaks.cu says what it computes.

#pragma once

#include <cmath>

#include "block_conv.cuh"

namespace {

// The reduction's rule: the larger value wins; between equal values the
// smaller index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The kernel's output argument, one type for both configurations.
struct PeaksOut {
  float* vals;
  int* idxs;
};

// A stacked thread's W-stage rows (two of its warp's 16), and the column
// groups of a stacked row (2 warpgroups x 4 lanes).
constexpr int kRows = 2, kGroups = 8;

template <bool STACKED>
struct ReducePeaks {
  using Out = PeaksOut;
  Out out;
  long long slot;  // this CTA's entry of the partial pyramid
  int gy0, gx0, vh, vw, out_h, out_w;
  float best;
  int best_i;
  // Stacked: the group (first block's pyramid base, blocks), and a running
  // (max, index) for each of this thread's kRows rows (rrow + 8 a, of its
  // warp's 16 in the wgmma layout) over its column group rcg (kGroups a
  // row).
  long long base;
  int nbw, blk0, count, rrow, rcg;
  float rb[kRows];
  int ri[kRows];

  __device__ ReducePeaks(Out o, const Cell& c, const OutGeom& g)
      : out(o),
        slot((((c.bb * g.n + c.ni) * g.nbh + c.bi) * g.row_chunks + c.rc) * g.nbw + c.bj),
        gy0(c.bi * g.vh), gx0(c.bj * g.vw), vh(g.vh), vw(g.vw),
        out_h(g.out_h), out_w(g.out_w), best(-INFINITY), best_i(INT_MAX),
        base((c.bb * g.n + c.ni) * static_cast<long long>(g.nbh) * g.nbw),
        nbw(g.nbw), blk0(c.bi * g.nbw + c.bj), count(c.count), rrow(0), rcg(0) {
    if constexpr (STACKED) {
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        rb[a] = -INFINITY;
        ri[a] = INT_MAX;
      }
    }
  }

  __device__ void take(float v, int i) {
    if (beats(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }

  template <int MT, int NT>
  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {
    if constexpr (STACKED) {
      static_assert(MT == 1 && NT == 8, "a stacked thread holds 2 rows x 8 n-tiles (wgmma)");
      rrow = row0;
      rcg = ((col0 % 128) >> 6) * 4 + ((col0 >> 1) & 3);  // warpgroup, then lane
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int row = row0 + 8 * a;
        const int t = row / vh;
        if (t >= count) continue;
        const int bi = (blk0 + t) / nbw;
        const int gy = bi * vh + row - t * vh;
        const int gxb = (blk0 + t - bi * nbw) * vw;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = col0 + 8 * nt + j;
            if (col >= vw) continue;
            const int gx = gxb + col;
            const float v = gy < out_h && gx < out_w ? acc[0][nt][2 * a + j] : -INFINITY;
            const int i = gy * out_w + gx;
            if (beats(v, i, rb[a], ri[a])) {
              rb[a] = v;
              ri[a] = i;
            }
          }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * mt + 8 * h;
          if (row >= vh || row >= row_end) continue;
          const int gy = gy0 + row;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = col0 + 8 * nt + j;
              if (col >= vw) continue;
              const int gx = gx0 + col;
              take(gy < out_h && gx < out_w ? acc[mt][nt][2 * h + j] : -INFINITY, gy * out_w + gx);
            }
        }
    }
  }

  __device__ void finish(float* scratch) {
    if constexpr (STACKED) {
      // Per stacked row: its kGroups column groups; per block: its vh rows.
      float* sv = scratch;                                        // [64][kGroups]
      int* si = reinterpret_cast<int*>(scratch + 64 * kGroups);  // [64][kGroups]
      __syncthreads();  // every thread is past its last read of the staging area
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        sv[(rrow + 8 * a) * kGroups + rcg] = rb[a];
        si[(rrow + 8 * a) * kGroups + rcg] = ri[a];
      }
      __syncthreads();
      const int tid = threadIdx.x;
      if (tid < 64) {
        float v = sv[tid * kGroups];
        int i = si[tid * kGroups];
        for (int k = 1; k < kGroups; ++k)
          if (beats(sv[tid * kGroups + k], si[tid * kGroups + k], v, i)) {
            v = sv[tid * kGroups + k];
            i = si[tid * kGroups + k];
          }
        sv[tid * kGroups] = v;
        si[tid * kGroups] = i;
      }
      __syncthreads();
      if (tid < count) {
        float v = -INFINITY;
        int i = INT_MAX;
        for (int r = tid * vh; r < (tid + 1) * vh; ++r)
          if (beats(sv[r * kGroups], si[r * kGroups], v, i)) {
            v = sv[r * kGroups];
            i = si[r * kGroups];
          }
        const int bi = (blk0 + tid) / nbw;
        const long long at = base + static_cast<long long>(bi) * nbw + (blk0 + tid - bi * nbw);
        out.vals[at] = v;
        out.idxs[at] = i;
      }
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take(__shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, best_i, off));
      float* wv = scratch;                                 // [kThreads / 32]
      int* wi = reinterpret_cast<int*>(scratch + kThreads / 32);
      __syncthreads();  // every thread is past its last read of the staging area
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        wv[warp] = best;
        wi[warp] = best_i;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < kThreads / 32; ++w) take(wv[w], wi[w]);
        out.vals[slot] = best;
        out.idxs[slot] = best_i;
      }
    }
  }
};

}  // namespace

#define FFTCONV_PEAKS_ENTRY(NAME, TS, SPLITS)                                   \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* g_pad, const float* m_tc, float* vals,       \
                      int* idxs, int b, int nbh, int nbw, int f, int n, int lh, \
                      int wc, int vh, int vw, int out_h, int out_w, int ktile,  \
                      void* stream) {                                           \
    return launch_block_conv<TS, ReducePeaks, SPLITS>(                         \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, RadixOps{},         \
        PeaksOut{vals, idxs}, b, nbh, nbw, f, n, lh, wc, vh,                   \
        vw, out_h, out_w, ktile, stream);                                      \
  }
// A radix body's entry: RadixOps' three pointers after m_tc (block_conv.cuh).
#define FFTCONV_PEAKS_RADIX_ENTRY(NAME, TS, SPLITS, BODY, KARA)                  \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,            \
                      const TS* k_im, const float* gt_re, const float* gt_im,    \
                      const float* g_pad, const float* m_tc, const float* u_pad, \
                      const float* tw, const float* slv, float* vals, int* idxs, \
                      int b, int nbh, int nbw, int f, int n, int lh, int wc,     \
                      int vh, int vw, int out_h, int out_w, int ktile,           \
                      void* stream) {                                            \
    return launch_block_conv<TS, ReducePeaks, SPLITS, BODY, KARA>(               \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc,                       \
        RadixOps{u_pad, tw, slv}, PeaksOut{vals, idxs}, b, nbh, nbw, f, n, lh,   \
        wc, vh, vw, out_h, out_w, ktile, stream);                                \
  }
// A Karatsuba entry (block_conv_peaks_k.cu): the v3 entries' operands.
#define FFTCONV_PEAKS_KARATSUBA_ENTRY(NAME, TS, SPLITS)                         \
  extern "C" int NAME(const TS* d_re, const TS* d_im, const TS* k_re,           \
                      const TS* k_im, const float* gt_re, const float* gt_im,   \
                      const float* g_pad, const float* m_tc, float* vals,       \
                      int* idxs, int b, int nbh, int nbw, int f, int n, int lh, \
                      int wc, int vh, int vw, int out_h, int out_w, int ktile,  \
                      void* stream) {                                           \
    return launch_block_conv<TS, ReducePeaks, SPLITS, kV3, true>(              \
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, RadixOps{},         \
        PeaksOut{vals, idxs}, b, nbh, nbw, f, n, lh, wc, vh,                   \
        vw, out_h, out_w, ktile, stream);                                      \
  }
// The peaks kernel's five dtype-and-tier entries of one radix body, in the
// H stage's 4-product form or (KARA) its Karatsuba form.
#define FFTCONV_PEAKS_RADIX_ENTRIES(SUFFIX, BODY, KARA)                                                   \
  FFTCONV_PEAKS_RADIX_ENTRY(fftconv_block_conv_peaks_f32##SUFFIX, float, 3, BODY, KARA)                   \
  FFTCONV_PEAKS_RADIX_ENTRY(fftconv_block_conv_peaks_bf16##SUFFIX, __nv_bfloat16, 3, BODY, KARA)          \
  FFTCONV_PEAKS_RADIX_ENTRY(fftconv_block_conv_peaks_f32_x6##SUFFIX, float, 6, BODY, KARA)                \
  FFTCONV_PEAKS_RADIX_ENTRY(fftconv_block_conv_peaks_f32_x1##SUFFIX, float, 1, BODY, KARA)                \
  FFTCONV_PEAKS_RADIX_ENTRY(fftconv_block_conv_peaks_bf16_io##SUFFIX, __nv_bfloat16, kBF16IO, BODY, KARA)
