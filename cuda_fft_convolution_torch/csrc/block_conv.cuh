// Fused overlap-save block convolution for Hopper (sm_90a): the transform
// stages shared by the maps kernel (block_conv.cu) and the peaks kernel
// (block_conv_peaks.cu). The two differ only in their epilogue, a template
// argument of the one kernel below, so they cannot drift apart. The spectra
// D and K are fp32 or bf16 (the serving tier, store_dtype='bfloat16'), a
// second template argument: a bf16 load is converted to fp32 in registers,
// and everything after it is fp32 whatever the spectra type.
//
// For each cell (image b, block (i, j), kernel n) the kernel computes
//
//   S    = sum_f K[n, f] * D[b, i, j, f]         complex, (Lh, Wc)
//   X    = G . S                                 G = windowed inverse DFT
//                                                along H, (Vh, Lh) complex
//   tile = Xr . Mr + Xi . Mi                     M = windowed packed inverse
//                                                DFT along W, (Wc, Vw) real
//
// and hands each thread's share of the tile to the epilogue. G and M are the
// JAX package's _inv_full_mats and _inv_packed_mats windows (ops/dft.py),
// handed in as f32 planes; G arrives transposed, (Lh, Vh), so that its
// staging loads coalesce.
//
// bf16 spectra. The JAX kernel's BF16IO mode feeds bf16 operands to
// single-pass MXU dots with f32 accumulation and also rounds S, X, G and M
// to bf16 on the way. Here only the loads of D and K are bf16: S, X, G, M
// and every product stay IEEE fp32, so the result is the fp32 kernel's on
// the bf16-rounded spectra, at least as accurate as BF16IO. What bf16
// changes is the bytes of D and K streamed per cell (half), not the
// arithmetic.
//
// What bounds it. At the 2048^2 x 100 x 64^2 headline plan (blocks 127 x 447,
// valid window 64 x 384, Wc = 224, 192 blocks) one cell is ~37 MFLOP as
// computed here (4-multiply complex products): the H stage (a complex
// (Vh x Lh)(Lh x Wc) product, 40%) and the W stage (a real (Vh x 2Wc)
// (2Wc x Vw) product, 60%); the MAC is <1%. Over 192 x 100 cells that is
// ~0.71 TFLOP against 1.68 GB of output maps and ~67 MB of spectra, so the
// kernel is bound by fp32 arithmetic, not by device-memory bytes.
// Single-pass reduced precision misses the 1e-5 bar, so every product is a
// plain IEEE fp32 FMA on the CUDA cores (a 3xTF32 split on wgmma is a later
// lever).
//
// Design. One CTA owns ROWS window rows of one cell; the rows of the tile
// are independent, so a cell taller than ROWS splits across CTAs by rows
// (row chunks), each recomputing its S columns from D and K (F complex MACs
// per element).
//   1. H stage, in column passes of kCols packed bins: S is computed on the
//      fly in (kUK x kCols) chunks from D and K and staged in shared memory
//      beside the matching (kUK x ROWS) chunk of G^T; each thread keeps a
//      TR x 4 complex register tile of X. Finished passes land in shared
//      memory as X^T (bins x rows) over the full packed width: a cell's
//      whole S (127 x 224 x 8 B = 227 KB) cannot stay resident, X^T for 64
//      rows (128 KB over 256 padded bins) can.
//   2. W stage, in column passes of kCols output columns: M streams from
//      global memory (it is shared by every CTA and stays in L2) through
//      (kKC x kCols) shared-memory chunks; each thread keeps a TR x 4 tile
//      of the output and hands it to the epilogue after each pass.
// Both stages load the next chunk's operands into registers before the
// products of the current chunk, so the loads are in flight during the FMAs
// (one CTA per SM at 64 rows leaves no other CTA to hide them). Two tile
// configurations are built: 64 rows x 8-row thread tiles (measured the
// fastest at the headline on an H100) and, where that X^T would not fit in
// shared memory (Wc > 384), 32 rows x 4-row thread tiles.
// Blocks run in parallel and in no order, unlike the TPU grid that kept the
// kernel index innermost so a data block stayed in VMEM across the bank;
// here the kernel index is the fastest-varying launch index, so the CTAs
// resident at one time share a data block (and the whole bank) in L2.
//
// Short windows (Vh <= 32): block-stacked CTAs. A 64-row CTA holding one
// block of Vh = 16 rows (the DPM plan) leaves 48 rows idle, and its MAC
// waits on 31 dependent channel loads with no other CTA to hide them. So a
// third configuration takes g = min(64 / Vh, 16) blocks of one (image,
// kernel) and stacks their window rows at offsets t * Vh of the 64-row X^T,
// as the JAX kernel's _make_kernel_v3 stacks MBH blocks' H-stage outputs:
//   - H stage: G is shared; row t * Vh + r takes block t's S. S is computed
//     in u-chunks of 16 / g spectrum rows for all g blocks at once (16 rows
//     of (block, u), 16 threads a row). Its channel MAC streams D (g
//     blocks) and K (once for the group) through a ring of steps of up to
//     4 channels (8 at bf16, in the same bytes) in shared memory, filled
//     with 16-byte cp.async: the steps ahead are in flight while one is
//     summed (one CTA per SM has no other CTA to hide a copy's latency
//     behind), and a step's barrier serves all its channels. A row segment is copied as the 16-byte chunks around it
//     (the planes' rows are not 16-byte aligned); the reader adds the row's
//     offset in them, which it tracks from the row's address. Where every
//     row starts on an element pair (even Wc: the DPM plan), a thread reads
//     two columns per load. A thread's 8 tile rows may straddle two (or,
//     for Vh < 8, more) blocks; such a thread sums each block's S with the
//     rows of the others masked.
//   - W stage: unchanged, over the 64 stacked rows, so M streams once for g
//     blocks instead of once per block.
//   - The epilogue maps stacked row R to block R / Vh, window row R % Vh;
//     a last group with fewer than g blocks leaves its rows unwritten.
// Its X^T covers the bins padded to kKC; where that and a ring of 2 steps
// do not fit (Wc > 320 at Vh 16), and for Vh > 32, the two configurations
// above run as before. At the DPM plan (Wc 70, F = 31) it issues ~1.9
// MFLOP per cell for 1.28 useful (the one-block CTA issued 6.3). Launch
// order: tiles of `ktile` kernels, the kernel index fastest inside a tile,
// then the block group (ops/block_conv.py kernel_tile sizes a tile's
// spectra to stay in L2); on the H100 the order did not change the DPM
// time, so the bank stream is not what bounds it.
//
// An epilogue is a class template on STACKED (the block-stacked
// configuration or not) with
//   using Out = ...;                            the kernel's output argument
//   __device__ Epi(Out, const Cell&, const OutGeom&);
//   template <int TR> __device__ void tile(const float (&acc)[TR][4],
//                                          int row0, int col0);
//   __device__ void finish(float* scratch);
// tile() receives a thread's TR x 4 accumulators for rows row0.. and window
// columns col0..: window rows of the cell, or, stacked, rows of the stack
// (row R is window row R % vh of the group's block R / vh); rows may pass
// what exists and columns vw: the epilogue masks them. finish() runs
// once, by every thread, after the last pass, with the staging area free
// for its use (>= 32 x 128 floats, and >= 64 x 32 x 2 floats stacked).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns per pass (packed bins, output columns)
constexpr int kUK = 16;     // spectrum rows per H-stage chunk
constexpr int kKC = 32;     // packed bins per W-stage chunk
constexpr int kMaxSmem = 232448;  // Hopper's per-block shared-memory limit

// The block-stacked configuration (64 rows, 8-row thread tiles).
constexpr int kMaxGroup = 16;   // blocks per CTA at most
constexpr int kStackRows = 16;  // (block, spectrum row) rows of S per u-chunk
constexpr int kMinStages = 2;   // steps of the MAC ring: at least,
constexpr int kMaxStages = 8;   // and at most
constexpr int kMaxSegments = 48;  // row segments of a channel, at most (g = 2)
// Staging before the ring: S (kStackRows x kCols, re and im) and G^T (at
// most 8 spectrum rows x 64 stacked rows, re and im).
constexpr int kStackStage = 2 * kStackRows * kCols + 2 * 8 * 64;

// Thread layout of both stages: 8 row groups x 32 column groups, each
// thread a TR x 4 tile. A warp spans 4 row groups x 8 column groups, so its
// float4 shared loads touch few distinct 16-byte words.
template <int ROWS, int TR>
struct Tile {
  static_assert(ROWS / TR == 8 && TR % 4 == 0, "8 row groups of float4 rows");
  static constexpr int kStageH = 2 * kUK * kCols + 2 * kUK * ROWS;
  static constexpr int kStageW = kKC * kCols;
  static constexpr int kStage = kStageH > kStageW ? kStageH : kStageW;
  static constexpr int kPerS = kUK * kCols / kThreads;  // S elements / thread
  static constexpr int kPerG = (kUK * ROWS + kThreads - 1) / kThreads;
  static constexpr int kPerM = kKC * kCols / kThreads;  // M elements / thread
};
static_assert(kCols == 32 * 4 && kCols % kKC == 0, "column layout");
static_assert(kStackRows * 16 == kThreads, "stacked MAC: 16 threads per S row");
static_assert(kStackStage >= kKC * kCols && kStackStage >= 64 * 32 * 2,
              "the W stage and the stacked finish() reuse the staging area");
static_assert(kStackStage % 4 == 0, "a 16-byte-aligned ring");

// A spectra element as fp32: the identity for fp32, a widening for bf16.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// Two adjacent spectra elements, from an address aligned to the pair.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

inline int padded_bins(int wc) { return (wc + kCols - 1) / kCols * kCols; }

template <int ROWS, int TR>
long long tile_smem_bytes(int wc) {
  return (2LL * padded_bins(wc) * ROWS + Tile<ROWS, TR>::kStage) * sizeof(float);
}

// Blocks a stacked CTA would take at window height vh (1: not stacked).
inline int group_of(int vh) {
  if (vh > 32) return 1;
  return 64 / vh < kMaxGroup ? 64 / vh : kMaxGroup;
}

// Spectrum rows per u-chunk of a g-block stack, and its ring's row segments
// per channel step (re and im of g data blocks and of the kernel).
__host__ __device__ inline int chunk_rows(int g) { return kStackRows / g; }
__host__ __device__ inline int ring_segments(int g) { return 2 * (g + 1) * chunk_rows(g); }

// The packed bins a stacked CTA's X^T holds: those the W stage reads.
inline int stacked_bins(int wc) { return (wc + kKC - 1) / kKC * kKC; }

// Bytes a ring slot gives one row segment of TS elements at packed width
// wc: the 16-byte chunks that can hold min(wc, 128) elements starting
// anywhere in a chunk.
template <class TS>
__host__ __device__ inline int segment_bytes(int wc) {
  constexpr int s = sizeof(TS);
  const int len = wc < kCols ? wc : kCols;
  return 16 * ((s * len + 15 - s) / 16 + 1);
}

// Channels a ring step of TS spectra holds at most: 4 fp32, 8 bf16.
template <class TS>
__host__ __device__ constexpr int max_step_channels() { return 16 / sizeof(TS); }

// A ring of steps of `channels` channels, `bytes` in all.
struct Ring {
  int channels, stages;
  long long bytes;
};

// The ring of TS spectra in `left` bytes: the most channels a step (a
// power of two up to max_channels) that leave room for kMinStages steps,
// and as many steps as fit, at most kMaxStages; {0, 0, 0} where even one
// channel a step does not fit.
template <class TS>
Ring ring_in(long long left, int wc, int g, int max_channels) {
  for (int cps = max_channels; cps >= 1; cps /= 2) {
    const long long step = static_cast<long long>(cps) * ring_segments(g) * segment_bytes<TS>(wc);
    const long long n = left < 0 ? 0 : left / step;
    if (n >= kMinStages) {
      const int stages = static_cast<int>(n < kMaxStages ? n : kMaxStages);
      return Ring{cps, stages, stages * step};
    }
  }
  return Ring{0, 0, 0};
}

// The shared memory a g-block stack takes at packed width wc is sized for
// fp32 spectra with at most 4 channels a step; bf16 spectra fill the same
// ring bytes with up to twice the channels a step.
inline Ring stacked_ring_f32(int wc, int g) {
  return ring_in<float>(kMaxSmem - 4LL * (2 * stacked_bins(wc) * 64 + kStackStage), wc, g,
                        max_step_channels<float>());
}

template <class TS>
Ring stacked_ring(int wc, int g) {
  return ring_in<TS>(stacked_ring_f32(wc, g).bytes, wc, g, max_step_channels<TS>());
}

inline long long stacked_smem_bytes(int wc, int g) {
  return 4LL * (2 * stacked_bins(wc) * 64 + kStackStage) + stacked_ring_f32(wc, g).bytes;
}

// The configuration a geometry runs: g > 1 blocks stacked in 64 rows where
// the window is at most 32 rows and that fits; else 64 rows where its X^T
// fits, else 32.
inline bool wide(int wc) { return tile_smem_bytes<64, 8>(wc) > kMaxSmem; }

inline int blocks_per_cta(int wc, int vh) {
  const int g = group_of(vh);
  return g > 1 && stacked_ring_f32(wc, g).stages >= kMinStages ? g : 1;
}

inline int tile_rows(int wc, int vh) {
  return blocks_per_cta(wc, vh) > 1 || !wide(wc) ? 64 : 32;
}

inline long long smem_bytes(int wc, int vh) {
  const int g = blocks_per_cta(wc, vh);
  if (g > 1) return stacked_smem_bytes(wc, g);
  return wide(wc) ? tile_smem_bytes<32, 4>(wc) : tile_smem_bytes<64, 8>(wc);
}

// The CTA's place: image bb, block (bi, bj), row chunk rc, kernel ni; a
// stacked CTA holds `count` blocks from (bi, bj) on in row-major block
// order (count is 1 otherwise).
struct Cell {
  long long bb;
  int bi, bj, rc, ni, count;
};

// What an epilogue needs of the launch geometry.
struct OutGeom {
  int n, nbh, nbw, row_chunks, vh, vw, out_h, out_w;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n of this thread's copy groups are pending (n < 7).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// One spectrum row u of the stacked H stage: X[a][c] += G[a] S[c] over the
// thread's TR rows; MASKED keeps only the rows in [lo, hi) (the rows of the
// block whose S this is).
template <int TR, bool MASKED>
__device__ __forceinline__ void h_fma(float (&ar)[TR][4], float (&ai)[TR][4],
                                      const float (&gr)[TR], const float (&gi)[TR],
                                      const float* s_r, const float* s_i, int lo, int hi) {
  const float4 sr4 = *reinterpret_cast<const float4*>(s_r);
  const float4 si4 = *reinterpret_cast<const float4*>(s_i);
  const float sr[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
  const float si[4] = {si4.x, si4.y, si4.z, si4.w};
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const bool in = !MASKED || (a >= lo && a < hi);
    const float g_r = in ? gr[a] : 0.f;
    const float g_i = in ? gi[a] : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ar[a][c] = fmaf(g_r, sr[c], ar[a][c]);
      ar[a][c] = fmaf(-g_i, si[c], ar[a][c]);
      ai[a][c] = fmaf(g_r, si[c], ai[a][c]);
      ai[a][c] = fmaf(g_i, sr[c], ai[a][c]);
    }
  }
}

template <class TS, int ROWS, int TR, int MIN_BLOCKS, bool STACKED, class Epi>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) block_conv_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    const float* __restrict__ gt_re, const float* __restrict__ gt_im,
    const float* __restrict__ m_re, const float* __restrict__ m_im,
    typename Epi::Out out, int nbh, int nbw, int f, int n, int lh, int wc,
    int vh, int vw, int out_h, int out_w, int row_chunks, int wc_pad,
    int group, int cps, int stages, int ktile) {
  using T = Tile<ROWS, TR>;
  extern __shared__ __align__(16) float smem[];
  float* xr_t = smem;                   // [wc_pad][ROWS]  X^T, real
  float* xi_t = xr_t + wc_pad * ROWS;   // [wc_pad][ROWS]  X^T, imaginary
  float* stage = xi_t + wc_pad * ROWS;  // staging, reused by both stages
  float* m_s = stage;                   // [kKC][kCols]  M chunk (W stage)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = (warp >> 2) * 4 + (lane >> 3);  // rows rg*TR .. rg*TR+TR-1
  const int cg = (warp & 3) * 8 + (lane & 7);    // cols cg*4 .. cg*4+3

  Cell cell_at;
  int r0 = 0;
  if constexpr (!STACKED) {
  float* s_r = stage;                   // [kUK][kCols]
  float* s_i = s_r + kUK * kCols;       // [kUK][kCols]
  float* g_r = s_i + kUK * kCols;       // [kUK][ROWS]  G^T chunk
  float* g_i = g_r + kUK * ROWS;        // [kUK][ROWS]

  // Kernel index fastest, then the row chunk, then the cell (b, i, j).
  long long bid = blockIdx.x;
  const int ni = static_cast<int>(bid % n);
  bid /= n;
  const int rc = static_cast<int>(bid % row_chunks);
  const long long cell = bid / row_chunks;
  const int bj = static_cast<int>(cell % nbw);
  const int bi = static_cast<int>((cell / nbw) % nbh);
  const long long bb = cell / (static_cast<long long>(nbw) * nbh);
  r0 = rc * ROWS;
  cell_at = Cell{bb, bi, bj, rc, ni, 1};

  const long long plane = static_cast<long long>(lh) * wc;
  const TS* dr_c = d_re + cell * f * plane;
  const TS* di_c = d_im + cell * f * plane;
  const TS* kr_c = k_re + static_cast<long long>(ni) * f * plane;
  const TS* ki_c = k_im + static_cast<long long>(ni) * f * plane;

  // ---- H stage: X[r, v] = sum_u G[r0 + r, u] S[u, v] ----
  for (int c0 = 0; c0 < wc_pad; c0 += kCols) {
    float ar[TR][4], ai[TR][4];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ar[a][c] = ai[a][c] = 0.f;

    // Channel ff of this thread's S elements of the chunk at u0: D and K.
    float dk[T::kPerS][4];
    auto load_dk = [&](int u0, int ff) {
#pragma unroll
      for (int q = 0; q < T::kPerS; ++q) {
        const int e = tid + q * kThreads;
        const int u = u0 + e / kCols;
        const int v = c0 + e % kCols;
        const bool ok = u < lh && v < wc;
        const long long off = ok ? static_cast<long long>(u) * wc + v + ff * plane : 0;
        dk[q][0] = ok ? to_f32(dr_c[off]) : 0.f;
        dk[q][1] = ok ? to_f32(di_c[off]) : 0.f;
        dk[q][2] = ok ? to_f32(kr_c[off]) : 0.f;
        dk[q][3] = ok ? to_f32(ki_c[off]) : 0.f;
      }
    };
    load_dk(0, 0);
    for (int u0 = 0; u0 < lh; u0 += kUK) {
      float gv[T::kPerG][2];
#pragma unroll
      for (int q = 0; q < T::kPerG; ++q) {
        const int e = tid + q * kThreads;
        const int u = u0 + e / ROWS;
        const int row = r0 + e % ROWS;
        const bool ok = e < kUK * ROWS && u < lh && row < vh;
        const long long off = ok ? static_cast<long long>(u) * vh + row : 0;
        gv[q][0] = ok ? gt_re[off] : 0.f;
        gv[q][1] = ok ? gt_im[off] : 0.f;
      }
      // S = sum_f K D: channel 0 was prefetched, the rest load here.
      float sv[T::kPerS][2];
#pragma unroll
      for (int q = 0; q < T::kPerS; ++q) {
        sv[q][0] = fmaf(dk[q][2], dk[q][0], -dk[q][3] * dk[q][1]);
        sv[q][1] = fmaf(dk[q][2], dk[q][1], dk[q][3] * dk[q][0]);
      }
      for (int ff = 1; ff < f; ++ff) {
        load_dk(u0, ff);
#pragma unroll
        for (int q = 0; q < T::kPerS; ++q) {
          sv[q][0] = fmaf(dk[q][2], dk[q][0], fmaf(-dk[q][3], dk[q][1], sv[q][0]));
          sv[q][1] = fmaf(dk[q][2], dk[q][1], fmaf(dk[q][3], dk[q][0], sv[q][1]));
        }
      }
      __syncthreads();  // the previous chunk's products are done with staging
#pragma unroll
      for (int q = 0; q < T::kPerS; ++q) {
        s_r[tid + q * kThreads] = sv[q][0];
        s_i[tid + q * kThreads] = sv[q][1];
      }
#pragma unroll
      for (int q = 0; q < T::kPerG; ++q) {
        const int e = tid + q * kThreads;
        if (e < kUK * ROWS) {
          g_r[e] = gv[q][0];
          g_i[e] = gv[q][1];
        }
      }
      __syncthreads();
      if (u0 + kUK < lh) load_dk(u0 + kUK, 0);  // in flight during the FMAs
#pragma unroll 4
      for (int uu = 0; uu < kUK; ++uu) {
        float gr[TR], gi[TR];
#pragma unroll
        for (int q = 0; q < TR / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(g_r + uu * ROWS + rg * TR + 4 * q);
          const float4 b = *reinterpret_cast<const float4*>(g_i + uu * ROWS + rg * TR + 4 * q);
          gr[4 * q] = a.x; gr[4 * q + 1] = a.y; gr[4 * q + 2] = a.z; gr[4 * q + 3] = a.w;
          gi[4 * q] = b.x; gi[4 * q + 1] = b.y; gi[4 * q + 2] = b.z; gi[4 * q + 3] = b.w;
        }
        const float4 sr4 = *reinterpret_cast<const float4*>(s_r + uu * kCols + cg * 4);
        const float4 si4 = *reinterpret_cast<const float4*>(s_i + uu * kCols + cg * 4);
        const float sr[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
        const float si[4] = {si4.x, si4.y, si4.z, si4.w};
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ar[a][c] = fmaf(gr[a], sr[c], ar[a][c]);
            ar[a][c] = fmaf(-gi[a], si[c], ar[a][c]);
            ai[a][c] = fmaf(gr[a], si[c], ai[a][c]);
            ai[a][c] = fmaf(gi[a], sr[c], ai[a][c]);
          }
      }
    }
    // Bins past wc hold zeros (S was zero there), which pads X^T for the
    // W stage's chunking.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = c0 + cg * 4 + c;
#pragma unroll
      for (int q = 0; q < TR / 4; ++q) {
        *reinterpret_cast<float4*>(xr_t + v * ROWS + rg * TR + 4 * q) = make_float4(
            ar[4 * q][c], ar[4 * q + 1][c], ar[4 * q + 2][c], ar[4 * q + 3][c]);
        *reinterpret_cast<float4*>(xi_t + v * ROWS + rg * TR + 4 * q) = make_float4(
            ai[4 * q][c], ai[4 * q + 1][c], ai[4 * q + 2][c], ai[4 * q + 3][c]);
      }
    }
  }
  } else {
  static_assert(ROWS == 64 && TR == 8, "the stacked configuration is 64 x 8");
  // ---- stacked H stage: `group` blocks of one (image, kernel) ----
  float* s_r = stage;                      // [kStackRows][kCols]  S, (block, u) rows
  float* s_i = s_r + kStackRows * kCols;
  float* g_r = s_i + kStackRows * kCols;   // [kug][64]  G^T chunk, stacked rows
  float* g_i = g_r + 8 * 64;
  char* ring = reinterpret_cast<char*>(stage + kStackStage);  // [stages][cps][nseg][seg_bytes]

  const int g = group;
  const int kug = chunk_rows(g);
  const int nblk = nbh * nbw;
  const int groups = (nblk + g - 1) / g;
  // Launch order: tiles of `ktile` kernels; in a tile the kernel index runs
  // fastest, then the block group, so the CTAs resident at one time share a
  // few groups' data and the tile's kernel spectra, which stay in L2 while
  // every group passes them. Tiles, then images, run outermost; the last
  // tile's CTAs past n return at once.
  const int ntiles = (n + ktile - 1) / ktile;
  const long long per_tile = static_cast<long long>(groups) * ktile;
  const int inner = static_cast<int>(blockIdx.x % per_tile);
  const long long outer = blockIdx.x / per_tile;
  const int ni = static_cast<int>(outer % ntiles) * ktile + inner % ktile;
  const int grp = inner / ktile;
  const long long bb = outer / ntiles;
  if (ni >= n) return;
  const int blk0 = grp * g;
  const int count = nblk - blk0 < g ? nblk - blk0 : g;
  cell_at = Cell{bb, blk0 / nbw, blk0 % nbw, 0, ni, count};

  const long long plane = static_cast<long long>(lh) * wc;
  const long long cell0 = bb * nblk + blk0;
  const TS* dr_g = d_re + cell0 * f * plane;
  const TS* di_g = d_im + cell0 * f * plane;
  const TS* kr_c = k_re + static_cast<long long>(ni) * f * plane;
  const TS* ki_c = k_im + static_cast<long long>(ni) * f * plane;

  // The address of row u, columns c0.., of plane pl at channel ff: planes
  // 2t, 2t + 1 are block t's D (re, im), 2g, 2g + 1 the kernel's K.
  auto row_ptr = [&](int pl, int u, int ff, int c0) -> const TS* {
    const long long off = static_cast<long long>(ff) * plane + static_cast<long long>(u) * wc + c0;
    if (pl < 2 * g) {
      const TS* base = (pl & 1) ? di_g : dr_g;
      return base + static_cast<long long>(pl >> 1) * f * plane + off;
    }
    return (pl == 2 * g ? kr_c : ki_c) + off;
  };
  // A ring step holds channels ff, ff + 1 of a u-chunk in a column pass:
  // for each (channel j, segment = (plane, row uu)), the 16-byte chunks
  // that hold the row. This thread's copy items are fixed, for every
  // channel of a step: (segment, chunk, uu) packed, -1 for none, and the
  // segment's row address at (ff, u0, c0) = 0.
  const int nseg = ring_segments(g);
  const int seg_bytes = segment_bytes<TS>(wc);
  const int step_bytes = cps * nseg * seg_bytes;
  const int len0 = wc < kCols ? wc : kCols;
  const int nch_max = (len0 * static_cast<int>(sizeof(TS)) + 15) / 16 + 1;
  constexpr int kMaxCh = kCols * static_cast<int>(sizeof(TS)) / 16 + 1;
  constexpr int kMaxItems = (kMaxSegments * kMaxCh + kThreads - 1) / kThreads;
  int items[kMaxItems];
  unsigned long long item_rows[kMaxItems];
#pragma unroll
  for (int q = 0; q < kMaxItems; ++q) {
    const int it = tid + q * kThreads;
    const int seg = it / nch_max;
    const int pl = seg / kug;
    const bool on = it < nseg * nch_max && (pl >= 2 * g || (pl >> 1) < count);
    items[q] = on ? seg << 9 | (it % nch_max) << 3 | seg % kug : -1;
    item_rows[q] = on ? reinterpret_cast<unsigned long long>(row_ptr(pl, seg % kug, 0, 0)) : 0;
  }

  // The issue cursor: the next step to copy, and its ring slot.
  int is_c0 = 0, is_u0 = 0, is_ff = 0, is_slot = 0;
  bool is_more = true;
  auto issue = [&]() {
    if (is_more) {
      const int len_bytes = (wc - is_c0 < kCols ? wc - is_c0 : kCols) * static_cast<int>(sizeof(TS));
      const unsigned long long off0 = static_cast<unsigned long long>(
          (static_cast<long long>(is_ff) * plane + static_cast<long long>(is_u0) * wc + is_c0) *
          static_cast<long long>(sizeof(TS)));
      const unsigned long long plane_b = static_cast<unsigned long long>(plane) * sizeof(TS);
      char* slot = ring + is_slot * step_bytes;
      const int nch_step = f - is_ff < cps ? f - is_ff : cps;
#pragma unroll
      for (int q = 0; q < kMaxItems; ++q) {
        const int at = items[q];
        if (at < 0 || is_u0 + (at & 7) >= lh) continue;
        const int k = (at >> 3) & 63;
        char* dst = slot + (at >> 9) * seg_bytes + 16 * k;
        unsigned long long a = item_rows[q] + off0;
        for (int j = 0; j < nch_step; ++j, a += plane_b, dst += nseg * seg_bytes) {
          const unsigned long long a0 = a & ~15ull;
          if (k < static_cast<int>(((a + len_bytes - 1) >> 4) - (a0 >> 4)) + 1)
            cp_async16(dst, reinterpret_cast<const char*>(a0) + 16 * k);
        }
      }
      // advance: channels, then u-chunks, then column passes
      if ((is_ff += cps) >= f) {
        is_ff = 0;
        if ((is_u0 += kug) >= lh) {
          is_u0 = 0;
          is_c0 += kCols;
          is_more = is_c0 < wc_pad;
        }
      }
      if (++is_slot == stages) is_slot = 0;
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };

  // This thread's S row: (block mt, spectrum row u0 + mu), columns
  // c0 + ml + 16 i; or, where every row of the planes starts on a pair of
  // elements (even wc, pair-aligned planes: the DPM plan), the pairs at
  // c0 + 2 ml + 32 i, loaded as one.
  const bool pairs =
      wc % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(dr_g) | reinterpret_cast<uintptr_t>(di_g) |
        reinterpret_cast<uintptr_t>(kr_c) | reinterpret_cast<uintptr_t>(ki_c)) %
       (2 * sizeof(TS))) == 0;
  const int mrow = tid >> 4;
  const int ml = tid & 15;
  const int mt = mrow / kug;
  const int mu = mrow % kug;
  const bool mrow_on = mrow < g * kug && mt < count;
  const int seg_dr = 2 * mt * kug + mu;
  const int seg_kr = 2 * g * kug + mu;

  // Rows of this thread's H-stage tile, and the blocks they belong to.
  const int hr0 = rg * TR;
  const int t_lo = hr0 / vh < g - 1 ? hr0 / vh : g - 1;
  const int t_hi = (hr0 + TR - 1) / vh < g - 1 ? (hr0 + TR - 1) / vh : g - 1;

  for (int s = 0; s < stages - 1; ++s) issue();
  int slot_at = 0;  // the ring slot of the step being summed
  for (int c0 = 0; c0 < wc_pad; c0 += kCols) {
    float ar[TR][4], ai[TR][4];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ar[a][c] = ai[a][c] = 0.f;
    const int len = wc - c0 < kCols ? wc - c0 : kCols;

    for (int u0 = 0; u0 < lh; u0 += kug) {
      // G^T for the stacked rows of this chunk, loaded ahead of the MAC.
      constexpr int kPerGs = 8 * 64 / kThreads;
      float gv[kPerGs][2];
#pragma unroll
      for (int q = 0; q < kPerGs; ++q) {
        const int e = tid + q * kThreads;
        const int u = u0 + e / 64;
        const int row = e % 64;
        const int t = row / vh;
        const bool ok = e < kug * 64 && u < lh && t < g;
        const long long off = ok ? static_cast<long long>(u) * vh + (row - t * vh) : 0;
        gv[q][0] = ok ? gt_re[off] : 0.f;
        gv[q][1] = ok ? gt_im[off] : 0.f;
      }
      // S = sum_f K D for this thread's row, two channels a step from the
      // ring. The low bits of the row addresses give each row's offset in
      // its staged span; they advance by a plane per channel.
      const bool on = mrow_on && u0 + mu < lh;
      unsigned lo_dr = 0, lo_di = 0, lo_kr = 0, lo_ki = 0;
      if (on) {
        lo_dr = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row_ptr(2 * mt, u0 + mu, 0, c0)));
        lo_di = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row_ptr(2 * mt + 1, u0 + mu, 0, c0)));
        lo_kr = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row_ptr(2 * g, u0 + mu, 0, c0)));
        lo_ki = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row_ptr(2 * g + 1, u0 + mu, 0, c0)));
      }
      const unsigned plane_bytes = static_cast<unsigned>(plane * static_cast<long long>(sizeof(TS)));
      float sv[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) sv[i][0] = sv[i][1] = 0.f;
      for (int ff = 0; ff < f; ff += cps) {
        cp_async_wait_at_most(stages - 2);
        __syncthreads();  // this step landed; the previous step's slot is free
        issue();
        if (on) {
          const char* slot = ring + slot_at * step_bytes;
#pragma unroll
          for (int j = 0; j < max_step_channels<TS>(); ++j) {
            if (j < cps && ff + j < f) {
              const char* cs = slot + j * nseg * seg_bytes;
              const unsigned dj = j * plane_bytes;
              const TS* pdr = reinterpret_cast<const TS*>(cs + seg_dr * seg_bytes + ((lo_dr + dj) & 15));
              const TS* pdi = reinterpret_cast<const TS*>(cs + (seg_dr + kug) * seg_bytes + ((lo_di + dj) & 15));
              const TS* pkr = reinterpret_cast<const TS*>(cs + seg_kr * seg_bytes + ((lo_kr + dj) & 15));
              const TS* pki = reinterpret_cast<const TS*>(cs + (seg_kr + kug) * seg_bytes + ((lo_ki + dj) & 15));
              if (pairs) {  // columns 2 ml + 32 i and the next: one load each
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  if (32 * i >= len) break;  // the same for every thread
                  const int v = 2 * ml + 32 * i;
                  if (v < len) {
                    const float2 dre = load2(pdr + v), dim = load2(pdi + v);
                    const float2 kre = load2(pkr + v), kim = load2(pki + v);
                    sv[2 * i][0] = fmaf(kre.x, dre.x, fmaf(-kim.x, dim.x, sv[2 * i][0]));
                    sv[2 * i][1] = fmaf(kre.x, dim.x, fmaf(kim.x, dre.x, sv[2 * i][1]));
                    sv[2 * i + 1][0] = fmaf(kre.y, dre.y, fmaf(-kim.y, dim.y, sv[2 * i + 1][0]));
                    sv[2 * i + 1][1] = fmaf(kre.y, dim.y, fmaf(kim.y, dre.y, sv[2 * i + 1][1]));
                  }
                }
              } else {  // column ml + 16 i
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  if (16 * i >= len) break;  // the same for every thread
                  const int v = ml + 16 * i;
                  if (v < len) {
                    const float dre = to_f32(pdr[v]), dim = to_f32(pdi[v]);
                    const float kre = to_f32(pkr[v]), kim = to_f32(pki[v]);
                    sv[i][0] = fmaf(kre, dre, fmaf(-kim, dim, sv[i][0]));
                    sv[i][1] = fmaf(kre, dim, fmaf(kim, dre, sv[i][1]));
                  }
                }
              }
            }
          }
          lo_dr += cps * plane_bytes;
          lo_di += cps * plane_bytes;
          lo_kr += cps * plane_bytes;
          lo_ki += cps * plane_bytes;
        }
        if (++slot_at == stages) slot_at = 0;
      }
      // The last step's sync ordered the previous chunk's products before
      // these stores.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = pairs ? 2 * ml + 32 * (i >> 1) + (i & 1) : ml + 16 * i;
        s_r[mrow * kCols + v] = sv[i][0];
        s_i[mrow * kCols + v] = sv[i][1];
      }
#pragma unroll
      for (int q = 0; q < kPerGs; ++q) {
        const int e = tid + q * kThreads;
        g_r[e] = gv[q][0];
        g_i[e] = gv[q][1];
      }
      __syncthreads();
#pragma unroll 2
      for (int uu = 0; uu < kug; ++uu) {
        float gr[TR], gi[TR];
#pragma unroll
        for (int q = 0; q < TR / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(g_r + uu * 64 + hr0 + 4 * q);
          const float4 b = *reinterpret_cast<const float4*>(g_i + uu * 64 + hr0 + 4 * q);
          gr[4 * q] = a.x; gr[4 * q + 1] = a.y; gr[4 * q + 2] = a.z; gr[4 * q + 3] = a.w;
          gi[4 * q] = b.x; gi[4 * q + 1] = b.y; gi[4 * q + 2] = b.z; gi[4 * q + 3] = b.w;
        }
        if (t_lo == t_hi) {
          const int o = (t_lo * kug + uu) * kCols + cg * 4;
          h_fma<TR, false>(ar, ai, gr, gi, s_r + o, s_i + o, 0, TR);
        } else {
          for (int tb = t_lo; tb <= t_hi; ++tb) {
            const int o = (tb * kug + uu) * kCols + cg * 4;
            h_fma<TR, true>(ar, ai, gr, gi, s_r + o, s_i + o, tb * vh - hr0, (tb + 1) * vh - hr0);
          }
        }
      }
    }
    // X^T over the bins the W stage reads (wc_pad, wc padded to kKC here);
    // bins past wc hold zeros (S was zero there).
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = c0 + cg * 4 + c;
      if (v < wc_pad) {
#pragma unroll
        for (int q = 0; q < TR / 4; ++q) {
          *reinterpret_cast<float4*>(xr_t + v * ROWS + hr0 + 4 * q) = make_float4(
              ar[4 * q][c], ar[4 * q + 1][c], ar[4 * q + 2][c], ar[4 * q + 3][c]);
          *reinterpret_cast<float4*>(xi_t + v * ROWS + hr0 + 4 * q) = make_float4(
              ai[4 * q][c], ai[4 * q + 1][c], ai[4 * q + 2][c], ai[4 * q + 3][c]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight into the staging the W stage reuses
  }

  // ---- W stage: tile[r, c] = sum_v Xr[r, v] Mr[v, c] + Xi[r, v] Mi[v, c] ----
  // Chunk t covers bins [v0, v0 + kKC) of plane t / nchunk (0 = re, 1 = im).
  const int nchunk = (wc + kKC - 1) / kKC;
  Epi epi(out, cell_at, OutGeom{n, nbh, nbw, row_chunks, vh, vw, out_h, out_w});
  for (int c0 = 0; c0 < vw; c0 += kCols) {
    float acc[TR][4];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

    float mv[T::kPerM];
    auto load_m = [&](int t) {
      const float* mp = t < nchunk ? m_re : m_im;
      const int v0 = (t % nchunk) * kKC;
#pragma unroll
      for (int q = 0; q < T::kPerM; ++q) {
        const int e = tid + q * kThreads;
        const int v = v0 + e / kCols;
        const int col = c0 + e % kCols;
        mv[q] = (v < wc && col < vw) ? mp[static_cast<long long>(v) * vw + col] : 0.f;
      }
    };
    load_m(0);
    for (int t = 0; t < 2 * nchunk; ++t) {
      const float* xp = t < nchunk ? xr_t : xi_t;
      const int v0 = (t % nchunk) * kKC;
      // The first sync also orders the X^T writes above before the reads.
      __syncthreads();
#pragma unroll
      for (int q = 0; q < T::kPerM; ++q) m_s[tid + q * kThreads] = mv[q];
      __syncthreads();
      if (t + 1 < 2 * nchunk) load_m(t + 1);  // in flight during the FMAs
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        float x[TR];
#pragma unroll
        for (int q = 0; q < TR / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(xp + (v0 + kk) * ROWS + rg * TR + 4 * q);
          x[4 * q] = a.x; x[4 * q + 1] = a.y; x[4 * q + 2] = a.z; x[4 * q + 3] = a.w;
        }
        const float4 m4 = *reinterpret_cast<const float4*>(m_s + kk * kCols + cg * 4);
        const float m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], m[c], acc[a][c]);
      }
    }
    epi.tile(acc, r0 + rg * TR, c0 + cg * 4);
  }
  epi.finish(stage);
}

template <class TS, int ROWS, int TR, int MIN_BLOCKS, bool STACKED, class Epi>
int launch(const TS* d_re, const TS* d_im, const TS* k_re,
           const TS* k_im, const float* gt_re, const float* gt_im,
           const float* m_re, const float* m_im, typename Epi::Out out, int b,
           int nbh, int nbw, int f, int n, int lh, int wc, int vh, int vw,
           int out_h, int out_w, int ktile, cudaStream_t stream) {
  const int group = STACKED ? blocks_per_cta(wc, vh) : 1;
  const long long smem = STACKED ? stacked_smem_bytes(wc, group) : tile_smem_bytes<ROWS, TR>(wc);
  const int row_chunks = STACKED ? 1 : (vh + ROWS - 1) / ROWS;
  const Ring ring = STACKED ? stacked_ring<TS>(wc, group) : Ring{0, 0, 0};
  // stacked: b images x tiles of ktile kernels x block groups
  const long long grid =
      STACKED ? static_cast<long long>(b) * ((n + ktile - 1) / ktile) * ktile *
                    ((static_cast<long long>(nbh) * nbw + group - 1) / group)
              : static_cast<long long>(b) * nbh * nbw * row_chunks * n;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = block_conv_kernel<TS, ROWS, TR, MIN_BLOCKS, STACKED, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), stream>>>(
      d_re, d_im, k_re, k_im, gt_re, gt_im, m_re, m_im, out, nbh, nbw, f, n,
      lh, wc, vh, vw, out_h, out_w, row_chunks, STACKED ? stacked_bins(wc) : padded_bins(wc),
      group, ring.channels, ring.stages, ktile);
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry and launches the configuration for (wc, vh) on
// `stream`; does not synchronise. `ktile` (1..n), the kernels a launch
// tile of the stacked configuration holds, is its launch order (n: the
// kernel index fastest); the others run the kernel index fastest. Epi is the epilogue class template.
// Returns cudaGetLastError() after the launch (0 = launched), or the error
// that stopped it.
template <class TS, template <bool> class Epi>
int launch_block_conv(const TS* d_re, const TS* d_im, const TS* k_re,
                      const TS* k_im, const float* gt_re, const float* gt_im,
                      const float* m_re, const float* m_im,
                      typename Epi<false>::Out out, int b, int nbh, int nbw,
                      int f, int n, int lh, int wc, int vh, int vw, int out_h,
                      int out_w, int ktile, void* stream) {
  if (b <= 0 || nbh <= 0 || nbw <= 0 || f <= 0 || n <= 0 || lh <= 0 ||
      wc <= 0 || vh <= 0 || vw <= 0 || out_h <= 0 || out_w <= 0 ||
      ktile < 1 || ktile > n || smem_bytes(wc, vh) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks_per_cta(wc, vh) > 1)
    return launch<TS, 64, 8, 1, true, Epi<true>>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                 m_re, m_im, out, b, nbh, nbw, f, n, lh,
                                                 wc, vh, vw, out_h, out_w, ktile, s);
  if (wide(wc))
    return launch<TS, 32, 4, 2, false, Epi<false>>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                   m_re, m_im, out, b, nbh, nbw, f, n, lh,
                                                   wc, vh, vw, out_h, out_w, ktile, s);
  return launch<TS, 64, 8, 1, false, Epi<false>>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                 m_re, m_im, out, b, nbh, nbw, f, n, lh,
                                                 wc, vh, vw, out_h, out_w, ktile, s);
}

}  // namespace
