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
// An epilogue is a class with
//   using Out = ...;                            the kernel's output argument
//   __device__ Epi(Out, const Cell&, const OutGeom&);
//   template <int TR> __device__ void tile(const float (&acc)[TR][4],
//                                          int row0, int col0);
//   __device__ void finish(float* scratch);
// tile() receives a thread's TR x 4 accumulators for window rows row0.. and
// window columns col0.. of the cell (rows may pass vh and columns vw: the
// epilogue masks them); finish() runs once, by every thread, after the last
// pass, with the staging area free for its use (>= 32 x 128 floats).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns per pass (packed bins, output columns)
constexpr int kUK = 16;     // spectrum rows per H-stage chunk
constexpr int kKC = 32;     // packed bins per W-stage chunk
constexpr int kMaxSmem = 232448;  // Hopper's per-block shared-memory limit

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

// A spectra element as fp32: the identity for fp32, a widening for bf16.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

inline int padded_bins(int wc) { return (wc + kCols - 1) / kCols * kCols; }

template <int ROWS, int TR>
long long tile_smem_bytes(int wc) {
  return (2LL * padded_bins(wc) * ROWS + Tile<ROWS, TR>::kStage) * sizeof(float);
}

// The configuration a width runs: 64 rows where its X^T fits, else 32.
inline bool wide(int wc) { return tile_smem_bytes<64, 8>(wc) > kMaxSmem; }

inline int tile_rows(int wc) { return wide(wc) ? 32 : 64; }

inline long long smem_bytes(int wc) {
  return wide(wc) ? tile_smem_bytes<32, 4>(wc) : tile_smem_bytes<64, 8>(wc);
}

// The CTA's place: image bb, block (bi, bj), row chunk rc, kernel ni.
struct Cell {
  long long bb;
  int bi, bj, rc, ni;
};

// What an epilogue needs of the launch geometry.
struct OutGeom {
  int n, nbh, nbw, row_chunks, vh, vw, out_h, out_w;
};

template <class TS, int ROWS, int TR, int MIN_BLOCKS, class Epi>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) block_conv_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    const float* __restrict__ gt_re, const float* __restrict__ gt_im,
    const float* __restrict__ m_re, const float* __restrict__ m_im,
    typename Epi::Out out, int nbh, int nbw, int f, int n, int lh, int wc,
    int vh, int vw, int out_h, int out_w, int row_chunks, int wc_pad) {
  using T = Tile<ROWS, TR>;
  extern __shared__ __align__(16) float smem[];
  float* xr_t = smem;                   // [wc_pad][ROWS]  X^T, real
  float* xi_t = xr_t + wc_pad * ROWS;   // [wc_pad][ROWS]  X^T, imaginary
  float* stage = xi_t + wc_pad * ROWS;  // staging, reused by both stages
  float* s_r = stage;                   // [kUK][kCols]
  float* s_i = s_r + kUK * kCols;       // [kUK][kCols]
  float* g_r = s_i + kUK * kCols;       // [kUK][ROWS]  G^T chunk
  float* g_i = g_r + kUK * ROWS;        // [kUK][ROWS]
  float* m_s = stage;                   // [kKC][kCols]  M chunk (W stage)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = (warp >> 2) * 4 + (lane >> 3);  // rows rg*TR .. rg*TR+TR-1
  const int cg = (warp & 3) * 8 + (lane & 7);    // cols cg*4 .. cg*4+3

  // Kernel index fastest, then the row chunk, then the cell (b, i, j).
  long long bid = blockIdx.x;
  const int ni = static_cast<int>(bid % n);
  bid /= n;
  const int rc = static_cast<int>(bid % row_chunks);
  const long long cell = bid / row_chunks;
  const int bj = static_cast<int>(cell % nbw);
  const int bi = static_cast<int>((cell / nbw) % nbh);
  const long long bb = cell / (static_cast<long long>(nbw) * nbh);
  const int r0 = rc * ROWS;

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

  // ---- W stage: tile[r, c] = sum_v Xr[r, v] Mr[v, c] + Xi[r, v] Mi[v, c] ----
  // Chunk t covers bins [v0, v0 + kKC) of plane t / nchunk (0 = re, 1 = im).
  const int nchunk = (wc + kKC - 1) / kKC;
  Epi epi(out, Cell{bb, bi, bj, rc, ni},
          OutGeom{n, nbh, nbw, row_chunks, vh, vw, out_h, out_w});
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

template <class TS, int ROWS, int TR, int MIN_BLOCKS, class Epi>
int launch(const TS* d_re, const TS* d_im, const TS* k_re,
           const TS* k_im, const float* gt_re, const float* gt_im,
           const float* m_re, const float* m_im, typename Epi::Out out, int b,
           int nbh, int nbw, int f, int n, int lh, int wc, int vh, int vw,
           int out_h, int out_w, cudaStream_t stream) {
  const long long smem = tile_smem_bytes<ROWS, TR>(wc);
  const int row_chunks = (vh + ROWS - 1) / ROWS;
  const long long grid = static_cast<long long>(b) * nbh * nbw * row_chunks * n;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = block_conv_kernel<TS, ROWS, TR, MIN_BLOCKS, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), stream>>>(
      d_re, d_im, k_re, k_im, gt_re, gt_im, m_re, m_im, out, nbh, nbw, f, n,
      lh, wc, vh, vw, out_h, out_w, row_chunks, padded_bins(wc));
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry and launches the configuration for its width on
// `stream`; does not synchronise. Returns cudaGetLastError() after the
// launch (0 = launched), or the error that stopped it.
template <class TS, class Epi>
int launch_block_conv(const TS* d_re, const TS* d_im, const TS* k_re,
                      const TS* k_im, const float* gt_re, const float* gt_im,
                      const float* m_re, const float* m_im, typename Epi::Out out,
                      int b, int nbh, int nbw, int f, int n, int lh, int wc,
                      int vh, int vw, int out_h, int out_w, void* stream) {
  if (b <= 0 || nbh <= 0 || nbw <= 0 || f <= 0 || n <= 0 || lh <= 0 ||
      wc <= 0 || vh <= 0 || vw <= 0 || out_h <= 0 || out_w <= 0 ||
      smem_bytes(wc) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(wc))
    return launch<TS, 32, 4, 2, Epi>(d_re, d_im, k_re, k_im, gt_re, gt_im, m_re,
                                 m_im, out, b, nbh, nbw, f, n, lh, wc, vh, vw,
                                 out_h, out_w, s);
  return launch<TS, 64, 8, 1, Epi>(d_re, d_im, k_re, k_im, gt_re, gt_im, m_re,
                               m_im, out, b, nbh, nbw, f, n, lh, wc, vh, vw,
                               out_h, out_w, s);
}

}  // namespace
