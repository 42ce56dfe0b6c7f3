// Fused overlap-save block convolution for Hopper (sm_90a): the peaks
// kernel, on fp32 or bf16 spectra (block_conv.cuh).
//
// Replaces cuda_fft_convolution_tpu/ops/block_conv.py::block_conv_peaks_pallas
// (its v3 body _make_kernel_v3_peaks and epilogue _peaks_reducer), at fp32
// spectra (at the maps kernel's three synthesis tiers) and at bf16 spectra
// (BF16IO, and the explicit 3xTF32); the values are fp32 and the indices
// int32 either way. It writes one pair per block (mbh = mbw = 1); cells of
// several blocks are reduced from those pairs by the wrapper
// (ops/block_conv.py group_cells), in _peaks_reducer's order. It runs the transforms of block_conv.cuh
// and, in place of the maps kernel's store, reduces each cell's valid
// window to (max, global flat index y * out_w + x): the larger value wins,
// between equal values the smaller index wins, and positions past
// (out_h, out_w) count as -inf. A cell with no position inside the output
// reports -inf at its first (out-of-range) position, as _peaks_reducer does.
//
// What bounds it: the maps kernel's arithmetic (~0.71 TFLOP at the headline
// plan, as 3, 6 or 1 TF32 passes on the tensor cores), without its 1.68 GB
// write of the maps;
// it writes 8 bytes per CTA. Design: each thread keeps a running (max,
// index) over its W-stage accumulators (block_conv.cuh's mma fragments)
// across the column passes; at the end the CTA reduces them with warp
// shuffles and one shared-memory round. A cell taller than the CTA's ROWS
// is split across CTAs by row chunk, and each writes one pair: the output
// is the partial pyramid (B, N, nbh, row_chunks, nbw), which the wrapper
// (ops/block_conv.py block_conv_peaks) reduces over row chunks with the
// same rule. A stacked CTA (short windows, block_conv.cuh) holds up to 4
// blocks and 2 kernels, and runs the W stage and this epilogue once a
// kernel; a thread's fragments may straddle the blocks' rows: each thread
// keeps a (max, index) per fragment row, and finish() reduces them per
// stacked row over its 8 column groups, then per block over its vh rows, in
// shared memory, and writes one pair per block (row_chunks = 1).

#include "block_conv_peaks.cuh"

// Write the partial pyramid vals/idxs (B, N, nbh, row_chunks, nbw), with
// row_chunks = 1 where fftconv_block_conv_f32_blocks(wc, vh, splits) > 1
// (stacked blocks) and ceil(vh / fftconv_block_conv_f32_rows(wc, vh,
// splits)) otherwise, from fp32 (_f32) or bf16 (_bf16) spectra at 3xTF32;
// fp32 spectra also at 6xTF32 (_f32_x6) and one TF32 pass (_f32_x1), bf16
// spectra at kBF16IO (_bf16_io) (the maps kernel's tiers, block_conv.cu); `ktile` as for the maps kernel. Launch
// on `stream`; do not synchronise. Return cudaGetLastError() after the
// launch (0 = launched), or the error that stopped it. The radix bodies'
// entries (_r4, _r5, _r5x) are in block_conv_r4.cu, block_conv_r5.cu and
// block_conv_r5x.cu.
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_f32, float, 3)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_bf16, __nv_bfloat16, 3)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_f32_x6, float, 6)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_f32_x1, float, 1)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_bf16_io, __nv_bfloat16, kBF16IO)
