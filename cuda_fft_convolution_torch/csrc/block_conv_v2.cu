// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's v2 body, _make_kernel (cuda_fft_convolution_tpu/ops/block_conv.py
// :269-308), which block_conv_pallas runs under wstack=False: a CTA takes
// MBH blocks of one block column (v2_blocks) and ROWS window rows of each
// (v2_rows), runs one column-stacked H stage, X = G [S_1 | ... | S_MBH]
// (the blocks' bins side by side, in column passes), keeps the blocks' X
// side by side, then runs the W stage once a block over its own rows — M
// streams once a block, and every W product has that block's rows only,
// the cost the JAX docstring names (:30-32). The H stage is the 4-product
// form (JAX's v2 default, karatsuba=False); block_conv_v2_k.cu has the
// Karatsuba form. The entries take the v3 entries' operands (block_conv.cu;
// M^T's planes for v2_rows' configuration) in every dtype mode and
// synthesis tier of those, with the suffix _v2.

#include "block_conv_maps.cuh"

// The v2 configuration at packed width wc, window height vh, tier `splits`
// (-1 for a tier outside 0, 1, 3, 6) and H-stage form `kara` (0, 1): its
// shared memory, rows and blocks a CTA (before the cut to the grid's nbh);
// ops/block_conv.py v2_smem_bytes, v2_rows and v2_blocks mirror them.
extern "C" long long fftconv_block_conv_v2_smem_bytes(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? v2_smem_bytes(wc, vh, splits, kara != 0) : -1;
}
extern "C" int fftconv_block_conv_v2_rows(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? v2_rows(wc, vh, splits, kara != 0) : -1;
}
extern "C" int fftconv_block_conv_v2_blocks(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? v2_blocks(wc, vh, splits, kara != 0) : -1;
}

FFTCONV_BLOCK_CONV_FORM_ENTRIES(_v2, kV2, false)
