// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's v3 body with the Karatsuba H stage, the complex product X = G S
// as three real products — t1 = Gr Sr, t2 = Gi Si, t3 = (Gr + Gi)(Sr + Si);
// Xr = t1 - t2, Xi = t3 - t1 - t2 — in place of four: the karatsuba form
// of _make_kernel_v3 (cuda_fft_convolution_tpu/ops/block_conv.py:153-157),
// which block_conv_pallas runs by default. block_conv.cuh says how each
// configuration runs it (KARA): the tensor-core configurations stage the
// planes Gr + Gi and Sr + Si (pieces of the fp32 sums, or at kBF16IO their
// bf16 roundings), the stacked one forms them as it loads its mma
// fragments of S and G. The
// entries take the v3 entries' operands (block_conv.cu) in every dtype
// mode and synthesis tier of those, with the suffix _k.

#include "block_conv_maps.cuh"

// Shared memory, rows, cluster size and pair bins of the Karatsuba
// configurations at packed width wc, window height vh and tier `splits` (-1
// for a tier outside 0, 1, 3, 6); ops/block_conv.py smem_bytes, tile_rows,
// cluster_size and pair_bins (karatsuba=True) mirror them. The blocks a CTA stacks are fftconv_block_conv_f32_blocks'.
extern "C" long long fftconv_block_conv_k_smem_bytes(int wc, int vh, int splits) {
  return valid_splits(splits) ? smem_bytes(wc, vh, splits, true) : -1;
}
extern "C" int fftconv_block_conv_k_rows(int wc, int vh, int splits) {
  return valid_splits(splits) ? tile_rows(wc, vh, splits, true) : -1;
}
extern "C" int fftconv_block_conv_k_cluster(int wc, int vh, int splits) {
  return valid_splits(splits) ? cluster_of(wc, vh, splits, true) : -1;
}
extern "C" int fftconv_block_conv_k_pair_bins(int wc, int vh, int splits) {
  return valid_splits(splits) ? pair_bins(wc, vh, splits, true) : -1;
}
// The v2 body's configuration in H-stage form `kara` (0, 1), v3's of that
// form (block_conv.cu, "JAX's v2 body"): its shared memory, rows and blocks
// a CTA (MBH before the cut to the grid's nbh); ops/block_conv.py
// v2_smem_bytes, v2_rows and v2_blocks mirror them.
extern "C" long long fftconv_block_conv_v2_smem_bytes(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? smem_bytes(wc, vh, splits, kara != 0) : -1;
}
extern "C" int fftconv_block_conv_v2_rows(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? tile_rows(wc, vh, splits, kara != 0) : -1;
}
extern "C" int fftconv_block_conv_v2_blocks(int wc, int vh, int splits, int kara) {
  return valid_splits(splits) ? blocks_per_cta(wc, vh, splits) : -1;
}

// (the 6xTF32 and one-pass entries: block_conv_k_tiers.cu)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_k, float, float, StoreF32, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_k, float, __nv_bfloat16, StoreBF16, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_k, __nv_bfloat16, float, StoreF32, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_bf16maps_k, __nv_bfloat16, __nv_bfloat16, StoreBF16, 3, kV3,
                              true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_io_k, __nv_bfloat16, float, StoreF32, kBF16IO, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_bf16maps_io_k, __nv_bfloat16, __nv_bfloat16, StoreBF16,
                              kBF16IO, kV3, true)
// the v2 body's Karatsuba form (JAX's _make_kernel under karatsuba=True,
// :291-297): the same kernels (block_conv.cu, "JAX's v2 body")
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_v2_k, float, float, StoreF32, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_v2_k, float, __nv_bfloat16, StoreBF16, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_v2_k, __nv_bfloat16, float, StoreF32, 3, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_bf16maps_v2_k, __nv_bfloat16, __nv_bfloat16, StoreBF16, 3,
                              kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_io_v2_k, __nv_bfloat16, float, StoreF32, kBF16IO, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_bf16_bf16maps_io_v2_k, __nv_bfloat16, __nv_bfloat16, StoreBF16,
                              kBF16IO, kV3, true)
