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

#include "block_conv_maps.cuh"

// Shared-memory bytes the kernels need at packed width wc, window height
// vh and tier `splits` (1, 3 or 6 tensor-core products, or 0 for kBF16IO;
// -1 for another), the window rows a CTA holds there (64 in a pair), the blocks it stacks (1: one
// block per CTA) and the kernels a stacked CTA takes (1 where it does not
// stack); the Python legality rule (ops/block_conv.py smem_bytes,
// tile_rows, blocks_per_cta, kernels_per_cta) mirrors all four.
extern "C" long long fftconv_block_conv_f32_smem_bytes(int wc, int vh, int splits) {
  return valid_splits(splits) ? smem_bytes(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_rows(int wc, int vh, int splits) {
  return valid_splits(splits) ? tile_rows(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_blocks(int wc, int vh, int splits) {
  return valid_splits(splits) ? blocks_per_cta(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_kernels(int wc, int vh, int splits) {
  return valid_splits(splits) ? kernels_per_cta(wc, vh, splits) : -1;
}
// The CTAs of a thread-block cluster (2: the paired configuration, else 1)
// and rank 0's bins there (0 elsewhere); ops/block_conv.py cluster_size and
// pair_bins mirror them.
extern "C" int fftconv_block_conv_f32_cluster(int wc, int vh, int splits) {
  return valid_splits(splits) ? cluster_of(wc, vh, splits) : -1;
}
extern "C" int fftconv_block_conv_f32_pair_bins(int wc, int vh, int splits) {
  return valid_splits(splits) ? pair_bins(wc, vh, splits) : -1;
}

// One entry per (spectra, maps) dtype pair and tier:
// fftconv_block_conv_<spectra>, with a _bf16maps suffix for bf16 maps and,
// for fp32 spectra, _x6 (6xTF32, fused_precision='highest') or _x1 (one
// TF32 pass, 'highest' with matmul_precision='default'), for bf16 spectra
// _io (kBF16IO, their default tier), for the tiers other than 3xTF32
// (block_conv.cuh). `ktile` is the stacked configuration's launch order
// (launch_block_conv). The 6xTF32 and one-pass entries are in
// block_conv_tiers.cu (two units, so that the two compile side by side),
// the radix bodies' in block_conv_r4.cu, block_conv_r5.cu and
// block_conv_r5x.cu.
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32, float, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps, float, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16, __nv_bfloat16, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps, __nv_bfloat16, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_io, __nv_bfloat16, float, StoreF32, kBF16IO)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps_io, __nv_bfloat16, __nv_bfloat16, StoreBF16, kBF16IO)

// JAX's v2 body (_make_kernel, :269-308; block_conv_pallas under
// wstack=False): MBH blocks of one block column, one H product G [S_1 |
// ... | S_MBH], then the W stage. Each output element's products are v3's
// (block_conv.cuh, "The bodies"), so its entries, with the suffix _v2
// (the 6xTF32 and one-pass ones in block_conv_tiers.cu, the Karatsuba
// form's _v2_k in block_conv_k.cu), launch v3's configuration of the same
// dtype mode and tier: the stacked one, 64 rows, the pair or 32 rows.
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_v2, float, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_v2, float, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_v2, __nv_bfloat16, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps_v2, __nv_bfloat16, __nv_bfloat16, StoreBF16, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_io_v2, __nv_bfloat16, float, StoreF32, kBF16IO)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_bf16maps_io_v2, __nv_bfloat16, __nv_bfloat16, StoreBF16, kBF16IO)
