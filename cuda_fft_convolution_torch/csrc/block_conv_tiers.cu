// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's entries at the 6xTF32 (_x6) and one-pass (_x1) synthesis tiers
// on fp32 spectra, f32 or bf16 maps, and the v2 body's (_v2: v3's kernels;
// block_conv.cu has the others and says what they compute; a unit of their
// own so that the library's sources compile side by side).

#include "block_conv_maps.cuh"

FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x6, float, float, StoreF32, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x6, float, __nv_bfloat16, StoreBF16, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x1, float, float, StoreF32, 1)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x1, float, __nv_bfloat16, StoreBF16, 1)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x6_v2, float, float, StoreF32, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x6_v2, float, __nv_bfloat16, StoreBF16, 6)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_x1_v2, float, float, StoreF32, 1)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32_bf16maps_x1_v2, float, __nv_bfloat16, StoreBF16, 1)
