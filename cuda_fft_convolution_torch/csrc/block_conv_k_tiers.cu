// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's Karatsuba entries (block_conv_k.cu says what they compute) at the
// 6xTF32 (_x6_k) and one-pass (_x1_k) tiers, and the v2 body's (_v2_k: the
// same kernels), a unit of their own so that the forms library's sources
// compile side by side.

#include "block_conv_maps.cuh"

FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_x6_k, float, float, StoreF32, 6, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_x6_k, float, __nv_bfloat16, StoreBF16, 6, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_x1_k, float, float, StoreF32, 1, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_x1_k, float, __nv_bfloat16, StoreBF16, 1, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_x6_v2_k, float, float, StoreF32, 6, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_x6_v2_k, float, __nv_bfloat16, StoreBF16, 6, kV3,
                              true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_x1_v2_k, float, float, StoreF32, 1, kV3, true)
FFTCONV_BLOCK_CONV_FORM_ENTRY(fftconv_block_conv_f32_bf16maps_x1_v2_k, float, __nv_bfloat16, StoreBF16, 1, kV3,
                              true)
