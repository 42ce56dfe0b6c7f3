// Fused overlap-save block convolution for Hopper (sm_90a): the maps
// kernel's v2 body (block_conv_v2.cu) with the Karatsuba H stage
// (block_conv_k.cu), JAX's _make_kernel under karatsuba=True
// (cuda_fft_convolution_tpu/ops/block_conv.py:291-297). The entries take
// the v3 entries' operands in every dtype mode and synthesis tier, with
// the suffix _v2_k.

#include "block_conv_maps.cuh"

FFTCONV_BLOCK_CONV_FORM_ENTRIES(_v2_k, kV2, true)
