// Fused overlap-save block convolution for Hopper (sm_90a): the peaks
// kernel's v3 body with the Karatsuba H stage (block_conv_k.cu), the
// karatsuba form of _make_kernel_v3_peaks
// (cuda_fft_convolution_tpu/ops/block_conv.py:1712, the form at :1737),
// which block_conv_peaks_pallas runs by default. The entries take the v3 peaks
// entries' operands (block_conv_peaks.cu) in its five dtype and tier
// modes, with the suffix _k.

#include "block_conv_peaks.cuh"

FFTCONV_PEAKS_KARATSUBA_ENTRY(fftconv_block_conv_peaks_f32_k, float, 3)
FFTCONV_PEAKS_KARATSUBA_ENTRY(fftconv_block_conv_peaks_bf16_k, __nv_bfloat16, 3)
FFTCONV_PEAKS_KARATSUBA_ENTRY(fftconv_block_conv_peaks_f32_x6_k, float, 6)
FFTCONV_PEAKS_KARATSUBA_ENTRY(fftconv_block_conv_peaks_f32_x1_k, float, 1)
FFTCONV_PEAKS_KARATSUBA_ENTRY(fftconv_block_conv_peaks_bf16_io_k, __nv_bfloat16, kBF16IO)
