// Fused overlap-save block convolution for Hopper (sm_90a): the v4 body's
// entries of the maps and peaks kernels, the radix-2 H stage
// (_make_kernel_v4, _make_kernel_v4_peaks) in
// cuda_fft_convolution_tpu/ops/block_conv.py. block_conv.cuh says how the
// stages run on Hopper; the entries take the operands of the v3 entries
// (block_conv.cu, block_conv_peaks.cu) and RadixOps' three pointers after
// m_tc, in every dtype mode and synthesis tier of those, with the suffix
// _r4.

#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"

FFTCONV_BLOCK_CONV_RADIX_ENTRIES(_r4, kV4, false)
FFTCONV_PEAKS_RADIX_ENTRIES(_r4, kV4, false)
