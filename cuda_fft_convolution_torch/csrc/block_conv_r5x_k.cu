// Fused overlap-save block convolution for Hopper (sm_90a): the v5x body's
// entries of the maps and peaks kernels (block_conv_r5x.cu) with the
// Karatsuba form of the radix-2 H stage's sub-transforms: csub's three real
// products, t1 = Ur Sr, t2 = Ui Si, t3 = (Ur + Ui)(Sr + Si); Re = t1 - t2, Im
// = t3 - t1 - t2, for E and for O
// (cuda_fft_convolution_tpu/ops/block_conv.py:1204 in _make_kernel_v5x, :1648
// in _make_kernel_v5x_peaks), the form block_conv_pallas and
// block_conv_peaks_pallas run by default. block_conv.cuh says how the stage
// runs on Hopper (KARA); the entries take the operands of the _r5x entries in
// every dtype mode and synthesis tier of those, with the suffix _r5x_k.

#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"

FFTCONV_BLOCK_CONV_RADIX_ENTRIES(_r5x_k, kV5X, true)
FFTCONV_PEAKS_RADIX_ENTRIES(_r5x_k, kV5X, true)
