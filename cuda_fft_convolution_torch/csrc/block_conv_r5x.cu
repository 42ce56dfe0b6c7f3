// Fused overlap-save block convolution for Hopper (sm_90a): the v5x body's
// entries of the maps and peaks kernels, the v5 stages with the Nyquist term
// synthesised outside the kernel (_make_kernel_v5x, _make_kernel_v5x_peaks,
// _xsliver_operands) in cuda_fft_convolution_tpu/ops/block_conv.py.
// block_conv.cuh says how the stages run on Hopper; the entries take the
// operands of the v3 entries (block_conv.cu, block_conv_peaks.cu) and
// RadixOps' three pointers after m_tc, in every dtype mode and synthesis
// tier of those, with the suffix _r5x.

#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"

FFTCONV_BLOCK_CONV_RADIX_ENTRIES(_r5x, kV5X, false)
FFTCONV_PEAKS_RADIX_ENTRIES(_r5x, kV5X, false)
