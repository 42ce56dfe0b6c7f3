"""Numerics: padding, FFT wrappers, spectral MAC, the convolution cores, the
fused block-conv kernel and the overlap-save engine — the JAX package's
``ops`` layer (src/cudaConvFFTData.cuh: padData /
elementwiseProductAndNormalize / sumAlongFeatures, and its cuFFT plans)."""

from cuda_fft_convolution_torch.ops.padding import (
    pad_clamp_to_border,
    pad_kernel_centered,
    pad_to_fft,
)
from cuda_fft_convolution_torch.ops.conv import (
    direct_conv_single,
    fft_conv_single,
    fft_conv_stack,
)

# ``ops.spectral_mac`` is the MAC submodule, as it is in the JAX package
# once its ``api`` has imported that submodule; the complex MAC of
# ``ops/conv.py`` is ``ops.conv.spectral_mac``.
from cuda_fft_convolution_torch.ops import spectral_mac  # noqa: E402

__all__ = [
    "pad_to_fft",
    "pad_clamp_to_border",
    "pad_kernel_centered",
    "direct_conv_single",
    "fft_conv_single",
    "fft_conv_stack",
    "spectral_mac",
]
