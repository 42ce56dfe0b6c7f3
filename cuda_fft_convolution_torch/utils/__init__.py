"""Utilities: validation errors, FFT-size policies, configuration, spectral
checkpoints, image I/O, profiling, logging and the device self-test — the
JAX package's ``utils`` layer, less ``fetch`` (a TPU transfer workaround)."""

from cuda_fft_convolution_torch.utils.checkpoint import load_spectral, save_spectral
from cuda_fft_convolution_torch.utils.config import Config, get_config, set_config
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate
from cuda_fft_convolution_torch.utils.fft_size import (
    FftSizePolicy,
    align_up,
    ceil_div,
    compute_fft_size,
    next_fast_len,
    next_multiple_of_16,
    next_pow2,
)
from cuda_fft_convolution_torch.utils.image_io import (
    compare_l2,
    compare_max,
    load_pgm,
    save_pgm,
)
from cuda_fft_convolution_torch.utils.profiling import Timer, benchmark, trace
from cuda_fft_convolution_torch.utils.selftest import selftest

__all__ = [
    "load_spectral",
    "save_spectral",
    "Config",
    "get_config",
    "set_config",
    "InvalidInputError",
    "validate",
    "compare_l2",
    "compare_max",
    "load_pgm",
    "save_pgm",
    "Timer",
    "benchmark",
    "trace",
    "selftest",
    "FftSizePolicy",
    "compute_fft_size",
    "next_fast_len",
    "next_multiple_of_16",
    "next_pow2",
    "align_up",
    "ceil_div",
]
