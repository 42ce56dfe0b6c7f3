"""cuda_fft_convolution_torch — FFT filter-bank convolution on PyTorch and CUDA.

The port of ``cuda_fft_convolution_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference: the port keeps its public
layouts and entry points, and its tests hold each ported function to the JAX
function of the same name. FFTs run on ``torch.fft``; the fused overlap-save
block convolution, its peaks variant and the spectral MAC are CUDA kernels
written for Hopper (``csrc/``), built with ``nvcc`` at first use, each at
float32 and at the bf16 serving tier (``store_dtype='bfloat16'``,
``out_dtype='bfloat16'``). This package imports ``torch`` and never ``jax``.

  - ``fft_conv``        ≈ cudaConvolutionFFT
  - ``fft_data``        ≈ cudaFFTData
  - ``conv_spectral``   ≈ cudaConvFFTData
  - ``conv_spectral_pipelined`` ≈ cudaConvFFTDataStreams (a chunk of the
    bank at a time; ``runtime.plan_bank`` sizes the chunks)
  - ``fft_data_tiled``, ``fft_kernels``: reusable block and bank spectra
  - ``fft_conv_single``, ``fft_conv_stack``, ``direct_conv_single``: the
    convolution cores on channel-leading arrays (``ops/conv.py``)
  - ``models.detect_peaks``, ``detect_top_k``, ``detect_local_peaks``: the
    detection heads; ``models.hog_features``: the DPM path's HOG front end;
    ``build_pyramid``, ``detect_pyramid``, ``detect_pyramid_peaks``,
    ``top_detections``: multi-scale detection; ``train_mosse``,
    ``update_mosse``, ``respond``: MOSSE correlation filters;
    ``FilterBankDetector``, ``init_detector``, ``detect``, ``loss_fn``,
    ``train_step``: the trainable detector (every name of ``models``)
  - ``make_plan`` / ``FftConvPlan``: a geometry fixed up front, stages
    warmed (≈ cufftPlanMany); ``ConvStream`` / ``RaggedConvStream``:
    bounded-depth serving over a resident bank on CUDA events;
    ``autotune_block_geometry`` and the block-geometry table keyed by
    device name (``runtime/``)
  - ``make_mesh``, ``shard_kernel_bank``, ``conv_spectral_sharded``,
    ``detect_peaks_sharded``, ``ShardedConvStream``: the bank sharded over
    a (data, kernels) ``DeviceMesh`` on ``torch.distributed``, one rank a
    device, outputs as ``DTensor``s; ``parallel.train_step_sharded`` the
    detector's DP×TP training step (``parallel/``)
  - ``selftest``: the device report, with every C entry of the kernels
    against its plain version; ``utils`` holds image I/O, profiling
    (``benchmark`` on CUDA events, ``trace``) and logging; ``demos`` the
    six demos
"""

from cuda_fft_convolution_torch.api import (
    conv_spectral,
    conv_spectral_pipelined,
    fft_conv,
    fft_data,
    fft_data_tiled,
    fft_kernels,
)
from cuda_fft_convolution_torch.models import (
    FilterBankDetector,
    MosseFilter,
    Pyramid,
    PyramidPeaks,
    build_pyramid,
    detect,
    detect_local_peaks,
    detect_peaks,
    detect_pyramid,
    detect_pyramid_peaks,
    detect_top_k,
    detector_from_numpy,
    gaussian_target,
    hog_features,
    init_detector,
    loss_fn,
    mosse_from_numpy,
    respond,
    top_detections,
    train_mosse,
    train_step,
    update_mosse,
)
from cuda_fft_convolution_torch.ops.conv import (
    direct_conv_single,
    fft_conv_single,
    fft_conv_stack,
)
from cuda_fft_convolution_torch.ops.block_conv import (
    block_conv,
    block_conv_peaks,
    block_conv_peaks_reference,
    block_conv_reference,
)
from cuda_fft_convolution_torch.parallel import (
    conv_spectral_sharded,
    detect_peaks_sharded,
    make_mesh,
    shard_kernel_bank,
)
from cuda_fft_convolution_torch.runtime import (
    BankPlan,
    ConvFuture,
    ConvStream,
    FftConvPlan,
    RaggedConvFuture,
    RaggedConvStream,
    ShardedConvStream,
    autotune_block_geometry,
    lookup_tuned_geometry,
    make_plan,
    plan_bank,
    register_tuned_geometry,
    save_user_cache,
)
from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.checkpoint import (
    from_numpy,
    load_spectral,
    save_spectral,
)
from cuda_fft_convolution_torch.utils.config import get_config, set_config
from cuda_fft_convolution_torch.utils.errors import InvalidInputError
from cuda_fft_convolution_torch.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
    next_fast_len,
    next_multiple_of_16,
    next_pow2,
)
from cuda_fft_convolution_torch.utils.selftest import selftest

__version__ = "0.1.0"

__all__ = [
    "SpectralData",
    "SpectralKernels",
    "TiledSpectralData",
    "conv_spectral",
    "conv_spectral_pipelined",
    "fft_conv",
    "fft_data",
    "fft_data_tiled",
    "fft_kernels",
    "fft_conv_single",
    "fft_conv_stack",
    "direct_conv_single",
    "conv_spectral_sharded",
    "detect_peaks_sharded",
    "make_mesh",
    "shard_kernel_bank",
    "detect_peaks",
    "detect_top_k",
    "detect_local_peaks",
    "hog_features",
    "FilterBankDetector",
    "detect",
    "init_detector",
    "loss_fn",
    "train_step",
    "MosseFilter",
    "gaussian_target",
    "respond",
    "train_mosse",
    "update_mosse",
    "Pyramid",
    "PyramidPeaks",
    "build_pyramid",
    "detect_pyramid",
    "detect_pyramid_peaks",
    "top_detections",
    "block_conv",
    "block_conv_reference",
    "block_conv_peaks",
    "block_conv_peaks_reference",
    "BankPlan",
    "plan_bank",
    "FftConvPlan",
    "make_plan",
    "ConvFuture",
    "ConvStream",
    "RaggedConvFuture",
    "RaggedConvStream",
    "ShardedConvStream",
    "autotune_block_geometry",
    "lookup_tuned_geometry",
    "register_tuned_geometry",
    "save_user_cache",
    "from_numpy",
    "detector_from_numpy",
    "mosse_from_numpy",
    "load_spectral",
    "save_spectral",
    "get_config",
    "set_config",
    "InvalidInputError",
    "selftest",
    "FftSizePolicy",
    "compute_fft_size",
    "next_fast_len",
    "next_multiple_of_16",
    "next_pow2",
    "__version__",
]
