"""Runtime layer, the port of ``cuda_fft_convolution_tpu/runtime``:

  - ``planner``: ``BankPlan`` and ``plan_bank``, the bank-chunk planner;
  - ``plan``: ``FftConvPlan`` / ``make_plan``, a geometry fixed up front
    with its stages warmed (the cufftPlanMany analogue,
    src/cudaConvolutionFFT.cu:128-142);
  - ``stream``: ``ConvStream``, ``RaggedConvStream`` and
    ``ShardedConvStream`` (over a device mesh, ``parallel/``),
    bounded-depth serving on CUDA events (the stream pool of
    src/cudaConvFFTDataStreams.cu:279-349);
  - ``autotune``: the block-geometry table keyed by device name, and its
    tuner (the reference's thread-dim knob, src/cudaConvolutionFFT.cu:72-82).

The JAX package's native ctypes planner is not ported (queue 1 item 5).
"""

from cuda_fft_convolution_torch.runtime.autotune import (
    autotune_block_geometry,
    lookup_tuned_geometry,
    register_tuned_geometry,
    save_user_cache,
)
from cuda_fft_convolution_torch.runtime.plan import FftConvPlan, make_plan
from cuda_fft_convolution_torch.runtime.planner import BankPlan, plan_bank
from cuda_fft_convolution_torch.runtime.stream import (
    ConvFuture,
    ConvStream,
    RaggedConvFuture,
    RaggedConvStream,
    ShardedConvStream,
)

__all__ = [
    "autotune_block_geometry",
    "lookup_tuned_geometry",
    "register_tuned_geometry",
    "save_user_cache",
    "BankPlan",
    "plan_bank",
    "FftConvPlan",
    "make_plan",
    "ConvFuture",
    "ConvStream",
    "RaggedConvFuture",
    "RaggedConvStream",
    "ShardedConvStream",
]
