"""Runtime configuration: the JAX package's ``Config``
(``cuda_fft_convolution_tpu.utils.config``), every field with its name,
environment variable and default, so ``set_config`` takes every name the
JAX package's takes. Fields that steer the port:

  - ``policy``: the FFT-size policy an entry point takes when its
    ``policy`` is None (``FFTCONV_POLICY``: multiple16, pow2, fast or tpu;
    default fast); ``set_config`` takes a policy or its name;
  - ``use_fused_block_conv``: None = auto (the fused kernel runs wherever
    its legality rule admits the geometry, ``ops.tiled.fused_dispatch_auto``),
    True/False force either branch of ``ops.tiled.conv_blocks``
    (``FFTCONV_FUSED_BLOCK_CONV``, 1/0, '' = auto);
  - ``hbm_fraction``: the share of the card's memory the bank planners may
    budget (``FFTCONV_HBM_FRACTION``, default 0.92);
  - ``hbm_budget_bytes``: an absolute budget in bytes that overrides the
    fraction on every device, the CPU included (``FFTCONV_HBM_BUDGET_BYTES``;
    None = derive it from the device);
  - ``chunk_size``: the kernels a ``conv_spectral_pipelined`` chunk holds
    when the call gives none (``FFTCONV_CHUNK``; None = the planner decides).

Fields that select an engine or a precision tier, as in the JAX package.
The port raises ``InvalidInputError`` naming the field for a value that is
not one of these:

  field (environment variable)                  values
  ``use_pallas`` (FFTCONV_USE_PALLAS)           None, True, False
  ``use_matmul_fft`` (FFTCONV_USE_MATMUL_FFT)   None, False (True refused)
  ``matmul_precision`` (FFTCONV_MATMUL_...)     'highest', 'high', 'default'
  ``inverse_precision`` (FFTCONV_INVERSE_...)   'highest', 'high', 'default'
  ``fused_precision`` (FFTCONV_FUSED_...)       'bf16x3', 'highest'

Every MAC runs the MAC kernel, whatever ``use_pallas`` says. The fused
kernels' syntheses (``ops/block_conv.py fused_splits``, the JAX rule of
``cuda_fft_convolution_tpu/ops/block_conv.py:683-693``): at fp32 spectra
'bf16x3' runs 3×TF32 (the default), and 'highest' runs the tier of
``matmul_precision``: 'highest' 6×TF32 (the TPU's fp32-exact 6-pass
HIGHEST), 'high' 3×TF32, 'default' one TF32 pass (~2e-3, the TPU's single
pass); bf16 spectra run their own entries whatever the fields say.
``matmul_precision`` and ``inverse_precision`` also select the tier of the
JAX package's MXU-DFT transforms, which JAX takes only on a TPU
(``cuda_fft_convolution_tpu/ops/dft.py:256-267``); the port's transforms
run on ``torch.fft`` (IEEE fp32) and, as JAX off the TPU, are unchanged by
them. ``use_matmul_fft=True`` asks for that MXU-DFT engine, which the port
leaves behind (``torch.fft`` replaces it): it is refused.

The JAX package's ``register_jit_consumer`` and ``invalidate_jit_consumers``
have no twin: the port keeps no jit cache for a configuration change to
invalidate; every call reads the config, so a plan or stream built under
one tier runs the tier in force at each call.
"""

from __future__ import annotations

import dataclasses
import os

from cuda_fft_convolution_torch.utils.errors import validate
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy

# field → the values the port accepts.
_ACCEPTED = {
    "use_matmul_fft": (None, False),
    "matmul_precision": ("highest", "high", "default"),
    "inverse_precision": ("highest", "high", "default"),
    "fused_precision": ("bf16x3", "highest"),
}


def _env_bool(name: str) -> bool | None:
    v = os.environ.get(name, "")
    if v == "":
        return None
    return v not in ("0", "false", "False")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "")
    return int(v) if v else None


@dataclasses.dataclass(frozen=True)
class Config:
    policy: FftSizePolicy = FftSizePolicy.FAST
    use_pallas: bool | None = None
    hbm_fraction: float = 0.92
    hbm_budget_bytes: int | None = None
    chunk_size: int | None = None
    use_matmul_fft: bool | None = None
    matmul_precision: str = "highest"
    inverse_precision: str = "highest"
    use_fused_block_conv: bool | None = None
    fused_precision: str = "bf16x3"

    def __post_init__(self):
        for name, accepted in _ACCEPTED.items():
            value = getattr(self, name)
            validate(
                value in accepted,
                f"{name}={value!r} is not available in the port (accepted: "
                f"{', '.join(map(repr, accepted))}; utils/config.py)",
            )

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            policy=FftSizePolicy(os.environ.get("FFTCONV_POLICY", "fast")),
            use_pallas=_env_bool("FFTCONV_USE_PALLAS"),
            hbm_fraction=float(os.environ.get("FFTCONV_HBM_FRACTION", "0.92")),
            hbm_budget_bytes=_env_int("FFTCONV_HBM_BUDGET_BYTES"),
            chunk_size=_env_int("FFTCONV_CHUNK"),
            use_matmul_fft=_env_bool("FFTCONV_USE_MATMUL_FFT"),
            matmul_precision=os.environ.get("FFTCONV_MATMUL_PRECISION", "highest"),
            inverse_precision=os.environ.get("FFTCONV_INVERSE_PRECISION", "highest"),
            use_fused_block_conv=_env_bool("FFTCONV_FUSED_BLOCK_CONV"),
            fused_precision=os.environ.get("FFTCONV_FUSED_PRECISION", "bf16x3"),
        )


_CONFIG = Config.from_env()


def get_config() -> Config:
    return _CONFIG


def set_config(**kwargs) -> Config:
    """Update the global defaults, e.g. ``set_config(hbm_budget_bytes=1 << 30)``
    or ``set_config(policy='pow2')``; ``set_config(hbm_budget_bytes=None)``
    restores the device's own budget. A value the port does not have raises
    ``InvalidInputError`` and leaves the config as it was. Returns the new
    config."""
    global _CONFIG
    if "policy" in kwargs:
        kwargs["policy"] = FftSizePolicy(kwargs["policy"])
    _CONFIG = dataclasses.replace(_CONFIG, **kwargs)
    return _CONFIG
