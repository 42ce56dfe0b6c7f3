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

Fields that select a TPU engine or precision tier. The port accepts a value
that describes what it already does, with no effect, and raises
``InvalidInputError`` naming the field for one that asks for what it does
not have:

  field (environment variable)                  accepted            refused
  ``use_pallas`` (FFTCONV_USE_PALLAS)           None, True, False   —
  ``use_matmul_fft`` (FFTCONV_USE_MATMUL_FFT)   None, False         True
  ``matmul_precision`` (FFTCONV_MATMUL_...)     'highest'           'high', 'default'
  ``inverse_precision`` (FFTCONV_INVERSE_...)   'highest'           'high', 'default'
  ``fused_precision`` (FFTCONV_FUSED_...)       'bf16x3'            'highest'

Every MAC runs the MAC kernel, whatever ``use_pallas`` says; transforms run
on ``torch.fft`` (IEEE fp32: 'highest'), never on a matmul DFT engine;
'bf16x3' is the JAX package's name for the split product that the fused
kernels' 3×TF32 syntheses implement, and its fp32-exact 'highest' tier has
no twin (3×TF32 sums are not fp32-exact).

The JAX package's ``register_jit_consumer`` and ``invalidate_jit_consumers``
have no twin: the port keeps no jit cache for a configuration change to
invalidate.
"""

from __future__ import annotations

import dataclasses
import os

from cuda_fft_convolution_torch.utils.errors import validate
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy

# field → the values the port accepts (it runs them all the same way).
_ACCEPTED = {
    "use_matmul_fft": (None, False),
    "matmul_precision": ("highest",),
    "inverse_precision": ("highest",),
    "fused_precision": ("bf16x3",),
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
