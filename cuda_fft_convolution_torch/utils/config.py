"""Runtime configuration: the fields of the JAX package's ``Config`` that the
port reads (``cuda_fft_convolution_tpu.utils.config``), with their names,
semantics and environment variables:

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
"""

from __future__ import annotations

import dataclasses
import os

from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy


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
    use_fused_block_conv: bool | None = None
    hbm_fraction: float = 0.92
    hbm_budget_bytes: int | None = None
    chunk_size: int | None = None

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            policy=FftSizePolicy(os.environ.get("FFTCONV_POLICY", "fast")),
            use_fused_block_conv=_env_bool("FFTCONV_FUSED_BLOCK_CONV"),
            hbm_fraction=float(os.environ.get("FFTCONV_HBM_FRACTION", "0.92")),
            hbm_budget_bytes=_env_int("FFTCONV_HBM_BUDGET_BYTES"),
            chunk_size=_env_int("FFTCONV_CHUNK"),
        )


_CONFIG = Config.from_env()


def get_config() -> Config:
    return _CONFIG


def set_config(**kwargs) -> Config:
    """Update the global defaults, e.g. ``set_config(hbm_budget_bytes=1 << 30)``
    or ``set_config(policy='pow2')``; ``set_config(hbm_budget_bytes=None)``
    restores the device's own budget. Returns the new config."""
    global _CONFIG
    if "policy" in kwargs:
        kwargs["policy"] = FftSizePolicy(kwargs["policy"])
    _CONFIG = dataclasses.replace(_CONFIG, **kwargs)
    return _CONFIG
