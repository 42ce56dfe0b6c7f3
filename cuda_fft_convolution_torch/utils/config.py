"""Runtime configuration: only the field the port reads.

``use_fused_block_conv`` has the JAX package's name and semantics
(``cuda_fft_convolution_tpu.utils.config``): None = auto (the fused kernel
runs wherever its legality rule admits the geometry,
``ops.tiled.fused_dispatch_auto``), True/False force either branch of
``ops.tiled.conv_blocks``. The environment variable
``FFTCONV_FUSED_BLOCK_CONV`` (1/0, '' = auto) sets the default.
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str) -> bool | None:
    v = os.environ.get(name, "")
    if v == "":
        return None
    return v not in ("0", "false", "False")


@dataclasses.dataclass(frozen=True)
class Config:
    use_fused_block_conv: bool | None = None

    @classmethod
    def from_env(cls) -> "Config":
        return cls(use_fused_block_conv=_env_bool("FFTCONV_FUSED_BLOCK_CONV"))


_CONFIG = Config.from_env()


def get_config() -> Config:
    return _CONFIG


def set_config(**kwargs) -> Config:
    """Update the global defaults, e.g. ``set_config(use_fused_block_conv=False)``.
    Returns the new config."""
    global _CONFIG
    _CONFIG = dataclasses.replace(_CONFIG, **kwargs)
    return _CONFIG
