"""Recoverable validation errors.

The same contract as ``cuda_fft_convolution_tpu.utils.errors``: every
user-input failure is a Python exception (``InvalidInputError``, a
``ValueError``); device-side failures surface as PyTorch or ``RuntimeError``
exceptions and propagate normally.
"""

from __future__ import annotations


class InvalidInputError(ValueError):
    """User-input validation failure (≈ mexErrMsgIdAndTxt 'InvalidInput')."""


def validate(cond: bool, msg: str) -> None:
    if not cond:
        raise InvalidInputError(msg)
