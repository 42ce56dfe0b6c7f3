"""Zero padding (≈ the reference's ``padData``, src/cudaConvFFTData.cuh:11-31).

Border-clamp padding and centered kernels are not ported yet (ROADMAP
queue 1 item 1); the API rejects them with ``InvalidInputError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_fft(x: torch.Tensor, fft_h: int, fft_w: int) -> torch.Tensor:
    """Zero-pad the last two axes (H, W) of ``x`` up to (fft_h, fft_w), data
    in the top-left corner. Leading axes pass through."""
    h, w = x.shape[-2], x.shape[-1]
    if h == fft_h and w == fft_w:
        return x
    if h > fft_h or w > fft_w:
        raise ValueError(
            f"input spatial dims ({h},{w}) exceed FFT dims ({fft_h},{fft_w})"
        )
    return F.pad(x, (0, fft_w - w, 0, fft_h - h))
