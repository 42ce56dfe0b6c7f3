"""Padding ops, the port of ``cuda_fft_convolution_tpu/ops/padding.py``.

  - ``pad_to_fft``          ≈ ``padData`` (src/cudaConvFFTData.cuh:11-31):
    zero padding, data in the top-left corner.
  - ``pad_kernel_centered`` ≈ ``padKernel`` (src/convolutionFFTkernel.cu:
    13-40): a kernel's centre wrapped to the origin, so maps come out
    un-shifted.
  - ``pad_clamp_to_border`` ≈ ``padDataClampToBorder``
    (src/convolutionFFTkernel.cu:46-76): the reference's three-region
    border-replicate rule.

Each takes a (..., H, W) tensor of any leading rank and pads its last two
axes.
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


def pad_kernel_centered(
    kernel: torch.Tensor, fft_h: int, fft_w: int
) -> torch.Tensor:
    """Zero-pad a (..., Kh, Kw) kernel to (fft_h, fft_w) with its centre
    (Kh//2, Kw//2) at the origin: the upper-left part wraps to the far
    corners. Convolving with it gives the 'same' window at rows/cols
    [0, H) directly."""
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    if kh > fft_h or kw > fft_w:
        raise ValueError(
            f"kernel ({kh},{kw}) exceeds FFT dims ({fft_h},{fft_w})"
        )
    # torch.roll of the zero-padded kernel by (−Kh//2, −Kw//2), written as
    # its four quadrants into zeros: one pass over the padded size, not two.
    ch, cw = kh // 2, kw // 2
    out = kernel.new_zeros((*kernel.shape[:-2], fft_h, fft_w))
    out[..., : kh - ch, : kw - cw] = kernel[..., ch:, cw:]
    out[..., : kh - ch, fft_w - cw :] = kernel[..., ch:, :cw]
    out[..., fft_h - ch :, : kw - cw] = kernel[..., :ch, cw:]
    out[..., fft_h - ch :, fft_w - cw :] = kernel[..., :ch, :cw]
    return out


def pad_clamp_to_border(
    x: torch.Tensor, fft_h: int, fft_w: int, border_h: int, border_w: int
) -> torch.Tensor:
    """Pad (H, W) up to (fft_h, fft_w) by the reference's three-region rule
    (src/convolutionFFTkernel.cu:65-74): the data in the top-left corner;
    the next (border_h, border_w) pad rows/cols replicate the far edge (row
    H−1 / col W−1); every pad row/col beyond that band replicates row/col 0.

    The row/col-0 replicas serve the top/left edge outputs: their taps at
    negative indices wrap, through the circular FFT, to the end of the
    padded array. ``border_h/w`` is the kernels' 'same'-window anchor (the
    reference's ``kernelY``/``kernelX``)."""
    h, w = x.shape[-2], x.shape[-1]
    if h > fft_h or w > fft_w:
        raise ValueError(
            f"input spatial dims ({h},{w}) exceed FFT dims ({fft_h},{fft_w})"
        )

    def source(n, fft_n, border):
        i = torch.arange(fft_n, device=x.device)
        return torch.where(
            i < n, i,
            torch.where(i < n + border, torch.full_like(i, n - 1), torch.zeros_like(i)),
        )

    rows = source(h, fft_h, border_h)
    cols = source(w, fft_w, border_w)
    return x.index_select(-2, rows).index_select(-1, cols)
