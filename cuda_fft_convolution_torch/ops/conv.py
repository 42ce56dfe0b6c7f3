"""Core FFT-convolution numerics on ``torch.fft``.

Per kernel: out = IFFT( Σ_f FFT(pad(data_f)) ⊙ FFT(pad(kernel_f)) ) / N —
the reference's contract (src/cudaConvolutionFFT.cu:245-282) with the channel
sum moved into the spectral domain, so each kernel costs one inverse FFT.
Spectra are split (re, im) float32 planes; complex tensors exist only inside
these functions, around the ``torch.fft`` calls.
"""

from __future__ import annotations

import torch

from cuda_fft_convolution_torch.ops.padding import pad_to_fft


def rfft2_padded_planes(
    x: torch.Tensor, fft_h: int, fft_w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the trailing (H, W) axes to (fft_h, fft_w) and take rfft2 →
    (re, im) float32 planes (..., fft_h, fft_w//2+1)."""
    s = torch.fft.rfft2(pad_to_fft(x.to(torch.float32), fft_h, fft_w))
    return s.real.contiguous(), s.imag.contiguous()


def irfft2_norm_planes(
    sr: torch.Tensor, si: torch.Tensor, fft_h: int, fft_w: int
) -> torch.Tensor:
    """Inverse real FFT of split planes → (..., fft_h, fft_w) float32 maps,
    normalized by 1/(fft_h·fft_w). ``s`` is always given: for an odd
    ``fft_w`` the packed width alone does not determine the length."""
    return torch.fft.irfft2(
        torch.complex(sr.to(torch.float32), si.to(torch.float32)),
        s=(fft_h, fft_w),
    )


def spectral_mac_planes(
    dr: torch.Tensor, di: torch.Tensor,
    kr: torch.Tensor, ki: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ_f K[..., f] ⊙ D[f] on split planes: data (F, H, Wc), kernels with
    any leading bank axes (..., F, H, Wc) → (..., H, Wc)."""

    def e(a, b):
        return torch.einsum("...fhw,fhw->...hw", a, b)

    return e(kr, dr) - e(ki, di), e(kr, di) + e(ki, dr)
