"""Core FFT-convolution numerics on ``torch.fft``.

Per kernel: out = IFFT( Σ_f FFT(pad(data_f)) ⊙ FFT(pad(kernel_f)) ) / N —
the reference's contract (src/cudaConvolutionFFT.cu:245-282) with the channel
sum moved into the spectral domain, so each kernel costs one inverse FFT.
Spectra are split (re, im) float32 planes; complex tensors exist only
inside these functions, around the ``torch.fft`` calls, and at the
complex-facing interop wrappers ``rfft2_padded``, ``irfft2_norm`` and
``spectral_mac``.

The cores of the JAX package's ``ops/conv.py``: ``fft_conv_single``,
``fft_conv_stack`` and the spatial ``direct_conv_single``. Their MAC is the
MAC kernel (``ops/spectral_mac.py spectral_mac_auto_planes``: the CUDA
kernel on CUDA tensors, the plain einsum on CPU tensors, differentiable
through both), where the JAX package runs its einsum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cuda_fft_convolution_torch.ops.padding import pad_to_fft
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.types import split_planes
from cuda_fft_convolution_torch.utils.device import as_tensor
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy, compute_fft_size


def rfft2_padded_planes(
    x: torch.Tensor, fft_h: int, fft_w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the trailing (H, W) axes to (fft_h, fft_w) and take rfft2 →
    (re, im) float32 planes (..., fft_h, fft_w//2+1)."""
    s = torch.fft.rfft2(pad_to_fft(x.to(torch.float32), fft_h, fft_w))
    return s.real.contiguous(), s.imag.contiguous()


def rfft2_padded(x: torch.Tensor, fft_h: int, fft_w: int) -> torch.Tensor:
    """Complex64 form of ``rfft2_padded_planes`` (interop)."""
    return torch.complex(*rfft2_padded_planes(x, fft_h, fft_w))


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


def irfft2_norm(s: torch.Tensor, fft_h: int, fft_w: int) -> torch.Tensor:
    """Complex-input form of ``irfft2_norm_planes`` (interop)."""
    return irfft2_norm_planes(*split_planes(s), fft_h, fft_w)


def spectral_mac_planes(
    dr: torch.Tensor, di: torch.Tensor,
    kr: torch.Tensor, ki: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ_f K[..., f] ⊙ D[f] on split planes: data (F, H, Wc), kernels with
    any leading bank axes (..., F, H, Wc) → (..., H, Wc)."""

    def e(a, b):
        return torch.einsum("...fhw,fhw->...hw", a, b)

    return e(kr, dr) - e(ki, di), e(kr, di) + e(ki, dr)


def _bank_mac(
    dr: torch.Tensor, di: torch.Tensor,  # (F, H, Wc)
    kr: torch.Tensor, ki: torch.Tensor,  # (..., F, H, Wc)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Σ_f K[..., f] ⊙ D[f] through the MAC kernel → (..., H, Wc) planes:
    the data is a batch of one, the bank's leading axes are flattened to N
    and restored on the output (a single (F, H, Wc) kernel is N = 1)."""
    lead = kr.shape[:-3]
    f, h, wc = dr.shape
    n = math.prod(lead)
    pr, pi = spectral_mac_auto_planes(
        dr[None], di[None], kr.reshape(n, f, h, wc), ki.reshape(n, f, h, wc))
    return pr.reshape(*lead, h, wc), pi.reshape(*lead, h, wc)


def spectral_mac(data_fft: torch.Tensor, kernel_fft: torch.Tensor) -> torch.Tensor:
    """Σ_f D[f, h, w] · K[..., f, h, w] on complex spectra: data (F, H, Wc),
    a bank with any number of leading axes (..., F, H, Wc) → complex64
    (..., H, Wc). ≈ elementwiseProductAndNormalize + sumAlongFeatures
    fused (src/cudaConvFFTData.cuh:47-92), through the MAC kernel on CUDA
    tensors (the planes are made contiguous float32 first)."""
    return torch.complex(*_bank_mac(*split_planes(data_fft), *split_planes(kernel_fft)))


def _check_channels(f: int, kf: int) -> None:
    if kf != f:
        raise ValueError(f"channel mismatch: data F={f}, kernel F={kf}")


def fft_conv_single(
    data,
    kernel,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
    device=None,
) -> torch.Tensor:
    """Convolve one (F, H, W) data array with one (F, Kh, Kw) kernel → the
    full (fft_h, fft_w) map summed over channels, the per-cell result of
    cudaConvolutionFFT (src/cudaConvolutionFFT.cu:284-288): ``fft_conv_stack``
    on a bank of one. ``device``: where array inputs go (the card when
    None, ``utils/device.py``); the kernel follows the data."""
    data = as_tensor(data, device)
    kernel = as_tensor(kernel, data.device)
    return fft_conv_stack(data, kernel[None], fft_h, fft_w, policy=policy)[0]


def fft_conv_stack(
    data,
    kernels,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
    device=None,
) -> torch.Tensor:
    """Convolve (F, H, W) data with a stacked bank (N, F, Kh, Kw) → (N,
    fft_h, fft_w). The data FFT is computed once for the whole bank — the
    reference's amortization (src/cudaConvolutionFFT.cu:167, then the
    per-kernel loop :204-291) — and the MAC is one kernel launch. Gradients
    reach the bank (and the data) through the MAC kernel's backward."""
    data = as_tensor(data, device)
    kernels = as_tensor(kernels, data.device)
    f, h, w = data.shape
    n, kf, kh, kw = kernels.shape
    _check_channels(f, kf)
    if fft_h is None or fft_w is None:
        fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    pr, pi = _bank_mac(*rfft2_padded_planes(data, fft_h, fft_w),
                       *rfft2_padded_planes(kernels, fft_h, fft_w))
    return irfft2_norm_planes(pr, pi, fft_h, fft_w)


def direct_conv_single(data, kernel, *, device=None) -> torch.Tensor:
    """Spatial 'full' convolution summed over channels → (H+Kh−1, W+Kw−1),
    MATLAB's ``sum_i conv2(data(:,:,i), kernel(:,:,i))``
    (demoCudaConvolutionFFT.m:91-96); a test oracle and the small-kernel
    path. ``F.conv2d`` computes correlation, so the kernel is flipped.

    On the card cuDNN may round fp32 convolutions to TF32
    (``torch.backends.cudnn.allow_tf32`` is True by default), which misses
    the 1e-5 bar where it does (many channels, small kernels); the call
    runs with TF32 off, as the JAX package runs its convolution at
    ``Precision.HIGHEST``, and restores the setting."""
    data = as_tensor(data, device)
    kernel = as_tensor(kernel, data.device)
    f, h, w = data.shape
    kf, kh, kw = kernel.shape
    _check_channels(f, kf)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(
            data[None].to(torch.float32),
            torch.flip(kernel, (-2, -1))[None].to(torch.float32),
            padding=(kh - 1, kw - 1),
        )
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return out[0, 0]
