"""Differentiable filter-bank detector.

The port of ``cuda_fft_convolution_tpu/models/filter_bank.py``: the
reference's target workload, scoring a feature map against a bank of
templates by correlation (demoCudaConvolutionFFT.m:63-69), as a trainable
model,

    scores[b, n] = correlate(features[b], bank[n]) + bias[n]      ('same')

through the FFT path: one data FFT per image shared by the bank, the MAC
kernel (``ops/spectral_mac.py``, forward and both cotangents of its
backward on the card) and one inverse per map. The parameters live in an
``nn.Module``; ``train_step`` takes a ``torch.optim`` optimizer where the
JAX package takes an optax transformation and its state.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from cuda_fft_convolution_torch.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import validate
from cuda_fft_convolution_torch.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
)


class FilterBankDetector(nn.Module):
    """Learnable correlation filter bank.

    kernels: (N, F, Kh, Kw) float32 — the bank, channel-leading.
    bias:    (N,) float32 — per-filter score offset (DPM's per-component
             bias).
    """

    def __init__(self, kernels: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        validate(
            kernels.ndim == 4 and bias.shape == kernels.shape[:1],
            f"kernels must be (N, F, Kh, Kw) and bias (N,); got "
            f"{tuple(kernels.shape)} and {tuple(bias.shape)}",
        )
        self.kernels = nn.Parameter(kernels.to(torch.float32))
        self.bias = nn.Parameter(bias.to(torch.float32))

    @property
    def num_filters(self) -> int:
        return self.kernels.shape[0]

    def forward(self, images, *, policy=FftSizePolicy.FAST) -> torch.Tensor:
        return detect(self, images, policy=policy)


def init_detector(
    generator: torch.Generator,
    num_filters: int,
    feature_dim: int,
    kh: int,
    kw: int,
    *,
    device=None,
) -> FilterBankDetector:
    """Kernels drawn normal × 1/sqrt(F·Kh·Kw) from ``generator`` (on its
    own device, so one seed gives one bank everywhere), zero bias, on
    ``device`` (the card when None)."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(feature_dim * kh * kw)
    kernels = scale * torch.randn(
        (num_filters, feature_dim, kh, kw), generator=generator,
        device=generator.device, dtype=torch.float32,
    )
    return FilterBankDetector(
        kernels.to(dev), torch.zeros(num_filters, dtype=torch.float32, device=dev)
    )


def detector_from_numpy(fields, device=None):
    """A ``FilterBankDetector`` from the fields of the JAX package's (a
    mapping with ``kernels`` (N, F, Kh, Kw) and ``bias`` (N,) arrays), on
    ``device`` (the card when None). The parameters are copies: an
    optimizer's in-place steps leave the arrays alone."""
    device = resolve_device(device)
    return FilterBankDetector(
        *(torch.tensor(np.asarray(fields[k], np.float32), device=device)
          for k in ("kernels", "bias"))
    )


def detect(
    model: FilterBankDetector,
    images,  # (B, F, H, W), channel-leading
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> torch.Tensor:
    """Score maps (B, N, H, W): 'same'-window correlation responses plus
    the bias, differentiable end to end (``torch.fft`` and the MAC's
    ``autograd.Function``). Array images go to the model's device."""
    images = as_tensor(images, model.kernels.device)
    b, f, h, w = images.shape
    n, kf, kh, kw = model.kernels.shape
    validate(kf == f, f"feature dim mismatch: images {f}, bank {kf}")
    fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    d_re, d_im = rfft2_padded_planes(images, fft_h, fft_w)
    # Correlation = convolution with the spatially flipped kernel
    # (demoCudaConvolutionFFT.m:67-69).
    k_re, k_im = rfft2_padded_planes(
        torch.flip(model.kernels, (-2, -1)), fft_h, fft_w
    )
    p_re, p_im = spectral_mac_auto_planes(d_re, d_im, k_re, k_im)
    maps = irfft2_norm_planes(p_re, p_im, fft_h, fft_w)
    r0, c0 = (kh - 1) // 2, (kw - 1) // 2
    same = maps[:, :, r0 : r0 + h, c0 : c0 + w]
    return same + model.bias[None, :, None, None]


def loss_fn(
    model: FilterBankDetector,
    images,  # (B, F, H, W)
    targets,  # (B, N, H, W) desired response maps
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> torch.Tensor:
    """MSE between predicted and target response maps (correlation-filter
    regression, solved by gradient descent through the FFT)."""
    scores = detect(model, images, policy=policy)
    targets = as_tensor(targets, scores.device)
    return torch.mean((scores - targets) ** 2)


def train_step(
    model: FilterBankDetector,
    optimizer: torch.optim.Optimizer,
    images,
    targets,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
):
    """One gradient step through the FFT-convolution path →
    ``(model, optimizer, loss)``, the JAX package's ``(model, opt_state,
    loss)``: the loss before the step, detached. The model's parameters
    and the optimizer's state are updated in place."""
    optimizer.zero_grad()
    loss = loss_fn(model, images, targets, policy=policy)
    loss.backward()
    optimizer.step()
    return model, optimizer, loss.detach()
