"""Spectral-state containers.

The same three containers as the JAX package (``cuda_fft_convolution_tpu/
types.py``), as plain dataclasses holding split (re, im) tensors: float32,
or bfloat16 at the bf16 serving tier (``store_dtype='bfloat16'``).
Field names and the static geometry fields are kept exactly, so a ``.npz``
written by either package's ``save_spectral`` loads into the other
(``utils/checkpoint.py``).

Packing: spectra are Hermitian-packed along the LAST axis (rfft2 layout:
(..., fft_h, fft_w//2+1)).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpectralData:
    """rfft2 of zero-padded data as split planes, plus static geometry."""

    # (F, fft_h, fft_w//2+1) f32 or bf16 each, or (B, F, ...) when batched.
    re: torch.Tensor
    im: torch.Tensor
    fft_h: int
    fft_w: int
    data_h: int
    data_w: int
    # Border-clamp padding (fft_data(padding='clamp')): the far-edge band
    # the data was padded with, −1 for zero padding.
    clamp: bool = False
    band_h: int = -1
    band_w: int = -1

    @property
    def batched(self) -> bool:
        return self.re.ndim == 4

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]


@dataclasses.dataclass(frozen=True)
class TiledSpectralData:
    """Overlap-save block spectra of the data (ops/tiled.py), split planes.

    Valid only for kernels up to (max_kh, max_kw): the block stride
    V = block − maxK + 1 bakes the kernel pad in."""

    # (nbh, nbw, F, block_h, block_w//2+1) f32 or bf16 each, or
    # (B, nbh, nbw, ...).
    re: torch.Tensor
    im: torch.Tensor
    block_h: int
    block_w: int
    max_kh: int
    max_kw: int
    data_h: int
    data_w: int
    # Baked output window (api.fft_data_tiled ``trim_mode``): origin = the
    # 'full'-window index of output row/col 0, win = extent.
    origin_h: int = 0
    origin_w: int = 0
    win_h: int | None = None
    win_w: int | None = None
    # trim_mode='fftmap': the baked window is the direct engine's FFT canvas.
    fftmap_canvas: bool = False

    @property
    def batched(self) -> bool:
        return self.re.ndim == 6

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]

    @property
    def out_h(self) -> int:
        """Output extent the blocks synthesize (the 'full' extent unless a
        window was baked at precompute time)."""
        return (
            self.win_h if self.win_h is not None
            else self.data_h + self.max_kh - 1
        )

    @property
    def out_w(self) -> int:
        return (
            self.win_w if self.win_w is not None
            else self.data_w + self.max_kw - 1
        )


@dataclasses.dataclass(frozen=True)
class SpectralKernels:
    """rfft2 of a zero-padded stacked kernel bank, split planes."""

    re: torch.Tensor  # (N, F, fft_h, fft_w//2+1) f32 or bf16
    im: torch.Tensor
    fft_h: int
    fft_w: int
    # Per-kernel true spatial sizes (pre-padding), for trimming modes.
    kernel_hs: tuple
    kernel_ws: tuple
    # centered: each kernel's centre wrapped to the origin
    # (kernel_layout='centered'). flat: the JAX package's lane-packed
    # (N, F, fft_h·Wc) layout, a TPU tiling layout; the port stores planar
    # planes, so it is False here (a flat checkpoint is unpacked on load).
    centered: bool = False
    flat: bool = False

    @property
    def num_kernels(self) -> int:
        return self.re.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.re.shape[1]
