"""Spectral-state containers.

The same three containers as the JAX package (``cuda_fft_convolution_tpu/
types.py``), as plain dataclasses holding split (re, im) tensors: float32,
or bfloat16 at the bf16 serving tier (``store_dtype='bfloat16'``).
Field names and the static geometry fields are kept exactly, so a ``.npz``
written by either package's ``save_spectral`` loads into the other
(``utils/checkpoint.py``).

Packing: spectra are Hermitian-packed along the LAST axis (rfft2 layout:
(..., fft_h, fft_w//2+1)). The reference packs along its column-major
innermost axis H instead (CFFT_H = FFT_H/2+1, src/cudaFFTData.cu:90-94);
``SpectralData.from_reference_packed`` loads that layout, and
``SpectralData.from_packed`` recovers the geometry of a raw rfft2 spectrum
(src/cudaConvFFTData.cu:92-98). Complex tensors appear only at this
interop surface (``split_planes``, ``combine_planes``, the ``fft``
properties).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _device_tensor(x, device) -> torch.Tensor:
    """``utils.device.as_tensor`` (imported here: the ``utils`` package
    imports this module)."""
    from cuda_fft_convolution_torch.utils.device import as_tensor

    return as_tensor(x, device)


def split_planes(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """complex → contiguous float32 (re, im) planes; a real input gives
    zeros for im. A numpy complex array is split on the host and its planes
    go to ``device`` (the card when None, ``utils/device.py``); a tensor
    stays on its device unless ``device`` is given."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return (_device_tensor(np.ascontiguousarray(x.real, np.float32), device),
                    _device_tensor(np.ascontiguousarray(x.imag, np.float32), device))
    x = _device_tensor(x, device)
    if x.is_complex():
        return x.real.float().contiguous(), x.imag.float().contiguous()
    re = x.float().contiguous()
    return re, torch.zeros_like(re)


def combine_planes(re, im, device=None) -> torch.Tensor:
    """(re, im) planes → complex64 (bf16 planes upcast), on ``re``'s device
    (array planes go to ``device``, the card when None)."""
    re = _device_tensor(re, device)
    return torch.complex(re.float(), _device_tensor(im, re.device).float())


def _plane_pair(fft, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A complex spectrum or an (re, im) pair → float32 planes on
    ``device``."""
    if isinstance(fft, (tuple, list)):
        re = _device_tensor(fft[0], device).float()
        return re, _device_tensor(fft[1], re.device).float()
    return split_planes(fft, device)


def _unpack_h_to_w(
    g_re: torch.Tensor, g_im: torch.Tensor, fft_h: int, fft_w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """H-packed half-spectrum planes (F, FFT_H//2+1, FFT_W) → the W-packed
    layout (F, FFT_H, FFT_W//2+1) by Hermitian symmetry, a gather and a
    sign flip (no transform is recomputed):

        S[u, v] = G[u, v]                              for u < CFFT_H
        S[u, v] = conj(G[FFT_H−u, (FFT_W−v) % FFT_W])  otherwise."""
    dev = g_re.device
    cfft_h = fft_h // 2 + 1
    u = torch.arange(fft_h, device=dev)
    v = torch.arange(fft_w // 2 + 1, device=dev)
    mirror = u >= cfft_h  # rows recovered by conjugate symmetry
    u_src = torch.where(mirror, fft_h - u, u)
    v_src = torch.where(mirror[:, None], (fft_w - v[None, :]) % fft_w, v[None, :])
    sign = torch.where(mirror, -1.0, 1.0).to(torch.float32)
    re = g_re[:, u_src[:, None], v_src]
    im = g_im[:, u_src[:, None], v_src] * sign[None, :, None]
    return re.contiguous(), im.contiguous()


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
    def fft(self) -> torch.Tensor:
        """The spectrum as one complex64 tensor (interop; the compute path
        never builds it)."""
        return combine_planes(self.re, self.im)

    @property
    def batched(self) -> bool:
        return self.re.ndim == 4

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]

    @property
    def batch_size(self) -> int:
        return self.re.shape[0] if self.batched else 1

    @property
    def cfft_w(self) -> int:
        """Hermitian-packed width (≈ CFFT_H in the reference's H-packed
        layout, src/cudaConvolutionFFT.cu:112)."""
        return self.fft_w // 2 + 1

    @classmethod
    def from_complex(
        cls, fft, fft_h: int, fft_w: int, data_h: int, data_w: int, *, device=None
    ) -> "SpectralData":
        """From a complex (..., fft_h, fft_w//2+1) spectrum, its planes on
        ``device`` (``split_planes``)."""
        re, im = split_planes(fft, device)
        return cls(re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=data_h, data_w=data_w)

    @classmethod
    def from_packed(
        cls, fft, data_h: int, data_w: int, *, fft_w: int | None = None, device=None
    ) -> "SpectralData":
        """From a RAW Hermitian-packed spectrum (a user's own rfft2 of the
        zero-padded data), the FFT geometry recovered from the packed shape
        — the reference's dim recovery for a bare gpuArray
        (src/cudaConvFFTData.cu:92-98). ``fft`` is complex (..., fft_h,
        fft_w//2+1) or an (re, im) pair; 2-D input is one channel, 3-D
        (F, H, Wc), 4-D (B, F, H, Wc). An even fft_w is assumed, as the
        reference does: pass ``fft_w`` for an odd size."""
        re, im = _plane_pair(fft, device)
        if re.ndim == 2:  # one channel → (1, H, Wc)
            re, im = re[None], im[None]
        if re.ndim not in (3, 4):
            raise ValueError(f"packed spectrum must be 2-4D (got shape {tuple(re.shape)})")
        fft_h, wc = int(re.shape[-2]), int(re.shape[-1])
        if fft_w is None:
            fft_w = (wc - 1) * 2
        if fft_w // 2 + 1 != wc:
            raise ValueError(f"fft_w={fft_w} inconsistent with packed width {wc}")
        return cls(re=re.contiguous(), im=im.contiguous(), fft_h=fft_h, fft_w=fft_w,
                   data_h=data_h, data_w=data_w)

    @classmethod
    def from_reference_packed(
        cls, fft, data_h: int, data_w: int, *, fft_h: int | None = None, device=None
    ) -> "SpectralData":
        """From a spectrum in the REFERENCE's packed layout — the gpuArray
        ``cudaFFTData`` returns (src/cudaFFTData.cu:90-101): MATLAB dims
        (CFFT_H, FFT_W, F) with CFFT_H = FFT_H/2+1, Hermitian-packed along
        **H**. Migrated reference state loads directly: the axes are
        moved channel-first and the layout re-packed along W by
        ``_unpack_h_to_w``. FFT_H = (CFFT_H−1)·2, the reference's recovery
        (src/cudaConvFFTData.cu:92-98); pass ``fft_h`` for an odd size.
        ``fft`` is complex or an (re, im) pair, (CFFT_H, FFT_W, F) or
        (CFFT_H, FFT_W) for one channel; planes land on ``device``."""
        g_re, g_im = _plane_pair(fft, device)
        if g_re.ndim == 2:
            g_re, g_im = g_re[..., None], g_im[..., None]
        if g_re.ndim != 3:
            raise ValueError(
                "reference-packed spectrum must be (CFFT_H, FFT_W[, F]) "
                f"(got shape {tuple(g_re.shape)})"
            )
        cfft_h, fft_w = int(g_re.shape[0]), int(g_re.shape[1])
        if fft_h is None:
            fft_h = (cfft_h - 1) * 2
        if fft_h // 2 + 1 != cfft_h:
            raise ValueError(f"fft_h={fft_h} inconsistent with packed height {cfft_h}")
        re, im = _unpack_h_to_w(g_re.movedim(-1, 0), g_im.movedim(-1, 0), fft_h, fft_w)
        return cls(re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=data_h, data_w=data_w)


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
    def fft(self) -> torch.Tensor:
        return combine_planes(self.re, self.im)

    @property
    def batched(self) -> bool:
        return self.re.ndim == 6

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]

    @property
    def batch_size(self) -> int:
        return self.re.shape[0] if self.batched else 1

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
    def fft(self) -> torch.Tensor:
        return combine_planes(self.re, self.im)

    @property
    def num_kernels(self) -> int:
        return self.re.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.re.shape[1]
