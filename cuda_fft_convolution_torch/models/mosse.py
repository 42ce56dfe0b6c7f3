"""MOSSE correlation filters: closed-form training in the spectral domain.

The port of ``cuda_fft_convolution_tpu/models/mosse.py``. The MOSSE
(Minimum Output Sum of Squared Error) filter is the least-squares optimal
correlation template (Bolme et al., CVPR 2010),

    Ĥ* = Σ_i Ĝ_i ⊙ conj(F̂_i)  /  ( Σ_i F̂_i ⊙ conj(F̂_i) + λ ),

per feature channel, computed from the same spectra (``SpectralData``) the
convolution API uses; the response sums the channels, which on the card
is the MAC kernel over a bank of one filter (``ops/spectral_mac.py``).

The filter spectrum is kept as split (re, im) float32 planes, like every
spectral object of the port; complex tensors exist only inside
``train_mosse`` and ``update_mosse``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_fft_convolution_torch.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac
from cuda_fft_convolution_torch.types import SpectralData
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import validate


@dataclasses.dataclass(frozen=True)
class MosseFilter:
    """Spectral-domain correlation filter: the conj-filter spectrum Ĥ* per
    channel as split (re, im) float32 planes, at a fixed FFT size."""

    h_re: torch.Tensor  # (F, fft_h, fft_w//2+1) float32
    h_im: torch.Tensor
    fft_h: int
    fft_w: int

    @property
    def h_conj(self) -> torch.Tensor:
        """Complex64 view of Ĥ* (interop and debugging only)."""
        return torch.complex(self.h_re, self.h_im)


def mosse_from_numpy(fields, device=None):
    """A ``MosseFilter`` from the fields of the JAX package's (a mapping
    with ``h_re``, ``h_im`` (F, fft_h, fft_w//2+1) arrays, ``fft_h`` and
    ``fft_w``), on ``device`` (the card when None)."""
    device = resolve_device(device)
    planes = {
        k: torch.tensor(np.asarray(fields[k], np.float32), device=device)
        for k in ("h_re", "h_im")
    }
    fft_h, fft_w = int(fields["fft_h"]), int(fields["fft_w"])
    validate(
        planes["h_re"].shape == planes["h_im"].shape
        and planes["h_re"].shape[-2:] == (fft_h, fft_w // 2 + 1),
        f"MOSSE planes {tuple(planes['h_re'].shape)} do not match the FFT "
        f"size ({fft_h}, {fft_w})",
    )
    return MosseFilter(**planes, fft_h=fft_h, fft_w=fft_w)


def gaussian_target(
    fft_h: int, fft_w: int, center: tuple[int, int], sigma: float = 2.0,
    *, device=None,
) -> torch.Tensor:
    """Desired response map (fft_h, fft_w) float32: a Gaussian peak at
    ``center`` (the MOSSE training target), on ``device`` (the card when
    None)."""
    dev = resolve_device(device)
    r = torch.arange(fft_h, device=dev)[:, None]
    c = torch.arange(fft_w, device=dev)[None, :]
    d2 = (r - center[0]) ** 2 + (c - center[1]) ** 2
    return torch.exp(-d2 / (2.0 * sigma**2)).to(torch.float32)


def _spectra(x: torch.Tensor, fft_h: int, fft_w: int) -> torch.Tensor:
    """rfft2 of ``x`` zero-padded to (fft_h, fft_w), as one complex tensor."""
    return torch.complex(*rfft2_padded_planes(x, fft_h, fft_w))


def _planes(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return h.real.contiguous(), h.imag.contiguous()


def train_mosse(
    patches,  # (S, F, H, W) training patches (channel-leading)
    targets,  # (S, fft_h, fft_w) desired responses
    fft_h: int,
    fft_w: int,
    *,
    reg: float = 1e-2,
    device=None,
) -> MosseFilter:
    """Closed-form MOSSE solve over S training patches. ``device``: where
    array inputs go (the card when None); ``targets`` follow the patches."""
    patches = as_tensor(patches, device)
    validate(
        patches.ndim == 4,
        f"patches must be (S, F, H, W); got {tuple(patches.shape)}",
    )
    targets = as_tensor(targets, patches.device).to(torch.float32)
    f_hat = _spectra(patches, fft_h, fft_w)  # (S, F, fh, wc)
    g_hat = torch.fft.rfft2(targets)  # (S, fh, wc)
    num = torch.sum(g_hat[:, None] * torch.conj(f_hat), dim=0)  # (F, fh, wc)
    den = torch.sum(f_hat * torch.conj(f_hat), dim=0) + reg
    h_re, h_im = _planes(num / den)
    return MosseFilter(h_re=h_re, h_im=h_im, fft_h=fft_h, fft_w=fft_w)


def update_mosse(
    filt: MosseFilter,
    patch,  # (F, H, W)
    target,  # (fft_h, fft_w)
    *,
    lr: float = 0.125,
    reg: float = 1e-2,
) -> MosseFilter:
    """Online running-average update (the MOSSE tracker's per-frame adapt),
    the standard practical variant: an exponential moving average of the
    ratio. Array inputs go to the filter's device."""
    dev = filt.h_re.device
    patch = as_tensor(patch, dev)
    target = as_tensor(target, dev).to(torch.float32)
    f_hat = _spectra(patch[None], filt.fft_h, filt.fft_w)[0]  # (F, fh, wc)
    g_hat = torch.fft.rfft2(target)
    new = (g_hat[None] * torch.conj(f_hat)) / (
        torch.sum(f_hat * torch.conj(f_hat), dim=0, keepdim=True) + reg
    )
    h = (1.0 - lr) * torch.complex(filt.h_re, filt.h_im) + lr * new
    h_re, h_im = _planes(h)
    return MosseFilter(h_re=h_re, h_im=h_im, fft_h=filt.fft_h, fft_w=filt.fft_w)


def respond(filt: MosseFilter, spectral: SpectralData) -> torch.Tensor:
    """Correlation response of a precomputed data spectrum against the
    filter: Σ_f IFFT(D̂_f ⊙ Ĥ*_f), one spectral MAC and one inverse
    transform → (fft_h, fft_w), or (B, fft_h, fft_w) for batched spectra.
    The MAC is ``spectral_mac`` over a bank of one filter (bf16 data planes
    upcast to float32): the kernel on CUDA tensors, its plain version on
    CPU tensors."""
    validate(
        spectral.fft_h == filt.fft_h and spectral.fft_w == filt.fft_w,
        f"FFT dims mismatch: data ({spectral.fft_h},{spectral.fft_w}), "
        f"filter ({filt.fft_h},{filt.fft_w})",
    )
    d_re = spectral.re if spectral.batched else spectral.re[None]
    d_im = spectral.im if spectral.batched else spectral.im[None]
    p_re, p_im = spectral_mac(
        d_re.float().contiguous(), d_im.float().contiguous(),
        filt.h_re[None], filt.h_im[None],
    )
    out = irfft2_norm_planes(p_re[:, 0], p_im[:, 0], filt.fft_h, filt.fft_w)
    return out if spectral.batched else out[0]
