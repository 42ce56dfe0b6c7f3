"""Spectral multiply-accumulate on split planes (the einsum form).

    out[b, n] = Σ_f data[b, f] ⊙ kernel[n, f]      (complex, per pixel)

The JAX package's default path is this einsum too
(``cuda_fft_convolution_tpu/ops/spectral_mac.py`` ``spectral_mac_auto_planes``
with ``use_pallas`` falsy). Its Pallas MAC kernel (``_mac_kernel``) is not
ported yet (ROADMAP queue 2 item 1), so ``use_pallas=True`` is rejected.
"""

from __future__ import annotations

import torch

from cuda_fft_convolution_torch.utils.errors import InvalidInputError


def spectral_mac_planes(
    dr: torch.Tensor, di: torch.Tensor,  # (B, F, H, Wc)
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, H, Wc)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, F, H, Wc) × (N, F, H, Wc) → (B, N, H, Wc) split planes, four
    real contractions over F."""

    def e(a, b):
        return torch.einsum("bfhw,nfhw->bnhw", a, b)

    return e(dr, kr) - e(di, ki), e(di, kr) + e(dr, ki)


def spectral_mac_auto_planes(
    dr: torch.Tensor, di: torch.Tensor,
    kr: torch.Tensor, ki: torch.Tensor,
    *,
    use_pallas: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Implementation dispatch: the einsum. ``use_pallas=True`` asks for the
    JAX package's Pallas MAC kernel, which has no Hopper port yet."""
    if use_pallas:
        raise InvalidInputError(
            "use_pallas=True selects the spectral-MAC kernel, which is not "
            "ported yet (ROADMAP queue 2 item 1: ops/spectral_mac.py "
            "_mac_kernel); leave use_pallas unset to run the einsum MAC"
        )
    return spectral_mac_planes(dr, di, kr, ki)
