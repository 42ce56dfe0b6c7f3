"""Filter-bank convolution through the FFT, in float64, filter block by
filter block so that a bank of any size fits beside the card's other
tensors.

The output windows are the port's documented ones, stated here from their
definitions: 'fftmap' is the circular convolution on an (nh, nw) canvas,
nh and nw the smallest 5-smooth sizes ≥ H + Kh − 1 and W + Kw − 1 (so it is
the full linear convolution, zero beyond it); 'same' is the full
convolution's (H, W) window at offset ((Kh − 1) // 2, (Kw − 1) // 2) (the
scipy offset); ``correlation`` convolves with the kernel flipped in both
spatial axes. Channels (the last axis) are summed.

``precision`` other than 'float64' computes the control: the same
arithmetic in float32 with the inputs, both spectra and their products
rounded to a lower precision ('tf32': 10 mantissa bits, round to nearest
even; 'fp8': float8 e4m3 with one scale per tensor), the nearest step below
what a configuration states.
"""

from __future__ import annotations

from typing import Iterator

import torch

PRECISIONS = ("float64", "tf32", "fp8")


def next_5smooth(n: int) -> int:
    """The smallest integer ≥ n whose only prime factors are 2, 3 and 5."""
    m = max(int(n), 1)
    while True:
        r = m
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def canvas(h: int, w: int, kh: int, kw: int) -> tuple[int, int]:
    return next_5smooth(h + kh - 1), next_5smooth(w + kw - 1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale for the tensor (amax to
    e4m3's largest normal, 448)."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


_ROUND = {"tf32": round_tf32, "fp8": round_fp8}


def _planes(z: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return z
    r = _ROUND[precision]
    return torch.complex(r(z.real), r(z.imag))


def conv_blocks(images: torch.Tensor, bank: torch.Tensor, *, mode: str,
                correlation: bool = False, precision: str = "float64",
                block_bytes: int = 2 << 30) -> Iterator[tuple[int, torch.Tensor]]:
    """Yield ``(n0, maps)``: the maps of filters n0, n0 + 1, … of ``bank``
    (N, Kh, Kw, F) over each of ``images`` (B, H, W, F), as (B, n, h, w)
    tensors in float64 (float32 for a control precision), on ``images``'
    device. Each filter's spectrum is computed once for all B images."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if mode not in ("same", "fftmap"):
        raise ValueError(f"mode must be 'same' or 'fftmap', got {mode!r}")
    real = torch.float64 if precision == "float64" else torch.float32
    b, h, w, f = images.shape
    n, kh, kw, kf = bank.shape
    if kf != f:
        raise ValueError(f"channels differ: images {f}, bank {kf}")
    nh, nw = canvas(h, w, kh, kw)
    rnd = (lambda t: t.to(real)) if precision == "float64" else _ROUND[precision]
    x = rnd(images).to(real).permute(0, 3, 1, 2)
    d = _planes(torch.fft.rfft2(x, s=(nh, nw)), precision)  # (B, F, nh, nw/2+1)
    per_filter = (2 * f + 3 * b) * nh * (nw // 2 + 1) * 2 * real.itemsize
    step = max(1, min(n, block_bytes // per_filter))
    for n0 in range(0, n, step):
        k = rnd(bank[n0 : n0 + step]).to(real).permute(0, 3, 1, 2)
        if correlation:
            k = k.flip(-2, -1)
        ks = _planes(torch.fft.rfft2(k, s=(nh, nw)), precision)  # (n, F, ...)
        prod = ks[None, :, 0] * d[:, None, 0]
        for c in range(1, f):
            prod += ks[None, :, c] * d[:, None, c]
        del ks
        maps = torch.fft.irfft2(_planes(prod, precision), s=(nh, nw))
        del prod
        if mode == "same":
            r0, c0 = (kh - 1) // 2, (kw - 1) // 2
            maps = maps[..., r0 : r0 + h, c0 : c0 + w]
        yield n0, maps
