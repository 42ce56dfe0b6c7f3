"""FFT-size policies (pure Python; the definition of record is the JAX
package's ``utils/fft_size.py`` and the tests pin this copy to it).

The reference picks FFT dims as ``round_up_to_16(data + max_kernel - 1)``
(src/cudaConvFFTData.h:96 ``computeFFTsize16``) with a legacy pow-2 policy
(``computeFFTsize`` :67). ``fast`` rounds to the next 5-smooth size, which
cuFFT (like XLA's FFT) transforms fastest; ``tpu`` additionally aligns H to
8 and W to 128 and is kept so that spectra sized by either package agree.
"""

from __future__ import annotations

import enum
import functools


def ceil_div(a: int, b: int) -> int:
    """Ceiling division (reference ``iDivUp``, src/cudaConvFFTData.h:36)."""
    return -(-a // b)


def align_up(a: int, b: int) -> int:
    """Round ``a`` up to a multiple of ``b`` (reference ``iAlignUp`` :41)."""
    return ceil_div(a, b) * b


def next_multiple_of_16(n: int) -> int:
    """Reference-parity policy: round up to a multiple of 16."""
    return align_up(max(int(n), 1), 16)


def next_pow2(n: int) -> int:
    """Legacy reference policy: align to 16, then the next power of two."""
    n = align_up(max(int(n), 1), 16)
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=4096)
def next_fast_len(n: int, primes: tuple = (2, 3, 5)) -> int:
    """Smallest integer >= n that factors entirely into ``primes``."""
    n = max(int(n), 1)
    if n <= max(primes):
        return n

    def is_smooth(m: int) -> bool:
        for p in primes:
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while not is_smooth(m):
        m += 1
    return m


def next_fast_len_aligned(n: int, align: int) -> int:
    """Smallest 5-smooth integer >= n that is also a multiple of ``align``
    (``align`` itself 5-smooth)."""
    return align * next_fast_len(ceil_div(n, align))


class FftSizePolicy(str, enum.Enum):
    """How to round ``data + max_kernel - 1`` up to the FFT size.

    MULTIPLE16  — reference parity (computeFFTsize16).
    POW2        — legacy reference policy (computeFFTsize).
    FAST        — next 5-smooth size.
    TPU         — 5-smooth AND aligned: H to 8, W to 128.
    """

    MULTIPLE16 = "multiple16"
    POW2 = "pow2"
    FAST = "fast"
    TPU = "tpu"


def compute_fft_size(
    data_h: int,
    data_w: int,
    max_kernel_h: int,
    max_kernel_w: int,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> tuple[int, int]:
    """FFT dims for linear convolution of (data_h, data_w) with kernels up to
    (max_kernel_h, max_kernel_w): ``policy(data + maxK - 1)``
    (src/cudaConvolutionFFT.cu:103-110)."""
    policy = FftSizePolicy(policy)
    need_h = data_h + max_kernel_h - 1
    need_w = data_w + max_kernel_w - 1
    if policy is FftSizePolicy.MULTIPLE16:
        return next_multiple_of_16(need_h), next_multiple_of_16(need_w)
    if policy is FftSizePolicy.POW2:
        return next_pow2(need_h), next_pow2(need_w)
    if policy is FftSizePolicy.FAST:
        return next_fast_len(need_h), next_fast_len(need_w)
    return (
        next_fast_len_aligned(need_h, 8),
        next_fast_len_aligned(need_w, 128),
    )
