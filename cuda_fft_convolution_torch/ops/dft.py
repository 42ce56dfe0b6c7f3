"""Windowed inverse-DFT matrices consumed by the fused block-conv kernel.

numpy copies of the JAX package's matrix functions (``cuda_fft_convolution_tpu/
ops/dft.py`` ``_inv_packed_mats`` and ``_inv_full_mats``): built in float64
and rounded to float32 once, so both packages hand their kernels the same
matrices bit for bit (the tests pin each with ``np.array_equal``). The
MXU-DFT transform stack is not ported: ``torch.fft`` replaces it.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def _inv_packed_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Hermitian-packed → real inverse matrices (L//2+1 × L), weights folded.

    x[n] = (1/L) Σ_m w_m [ Sr[m] cos(2πnm/L) − Si[m] sin(2πnm/L) ],
    w_m = 1 for m ∈ {0, L/2}, else 2 (Hermitian double-count)."""
    wc = l // 2 + 1
    n = np.arange(l)[None, :].astype(np.float64)
    m = np.arange(wc)[:, None].astype(np.float64)
    w = np.where((m == 0) | (m == l / 2), 1.0, 2.0)
    ph = 2.0 * np.pi * n * m / l
    mr = (w * np.cos(ph) / l).astype(np.float32)  # (Wc, L)
    mi = (-w * np.sin(ph) / l).astype(np.float32)
    return mr, mi


@functools.lru_cache(maxsize=64)
def _inv_full_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Full inverse DFT matrix G[n,k] = exp(+2πi nk/L)/L, split planes f32."""
    n = np.arange(l)[:, None].astype(np.float64)
    k = np.arange(l)[None, :].astype(np.float64)
    ph = 2.0 * np.pi * n * k / l
    return (np.cos(ph) / l).astype(np.float32), (np.sin(ph) / l).astype(
        np.float32
    )
