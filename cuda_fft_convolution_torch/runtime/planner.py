"""Bank planning: how many kernels a pass over a bank may hold at once.

The port of ``cuda_fft_convolution_tpu/runtime/planner.py``'s ``BankPlan``
and ``plan_bank``, with the same structure (fixed residents; the unchunked
per-kernel cost with the F > 1 slack; the chunked per-kernel cost) and the
port's own byte model: plain bytes, because a CUDA tensor occupies its
element count (the JAX model pads every plane to the TPU's (8, 128) tiles),
and the tensors the port's direct engine really allocates — the MAC
kernel's products, always float32 (``ops/spectral_mac.py``), the complex
input of the C2R inverse and the copy the C2R transform overwrites, and its
output maps. Bank slices along N are views here, so a chunk copies nothing
of the bank. The JAX package's native planner (``csrc/planner.cpp``) models
the TPU and is not used.

Every function counts bytes of one ``fft_h × fft_w`` transform size;
``store_bytes`` is the width of the stored spectra (4 = float32, 2 = the
bf16 serving tier).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BankPlan:
    """chunk_size: kernels per chunk (the whole bank when it fits);
    peak_bytes: the modelled device working set at that chunk size."""

    chunk_size: int
    peak_bytes: int


def spectra_bytes(
    n: int, f: int, fft_h: int, fft_w: int, store_bytes: int = 4
) -> int:
    """The (re, im) planes of ``n × f`` stored spectra (N, F, fft_h, Wc)."""
    return 2 * store_bytes * n * f * fft_h * (fft_w // 2 + 1)


def transform_bytes(f: int, fft_h: int, fft_w: int) -> int:
    """Temporaries of one kernel's forward transform (``ops/conv.py
    rfft2_padded_planes``): its ``f`` zero-padded float32 channels, their
    complex64 spectra and the float32 planes split from them."""
    return f * (4 * fft_h * fft_w + 16 * fft_h * (fft_w // 2 + 1))


def inverse_bytes(fft_h: int, fft_w: int, store_bytes: int = 4) -> int:
    """Temporaries of one (image, kernel) map on the direct engine: the MAC
    kernel's float32 products, at the bf16 tier their bf16 copy and its
    float32 upcast, the complex64 input of the C2R inverse and the copy
    the C2R transform works in (its output is counted as a map)."""
    plane = fft_h * (fft_w // 2 + 1)
    tier = (2 * store_bytes + 8) * plane if store_bytes < 4 else 0
    return 8 * plane + tier + 16 * plane


def _map_bytes(fft_h: int, fft_w: int) -> int:
    return 4 * fft_h * fft_w


def plan_transform(
    n_kernels: int,
    feature_dim: int,
    fft_h: int,
    fft_w: int,
    hbm_budget_bytes: int = 8 << 30,
    store_bytes: int = 4,
    stack_bytes: int = 0,
) -> BankPlan:
    """The chunk size of a bank's forward transform (``api.fft_kernels``):
    the stored spectra and the ``stack_bytes`` of spatial kernels are
    resident, and a chunk's transform temporaries may take a quarter of
    what is left (the JAX package's rule, in plain bytes); the whole bank
    when they fit. Peak: the residents plus one chunk's temporaries."""
    resident = spectra_bytes(n_kernels, feature_dim, fft_h, fft_w, store_bytes)
    per_k = transform_bytes(feature_dim, fft_h, fft_w)
    avail = hbm_budget_bytes - resident - stack_bytes
    chunk = max(1, min(n_kernels, avail // (4 * per_k)))
    return BankPlan(int(chunk), int(resident + stack_bytes + chunk * per_k))


def plan_bank(
    n_kernels: int,
    feature_dim: int,
    fft_h: int,
    fft_w: int,
    batch: int = 1,
    hbm_budget_bytes: int = 8 << 30,
    store_bytes: int = 4,
) -> BankPlan:
    """The chunk size that keeps a bank convolution against resident
    spectra inside ``hbm_budget_bytes``: the whole bank when it fits,
    otherwise the most kernels whose products, inverse temporaries and
    chunk maps fit beside the residents (at least 1)."""
    spec = spectra_bytes(1, 1, fft_h, fft_w, store_bytes)
    maps = _map_bytes(fft_h, fft_w)
    # Fixed: data spectra + the data + resident bank spectra + all output maps.
    fixed = (
        batch * feature_dim * spec
        + batch * feature_dim * maps
        + n_kernels * feature_dim * spec
        + batch * n_kernels * maps
    )
    budget = hbm_budget_bytes - fixed
    # Unchunked: one map's temporaries per (image, kernel); for F > 1 the
    # JAX model's bank/16 of slack is kept as headroom for the allocator.
    per_unchunked = batch * inverse_bytes(fft_h, fft_w, store_bytes)
    unchunked_extra = (
        (n_kernels * feature_dim * spec) // 16 if feature_dim > 1 else 0
    )
    if budget >= n_kernels * per_unchunked + unchunked_extra:
        return BankPlan(
            int(n_kernels),
            int(fixed + n_kernels * per_unchunked + unchunked_extra),
        )
    # Chunked: the same temporaries plus each chunk map, which is copied
    # into the preallocated output.
    per_chunked = batch * (inverse_bytes(fft_h, fft_w, store_bytes) + maps)
    chunk = max(1, min(n_kernels, max(budget, per_chunked) // per_chunked))
    return BankPlan(int(chunk), int(fixed + chunk * per_chunked))


def plan_streaming(
    n_kernels: int,
    feature_dim: int,
    fft_h: int,
    fft_w: int,
    batch: int = 1,
    hbm_budget_bytes: int = 8 << 30,
    store_bytes: int = 4,
    stack_bytes: int = 0,
) -> BankPlan:
    """The chunk size of the streaming-spatial path, whose kernel spectra
    are never resident: each chunk is transformed, multiplied and inverted
    in turn (``api._conv_from_spatial_chunked``). Fixed: the data spectra
    (and their float32 upcast at the bf16 tier), all output maps and the
    ``stack_bytes`` of spatial kernels; per kernel: its transform and one
    map's temporaries per image."""
    plane = fft_h * (fft_w // 2 + 1)
    data = batch * feature_dim * 2 * plane * (store_bytes + (4 if store_bytes < 4 else 0))
    fixed = data + batch * n_kernels * _map_bytes(fft_h, fft_w) + stack_bytes
    per_k = transform_bytes(feature_dim, fft_h, fft_w) + batch * (
        inverse_bytes(fft_h, fft_w) + _map_bytes(fft_h, fft_w)
    )
    budget = max(hbm_budget_bytes - fixed, per_k)
    chunk = max(1, min(n_kernels, budget // per_k))
    return BankPlan(int(chunk), int(fixed + chunk * per_k))
