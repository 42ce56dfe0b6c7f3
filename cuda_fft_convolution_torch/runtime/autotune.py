"""Measured block-geometry table for the overlap-save engine, and its tuner.

The port of ``cuda_fft_convolution_tpu/runtime/autotune.py``. The tiled
engine's speed is set by its (valid_h, valid_w) block geometry, and the
best one is a property of the device, so the table is keyed by the device
it was measured on: ``torch.cuda.get_device_name`` for a CUDA device,
``"cpu"`` for the CPU. An entry is applied only on a device of the same
name. The builtin table is empty: the JAX package's builtin entries were
measured on a TPU v5e and say nothing about another device.

Key: (device name, kernel-envelope pow-2 per axis, feature-dim bucket,
dtype tag[, head]). ``ops.tiled.choose_block_fft`` looks a shape up before
its analytic rule. Lookups fall back from an unmeasured 2 ≤ F < 8 bucket to
F = 1, from the bf16 tier to float32, and from a non-conv head to the conv
entry, as in the JAX package.

``$FFTCONV_AUTOTUNE_CACHE`` names a JSON file that extends the table; it
is read once, on the first lookup. The port's file holds its entries by
device (``{"devices": {name: {"64,64,1,f32": [...]}}}``). A JAX-package
cache has no device in its keys, so its entries are not applied (with a
warning); a file that exists but cannot be read raises and names the file.

This is the reference's user-tunable thread-block dims (the optional
``[H W D 2D]`` 4-vector, src/cudaConvolutionFFT.cu:72-82), measured.
"""

from __future__ import annotations

import json
import os
import statistics
import time
import warnings

import numpy as np
import torch

from cuda_fft_convolution_torch.utils.errors import InvalidInputError

# (device, kh_env, kw_env, f_bucket, dtype_tag[, head]) -> (valid_h,
# valid_w, use_fused[, block_h, block_w]); explicit blocks pin an enlarged
# effective kernel envelope. Empty: no geometry has been measured for the
# port on any device yet.
_BUILTIN: dict = {}
_MEASURED: dict = {}

_ENV_CACHE_PATH = "FFTCONV_AUTOTUNE_CACHE"
_user_cache_loaded = False


def device_name(device=None) -> str:
    """The table's device key: the CUDA device's name, or ``"cpu"``. None
    is the device the port's entry points default to — the card where one
    is present, else the CPU (a key only: nothing runs here)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _envelope(n: int) -> int:
    return max(1 << (int(n) - 1).bit_length(), 8)


def _dtype_tag(store_dtype) -> str:
    return "bf16" if str(store_dtype) in ("bfloat16", "bf16") else "f32"


def _key(
    kh: int, kw: int, f: int, store_dtype="float32", head: str = "conv",
    device=None,
) -> tuple:
    base = (
        device_name(device), _envelope(kh), _envelope(kw),
        8 if f >= 8 else (2 if f >= 2 else 1),
        _dtype_tag(store_dtype),
    )
    return base if head == "conv" else base + (head,)


def register_tuned_geometry(
    kh: int, kw: int, valid_h: int, valid_w: int, *, f: int = 1,
    fused: bool = False, block_h: int | None = None,
    block_w: int | None = None, store_dtype="float32",
    head: str = "conv", device=None,
) -> None:
    """Record a measured-best geometry (and whether the fused block-conv
    ran it) for kernels in (kh, kw)'s envelope at the given tier, under
    ``device``'s name. Explicit ``block_h/block_w`` pin the block beyond
    the derived vh+kh-1. ``head='peaks'`` records a detection-head
    geometry (falls back to the conv entry when absent)."""
    entry = [int(valid_h), int(valid_w), bool(fused)]
    if block_h is not None and block_w is not None:
        entry += [int(block_h), int(block_w)]
    _MEASURED[_key(kh, kw, f, store_dtype, head, device)] = tuple(entry)


def _lookup_one(key) -> tuple | None:
    dev, eh, ew, fb, tag = key[:5]
    head = key[5:]
    # exact → F-bucket 1 at the same tier → the f32 entries in that order
    buckets = (fb, 1) if fb == 2 else (fb,)
    tags = (tag, "f32") if tag != "f32" else (tag,)
    for t in tags:
        for b in buckets:
            k = (dev, eh, ew, b, t) + head
            hit = _MEASURED.get(k, _BUILTIN.get(k))
            if hit is not None:
                return hit
    return None


def lookup_tuned_geometry(
    kh: int, kw: int, f: int = 1, store_dtype="float32",
    head: str = "conv", device=None,
) -> tuple | None:
    """Best-known (valid_h, valid_w, use_fused[, block_h, block_w]) for
    this kernel envelope at this tier on ``device``, or None. bf16 lookups
    fall back to the f32 entry, non-conv heads to the conv entry."""
    _load_user_cache()
    hit = _lookup_one(_key(kh, kw, f, store_dtype, head, device))
    if hit is None and head != "conv":
        hit = _lookup_one(_key(kh, kw, f, store_dtype, device=device))
    return None if hit is None else tuple(hit)


def _parse_entries(path: str, data) -> dict:
    """The port's cache file → {key: entry}. Raises on anything else but
    a JAX-package cache, whose device-less entries are skipped."""
    if not isinstance(data, dict):
        raise ValueError("the top level is not an object")
    if "devices" not in data:
        warnings.warn(
            f"{_ENV_CACHE_PATH}={path} holds no device names (a cache of the "
            "JAX package?): its geometries were measured elsewhere and are "
            "not applied",
            stacklevel=3,
        )
        return {}
    out = {}
    for dev, entries in data["devices"].items():
        for k, v in entries.items():
            parts = k.split(",")
            env_h, env_w, fb = (int(x) for x in parts[:3])
            key = (str(dev), env_h, env_w, fb, parts[3]) + tuple(parts[4:5])
            out[key] = tuple(bool(x) if i == 2 else int(x) for i, x in enumerate(v))
    return out


def _read_cache(path: str) -> dict:
    try:
        with open(path) as fh:
            return _parse_entries(path, json.load(fh))
    except (OSError, ValueError, TypeError, AttributeError, IndexError) as exc:
        raise InvalidInputError(
            f"autotune cache {path} ({_ENV_CACHE_PATH}) cannot be read: {exc}"
        ) from exc


def _load_user_cache() -> None:
    global _user_cache_loaded
    if _user_cache_loaded:
        return
    path = os.environ.get(_ENV_CACHE_PATH, "")
    if path and os.path.exists(path):
        for key, entry in _read_cache(path).items():
            _MEASURED.setdefault(key, entry)
    _user_cache_loaded = True


def save_user_cache() -> None:
    """Persist the measured table, every device's entries, to
    ``$FFTCONV_AUTOTUNE_CACHE`` (if set). A file there that is not the
    port's cache is left as it is, and the call raises."""
    path = os.environ.get(_ENV_CACHE_PATH, "")
    if not path:
        return
    if os.path.exists(path):
        try:
            with open(path) as fh:
                existing = json.load(fh)
        except (OSError, ValueError) as exc:
            raise InvalidInputError(
                f"autotune cache {path} cannot be read: {exc}"
            ) from exc
        if not (isinstance(existing, dict) and "devices" in existing):
            raise InvalidInputError(
                f"{path} is not this package's autotune cache (no 'devices' "
                "key); not overwriting it — point FFTCONV_AUTOTUNE_CACHE at "
                "another file"
            )
    devices: dict = {}
    for (dev, *rest), v in _MEASURED.items():
        devices.setdefault(dev, {})[",".join(str(x) for x in rest)] = list(v)
    with open(path, "w") as fh:
        json.dump({"devices": devices}, fh)


def default_candidates(kh: int, kw: int) -> list[tuple]:
    """Candidate plans for ``autotune_block_geometry`` — the JAX package's
    list: (vh, vw) geometries whose Hermitian width Wc is a multiple of
    128, and (vh, vw, block_h, block_w) enlarged-envelope plans with
    blocks (2·Ke or 4·Ke, 511)."""
    ke_h = _envelope(kh)
    base_h = [max(8, _envelope(kh - 1) // 2), _envelope(kh - 1),
              2 * _envelope(kh - 1)]
    cand_w = []
    m0 = -(-(128 + kw) // 256)
    for m in (m0, m0 + 1, m0 + 2):
        vw = 256 * m - kw
        if vw >= 128:
            cand_w.append(vw)
    cands: list[tuple] = [(vh, vw) for vh in base_h for vw in cand_w]
    if ke_h % 8 == 0 and kw <= 128:
        for mult in (2, 4):
            bh = mult * ke_h
            vh = bh - ke_h
            if vh >= 8:
                cands.append((vh, 384, bh, 511))
    return cands


def _blocks(cand: tuple, kh: int, kw: int) -> tuple[int, int, int, int]:
    """A candidate → (vh, vw, block_h, block_w)."""
    if len(cand) == 4:
        return tuple(cand)
    vh, vw = cand
    return vh, vw, vh + kh - 1, vw + kw - 1


def _median_ms(fn, iters: int, device: torch.device) -> float:
    """Median ms of ``fn()`` over ``iters`` runs after a warm-up: CUDA
    events on a CUDA device, the host clock on the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def autotune_block_geometry(
    data_shape: tuple,  # (H, W, F) channels-last
    kh: int,
    kw: int,
    *,
    n_kernels: int = 32,
    candidates: list[tuple] | None = None,
    iters: int = 3,
    register: bool = True,
    store_dtype: str = "float32",
    sweep_groups: bool = True,
    device=None,
) -> tuple[tuple, dict]:
    """Measure candidate block plans on ``device`` (the card unless
    ``device='cpu'``) for this workload shape → (best, {plan: seconds}).
    Plans are (valid_h, valid_w) or (valid_h, valid_w, block_h, block_w);
    the latter pins explicit blocks with an enlarged effective kernel
    envelope (extra prehistory zeros; the same maps).

    Each candidate runs ``conv_spectral(mode='same')`` on seeded random
    data and bank spectra at ``store_dtype``; on a CUDA device it is timed
    with CUDA events, the median of ``iters`` after a warm-up. A candidate
    is declined only by rule: a block below the kernel, or one the image
    does not span. Whether it runs the fused kernel is the shared-memory
    rule of ``ops.tiled.fused_dispatch_auto``; a launch error propagates.

    The winner is registered under the device's name with its explicit
    blocks and its fused flag, so that lookup and dispatch reproduce the
    measured configuration. ``sweep_groups`` is accepted with nothing to
    sweep: the Hopper kernel picks its CTA configuration by rule
    (``ops/block_conv.py`` ``blocks_per_cta``, ``tile_rows``), where the
    TPU kernel has (MBH, MBW) block groups to choose."""
    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.ops.tiled import fused_dispatch_auto
    from cuda_fft_convolution_torch.utils.device import resolve_device

    del sweep_groups
    dev = resolve_device(device)
    h, w, f = data_shape
    if candidates is None:
        candidates = default_candidates(kh, kw)
    store_t = api._resolve_store_dtype(store_dtype)
    rng = np.random.default_rng(0)
    data = torch.as_tensor(rng.standard_normal((h, w, f)).astype(np.float32), device=dev)
    kerns = torch.as_tensor(
        rng.standard_normal((n_kernels, kh, kw, f)).astype(np.float32), device=dev
    )

    timings: dict = {}
    fused_flags: dict = {}
    for cand in candidates:
        vh, vw, bh, bw = _blocks(cand, kh, kw)
        pkh, pkw = bh - vh + 1, bw - vw + 1  # effective envelope
        if pkh < kh or pkw < kw:
            continue
        if bh > h + pkh - 1 or bw > w + pkw - 1:
            continue
        with torch.no_grad():
            sd = api.fft_data_tiled(
                data, pkh, pkw, block_h=bh, block_w=bw, store_dtype=store_dtype
            )
            sk = api.fft_kernels(kerns, spectral=sd, store_dtype=store_dtype,
                                 storage="planar")
            ms = _median_ms(lambda: api.conv_spectral(sd, sk, mode="same"), iters, dev)
        timings[cand] = ms / 1e3
        fused_flags[cand] = fused_dispatch_auto(bw, store_t, vh)
        del sd, sk
    if not timings:
        raise InvalidInputError(
            f"no autotune candidate fits data {tuple(data_shape)} with kernel "
            f"({kh},{kw}): {candidates}"
        )
    best = min(timings, key=timings.get)
    vh, vw, bh, bw = _blocks(best, kh, kw)
    if register:
        register_tuned_geometry(
            kh, kw, vh, vw, f=f, fused=fused_flags[best], block_h=bh,
            block_w=bw, store_dtype=store_dtype, device=dev,
        )
    return best, timings
