"""Spectral-state persistence in the JAX package's ``.npz`` layout.

The keys are those of ``cuda_fft_convolution_tpu/utils/checkpoint.py``:
``kind`` (the container's class name), ``store_dtype``, ``fft_re`` and
``fft_im`` (f32 planes), and one entry per static field, with None written
as −1. A bank's spectra or an image's block spectra saved by either package
load into the other's containers. Spectra of the bf16 serving tier are
saved as f32 planes (``.npz`` has no bfloat16; the widening is exact) with
``store_dtype='bfloat16'``, and a load restores the tier. A JAX flat bank
(planes (N, F, fft_h·Wc), ``flat=True``) is unpacked on load to the port's
planar (N, F, fft_h, Wc) planes with ``flat=False``; saving is always
planar, which the JAX package loads as such.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.device import resolve_device
from cuda_fft_convolution_torch.utils.errors import validate

_KINDS = {
    "SpectralData": SpectralData,
    "TiledSpectralData": TiledSpectralData,
    "SpectralKernels": SpectralKernels,
}
# Static fields whose None is written as −1 (all other −1s are values,
# e.g. SpectralData.band_h's 'unknown').
_OPTIONAL = {"win_h", "win_w"}
_BOOL = {"clamp", "fftmap_canvas", "centered", "flat"}
_TUPLE = {"kernel_hs", "kernel_ws"}
_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def save_spectral(path: str, obj) -> None:
    """Serialize a spectral container to ``path`` (.npz)."""
    kind = type(obj).__name__
    validate(kind in _KINDS, f"not a spectral object: {type(obj)}")
    validate(
        obj.re.dtype in _STORE_DTYPES.values(),
        f"spectra must be float32 or bfloat16 (got {obj.re.dtype})",
    )
    store_dtype = str(obj.re.dtype).removeprefix("torch.")
    meta = {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if f.name not in ("re", "im")
    }
    np.savez(
        path,
        kind=kind,
        store_dtype=store_dtype,
        fft_re=obj.re.detach().float().cpu().numpy(),
        fft_im=obj.im.detach().float().cpu().numpy(),
        **{k: np.asarray(-1 if v is None else v) for k, v in meta.items()},
    )


def from_numpy(fields, device=None):
    """Build a spectral container from the arrays of a saved ``.npz`` (a
    mapping of key → numpy array), with its planes on ``device`` (the card
    when None; ``utils/device.py``)."""
    kind = str(fields["kind"])
    validate(kind in _KINDS, f"unknown spectral kind {kind!r}")
    store_dtype = str(fields["store_dtype"]) if "store_dtype" in fields else "float32"
    validate(
        store_dtype in _STORE_DTYPES,
        f"unknown store_dtype {store_dtype!r} (float32 or bfloat16)",
    )
    cls = _KINDS[kind]
    device = resolve_device(device)
    kwargs = {
        key: torch.as_tensor(
            np.asarray(fields[f"fft_{key}"], np.float32), device=device
        ).to(_STORE_DTYPES[store_dtype])
        for key in ("re", "im")
    }
    for f in dataclasses.fields(cls):
        if f.name in ("re", "im") or f.name not in fields:
            continue  # a field added after the file was saved: its default
        v = np.asarray(fields[f.name])
        if f.name in _TUPLE:
            kwargs[f.name] = tuple(int(x) for x in v.reshape(-1))
        elif f.name in _BOOL:
            kwargs[f.name] = bool(v)
        elif f.name in _OPTIONAL and int(v) < 0:
            kwargs[f.name] = None
        else:
            kwargs[f.name] = int(v)
    if kwargs.get("flat"):
        shape = (*kwargs["re"].shape[:2], kwargs["fft_h"], kwargs["fft_w"] // 2 + 1)
        validate(
            kwargs["re"].shape[-1] == shape[2] * shape[3],
            f"flat bank planes {tuple(kwargs['re'].shape)} do not pack "
            f"(fft_h, fft_w//2+1) = {shape[2:]}",
        )
        kwargs.update(re=kwargs["re"].reshape(shape), im=kwargs["im"].reshape(shape),
                      flat=False)
    return cls(**kwargs)


def load_spectral(path: str, device=None):
    """Load a container saved by either package's ``save_spectral``, with
    its planes on ``device`` (the card when None, as ``from_numpy``)."""
    with np.load(path, allow_pickle=False) as z:
        return from_numpy({k: z[k] for k in z.files}, device)
