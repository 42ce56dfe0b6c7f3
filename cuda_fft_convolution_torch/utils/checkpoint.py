"""Spectral-state persistence in the JAX package's ``.npz`` layout.

The keys are those of ``cuda_fft_convolution_tpu/utils/checkpoint.py``:
``kind`` (the container's class name), ``store_dtype``, ``fft_re`` and
``fft_im`` (f32 planes), and one entry per static field, with None written
as −1. A bank's spectra or an image's block spectra saved by either package
load into the other's containers.
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
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate

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


def save_spectral(path: str, obj) -> None:
    """Serialize a spectral container to ``path`` (.npz)."""
    kind = type(obj).__name__
    validate(kind in _KINDS, f"not a spectral object: {type(obj)}")
    validate(
        obj.re.dtype == torch.float32,
        f"only float32 spectra are stored (got {obj.re.dtype})",
    )
    meta = {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if f.name not in ("re", "im")
    }
    np.savez(
        path,
        kind=kind,
        store_dtype="float32",
        fft_re=obj.re.detach().cpu().numpy(),
        fft_im=obj.im.detach().cpu().numpy(),
        **{k: np.asarray(-1 if v is None else v) for k, v in meta.items()},
    )


def from_numpy(fields, device=None):
    """Build a spectral container from the arrays of a saved ``.npz`` (a
    mapping of key → numpy array), with its planes on ``device`` (the CPU
    when None)."""
    kind = str(fields["kind"])
    validate(kind in _KINDS, f"unknown spectral kind {kind!r}")
    if "store_dtype" in fields and str(fields["store_dtype"]) != "float32":
        raise InvalidInputError(
            f"store_dtype={str(fields['store_dtype'])!r} spectra are not "
            "ported to cuda_fft_convolution_torch yet (ROADMAP queue 1 item 6)"
        )
    cls = _KINDS[kind]
    kwargs = {
        "re": torch.as_tensor(np.asarray(fields["fft_re"], np.float32), device=device),
        "im": torch.as_tensor(np.asarray(fields["fft_im"], np.float32), device=device),
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
    return cls(**kwargs)


def load_spectral(path: str, device=None):
    """Load a container saved by either package's ``save_spectral``, with
    its planes on ``device`` (the CPU when None)."""
    with np.load(path, allow_pickle=False) as z:
        return from_numpy({k: z[k] for k in z.files}, device)
