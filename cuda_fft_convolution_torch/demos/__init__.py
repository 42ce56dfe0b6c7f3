"""The six demos of the JAX package's ``examples/``, on the port: each
module's ``main(argv=None, device=None) -> dict`` runs its scenario (``argv``
the command line's arguments, None for none), raises
``AssertionError`` on a failed check, and returns its checks and numbers;
``python -m cuda_fft_convolution_torch.demos.<name>`` runs it on the card
(``--device cpu`` on the CPU).

  - ``demo``:         the reference demo (demoCudaConvolutionFFT.m)
  - ``demo_bank``:    a filter bank against a large image, both engines
  - ``demo_detect``:  the detection heads, ragged serving, the pyramid
  - ``demo_dpm``:     HOG features and a large filter bank
  - ``demo_serving``: amortized spectra, plans, ``ConvStream``, the bf16 tier
  - ``demo_train``:   a filter bank trained through the FFT path, and MOSSE

``device='cpu'`` runs a demo on the CPU, where each kernel's plain version
runs. Times are printed beside the device they were taken on (on the card,
its name and power limit as nvidia-smi reports them).
"""

from __future__ import annotations

import functools
import subprocess

import numpy as np
import torch

from cuda_fft_convolution_torch.utils.device import resolve_device


def demo_device(device, args) -> torch.device:
    """``main``'s ``device``, else the command line's ``--device``, else
    the card (``utils/device.py``: without one the demo raises)."""
    return resolve_device(device if device is not None else args.device)


def check(cond, msg: str) -> None:
    """A demo's assertion (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def host(x) -> np.ndarray:
    """A tensor or array as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, np.float64)


def rel(got, want) -> float:
    """max |got − want| / max |want|."""
    got, want = host(got), host(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.cache
def device_label(device: torch.device) -> str:
    """The device a time was taken on: the card's name and power limit
    (nvidia-smi), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return smi.stdout.strip().splitlines()[index].strip()
