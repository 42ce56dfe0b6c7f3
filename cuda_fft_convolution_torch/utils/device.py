"""Where the port's entry points run.

The card is the default: a numpy or array-like input with ``device=None``
goes to ``torch.device('cuda')``; a tensor stays on its device unless
``device`` is given; ``device='cpu'`` runs on the CPU. With no CUDA device
and no ``device='cpu'`` the call raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_fft_convolution_torch.utils.errors import InvalidInputError


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the card, which must be
    present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise InvalidInputError(
            "no CUDA device: cuda_fft_convolution_torch runs on the card "
            "unless asked for the CPU; pass device='cpu' (or CPU tensors) "
            "to run there"
        )
    return torch.device("cuda")


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its device (moved only when ``device`` is given);
    any other input is copied to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.tensor(np.asarray(x), device=resolve_device(device))
