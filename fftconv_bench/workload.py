"""The general generator: a configuration's frames and bank from a seed.

Everything is made on the run's device with one ``torch.Generator`` seeded
from ``--seed``, in a few large calls. The same seed gives the same pool
and bank; the kinds below are chosen by name from the configuration file:

frames (``config["image"]``)
  ``normal``: standard normal pixels of ``shape``.
  ``smooth``: grayscale photographs stand-in, so that HOG sees oriented
  edges: ``mean + contrast`` × a coarse normal field (``coarse``² points,
  bilinearly enlarged) + ``noise`` × pixel noise.

bank (``config["bank"]``)
  ``normal``: standard normal taps of ``shape``.
  ``exemplar``: Exemplar-SVM templates: for each filter a crop of ``shape``
  from the features of a pool frame (the reference HOG), its mean taken
  out, plus ``noise`` × its standard deviation × normal noise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fftconv_bench.reference.hog import hog


@dataclasses.dataclass
class Inputs:
    pool: torch.Tensor  # (P, *frame) frames, as the client sends them
    bank: torch.Tensor  # (N, Kh, Kw, F) float32 spatial filters


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def frames(spec: dict, pool: int, gen: torch.Generator, device) -> torch.Tensor:
    shape = tuple(spec["shape"])
    kind = spec["kind"]
    if kind == "normal":
        return torch.randn((pool, *shape), generator=gen, device=device)
    if kind == "smooth":
        c = int(spec["coarse"])
        field = torch.randn((pool, 1, c, c), generator=gen, device=device)
        big = F.interpolate(field, size=shape, mode="bilinear", align_corners=False)[:, 0]
        noise = torch.randn((pool, *shape), generator=gen, device=device)
        return spec["mean"] + spec["contrast"] * big + spec["noise"] * noise
    raise ValueError(f"unknown frame kind {kind!r}")


def features(config: dict, img: torch.Tensor) -> torch.Tensor:
    """The reference HOG of one frame, float32: what a bank is cut from."""
    fe = config["front_end"]["hog"]
    return hog(img, fe["cell"], fe["bins"], dtype=torch.float32)


def bank(config: dict, pool: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    spec = config["bank"]
    n, kh, kw, f = spec["shape"]
    kind = spec["kind"]
    if kind == "normal":
        return torch.randn((n, kh, kw, f), generator=gen, device=device)
    if kind == "exemplar":
        feats = torch.stack([features(config, img) for img in pool])
        p, fh, fw, ff = feats.shape
        if ff != f:
            raise ValueError(f"bank channels {f} != feature channels {ff}")
        src = torch.randint(0, p, (n,), generator=gen, device=device)
        y0 = torch.randint(0, fh - kh + 1, (n,), generator=gen, device=device)
        x0 = torch.randint(0, fw - kw + 1, (n,), generator=gen, device=device)
        dy = torch.arange(kh, device=device)[None, :, None]
        dx = torch.arange(kw, device=device)[None, None, :]
        crops = feats[src[:, None, None], y0[:, None, None] + dy, x0[:, None, None] + dx]
        del feats
        crops = crops - crops.mean(dim=(1, 2, 3), keepdim=True)
        sd = crops.std(dim=(1, 2, 3), keepdim=True)
        noise = torch.randn(crops.shape, generator=gen, device=device)
        return crops + spec["noise"] * sd * noise
    raise ValueError(f"unknown bank kind {kind!r}")


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    device = torch.device(device)
    gen = generator(seed, device)
    pool = frames(config["image"], int(traffic["pool"]), gen, device)
    return Inputs(pool=pool, bank=bank(config, pool, gen, device))
