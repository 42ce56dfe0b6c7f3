"""The comparisons that decide ``correct``: the program's answers against
the float64 reference, each as one number that a limit bounds.

Every number is relative to the reference map's own largest magnitude, so
that it reads alike on maps of any scale:

- ``map_err``: the largest |program − reference| over a map, over that
  map's max |reference|; the largest over the maps and frames compared;
- ``peak_value_err``: |the program's peak value − the reference map's
  maximum|, on the same scale;
- ``peak_position_gap``: the reference map's maximum less its value at the
  position the program reported, on the same scale: 0 where the program
  found the maximum, small where it found a near tie, large where it
  found another place. A position outside the map reads infinity.

Both take the reference as ``(n0, ref)`` blocks, ``ref`` (B, n, h, w) for
B frames, and the program's answers for the same B frames in that order.
Each returns its number for each of the B frames.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

_TINY = 1e-300


def map_err(maps: list, ref_blocks: Iterable) -> list[float]:
    """``maps``: B tensors (N, h, w) of any dtype."""
    worst = [0.0] * len(maps)
    for n0, ref in ref_blocks:
        for b, got in enumerate(maps):
            r = ref[b].to(torch.float64)
            g = got[n0 : n0 + r.shape[0]].to(device=r.device, dtype=torch.float64)
            if g.shape != r.shape:
                worst[b] = math.inf
                continue
            scale = r.abs().flatten(1).amax(1).clamp_min(_TINY)
            err = (g - r).abs().flatten(1).amax(1) / scale
            worst[b] = max(worst[b], float(err.max()))
    return worst


def peak_errs(answers: list, ref_blocks: Iterable) -> list[tuple[float, float]]:
    """``answers``: B pairs (values (R, N), positions (R, N, 2) as (row,
    column)), R answers for each frame. Returns (peak_value_err,
    peak_position_gap) for each frame."""
    out = [[0.0, 0.0] for _ in answers]
    for n0, ref in ref_blocks:
        for b, (values, positions) in enumerate(answers):
            r = ref[b].to(torch.float64)
            nb, h, w = r.shape
            flat = r.flatten(1)
            top = flat.amax(1)
            scale = flat.abs().amax(1).clamp_min(_TINY)
            v = values[:, n0 : n0 + nb].to(device=r.device, dtype=torch.float64)
            pos = positions[:, n0 : n0 + nb].to(device=r.device, dtype=torch.int64)
            out[b][0] = max(out[b][0], float(((v - top) / scale).abs().max()))
            ys, xs = pos[..., 0], pos[..., 1]
            if not bool(((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)).all()):
                out[b][1] = math.inf
                continue
            at = torch.gather(flat.expand(v.shape[0], nb, h * w), 2,
                              (ys * w + xs)[..., None])[..., 0]
            out[b][1] = max(out[b][1], float(((top - at) / scale).max()))
    return [tuple(x) for x in out]
