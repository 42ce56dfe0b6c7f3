"""The roofline yardstick, from a cell's shapes alone.

It counts the work of the convolution whatever implements it, so that no
change of the program's plan, body or kernels can make it stale:

- bytes: each input read once (the frame as the stream receives it, and the
  bank in space at its stored precision) and each output written once (the
  maps at their dtype, or 12 bytes a filter for a (value, row, column)
  peak);
- FLOPs: an FFT convolution at the 5-smooth canvas n ≥ H + Kh − 1 (and W):
  2.5·n·log2(n) for each real transform of n = nh·nw points, F forward and
  N inverse (the bank's spectra are resident), and 8 for each complex
  product over F·N half-spectra of nh·(nw/2 + 1) points;
- peak: the fastest rate the configuration's accuracy allows, so that the
  share cannot pass 100%: float32 as three TF32 tensor-core passes (495 / 3
  TFLOP/s), bfloat16 at 989 TFLOP/s; HBM at 3.35 TB/s. NVIDIA's H100 SXM
  data sheet, dense, at the 700 W limit.

The bound is the larger of FLOPs over peak and bytes over bandwidth.
"""

from __future__ import annotations

import math

from fftconv_bench.reference.conv import canvas

PEAK_FLOP_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_S = 3.35e12
_BYTES = {"float32": 4, "bfloat16": 2}
PEAK_BYTES = 12  # one peak: a value and a row and a column, 4 bytes each


def conv_shapes(config: dict) -> tuple[tuple, tuple]:
    """(H, W, F) of the frame the stream receives, and (N, Kh, Kw, F)."""
    n, kh, kw, f = config["bank"]["shape"]
    fe = config.get("front_end")
    if fe:
        h, w = config["image"]["shape"][:2]
        cell = fe["hog"]["cell"]
        return (h // cell, w // cell, fe["hog"]["bins"]), (n, kh, kw, f)
    return tuple(config["image"]["shape"]), (n, kh, kw, f)


def counts(config: dict, traffic: dict) -> dict:
    (h, w, f), (n, kh, kw, _) = conv_shapes(config)
    entry = traffic["entry"]
    fe = config.get("front_end")
    frame_b = _BYTES[fe["dtype"]] if fe else 4
    store_b = _BYTES[config["entry"]["store_dtype"]]
    nh, nw = canvas(h, w, kh, kw)
    if entry.get("head") == "peaks":
        out = n * PEAK_BYTES
    else:
        oh, ow = (nh, nw) if entry["mode"] == "fftmap" else (h, w)
        out = n * oh * ow * _BYTES[entry.get("out_dtype") or "float32"]
    nbytes = h * w * f * frame_b + n * kh * kw * f * store_b + out
    pts = nh * nw
    flops = 2.5 * pts * math.log2(pts) * (f + n) + 8.0 * f * n * nh * (nw // 2 + 1)
    t_flops = flops / PEAK_FLOP_S[config["precision"]]
    t_bytes = nbytes / HBM_BYTES_S
    return {
        "bytes": nbytes, "flops": flops, "canvas": (nh, nw),
        "bound_ms": 1e3 * max(t_flops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_flops else "flops",
    }
