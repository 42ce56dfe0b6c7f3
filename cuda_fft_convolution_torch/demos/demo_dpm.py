"""DPM-style detection demo, the torch twin of ``examples/demo_dpm.py``:
bf16 imagery, HOG features, one feature spectrum against a large filter
bank through the planner-chunked pipelined path, and the top detection.

    python -m cuda_fft_convolution_torch.demos.demo_dpm [--device cpu]
        [--height 4096 --width 4096 --filters 1024 ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, device_label, host, sync
from cuda_fft_convolution_torch.models import hog_features


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--kh", type=int, default=8)  # filter size in HOG cells
    p.add_argument("--kw", type=int, default=8)
    p.add_argument("--cell", type=int, default=8)
    p.add_argument("--bins", type=int, default=9)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    rng = np.random.default_rng(3)
    out = {}

    # bf16 imagery, widened to float32 for the HOG front end
    image = torch.as_tensor(
        rng.standard_normal((args.height, args.width)).astype(np.float32), device=dev
    ).to(torch.bfloat16)
    t0 = time.perf_counter()
    feats = hog_features(image.float(), cell=args.cell, bins=args.bins)
    sync(dev)
    fh, fw, f = feats.shape
    out["hog_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"HOG features: {tuple(feats.shape)} from {tuple(image.shape)} image "
          f"({out['hog_ms']:.1f} ms, first call; {device_label(dev)})")

    # the bank (normally learned or clustered), filter 7 planted in the features
    bank = rng.standard_normal((args.filters, args.kh, args.kw, f)).astype(np.float32)
    f7 = bank[7] / (np.linalg.norm(bank[7]) + 1e-6) * 5.0
    r0, c0 = fh // 3, fw // 4
    feats[r0 : r0 + args.kh, c0 : c0 + args.kw, :] += torch.as_tensor(f7, device=dev)

    # one feature FFT, the bank correlated a planned chunk at a time
    sd = fc.fft_data(feats, args.kh, args.kw)
    sk = fc.fft_kernels(bank, spectral=sd, correlation=True)
    scores = fc.conv_spectral_pipelined(sd, sk, mode="same")
    sync(dev)
    t0 = time.perf_counter()
    scores = fc.conv_spectral_pipelined(sd, sk, mode="same")
    sync(dev)
    dt = time.perf_counter() - t0
    out["scoring_ms"] = dt * 1e3
    out["gpix_filters_per_s"] = fh * fw * args.filters / dt / 1e9
    print(f"bank scoring: {tuple(scores.shape)} in {out['scoring_ms']:.1f} ms "
          f"({out['gpix_filters_per_s']:.3f} GPix*filters/s over the feature map; "
          f"{device_label(dev)})")

    best = np.unravel_index(int(torch.argmax(scores)), tuple(scores.shape))
    best = tuple(int(i) for i in best)
    print(f"top detection: filter {best[0]} at cell ({best[1]}, {best[2]}); planted "
          f"filter 7 at ({r0 + args.kh // 2}, {c0 + args.kw // 2})")
    check(best[0] == 7, f"top detection is filter {best[0]}, not 7")
    check(abs(best[1] - (r0 + (args.kh - 1) // 2)) <= 1, "top detection row")
    check(abs(best[2] - (c0 + (args.kw - 1) // 2)) <= 1, "top detection column")
    out["best"] = best
    out["max_score"] = float(host(scores).max())
    print("demo_dpm OK")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
