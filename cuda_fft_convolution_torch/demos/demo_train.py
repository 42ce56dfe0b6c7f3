"""Training demo, the torch twin of ``examples/demo_train.py``: a filter
bank learned through the FFT-convolution path, which the reference's MEX
pipeline could not do. Two ways:

  1. gradient descent (``models.train_step``, ``torch.optim.Adam`` where
     the JAX demo uses optax) through rfft2 → the MAC kernel → irfft2 →
     the 'same' trim, against a second detector's maps;
  2. the closed-form MOSSE filter (``models.mosse``), solved in the
     spectral domain and applied to the serving path's ``SpectralData``.

Both recover their targets.

    python -m cuda_fft_convolution_torch.demos.demo_train [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, host
from cuda_fft_convolution_torch.models import (
    detect,
    gaussian_target,
    init_detector,
    respond,
    train_mosse,
    train_step,
)


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = parser.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    rng = np.random.default_rng(11)
    out = {}

    # 1. gradient descent through the FFT
    target_model = init_detector(torch.Generator().manual_seed(0), 4, 2, 7, 7, device=dev)
    model = init_detector(torch.Generator().manual_seed(1), 4, 2, 7, 7, device=dev)
    images = torch.as_tensor(rng.standard_normal((4, 2, 32, 32)).astype(np.float32),
                             device=dev)
    with torch.no_grad():
        targets = detect(target_model, images)
    opt = torch.optim.Adam(model.parameters(), lr=2e-2)
    losses = [float(train_step(model, opt, images, targets)[2]) for _ in range(args.steps)]
    out["loss_first"], out["loss_last"] = losses[0], losses[-1]
    print(f"gradient descent: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{args.steps} steps")
    check(losses[-1] < 0.2 * losses[0], "the loss did not fall to a fifth")

    # 2. closed-form MOSSE
    obj = rng.standard_normal((1, 12, 12)).astype(np.float32)
    patches, resp = [], []
    for (r0, c0) in [(2, 2), (6, 1), (0, 8), (5, 5)]:
        p = np.zeros((1, 32, 32), np.float32)
        p[:, r0 : r0 + 12, c0 : c0 + 12] = obj
        p += 0.05 * rng.standard_normal((1, 32, 32)).astype(np.float32)
        patches.append(p)
        resp.append(host(gaussian_target(64, 64, (r0 + 6, c0 + 6), 2.0, device=dev)))
    filt = train_mosse(np.stack(patches), np.stack(resp).astype(np.float32), 64, 64,
                       device=dev)
    # track the object in a new frame through the serving path's spectra
    frame = np.zeros((32, 32, 1), np.float32)
    frame[9:21, 13:25, 0] = obj[0]
    sd = fc.fft_data(frame, 33, 33, policy="pow2", device=dev)
    r = host(respond(filt, sd))
    peak = tuple(int(i) for i in np.unravel_index(np.argmax(r), r.shape))
    print(f"MOSSE: object planted at centre (15, 19); response peak at {peak}")
    check(abs(peak[0] - 15) <= 1 and abs(peak[1] - 19) <= 1, f"MOSSE peak at {peak}")
    out["mosse_peak"] = peak
    print("demo_train OK")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
