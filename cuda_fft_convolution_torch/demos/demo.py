"""End-to-end demo, the torch twin of ``examples/demo.py``: the port of
demoCudaConvolutionFFT.m, with its visual checks turned into assertions.

  1. random 64×8×5 data and 10×4×5 kernels (:37-55)
  2. the kernel planted in the data at a known offset (:58-61)
  3. kernels flipped for correlation (:67-69) — here ``correlation=True``
  4. a 3-kernel cell with one perturbed kernel (:110-113)
  5. one-shot convolution at FFT size 80×16 (multiple16 policy, :78-79)
  6. validation against the float64 fft2 oracle (:91-102)
  7. the split API (cudaFFTData → cudaConvFFTData) for amortized reuse

    python -m cuda_fft_convolution_torch.demos.demo [--device cpu]

At this size the port's one-shot call runs the overlap-save engine and the
split API the direct engine (the JAX package runs its direct engine for
both), so the split API is held to the one-shot direct call within 1e-6
absolute, as the JAX demo holds its two calls, and to the default one-shot
call within 1e-6 of its largest value.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, host, rel

H, W, F = 64, 8, 5
KH, KW = 10, 4
PLANT = (30, 2)


def inputs(seed: int = 42):
    """The demo's data (H, W, F) with kernel 0 planted, and its 3-kernel
    bank (the second kernel perturbed), from ``seed``."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((H, W, F)).astype(np.float32)
    kernel = rng.standard_normal((KH, KW, F)).astype(np.float32)
    r0, c0 = PLANT
    data[r0 : r0 + KH, c0 : c0 + KW, :] += 3.0 * kernel
    kernel2 = kernel + 0.1 * rng.standard_normal((KH, KW, F)).astype(np.float32)
    return data, [kernel, kernel2, kernel]


def oracle(data, bank, fft_h: int, fft_w: int) -> np.ndarray:
    """float64 numpy correlation maps at (fft_h, fft_w): each kernel
    flipped, per channel fft2 product, summed (:78-102)."""
    out = []
    for k in bank:
        kf = k[::-1, ::-1, :]
        ref = np.zeros((fft_h, fft_w))
        for c in range(data.shape[2]):
            ref += np.real(np.fft.ifft2(
                np.fft.fft2(data[:, :, c].astype(np.float64), (fft_h, fft_w))
                * np.fft.fft2(kf[:, :, c].astype(np.float64), (fft_h, fft_w))))
        out.append(ref)
    return np.stack(out)


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = parser.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    data, bank = inputs(args.seed)

    maps = fc.fft_conv(data, KH, KW, bank, policy="multiple16", correlation=True, device=dev)
    print(f"conv maps: {tuple(maps.shape)} on {maps.device} (expect (3, 80, 16))")
    check(tuple(maps.shape) == (3, 80, 16), f"maps shape {tuple(maps.shape)}")

    full = host(maps[0])[: H + KH - 1, : W + KW - 1]
    peak = tuple(int(i) for i in np.unravel_index(np.argmax(full), full.shape))
    want_peak = (PLANT[0] + KH - 1, PLANT[1] + KW - 1)
    print(f"planted at {PLANT} + (KH-1, KW-1) = {want_peak}; correlation peak at {peak}")
    check(peak == want_peak, f"peak {peak} not at the plant site {want_peak}")

    err = max(rel(m, r) for m, r in zip(maps, oracle(data, bank, 80, 16)))
    print(f"max rel err vs float64 fft2 oracle: {err:.3e} (tolerance 1e-5)")
    check(err < 1e-5, f"error {err} against the float64 oracle")

    spectral = fc.fft_data(data, KH, KW, policy="multiple16", device=dev)
    sk = fc.fft_kernels(bank, spectral=spectral, correlation=True)
    maps2 = fc.conv_spectral(spectral, sk)
    direct = fc.fft_conv(data, KH, KW, bank, policy="multiple16", correlation=True,
                         algorithm="direct", device=dev)
    drift = float(np.abs(host(maps2) - host(direct)).max())
    drift_rel = rel(maps2, maps)
    print(f"split API == one-shot direct call: max abs diff {drift:.3e}; "
          f"vs the one-shot call: rel diff {drift_rel:.3e}")
    check(drift < 1e-6, f"split API differs from the one-shot direct call by {drift}")
    check(drift_rel < 1e-6, f"split API differs from the one-shot call by {drift_rel} (rel)")
    print("demo OK")
    return dict(data=data, bank=bank, maps=host(maps), peak=peak, plant_peak=want_peak,
                max_rel_err=err, split_drift=drift, split_drift_rel=drift_rel)


if __name__ == "__main__":
    main(sys.argv[1:])
