"""Filter-bank demo, the torch twin of ``examples/demo_bank.py``: a
detection-style bank against a large image, the reference's target
workload (README.md:4-6, "many large kernels, large images"). Both engines:

  - direct: one image-sized FFT shared by the bank (the reference's design);
  - tiled: overlap-save block FFTs through the fused block-conv kernel;

held against each other and against a float64 oracle on one kernel; then
an amortized serving loop (block spectra per frame against one precomputed
bank) and the boundary options (``padding='clamp'``,
``kernel_layout='centered'``, ``same_offset='matlab'``).

    python -m cuda_fft_convolution_torch.demos.demo_bank [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, device_label, host, rel, sync


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=512, help="image height and width")
    parser.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = parser.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    rng = np.random.default_rng(7)
    h = w = args.size
    n, kh, kw, f = 16, 32, 32, 3
    image = rng.standard_normal((h, w, f)).astype(np.float32)
    bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
    out = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        out[f"{label}_ms"] = (time.perf_counter() - t0) * 1e3
        return result

    direct = timed("direct", lambda: fc.fft_conv(image, kernels=bank, mode="same",
                                                 algorithm="direct", device=dev))
    tiled = timed("tiled", lambda: fc.fft_conv(image, kernels=bank, mode="same",
                                               algorithm="tiled", device=dev))
    print(f"direct engine: {tuple(direct.shape)} in {out['direct_ms']:.1f} ms, tiled "
          f"engine: {tuple(tiled.shape)} in {out['tiled_ms']:.1f} ms (first calls, "
          f"{device_label(dev)})")
    out["engines_rel_diff"] = rel(tiled, direct)
    print(f"engines agree: rel diff {out['engines_rel_diff']:.3e}")
    check(out["engines_rel_diff"] < 1e-4, "the engines disagree")

    # float64 oracle on kernel 0, 'same' window
    oh, ow = h + kh - 1, w + kw - 1
    ref = np.zeros((oh, ow))
    for c in range(f):
        ref += np.real(np.fft.ifft2(
            np.fft.fft2(image[:, :, c].astype(np.float64), (oh, ow))
            * np.fft.fft2(bank[0, :, :, c].astype(np.float64), (oh, ow))))
    r0, c0 = (kh - 1) // 2, (kw - 1) // 2
    out["tiled_vs_f64"] = rel(tiled[0], ref[r0 : r0 + h, c0 : c0 + w])
    print(f"tiled vs float64 oracle (kernel 0): rel err {out['tiled_vs_f64']:.3e}")
    check(out["tiled_vs_f64"] < 1e-5, "tiled maps disagree with float64")

    # amortized serving: each frame's block spectra against the SAME bank
    # spectra (the reference re-transforms its kernels every call)
    sk = fc.fft_kernels(bank, spectral=fc.fft_data_tiled(image, kh, kw, device=dev))
    frames = 5
    t0 = time.perf_counter()
    for i in range(frames):
        sd = fc.fft_data_tiled(image + 0.01 * i, kh, kw, device=dev)
        scores = fc.conv_spectral(sd, sk, mode="same")
    sync(dev)
    out["serving_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / frames
    print(f"amortized serving: {out['serving_ms_per_frame']:.1f} ms/frame, bank spectra "
          f"cached ({device_label(dev)})")
    check(tuple(scores.shape) == (n, h, w), f"serving maps {tuple(scores.shape)}")

    # boundary handling and window conventions (padDataClampToBorder /
    # padKernel, src/convolutionFFTkernel.cu)
    clamped = fc.fft_conv(image, kh, kw, bank, mode="same", padding="clamp", device=dev)
    centered = fc.fft_conv(image, kernels=bank, mode="same", kernel_layout="centered",
                           device=dev)
    matlab_same = fc.fft_conv(image, kernels=bank, mode="same", same_offset="matlab",
                              algorithm="direct", device=dev)
    out["centered_vs_matlab"] = rel(centered, matlab_same)
    check(out["centered_vs_matlab"] < 1e-5, "centered anchoring != the matlab offset")
    zero = host(fc.fft_conv(image, kh, kw, bank, mode="same", device=dev))
    cl = host(clamped)
    scale = np.abs(zero).max()
    interior = np.s_[:, kh:-kh, kw:-kw]
    out["clamp_interior"] = float(np.abs(cl[interior] - zero[interior]).max() / scale)
    out["clamp_border"] = float(np.abs(cl - zero).max() / scale)
    check(out["clamp_interior"] < 1e-5, "clamp differs from zero padding inside")
    check(out["clamp_border"] > 1e-3, "clamp equals zero padding at the border")
    print("boundary options OK (clamp / centered / matlab-same)")
    print("demo_bank OK")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
