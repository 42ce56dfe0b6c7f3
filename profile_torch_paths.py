#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's paths on one CUDA GPU.

    python3 profile_torch_paths.py [--seed 0] [--calls 3]

Run from the repository root on the machine ``chip_smoke.py`` runs on. It
builds the detection headline's inputs with ``chip_smoke.detection_headline``
(a 2048² image holding each of 100 64² kernels once; the call also checks
the detection heads), then runs ``torch.profiler`` over ``--calls`` calls
each of ``detect_peaks``, the maps path (``fft_conv`` + ``peaks_from_maps``),
the fused ``fft_conv`` and the direct ``fft_conv``, the fused ``fft_conv`` at
the bf16 tier, and the DPM/HOG config's calls at the tier on
``chip_smoke.dpm_inputs`` (``conv_spectral`` with float32 and with bf16
maps, and the one-shot ``detect_peaks``). For each path it prints
the device's busy time per call (the union of the GPU kernel and copy spans)
against the profiled span, their difference as the idle share, and the
kernels with the most self device time.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import chip_smoke


def busy_and_span(events) -> tuple[float, float]:
    """(union of the device spans, first start to last end), in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def report(label, fn, calls) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, span = busy_and_span(
        [e for e in prof.events() if e.device_type == DeviceType.CUDA])
    if span == 0:
        raise AssertionError(f"{label}: the profiler saw no device work")
    print(f"== {label}: device busy {busy / calls / 1e3:.3f} of "
          f"{span / calls / 1e3:.3f} ms per call, idle share "
          f"{100 * (1 - busy / span):.1f}%")
    rows = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in rows[:8]:
        if a.self_device_time_total > 0:
            print(f"   {a.self_device_time_total / calls / 1e3:8.3f} ms  "
                  f"x{a.count // calls:<3d} {a.key[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    chip_smoke.env_report()
    image, bank, _ = chip_smoke.detection_headline(fc, args.seed)
    report("detect_peaks", lambda: detect_peaks(image, bank), args.calls)
    report("maps path (fft_conv + peaks_from_maps)", lambda: peaks_from_maps(
        fc.fft_conv(image, kernels=bank, mode="same", correlation=True)[None]),
        args.calls)
    report("fft_conv, fused", lambda: fc.fft_conv(image, kernels=bank, mode="same"),
           args.calls)
    report("fft_conv, direct", lambda: fc.fft_conv(
        image, kernels=bank, mode="same", algorithm="direct"), args.calls)
    report("fft_conv, bf16 tier", lambda: fc.fft_conv(
        image, kernels=bank, mode="same", store_dtype="bfloat16"), args.calls)
    del image, bank
    feats, dbank, _ = chip_smoke.dpm_inputs(args.seed)
    k = chip_smoke.DPM["k"]
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(dbank, spectral=sd, store_dtype="bfloat16")
    report("DPM conv_spectral, bf16 tier, f32 maps",
           lambda: fc.conv_spectral(sd, sk, mode="same"), args.calls)
    report("DPM conv_spectral, bf16 tier, bf16 maps",
           lambda: fc.conv_spectral(sd, sk, mode="same", out_dtype="bfloat16"), args.calls)
    report("DPM detect_peaks from the features, bf16 tier",
           lambda: detect_peaks(feats, dbank, store_dtype="bfloat16"), args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
