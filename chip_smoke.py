#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cuda_fft_convolution_torch) on one CUDA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA. It

  1. prints the card (nvidia-smi name and power limit), the PyTorch and CUDA
     versions, and turns TF32 off for matmuls and cuDNN;
  2. builds the CUDA kernels from ``cuda_fft_convolution_torch/csrc`` and
     prints what ptxas reports (registers, shared memory, spills);
  3. holds the fused block-conv kernel against its plain PyTorch version on
     the card at a small ragged shape, a wide block and the headline plan's
     geometry;
  4. runs the headline call — ``fft_conv`` of a 2048² fp32 image with 100
     kernels of 64², mode 'same', on the GPU — checks that it went through
     the kernel and agrees with a float64 numpy reference on 8 kernels, and
     that the amortized path (fft_data_tiled + fft_kernels + conv_spectral)
     gives the same maps;
  5. times the fused call, the same call through the unfused torch.fft
     pipeline, and the kernel alone against its plain version, with CUDA
     events (median of 7 runs after a warm-up).

It prints one JSON line describing the kernel, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

TOL = 1e-5  # max |x − ref| / max |ref|: the repo's fp32 bar
HEADLINE = dict(size=2048, n=100, k=64)
RUNS = 7


def env_report() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def build_kernels() -> None:
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops.block_conv import smem_bytes

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"  ptxas: {line.strip()}")
    for wc in (17, 76, 224, 384, 385, 451, 513, 769):
        if lib.fftconv_block_conv_f32_smem_bytes(wc) != smem_bytes(wc):
            raise AssertionError(f"shared-memory model differs from the kernel at Wc={wc}")
    print(f"  smem bytes at Wc=224: {smem_bytes(224)} (Python model = kernel)")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def check_kernel(d_re, d_im, k_re, k_im, geom, label) -> float:
    """Kernel against its plain version on the same CUDA inputs → max abs
    error. Raises above TOL (relative to max |plain|)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    got = block_conv(d_re, d_im, k_re, k_im, *geom)
    want = block_conv_reference(d_re, d_im, k_re, k_im, *geom)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    print(f"kernel vs plain [{label}] shape {tuple(got.shape)}: "
          f"max abs {abs_err:.3e}, rel {err:.3e}")
    if not (err <= TOL and torch.isfinite(got).all()):
        raise AssertionError(f"kernel disagrees with its plain version ({label}): {err}")
    return abs_err


def check_kernel_shapes(fc, rng) -> None:
    import torch

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device="cuda")

    # Small ragged shape: B=2, F=3, N=5, odd blocks, out_h/out_w not
    # multiples of the valid window (clipped edge tiles); then a block wide
    # enough (Wc = 451) for the kernel's 32-row configuration, 2 row chunks.
    for b, f, n, bh, bw, kh, kw, out_h, out_w, label in (
        (2, 3, 5, 45, 151, 10, 24, 100, 300, "small ragged"),
        (1, 2, 2, 40, 901, 9, 101, 150, 1700, "wide block, 32-row tiles"),
    ):
        vh, vw = bh - kh + 1, bw - kw + 1
        nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1
        d = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc))
        k = (t(n, f, bh, wc), t(n, f, bh, wc))
        check_kernel(*d, *k, (bh, bw, kh, kw, out_h, out_w), label)

    # The headline plan's geometry, real spectra, a few kernels.
    s, kk = HEADLINE["size"], HEADLINE["k"]
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    bank = rng.standard_normal((4, kk, kk, 1)).astype(np.float32)
    spec = fc.fft_data_tiled(image, kk, kk, device="cuda", trim_mode="same")
    assert (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw) == (127, 447, 64, 64)
    sk = fc.fft_kernels(bank, spectral=spec)
    check_kernel(
        spec.re[None], spec.im[None], sk.re, sk.im,
        (127, 447, 64, 64, spec.out_h, spec.out_w), "headline plan, N=4",
    )
    torch.cuda.synchronize()


def same_reference_f64(image, bank, idx) -> np.ndarray:
    """float64 numpy 'same' maps (scipy offset) for bank[idx]."""
    h, w = image.shape[:2]
    kh, kw = bank.shape[1:3]
    ph, pw = h + kh - 1, w + kw - 1
    spec = np.fft.rfft2(image[..., 0].astype(np.float64), s=(ph, pw))
    out = []
    for i in idx:
        full = np.fft.irfft2(
            spec * np.fft.rfft2(bank[i, ..., 0].astype(np.float64), s=(ph, pw)),
            s=(ph, pw),
        )
        oh, ow = (kh - 1) // 2, (kw - 1) // 2
        out.append(full[oh : oh + h, ow : ow + w])
    return np.stack(out)


def cuda_ms(fn, runs=RUNS) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    env_report()
    build_kernels()
    rng = np.random.default_rng(args.seed)
    check_kernel_shapes(fc, rng)

    # ---- the headline call ----
    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    torch.cuda.synchronize()
    block_conv.launches = 0
    maps = fc.fft_conv(image, kernels=bank, mode="same", device="cuda")
    torch.cuda.synchronize()
    launches = block_conv.launches
    print(f"headline fft_conv: shape {tuple(maps.shape)} on {maps.device}, "
          f"block_conv launches {launches}")
    if not (maps.is_cuda and tuple(maps.shape) == (n, s, s)):
        raise AssertionError(f"headline maps: {maps.device} {tuple(maps.shape)}")
    if launches < 1:
        raise AssertionError("the headline call did not launch the fused kernel")
    if not torch.isfinite(maps).all():
        raise AssertionError("headline maps are not finite")
    idx = list(range(0, n, n // 8))[:8]
    want = same_reference_f64(image, bank, idx)
    got = maps[idx].double().cpu().numpy()
    errs = [float(np.abs(g - w_).max() / np.abs(w_).max()) for g, w_ in zip(got, want)]
    print(f"headline vs float64 numpy on kernels {idx}: max rel err {max(errs):.3e}")
    if max(errs) > TOL:
        raise AssertionError(f"headline error {max(errs)} above {TOL}")

    spec = fc.fft_data_tiled(image, k, k, device="cuda", trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=spec)
    amortized = fc.conv_spectral(spec, sk, mode="same")
    torch.cuda.synchronize()
    diff = rel_err(amortized, maps)
    print(f"amortized path vs one-shot: rel diff {diff:.3e}")
    if diff > 1e-6:
        raise AssertionError(f"amortized maps differ from the one-shot call: {diff}")
    del maps, amortized
    torch.cuda.empty_cache()

    # ---- times ----
    image_d = torch.as_tensor(image, device="cuda")
    bank_d = torch.as_tensor(bank, device="cuda")
    fused_ms = cuda_ms(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"))
    fc.set_config(use_fused_block_conv=False)
    try:
        unfused_ms = cuda_ms(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"))
    finally:
        fc.set_config(use_fused_block_conv=None)
    print(f"headline fft_conv, fused: {fused_ms:.3f} ms")
    print(f"headline fft_conv, unfused torch.fft pipeline: {unfused_ms:.3f} ms")

    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    abs_err = check_kernel(*ops, geom, f"headline plan, N={n}")
    kernel_ms = cuda_ms(lambda: block_conv(*ops, *geom))
    plain_ms = cuda_ms(lambda: block_conv_reference(*ops, *geom))
    cells = spec.re.shape[0] * spec.re.shape[1] * n
    print(f"kernel alone at the headline plan: {kernel_ms:.3f} ms "
          f"({cells} cells); plain version: {plain_ms:.3f} ms")
    vh, vw, lh, wc = 64, 384, 127, 224
    flop = cells * (8 * lh * wc + 8 * vh * lh * wc + 4 * vh * wc * vw)
    print(f"kernel fp32 rate: {flop / kernel_ms / 1e9:.2f} TFLOP/s "
          f"({flop / 1e12:.3f} TFLOP useful, 4-mult complex H stage)")
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(json.dumps({"kernels": [{
        "name": "block_conv_f32",
        "route": "cuda",
        "source": "cuda_fft_convolution_torch/csrc/block_conv.cu",
        "replaces": "cuda_fft_convolution_tpu/ops/block_conv.py:618",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
