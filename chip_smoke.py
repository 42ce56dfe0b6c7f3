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
     events (median of 7 runs after a warm-up);
  6. holds the peaks kernel against its plain version at the geometries of
     step 3 (values within 1e-5 relative; indices equal except in near-tie
     cells, where the kernel's position must hold a plain value within
     tolerance of the cell max), and at the headline plan with N=100;
  7. runs the detection headline — ``detect_peaks`` of a 2048² noise image
     with the 100 kernels planted once each at 3× amplitude on a 10×10 grid
     — checks that it went through the peaks kernel, found every planted
     centre and agrees with the argmax of the ``fft_conv`` maps, and checks
     ``detect_top_k`` (k=1 and k=5) and ``detect_local_peaks`` against the
     same maps;
  8. runs the direct engine at the headline shape, checks that it went
     through the MAC kernel and agrees with float64 numpy on 8 maps, and
     holds the MAC kernel against the einsum at the direct shape with F=1
     and F=3 channels;
  9. times the detection call against the maps path, the peaks kernel
     against its plain version, the direct call, and the MAC kernel
     against the einsum at F=1 and F=3.

It prints one JSON line describing the three kernels, then, as its last
line, ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 2 and prints no result.
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
# The detection headline: the headline shape, each kernel planted once at
# 3x amplitude, top-left corners on a grid x grid lattice.
DETECT = dict(HEADLINE, grid=10, stride=200, offset=100, amplitude=3.0)
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
    from cuda_fft_convolution_torch.ops.block_conv import smem_bytes, tile_rows

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error")):
            print(f"  ptxas: {line.strip()}")
    for wc in (17, 76, 224, 384, 385, 451, 513, 769):
        if lib.fftconv_block_conv_f32_smem_bytes(wc) != smem_bytes(wc):
            raise AssertionError(f"shared-memory model differs from the kernel at Wc={wc}")
        if lib.fftconv_block_conv_f32_rows(wc) != tile_rows(wc):
            raise AssertionError(f"row-chunk model differs from the kernel at Wc={wc}")
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
        check_peaks(*d, *k, (bh, bw, kh, kw, out_h, out_w), label)

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
    check_peaks(
        spec.re[None], spec.im[None], sk.re, sk.im,
        (127, 447, 64, 64, spec.out_h, spec.out_w), "headline plan, N=4",
    )
    torch.cuda.synchronize()


def check_peaks(d_re, d_im, k_re, k_im, geom, label) -> float:
    """Peaks kernel against its plain version on the same CUDA inputs → max
    abs error of the values. Values must agree within TOL relative to the
    largest |value|; indices must be equal, except in a near-tie cell (its
    plain maps hold a second value within that tolerance of the cell max),
    where the kernel's position must lie in the cell and hold a plain value
    within the tolerance of the max."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
        cell_view,
    )

    bh, bw, kh, kw, out_h, out_w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw = d_re.shape[1], d_re.shape[2]
    got_v, got_i = block_conv_peaks(d_re, d_im, k_re, k_im, *geom)
    want_v, want_i = block_conv_peaks_reference(d_re, d_im, k_re, k_im, *geom)
    maps = block_conv_reference(d_re, d_im, k_re, k_im, *geom)
    torch.cuda.synchronize()
    if not (got_v.shape == want_v.shape and got_i.dtype == torch.int32
            and torch.isfinite(got_v).all() and torch.isfinite(want_v).all()):
        raise AssertionError(f"peaks kernel output malformed ({label})")
    scale = float(want_v.abs().max())
    atol = TOL * scale
    abs_err = float((got_v - want_v).abs().max())
    if abs_err > atol:
        raise AssertionError(f"peaks kernel values disagree ({label}): {abs_err / scale}")
    b, n = maps.shape[:2]
    near = (cell_view(maps, nbh, nbw, vh, vw) >= want_v[..., None] - atol).sum(-1) >= 2
    flips = got_i != want_i
    if flips.any():
        gi = got_i[flips].long()
        gy, gx = gi // out_w, gi % out_w
        ci = flips.nonzero()
        inside = (gy < out_h) & (gx < out_w) & (gy // vh == ci[:, 2]) & (gx // vw == ci[:, 3])
        at = maps.reshape(b, n, -1)[ci[:, 0], ci[:, 1], gi.clamp(max=out_h * out_w - 1)]
        ok = near[flips] & inside & (at >= want_v[flips] - atol)
        if not ok.all():
            raise AssertionError(
                f"peaks kernel indices disagree outside near-tie cells ({label}): "
                f"{int((~ok).sum())} cells")
    print(f"peaks kernel vs plain [{label}] {tuple(got_v.shape)} cells: values max abs "
          f"{abs_err:.3e}, rel {abs_err / scale:.3e}; near-tie cells {int(near.sum())}, "
          f"index flips {int(flips.sum())}")
    return abs_err


def detection_headline(fc, seed):
    """The detection headline on the card: ``detect_peaks`` of a 2048²
    noise image holding each of 100 64² kernels once at 3× amplitude, on a
    10×10 grid of stride 200. Checks the positions against the planted
    centres and the ``fft_conv`` maps, and the top-k and local-peak heads
    against the same maps → (image, bank on the card, peaks launches)."""
    import torch

    from cuda_fft_convolution_torch.models import (
        detect_local_peaks,
        detect_peaks,
        detect_top_k,
    )
    from cuda_fft_convolution_torch.ops.block_conv import block_conv_peaks, cell_peaks
    from cuda_fft_convolution_torch.ops.tiled import (
        choose_block_plan,
        local_peaks_from_maps,
        peaks_from_maps,
        top_k_ordered,
    )

    s, n, k, g = DETECT["size"], DETECT["n"], DETECT["k"], DETECT["grid"]
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    at = [DETECT["offset"] + DETECT["stride"] * i for i in range(g)]
    plants = [(y0, x0) for y0 in at for x0 in at]
    assert len(plants) == n
    for t, (y0, x0) in enumerate(plants):
        image[y0 : y0 + k, x0 : x0 + k, 0] += DETECT["amplitude"] * bank[t, :, :, 0]
    image_d = torch.as_tensor(image, device="cuda")
    bank_d = torch.as_tensor(bank, device="cuda")

    torch.cuda.synchronize()
    block_conv_peaks.launches = 0
    vals, pos = detect_peaks(image_d, bank_d, mode="same", correlation=True)
    torch.cuda.synchronize()
    launches = block_conv_peaks.launches
    print(f"detection headline: detect_peaks values {tuple(vals.shape)} positions "
          f"{tuple(pos.shape)} on {vals.device}, block_conv_peaks launches {launches}")
    if launches < 1:
        raise AssertionError("detect_peaks did not launch the peaks kernel")
    centres = torch.tensor([(y0 + k // 2, x0 + k // 2) for y0, x0 in plants],
                           dtype=torch.int32)
    if not torch.equal(pos.cpu(), centres):
        bad = int((pos.cpu() != centres).any(-1).sum())
        raise AssertionError(f"detect_peaks missed {bad} of the {n} planted centres")

    maps = fc.fft_conv(image_d, kernels=bank_d, mode="same", correlation=True)
    mv, my, mx = peaks_from_maps(maps[None])
    if not torch.equal(pos, torch.stack([my[0], mx[0]], -1)):
        raise AssertionError("detect_peaks positions differ from the argmax of the maps")
    v_err = float(((vals - mv[0]).abs() / mv[0].abs()).max())
    print(f"detect_peaks: all {n} planted centres found, = argmax of the fft_conv "
          f"maps; values max rel err {v_err:.3e}")
    if v_err > TOL:
        raise AssertionError(f"detect_peaks values differ from the maps' maxima: {v_err}")

    v1, p1 = detect_top_k(image_d, bank_d, k=1, mode="same", correlation=True)
    if not (torch.equal(p1[:, 0], pos) and torch.equal(v1[:, 0], vals)):
        raise AssertionError("detect_top_k(k=1) differs from detect_peaks")
    # k=5: the top 5 one-block cell maxima of the same maps.
    lh, lw, pkh, pkw = choose_block_plan(s, s, k, k)
    vh, vw = lh - pkh + 1, lw - pkw + 1
    cv, ci = cell_peaks(maps[None], -(-s // vh), -(-s // vw), vh, vw)
    want_v, order = top_k_ordered(cv.reshape(1, n, -1), 5)
    want_i = ci.reshape(1, n, -1).gather(-1, order)[0]
    want_p = torch.stack([want_i // s, want_i % s], -1)
    v5, p5 = detect_top_k(image_d, bank_d, k=5, mode="same", correlation=True)
    atol = TOL * float(want_v.abs().max())
    v5_err = float((v5 - want_v[0]).abs().max())
    # positions may swap only between values within the tolerance
    gap = (want_v[0, :, :-1] - want_v[0, :, 1:]) <= atol
    tie = torch.zeros_like(want_v[0], dtype=torch.bool)
    tie[:, :-1] |= gap
    tie[:, 1:] |= gap
    same = (p5 == want_p).all(-1) | tie
    print(f"detect_top_k(k=5) vs the top 5 cell maxima of the maps ({vh}x{vw} cells): "
          f"values max abs {v5_err:.3e}; near-tie slots {int(tie.sum())}")
    if v5_err > atol or not same.all():
        raise AssertionError("detect_top_k(k=5) differs from the maps' cell maxima")

    lv, lp = detect_local_peaks(image_d, bank_d, k=16, mode="same", correlation=True)
    wv, wy, wx = local_peaks_from_maps(maps[None], 16)
    if not (torch.equal(lv, wv[0]) and torch.equal(lp, torch.stack([wy[0], wx[0]], -1))):
        raise AssertionError("detect_local_peaks differs from the maps' local maxima")
    print(f"detect_local_peaks(k=16) = local maxima of the same maps; "
          f"{int(torch.isfinite(lv).sum())} hits")
    del maps
    torch.cuda.empty_cache()
    return image_d, bank_d, launches


def check_mac(ops) -> float:
    """MAC kernel against the einsum on the same CUDA planes → max abs
    error. Raises above TOL (relative to max |einsum|)."""
    import torch

    from cuda_fft_convolution_torch.ops.spectral_mac import (
        spectral_mac,
        spectral_mac_planes,
    )

    got = spectral_mac(*ops)
    want = spectral_mac_planes(*ops)
    torch.cuda.synchronize()
    err = max(rel_err(g, w_) for g, w_ in zip(got, want))
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    print(f"MAC kernel vs einsum at {tuple(ops[0].shape)} x {tuple(ops[2].shape)}: "
          f"max abs {abs_err:.3e}, rel {err:.3e}")
    if err > TOL:
        raise AssertionError(f"MAC kernel disagrees with the einsum: {err}")
    return abs_err


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
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv,
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
    )
    from cuda_fft_convolution_torch.ops.spectral_mac import (
        spectral_mac,
        spectral_mac_planes,
    )
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

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
    del spec, sk, ops
    torch.cuda.empty_cache()

    # ---- the detection headline ----
    det_image, det_bank, peaks_launches = detection_headline(fc, args.seed)

    # ---- the direct engine through the MAC kernel ----
    spectral_mac.launches = 0
    direct = fc.fft_conv(image_d, kernels=bank_d, mode="same", algorithm="direct")
    torch.cuda.synchronize()
    mac_launches = spectral_mac.launches
    print(f"direct fft_conv: shape {tuple(direct.shape)}, "
          f"spectral_mac launches {mac_launches}")
    if mac_launches < 1:
        raise AssertionError("the direct call did not launch the MAC kernel")
    if not (tuple(direct.shape) == (n, s, s) and torch.isfinite(direct).all()):
        raise AssertionError("direct maps malformed")
    got = direct[idx].double().cpu().numpy()
    errs = [float(np.abs(g - w_).max() / np.abs(w_).max()) for g, w_ in zip(got, want)]
    print(f"direct fft_conv vs float64 numpy on kernels {idx}: "
          f"max rel err {max(errs):.3e}")
    if max(errs) > TOL:
        raise AssertionError(f"direct error {max(errs)} above {TOL}")
    del direct
    dspec = fc.fft_data(image_d, k, k)
    dsk = fc.fft_kernels(bank_d, spectral=dspec)
    mac_ops = (dspec.re[None], dspec.im[None], dsk.re, dsk.im)
    mac_abs = check_mac(mac_ops)
    # F=3: the same pixels, three channels of random spectra
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    h, wc = dspec.re.shape[-2:]
    mac3_ops = tuple(torch.randn((m, 3, h, wc), generator=gen, device="cuda")
                     for m in (1, 1, n, n))
    check_mac(mac3_ops)
    torch.cuda.empty_cache()

    # ---- times of the detection and MAC paths ----
    detect_ms = cuda_ms(lambda: detect_peaks(det_image, det_bank))
    maps_path_ms = cuda_ms(lambda: peaks_from_maps(
        fc.fft_conv(det_image, kernels=det_bank, mode="same", correlation=True)[None]))
    print(f"detect_peaks call: {detect_ms:.3f} ms; maps path (fft_conv + "
          f"peaks_from_maps): {maps_path_ms:.3f} ms")
    dspec_t = fc.fft_data_tiled(det_image, k, k, trim_mode="same")
    dsk_t = fc.fft_kernels(det_bank, spectral=dspec_t, correlation=True)
    geom = (dspec_t.block_h, dspec_t.block_w, dspec_t.max_kh, dspec_t.max_kw,
            dspec_t.out_h, dspec_t.out_w)
    pops = (dspec_t.re[None], dspec_t.im[None], dsk_t.re, dsk_t.im)
    peaks_err = check_peaks(*pops, geom, f"headline plan, N={n}")
    peaks_ms = cuda_ms(lambda: block_conv_peaks(*pops, *geom))
    peaks_plain_ms = cuda_ms(lambda: block_conv_peaks_reference(*pops, *geom))
    print(f"peaks kernel alone at the headline plan: {peaks_ms:.3f} ms; "
          f"plain version: {peaks_plain_ms:.3f} ms")
    del dspec_t, dsk_t, pops
    torch.cuda.empty_cache()
    direct_ms = cuda_ms(lambda: fc.fft_conv(
        image_d, kernels=bank_d, mode="same", algorithm="direct"))
    print(f"direct fft_conv (MAC kernel): {direct_ms:.3f} ms")
    mac_ms = cuda_ms(lambda: spectral_mac(*mac_ops))
    einsum_ms = cuda_ms(lambda: spectral_mac_planes(*mac_ops))
    print(f"MAC kernel alone at the direct shape, F=1: {mac_ms:.3f} ms; "
          f"einsum: {einsum_ms:.3f} ms")
    mac3_ms = cuda_ms(lambda: spectral_mac(*mac3_ops))
    einsum3_ms = cuda_ms(lambda: spectral_mac_planes(*mac3_ops))
    print(f"MAC kernel alone at the direct shape, F=3: {mac3_ms:.3f} ms; "
          f"einsum: {einsum3_ms:.3f} ms")
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
    }, {
        "name": "block_conv_peaks_f32",
        "route": "cuda",
        "source": "cuda_fft_convolution_torch/csrc/block_conv_peaks.cu",
        "replaces": "cuda_fft_convolution_tpu/ops/block_conv.py:1833",
        "launches": peaks_launches,
        "max_abs_err": peaks_err,
        "ms": peaks_ms,
        "plain_ms": peaks_plain_ms,
    }, {
        "name": "spectral_mac_f32",
        "route": "cuda",
        "source": "cuda_fft_convolution_torch/csrc/spectral_mac.cu",
        "replaces": "cuda_fft_convolution_tpu/ops/spectral_mac.py:206",
        "launches": mac_launches,
        "max_abs_err": mac_abs,
        "ms": mac_ms,
        "plain_ms": einsum_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
