"""Device capability probe, the JAX package's ``utils/selftest.py`` on
PyTorch — ≈ ``checkDeviceProp`` (src/cudaConvFFTData.h:47-65), which
printed compute capability and concurrent-kernel support. One call reports
the device, its memory, whether ``torch.fft`` round-trips, and whether every
C entry of the port's CUDA kernels builds, launches and agrees with its
plain version at a tiny shape. Cheap enough to run at service start-up.
"""

from __future__ import annotations

import contextlib

import torch

from cuda_fft_convolution_torch.utils.device import resolve_device

# Bars against the plain version (chip_smoke.py's): fp32 maps and MAC
# outputs 1e-5 of the largest plain value, bf16 maps 5e-3 (their rounding),
# the MAC on bf16 planes 1e-6 (exact products, fp32 sums); the fused
# kernels' one-pass TF32 tier 2e-3 (fp32 spectra, fp32 maps), and their
# BF16IO tier (bf16 spectra) 5e-3 and 1e-4 in root mean square: S and X
# are rounded to bf16 after sums taken in another order than the plain
# version's, so a rare value at a rounding boundary lands one bf16 step
# away (chip_smoke.py IO_TOL).
TOL = 1e-5
BF16_MAPS_TOL = 5e-3
MAC_BF16_TOL = 1e-6
ONE_PASS_TOL = 2e-3
IO_TOL = 5e-3
IO_RMS_TOL = 1e-4
# (B, F, N, block_h, block_w, kh, kw, out_h, out_w) of each configuration
# of the block-conv and peaks kernels (ops/block_conv.py tile_rows,
# blocks_per_cta, cluster_size): one block's 36 window rows in a 64-row
# CTA, Wc 451 in a pair of 64-row CTAs that split the bins, and 21-row
# windows stacked 3 to a CTA. Ragged in B, F, N and the clipped edge tiles.
CONFIGS = {
    "64 rows": (2, 3, 5, 45, 151, 10, 24, 100, 300),
    "paired": (1, 2, 2, 40, 901, 9, 101, 150, 1700),
    "stacked": (1, 3, 4, 45, 151, 25, 24, 100, 300),
}
# (B, N, F, H, Wc) of the MAC kernel's check: partial image and filter tiles
# and a partial pixel chunk.
MAC_SHAPE = (3, 13, 5, 40, 25)
NO_CARD = "no CUDA device; kernels run only on the card"


@contextlib.contextmanager
def _fp32_matmuls():
    """Plain versions in IEEE fp32: TF32 matmuls off, restored after."""
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def _peaks_check(vals, idxs, want_v, want_i, maps, bar) -> tuple:
    """A peaks entry's report: its values' error against the plain
    version's; its indices equal to the plain version's, or, at the
    one-pass and BF16IO tiers (``bar`` above TOL), each at a position whose
    plain value is within ``bar`` of the cell's max (a near tie may resolve
    either way)."""
    err = _rel(vals, want_v)
    if torch.equal(idxs, want_i):
        return err, bar, None
    if bar > TOL:
        flat = maps.reshape(*maps.shape[:2], -1)
        at = flat.gather(-1, idxs.reshape(*idxs.shape[:2], -1).long().clamp(max=flat.shape[-1] - 1))
        if (at.reshape(idxs.shape) >= want_v - bar * want_v.abs().max()).all():
            return err, bar, None
    return err, bar, "peak indices differ"


def _block_conv_checks(dev: torch.device, gen: torch.Generator, report: dict) -> None:
    """The four maps entries and the two peaks entries in each
    configuration, the bf16 entries of the BF16IO tier (``_io``, at IO_TOL)
    and the fp32 entries of the other synthesis tiers (6×TF32 ``_x6`` at
    TOL, one pass ``_x1`` at ONE_PASS_TOL), against ``block_conv_reference``
    and ``block_conv_peaks_reference`` at the same tier on the same planes
    (peaks: indices equal but for near ties at the tiers above TOL)."""
    from cuda_fft_convolution_torch.ops.block_conv import (
        BF16IO,
        block_conv,
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
    )

    bf16 = torch.bfloat16
    for config, (b, f, n, bh, bw, kh, kw, out_h, out_w) in CONFIGS.items():
        vh, vw, wc = bh - kh + 1, bw - kw + 1, bw // 2 + 1
        nbh, nbw = -(-out_h // vh), -(-out_w // vw)
        f32 = tuple(torch.randn(shape, generator=gen, device=dev)
                    for shape in ((b, nbh, nbw, f, bh, wc),) * 2 + ((n, f, bh, wc),) * 2)
        geom = (bh, bw, kh, kw, out_h, out_w)
        b16 = tuple(x.to(bf16) for x in f32)
        tiers = (("f32", f32, 3, "", TOL), ("bf16", b16, 3, "", TOL),
                 ("bf16", b16, BF16IO, "_io", IO_TOL),
                 ("f32", f32, 6, "_x6", TOL), ("f32", f32, 1, "_x1", ONE_PASS_TOL))
        for tag, ops, splits, tier, tol in tiers:
            want = block_conv_reference(*ops, *geom, splits=splits)
            for suffix, out_dtype, bar in (("", torch.float32, tol),
                                           ("_bf16maps", bf16, max(tol, BF16_MAPS_TOL))):
                got = block_conv(*ops, *geom, out_dtype, splits).float()
                rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
                fault = (f"rms error {rms:.3e} over {IO_RMS_TOL}"
                         if splits == BF16IO and not suffix and rms > IO_RMS_TOL else None)
                report[f"fftconv_block_conv_{tag}{suffix}{tier} ({config})"] = (
                    _rel(got, want), bar, fault)
            vals, idxs = block_conv_peaks(*ops, *geom, splits)
            want_v, want_i = block_conv_peaks_reference(*ops, *geom, splits)
            report[f"fftconv_block_conv_peaks_{tag}{tier} ({config})"] = _peaks_check(
                vals, idxs, want_v, want_i, want, tol)


def _mac_checks(dev: torch.device, gen: torch.Generator, report: dict) -> None:
    """Both MAC entries (f32 and bf16 planes) at every tile the kernel
    instantiates, called bare with the tile forced, against the einsum."""
    from cuda_fft_convolution_torch._build import library
    from cuda_fft_convolution_torch.ops.spectral_mac import MAC_TILES, spectral_mac_planes

    lib = library()
    b, n, f, h, wc = MAC_SHAPE
    f32 = tuple(torch.randn((m, f, h, wc), generator=gen, device=dev) for m in (b, b, n, n))
    for tag, ops, bar in (("f32", f32, TOL),
                          ("bf16", tuple(x.to(torch.bfloat16) for x in f32), MAC_BF16_TOL)):
        want = spectral_mac_planes(*ops)
        for tb, tn in MAC_TILES:
            o_re = torch.empty((b, n, h, wc), device=dev)
            o_im = torch.empty_like(o_re)
            code = getattr(lib, f"fftconv_spectral_mac_{tag}")(
                *(t.data_ptr() for t in (*ops, o_re, o_im)), b, f, n, h * wc, tb, tn,
                torch.cuda.current_stream(dev).cuda_stream)
            name = f"fftconv_spectral_mac_{tag} (tile {tb}x{tn})"
            if code != 0:
                report[name] = (float("nan"), bar, f"cudaError {code}")
                continue
            err = max(_rel(o, w) for o, w in zip((o_re, o_im), want))
            report[name] = (err, bar, None)


def _kernel_report(dev: torch.device) -> dict:
    """C entry name (with its configuration or tile) → (max relative error
    against the plain version, its bar, None or what else failed)."""
    checks: dict = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.cuda.device(dev), _fp32_matmuls():
        _block_conv_checks(dev, gen, checks)
        _mac_checks(dev, gen, checks)
        torch.cuda.synchronize(dev)
    return checks


def selftest(run_pallas: bool = True, *, device=None) -> dict:
    """Report what ``device`` (the card when None, which must be present;
    ``utils/device.py``) can do:

      - ``backend`` ('cuda' or 'cpu'), ``device_kind``
        (``torch.cuda.get_device_name``), ``device_count``,
        ``hbm_bytes_limit`` (the card's total memory; 0 on the CPU);
      - ``fft_ok``: an rfft2/irfft2 round trip;
      - ``kernels``: each C entry of the CUDA kernels (with its
        configuration or MAC tile) → max relative error against its plain
        version at a tiny shape, and ``kernels_ok``: every entry within its
        bar (and the peaks' indices equal), with ``kernels_failed`` mapping
        each entry that was not to what failed. The kernels run only on the
        card: on the CPU ``kernels_ok`` is None and ``kernels_reason`` says
        why; the plain versions are never reported as the kernels. A kernel
        that does not build puts the error in ``kernels_error``.

    ``run_pallas`` keeps the JAX package's name for the signature: here it
    says whether to run the CUDA kernels."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    report: dict = {
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "hbm_bytes_limit": torch.cuda.get_device_properties(dev).total_memory if cuda else 0,
    }
    x = torch.ones((2, 16, 16), device=dev)
    back = torch.fft.irfft2(torch.fft.rfft2(x), s=(16, 16))
    report["fft_ok"] = bool(torch.allclose(back, x, atol=1e-5))
    if not cuda or not run_pallas:
        report["kernels"] = {}
        report["kernels_ok"] = None
        report["kernels_reason"] = NO_CARD if not cuda else "not run (run_pallas=False)"
        return report
    try:
        checks = _kernel_report(dev)
    except (RuntimeError, OSError) as e:  # a build or launch failure
        report["kernels"] = {}
        report["kernels_ok"] = False
        report["kernels_error"] = repr(e)
        return report
    report["kernels"] = {name: err for name, (err, _, _) in checks.items()}
    report["kernels_failed"] = {
        name: other or f"error {err:.3e} above {bar:g}"
        for name, (err, bar, other) in checks.items()
        if other is not None or not err <= bar
    }
    report["kernels_ok"] = not report["kernels_failed"]
    return report
