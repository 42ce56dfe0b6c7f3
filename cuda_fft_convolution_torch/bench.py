"""The port's benchmark: the JAX package's ``bench.py`` on PyTorch.

    python -m cuda_fft_convolution_torch.bench [--device cpu]

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline", "detail"}``, with the rows of the JAX package's bench under
their own names, in its order and at its sizes, each through the port's
function of the same name:

  - BASELINE configs[0]/[1] correctness: ``fft_conv(mode='full')`` of a
    512² crop with 8 kernels against a float64 ``np.fft`` oracle;
  - the headline (2048² fp32, 100 kernels of 64², 'same'): one-shot
    ``fft_conv``, amortized tiled spectra one call at a time and streamed,
    fftmap parity, amortized direct spectra, the bf16 tier one-shot and
    streamed, with float32 and with bf16 maps;
  - configs[3]: a batch of 8 images of 1024², tiled;
  - configs[4]: HOG features of a 4096² image (512²×31, bf16) against 576
    filters on the direct engine ('fftmap') and 1024 filters tiled;
  - the detection head: ``detect_peaks`` on tiled spectra at its peaks
    plan, bf16 and float32, and the host fetch of its results and (one
    map's fetch × N, an estimate) of the maps;
  - configs[1]: ``fft_conv`` over the 16-cell ragged bank, and a
    ``RaggedConvStream`` (depth 12, direct engine);
  - the F=8 tier: 1024²×8 with 64 kernels of 32²×8, bf16, tiled;
  - configs[2]: 16 kernels of 512², one-shot and amortized.

Every row runs on the card unless ``--device cpu`` is given; without a card
the bench raises ``InvalidInputError``, as the entry points do. Times are
CUDA events (host clock on the CPU): a one-call row is the median of its
per-call times after a warm-up; a streamed row (``sync_every = s``, the
JAX bench's pipelined dispatch) times ``s`` back-to-back calls between one
pair of events, each call's output dropped before the next, and takes the
median over groups. Each row's spread (min–max of its timings) goes to
stderr. ``vs_baseline`` and ``hbm_floor_GPixF_s`` use the card's HBM rate
(``utils/profiling.py``; null for a card not in ``HBM_BYTES_PER_S``).

``BENCH_QUICK=1`` runs only the accuracy, headline and tiled rows.
``BENCH_SMOKE=1`` shrinks every configuration so that all rows run in
seconds on the CPU: a plumbing check, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.models import detect_peaks, hog_features
from cuda_fft_convolution_torch.ops.tiled import choose_block_plan
from cuda_fft_convolution_torch.utils.device import resolve_device
from cuda_fft_convolution_torch.utils.fft_size import compute_fft_size
from cuda_fft_convolution_torch.utils.profiling import (
    _call_seconds,
    benchmark,
    card_label,
    hbm_bytes_per_s,
)

METRIC = ("GPix*filters/s, one-shot fft_conv (auto engine), 2048^2 image x 100 "
          "64x64 kernels, fp32, 'same' maps")

# The timed rows of ``detail``; QUICK_ROWS run under BENCH_QUICK=1.
QUICK_ROWS = ("headline_ms", "amortized_tiled_GPixF_s", "amortized_tiled_ms",
              "streaming_tiled_GPixF_s")
ROWS = QUICK_ROWS + (
    "fftmap_parity_GPixF_s", "amortized_direct_GPixF_s", "bf16_GPixF_s",
    "bf16_streaming_GPixF_s", "bf16_bf16out_streaming_GPixF_s",
    "batch8_1024_GPixF_s", "bigkernel_512_GPixF_s", "bigkernel_streaming_GPixF_s",
    "dpm_hog_bf16_1024f_GPixF_s", "dpm_hog_streaming_GPixF_s",
    "dpm_hog_bf16out_stream_GPixF_s", "detect_peaks_bf16_GPixF_s",
    "detect_peaks_bf16_stream_GPixF_s", "detect_peaks_bf16_stream_ms_frame",
    "detect_peaks_f32_stream_GPixF_s", "detect_peaks_f32_stream_ms_frame",
    "peaks_result_fetch_ms", "maps_result_fetch_est_ms", "ragged_bank16_GPixF_s",
    "ragged_bank16_stream_GPixF_s", "dpm_f8_bf16_stream_GPixF_s",
    "dpm_direct_giantbank_GPixF_s", "dpm_direct_streaming_GPixF_s",
)


# The JAX bench's sizes (bench.py:197-210): the headline image and bank,
# the accuracy crop, the large-kernel bank, the batch, the DPM image and
# banks; then the F=8 row's image, which the JAX smoke keeps at full size
# and this one shrinks (its plain version takes seconds a call on the CPU).
SIZES = dict(H=2048, W=2048, N=100, KH=64, KW=64, F=1, ACC=512, BIGK=512, NB=16,
             BATCH_B=8, BATCH_HW=1024, IMG4K=4096, NK=1024, KD=12, NKD=576,
             F8_HW=1024)
SMOKE_SIZES = dict(H=256, W=256, N=10, KH=16, KW=16, F=1, ACC=128, BIGK=48, NB=2,
                   BATCH_B=2, BATCH_HW=128, IMG4K=256, NK=16, KD=12, NKD=8,
                   F8_HW=128)


class _Timer:
    """Times calls on one device (``profiling.benchmark``) and keeps each
    row's timings (seconds a call) for the spread."""

    def __init__(self, device: torch.device, label: str):
        self.device = device
        self.label = label
        self.timings: dict[str, list[float]] = {}

    def free(self) -> None:
        """Return the freed tensors' memory to the card between configurations."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def call(self, row: str, fn, *, warmup=2, iters=5, sync_every=1) -> float:
        """Median seconds of ``fn()``: one call a window, or ``sync_every``
        back-to-back calls a window (over the count), ``iters`` calls in
        all, after ``warmup`` calls."""
        stats = benchmark(fn, warmup=warmup, iters=max(iters // sync_every, 1),
                          reps=sync_every)
        return self._keep(row, stats["times_s"])

    def stream(self, row: str, stream, frame, *, iters=18, sync_every=9) -> float:
        """Median seconds a frame of ``stream.submit(frame)``, ``sync_every``
        submits a window (``stream.depth`` must hold them all), after one
        frame of warm-up."""
        stream.submit(frame).result()
        stream.flush()

        def group():
            for _ in range(sync_every):
                stream.submit(frame)

        cuda = self.device if self.device.type == "cuda" else None
        times = []
        for _ in range(max(iters // sync_every, 1)):
            times.append(_call_seconds(group, (), cuda) / sync_every)
            stream.flush()
        return self._keep(row, times)

    def fetch(self, row: str, *tensors) -> float:
        """Seconds of copying ``tensors`` to the host (host clock; the
        device work that made them is waited for first)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for t in tensors:
            t.to("cpu", copy=True)
        return self._keep(row, [time.perf_counter() - t0])

    def _keep(self, row: str, times: list[float]) -> float:
        self.timings[row] = times
        return statistics.median(times)

    def report_spread(self, file=sys.stderr) -> None:
        for row, times in self.timings.items():
            print(f"{row}: median {statistics.median(times) * 1e3:.3f} ms, spread "
                  f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f} ms over "
                  f"{len(times)} ({self.label})", file=file)


def card(device: torch.device) -> tuple[str, float | None, float | None]:
    """The card's name, power limit in watts (None where nvidia-smi does not
    give one) and HBM rate (``profiling.hbm_bytes_per_s``), or ('cpu',
    None, None)."""
    if device.type != "cuda":
        return "cpu", None, None
    name = torch.cuda.get_device_name(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    watts = card_label(index).rsplit(", ", 1)[-1].removesuffix(" W")
    power_w = float(watts) if watts.replace(".", "", 1).isdigit() else None
    return name, power_w, hbm_bytes_per_s(name)


def _full_f64(image, bank) -> list[np.ndarray]:
    """float64 'full' maps of an (H, W, F) image with each (Kh, Kw, F)
    kernel of ``bank``, by ``np.fft``."""
    h, w, f = image.shape
    oh, ow = h + bank.shape[1] - 1, w + bank.shape[2] - 1
    out = []
    for k in bank:
        ref = np.zeros((oh, ow))
        for c in range(f):
            ref += np.real(np.fft.ifft2(
                np.fft.fft2(image[:, :, c].astype(np.float64), (oh, ow))
                * np.fft.fft2(k[:, :, c].astype(np.float64), (oh, ow))
            ))
        out.append(ref)
    return out


def run(device: torch.device, quick: bool, smoke: bool) -> dict:
    """Every row on ``device`` → the bench's result record."""
    name, power_w, rate = card(device)
    timer = _Timer(device, name if power_w is None else f"{name}, {power_w:.2f} W")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    z = SMOKE_SIZES if smoke else SIZES
    H, W, N, KH, KW, F = (z[k] for k in ("H", "W", "N", "KH", "KW", "F"))

    def put(x):
        return torch.as_tensor(x, device=device)

    data_np = rng.standard_normal((H, W, F)).astype(np.float32)
    kernels_np = rng.standard_normal((N, KH, KW, F)).astype(np.float32)
    data, kernels = put(data_np), put(kernels_np)
    gpix_filters = H * W * N / 1e9

    # accuracy against the float64 oracle first (configs[0]/[1])
    dh, ks = data_np[: z["ACC"], : z["ACC"], :], kernels_np[:8]
    got = fc.fft_conv(put(dh), KH, KW, put(ks), mode="full").double().cpu().numpy()
    err = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, _full_f64(dh, ks)))
    del got

    t_head = timer.call("headline_ms", lambda: fc.fft_conv(
        data, KH, KW, kernels, mode="same", algorithm="auto"))
    v_head = gpix_filters / t_head

    sdt = fc.fft_data_tiled(data, KH, KW, trim_mode="same")
    skt = fc.fft_kernels(kernels, spectral=sdt)
    t_tiled = timer.call("amortized_tiled_ms",
                         lambda: fc.conv_spectral(sdt, skt, mode="same"))
    t_stream = timer.call("streaming_tiled_GPixF_s",
                          lambda: fc.conv_spectral(sdt, skt, mode="same"),
                          iters=18, sync_every=9)
    del sdt, skt

    full = {}
    if not quick:
        timer.free()
        full = _full_rows(timer, rng, put, z, data, kernels)

    floor_bytes = H * W * F * 4 + N * KH * KW * F * 4 + N * H * W * 4
    roofline = None if rate is None else gpix_filters / (floor_bytes / rate)
    fft_h, fft_w = compute_fft_size(H, W, KH, KW, "fast")
    detail = {
        "backend": device.type,
        "device": name,
        "power_limit_w": power_w,
        "headline_ms": t_head * 1e3,
        "amortized_tiled_GPixF_s": gpix_filters / t_tiled,
        "amortized_tiled_ms": t_tiled * 1e3,
        "streaming_tiled_GPixF_s": gpix_filters / t_stream,
        "hbm_floor_GPixF_s": roofline,
        "direct_fft_size": [fft_h, fft_w],
        "max_rel_err_vs_f64_fft": err,
        **{k: full.get(k) for k in ROWS if k not in QUICK_ROWS},
    }
    timer.report_spread()
    return {
        "metric": METRIC,
        "value": v_head,
        "unit": "GPix*filters/s",
        "vs_baseline": None if roofline is None else v_head / roofline,
        "detail": detail,
    }


def _full_rows(timer: _Timer, rng, put, z: dict, data, kernels) -> dict:
    """The rows BENCH_QUICK=1 skips, in the JAX bench's order, at sizes
    ``z`` → {row: value}."""
    H, W, N, KH, KW, F = (z[k] for k in ("H", "W", "N", "KH", "KW", "F"))
    IMG4K, NK, KD, NKD = (z[k] for k in ("IMG4K", "NK", "KD", "NKD"))
    gpix_filters = H * W * N / 1e9
    out = {}

    # reference-parity one-shot: raw circular fftmaps
    out["fftmap_parity_GPixF_s"] = gpix_filters / timer.call(
        "fftmap_parity_GPixF_s",
        lambda: fc.fft_conv(data, KH, KW, kernels, mode="fftmap"), iters=3)
    # amortized direct: precomputed data and bank spectra
    sd = fc.fft_data(data, KH, KW)
    sk = fc.fft_kernels(kernels, spectral=sd)
    out["amortized_direct_GPixF_s"] = gpix_filters / timer.call(
        "amortized_direct_GPixF_s", lambda: fc.conv_spectral(sd, sk), iters=3)
    del sd, sk
    timer.free()

    # the bf16 tier (configs[4] dtype): one-shot on bf16 inputs, then
    # amortized and streamed, with float32 and with bf16 maps
    data16, kernels16 = data.to(torch.bfloat16), kernels.to(torch.bfloat16)
    out["bf16_GPixF_s"] = gpix_filters / timer.call(
        "bf16_GPixF_s", lambda: fc.fft_conv(
            data16, KH, KW, kernels16, mode="same", store_dtype="bfloat16"), iters=3)
    del data16, kernels16
    sdt16 = fc.fft_data_tiled(data, KH, KW, trim_mode="same", store_dtype="bfloat16")
    skt16 = fc.fft_kernels(kernels, spectral=sdt16, store_dtype="bfloat16")
    out["bf16_streaming_GPixF_s"] = gpix_filters / timer.call(
        "bf16_streaming_GPixF_s", lambda: fc.conv_spectral(sdt16, skt16, mode="same"),
        iters=18, sync_every=9)
    out["bf16_bf16out_streaming_GPixF_s"] = gpix_filters / timer.call(
        "bf16_bf16out_streaming_GPixF_s", lambda: fc.conv_spectral(
            sdt16, skt16, mode="same", out_dtype="bfloat16"), iters=18, sync_every=9)
    del sdt16, skt16
    timer.free()

    # a batch of 8 images (configs[3])
    b, hw = z["BATCH_B"], z["BATCH_HW"]
    bdata = put(rng.standard_normal((b, hw, hw, F)).astype(np.float32))
    sdb = fc.fft_data_tiled(bdata, KH, KW, trim_mode="same")
    skb = fc.fft_kernels(kernels, spectral=sdb)
    out["batch8_1024_GPixF_s"] = b * hw * hw * N / 1e9 / timer.call(
        "batch8_1024_GPixF_s", lambda: fc.conv_spectral(sdb, skb, mode="same"), iters=3)
    del sdb, skb, bdata
    timer.free()

    # DPM/HOG (configs[4]): 4K image → HOG (512²×31, bf16) → the filter bank
    img4k = put(rng.standard_normal((IMG4K, IMG4K)).astype(np.float32))
    feats = hog_features(img4k, cell=8, bins=31).to(torch.bfloat16)
    del img4k
    dpm_bank = put(rng.standard_normal((NK, KD, KD, 31)).astype(np.float32))
    fh, fw = feats.shape[:2]
    dpm_gpixf = fh * fw * NK / 1e9
    # the giant bank on the direct engine first, at the bf16 tier
    sdf = fc.fft_data(feats.to(torch.float32), KD, KD, store_dtype="bfloat16")
    skf = fc.fft_kernels(dpm_bank[:NKD], spectral=sdf, store_dtype="bfloat16")
    out["dpm_direct_giantbank_GPixF_s"] = fh * fw * NKD / 1e9 / timer.call(
        "dpm_direct_giantbank_GPixF_s",
        lambda: fc.conv_spectral(sdf, skf, mode="fftmap"), iters=2)
    out["dpm_direct_streaming_GPixF_s"] = fh * fw * NKD / 1e9 / timer.call(
        "dpm_direct_streaming_GPixF_s",
        lambda: fc.conv_spectral(sdf, skf, mode="fftmap"), iters=12, sync_every=6)
    del sdf, skf
    timer.free()
    # the tiled detector loop at the tier
    sdd = fc.fft_data_tiled(feats, KD, KD, trim_mode="same", store_dtype="bfloat16")
    skd = fc.fft_kernels(dpm_bank, spectral=sdd, store_dtype="bfloat16")
    out["dpm_hog_bf16_1024f_GPixF_s"] = dpm_gpixf / timer.call(
        "dpm_hog_bf16_1024f_GPixF_s", lambda: fc.conv_spectral(sdd, skd, mode="same"),
        iters=3)
    out["dpm_hog_streaming_GPixF_s"] = dpm_gpixf / timer.call(
        "dpm_hog_streaming_GPixF_s", lambda: fc.conv_spectral(sdd, skd, mode="same"),
        iters=18, sync_every=9)
    out["dpm_hog_bf16out_stream_GPixF_s"] = dpm_gpixf / timer.call(
        "dpm_hog_bf16out_stream_GPixF_s", lambda: fc.conv_spectral(
            sdd, skd, mode="same", out_dtype="bfloat16"), iters=24, sync_every=12)
    del sdd, skd, feats, dpm_bank
    timer.free()

    # the detection head: top-1 peaks at the peaks plan, bf16 then f32
    def peaks_spectra(store):
        lh, lw, pkh, pkw = choose_block_plan(H, W, KH, KW, store_dtype=store,
                                             head="peaks", device=data.device)
        sdp = fc.fft_data_tiled(data, pkh, pkw, block_h=lh, block_w=lw, trim_mode="same",
                                trim_kernel_h=KH, trim_kernel_w=KW, store_dtype=store)
        skp = fc.fft_kernels(kernels, spectral=sdp, store_dtype=store, storage="planar",
                             correlation=True)
        return sdp, skp

    sdp, skp = peaks_spectra("bfloat16")
    t_pk = timer.call("detect_peaks_bf16_GPixF_s",
                      lambda: detect_peaks(sdp, skp, mode="same"), iters=3)
    t_pks = timer.call("detect_peaks_bf16_stream_GPixF_s",
                       lambda: detect_peaks(sdp, skp, mode="same"), iters=18, sync_every=9)
    out.update(detect_peaks_bf16_GPixF_s=gpix_filters / t_pk,
               detect_peaks_bf16_stream_GPixF_s=gpix_filters / t_pks,
               detect_peaks_bf16_stream_ms_frame=t_pks * 1e3)
    # what a consumer pays to fetch the results: the (values, positions)
    # pairs, and one map's fetch × N for the maps (an estimate)
    out["peaks_result_fetch_ms"] = 1e3 * timer.fetch(
        "peaks_result_fetch_ms", *detect_peaks(sdp, skp, mode="same"))
    maps = fc.conv_spectral(sdp, skp, mode="same")
    out["maps_result_fetch_est_ms"] = 1e3 * N * timer.fetch("maps_result_fetch_est_ms",
                                                            maps[0])
    del maps, sdp, skp
    sdp32, skp32 = peaks_spectra("float32")
    t_pk32 = timer.call("detect_peaks_f32_stream_GPixF_s",
                        lambda: detect_peaks(sdp32, skp32, mode="same"),
                        iters=18, sync_every=9)
    out.update(detect_peaks_f32_stream_GPixF_s=gpix_filters / t_pk32,
               detect_peaks_f32_stream_ms_frame=t_pk32 * 1e3)
    del sdp32, skp32
    timer.free()

    # configs[1]: a mixed-size bank of 16 cells sharing one image
    rag_hw = 512
    rag_data = put(rng.standard_normal((rag_hw, rag_hw, F)).astype(np.float32))
    rag_cells = [put(rng.standard_normal((k, k, F)).astype(np.float32))
                 for k in (9, 17, 33, 64) for _ in range(4)]
    rag_gpixf = rag_hw * rag_hw * len(rag_cells) / 1e9
    out["ragged_bank16_GPixF_s"] = rag_gpixf / timer.call(
        "ragged_bank16_GPixF_s",
        lambda: fc.fft_conv(rag_data, kernels=rag_cells, mode="same"), iters=3)
    rag_stream = fc.RaggedConvStream((rag_hw, rag_hw, F), rag_cells, depth=12,
                                     algorithm="direct", mode="same", device=data.device)
    out["ragged_bank16_stream_GPixF_s"] = rag_gpixf / timer.stream(
        "ragged_bank16_stream_GPixF_s", rag_stream, rag_data, iters=24, sync_every=12)
    del rag_data, rag_cells, rag_stream
    timer.free()

    # the F=8 fused tier: 64 kernels of 32²×8, bf16, tiled
    f8_hw = z["F8_HW"]
    f8_data = put(rng.standard_normal((f8_hw, f8_hw, 8)).astype(np.float32))
    f8_bank = put(rng.standard_normal((64, 32, 32, 8)).astype(np.float32))
    sd8 = fc.fft_data_tiled(f8_data, 32, 32, trim_mode="same", store_dtype="bfloat16")
    sk8 = fc.fft_kernels(f8_bank, spectral=sd8, store_dtype="bfloat16", storage="planar")
    out["dpm_f8_bf16_stream_GPixF_s"] = f8_hw * f8_hw * 64 / 1e9 / timer.call(
        "dpm_f8_bf16_stream_GPixF_s", lambda: fc.conv_spectral(sd8, sk8, mode="same"),
        iters=18, sync_every=9)
    del sd8, sk8, f8_data, f8_bank
    timer.free()

    # configs[2]: the large-kernel regime, 16 kernels of 512², last
    bigk, nb = z["BIGK"], z["NB"]
    kbig = put(rng.standard_normal((nb, bigk, bigk, F)).astype(np.float32))
    out["bigkernel_512_GPixF_s"] = H * W * nb / 1e9 / timer.call(
        "bigkernel_512_GPixF_s",
        lambda: fc.fft_conv(data, bigk, bigk, kbig, mode="same"), iters=3)
    sdbk = fc.fft_data_tiled(data, bigk, bigk, trim_mode="same")
    skbk = fc.fft_kernels(kbig, spectral=sdbk)
    out["bigkernel_streaming_GPixF_s"] = H * W * nb / 1e9 / timer.call(
        "bigkernel_streaming_GPixF_s", lambda: fc.conv_spectral(sdbk, skbk, mode="same"),
        iters=16, sync_every=8)
    del kbig, sdbk, skbk
    timer.free()
    return out


def main(argv=None) -> dict:
    """Run the bench (``BENCH_QUICK``/``BENCH_SMOKE`` from the environment),
    print its JSON line on stdout and return it."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; the card by default")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    result = run(device, quick=os.environ.get("BENCH_QUICK", "0") == "1",
                 smoke=os.environ.get("BENCH_SMOKE", "0") == "1")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
