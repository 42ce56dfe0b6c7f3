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
kernels with the most self device time. Then the same for the DPM giant
bank's direct ``conv_spectral`` (576 filters resident at the tier), the
ragged cell array's ``fft_conv`` and its ``RaggedConvStream`` (BASELINE
configs[1]), and the headline ``ConvStream`` at depth 1 and 3 over 16 host
frames, per frame: the serving loop's idle share. Then the model layer on
``chip_smoke``'s inputs: ``detect_pyramid_peaks`` of the DPM pyramid (1024
filters, 5 levels), a ``train_step`` of the filter-bank detector (8 frames,
64 filters) and a frame of the MOSSE tracker on HOG cells.

    python3 profile_torch_paths.py --ab-parent PARENT/cuda_fft_convolution_torch/csrc

instead builds the fused maps and peaks kernels of a parent checkout's
``csrc`` (one whose C entries take the launch-order argument and this
tree's default-tier operands, ``_kernel_mats(..., splits=3)``: G^T, G and
M^T's TF32 hi and lo planes) beside this tree's default-tier (3×TF32)
entries and times both in turns —
parent, this tree, this tree, parent, CUDA events, median of 7, each side a
bare call of its C entry — at the headline plan (float32) and at the DPM
plan (bf16 spectra, and the same planes upcast to float32), printing how
far the outputs differ and each side's error against the plain version.

    python3 profile_torch_paths.py --submit-probe

instead times, on the host's clock, a headline ``ConvStream`` submit (a
2048² host frame into a queue with room, depth 3, as ``chip_smoke.py``
times it) and the copy that stages such a frame into a pinned buffer, by
``torch``'s ``copy_`` (every intra-op thread) and by numpy's one-thread
``copyto``, with 0, 2, 4 and 8 busy-looping processes beside it on the
host's cores (median and worst of 32 each; the busy processes are stopped
before it returns). ``--soak SECONDS`` then repeats the smoke's submit
trial for that long, each followed by three host canaries (a fixed Python
loop, ``torch.cuda.mem_get_info``, the staging copy), and prints the
spread, the worst median of 8 consecutive trials (the smoke's statistic),
the caching allocator's retries, and for the submits over 3.5 ms the
garbage collector's time in them and where the main thread was after 4 ms
(sampled from a second thread), then the slowest trials.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
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


def report(label, fn, calls, frames=1) -> None:
    """Profile ``calls`` calls of ``fn`` (after one warm-up) and print the
    device's busy time and span per unit — a call, or a frame when each
    call serves ``frames`` frames — the idle share, and the kernels with
    the most self device time."""
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
    units, unit = calls * frames, "frame" if frames > 1 else "call"
    print(f"== {label}: device busy {busy / units / 1e3:.3f} of "
          f"{span / units / 1e3:.3f} ms per {unit}, idle share "
          f"{100 * (1 - busy / span):.1f}%")
    rows = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in rows[:8]:
        if a.self_device_time_total > 0:
            print(f"   {a.self_device_time_total / units / 1e3:8.3f} ms  "
                  f"x{a.count / units:<5.3g} {a.key[:90]}")


def serve(stream, frames):
    """One pass of ``frames`` through ``stream``: every frame submitted,
    then a flush."""
    for f in frames:
        stream.submit(f)
    stream.flush()


def build_parent(csrc: pathlib.Path):
    """The parent's maps and peaks kernels, built from ``csrc`` into
    ``build/parent_ab`` with this tree's nvcc flags → the loaded library."""
    from cuda_fft_convolution_torch import _build

    out = _build.BUILD_DIR / "parent_ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs = [out / f"{name}.o" for name in ("block_conv", "block_conv_peaks")]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", str(csrc / f"{o.stem}.cu"),
                               "-o", str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for o in objs]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's sources:\n{log}")
    lib_path = out / "libparent.so"
    subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(lib_path), *map(str, objs)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for tag in ("f32", "bf16"):
        for name, pointers in ((f"fftconv_block_conv_{tag}", 9),
                               (f"fftconv_block_conv_peaks_{tag}", 10)):
            getattr(lib, name).argtypes = [p] * pointers + [i] * 12 + [p]
            getattr(lib, name).restype = i
    return lib


def bare_call(lib, ops, geom, peaks: bool, order: int, parent: bool):
    """The C entry of ``lib`` (the parent's, or this tree's) with launch
    order ``order`` on ``ops`` at ``geom``, with no wrapper around it →
    maps (B, N, out_h, out_w), or the per-block (vals, idxs) of a
    one-row-chunk geometry."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import _kernel_mats

    b, nbh, nbw, f, lh, wc = ops[0].shape
    n = ops[2].shape[0]
    bh, bw, kh, kw, out_h, out_w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    # both sides take the default tier's operands
    mats = _kernel_mats(bh, bw, kh, kw, str(ops[0].device), 3)
    tag = "bf16" if ops[0].dtype == torch.bfloat16 else "f32"
    if peaks:
        vals = torch.empty((b, n, nbh, 1, nbw), device=ops[0].device)
        idxs = torch.empty((b, n, nbh, 1, nbw), dtype=torch.int32, device=ops[0].device)
        outs, name = (vals, idxs), f"fftconv_block_conv_peaks_{tag}"
    else:
        outs = (torch.empty((b, n, out_h, out_w), device=ops[0].device),)
        name = f"fftconv_block_conv_{tag}"
    err = getattr(lib, name)(
        *(t.data_ptr() for t in (*ops, *mats, *outs)), b, nbh, nbw, f, n, lh, wc, vh, vw,
        out_h, out_w, order, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{'the parent' if parent else 'this tree'}: {name} failed: "
                           f"cudaError {err}")
    return (outs[0][:, :, :, 0], outs[1][:, :, :, 0]) if peaks else outs[0]


def ab_parent(csrc: pathlib.Path, seed: int) -> None:
    """Time the parent's fused kernels against this tree's, in turns, at
    the headline plan and the DPM plan (module docstring)."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv_peaks_reference,
        block_conv_reference,
        kernel_tile,
    )

    lib = build_parent(csrc)
    this = _build.library()

    def calls(ops, geom, peaks):
        """(the parent's call, this tree's call): both bare C entries, so
        the timing holds no wrapper's host time."""
        wc, vh = ops[0].shape[-1], geom[0] - geom[2] + 1
        order = kernel_tile(wc, vh, ops[2])
        return (lambda: bare_call(lib, ops, geom, peaks, order, True),
                lambda: bare_call(this, ops, geom, peaks, order, False))

    def turns(label, parent, new, runs=chip_smoke.RUNS):
        t = [chip_smoke.cuda_ms(f, runs) for f in (parent, new, new, parent)]
        print(f"A/B {label}: parent {t[0]:.3f}, this tree {t[1]:.3f}, this tree "
              f"{t[2]:.3f}, parent {t[3]:.3f} ms")
        torch.cuda.empty_cache()

    def compare(label, parent, new, peaks, ops, geom):
        a, b = parent(), new()
        want = (block_conv_peaks_reference if peaks else block_conv_reference)(*ops, *geom)
        torch.cuda.synchronize()
        flips = ""
        if peaks:
            flips = f", index flips {int((a[1] != b[1]).sum())} of {a[1].numel()}"
            a, b, want = a[0], b[0], want[0]
        rel = float((a - b).abs().max() / a.abs().max())
        print(f"{label}: parent vs this tree rel {rel:.3e}{flips}, bitwise equal "
              f"{torch.equal(a, b)}; vs the plain version: parent "
              f"{chip_smoke.rel_err(a, want):.3e}, this tree {chip_smoke.rel_err(b, want):.3e}")
        del a, b, want
        torch.cuda.empty_cache()

    rng = np.random.default_rng(seed)
    s, n, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["n"], chip_smoke.HEADLINE["k"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    bank = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32), device="cuda")
    spec = fc.fft_data_tiled(image, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=spec)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    for peaks in (False, True):
        label = f"headline plan, f32 {'peaks' if peaks else 'maps'}"
        compare(label, *calls(ops, geom, peaks), peaks, ops, geom)
        turns(label, *calls(ops, geom, peaks))
    del spec, sk, ops
    torch.cuda.empty_cache()

    feats, dbank, _ = chip_smoke.dpm_inputs(seed)
    k = chip_smoke.DPM["k"]
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sks = (fc.fft_kernels(dbank, spectral=sd, store_dtype="bfloat16"),
           fc.fft_kernels(dbank, spectral=sd, correlation=True, store_dtype="bfloat16"))
    geom = (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw, sd.out_h, sd.out_w)
    for peaks in (False, True):
        ops = (sd.re[None], sd.im[None], sks[peaks].re, sks[peaks].im)
        label = f"DPM plan, bf16 spectra, {'peaks' if peaks else 'f32 maps'}"
        compare(label, *calls(ops, geom, peaks), peaks, ops, geom)
        turns(label, *calls(ops, geom, peaks))
    ops = (sd.re[None], sd.im[None], sks[0].re, sks[0].im)
    print(f"DPM plan, plain version of the maps kernel: "
          f"{chip_smoke.cuda_ms(lambda: block_conv_reference(*ops, *geom)):.3f} ms")
    ops = tuple(t.float() for t in ops)
    turns("DPM plan, the same planes upcast to f32, f32 maps", *calls(ops, geom, False), runs=3)


def submit_soak(stream, frames, pinned, host, seconds: float) -> None:
    """The ``--soak`` part of ``--submit-probe`` (module docstring)."""
    import collections
    import gc
    import statistics
    import threading
    import time
    import traceback

    import torch

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    # While a submit runs: the garbage collector's time in it, and where the
    # main thread is once the submit has taken 4 ms (sampled from a thread).
    live = {"t0": None, "gc": 0.0, "gc_t": 0.0, "stack": None}
    main, done = threading.get_ident(), threading.Event()

    def on_gc(phase, info):
        if live["t0"] is None:
            return
        if phase == "start":
            live["gc_t"] = time.perf_counter()
        else:
            live["gc"] += 1e3 * (time.perf_counter() - live["gc_t"])

    def sampler():
        while not done.is_set():
            t0 = live["t0"]
            if t0 is not None and live["stack"] is None and time.perf_counter() - t0 > 4e-3:
                frames_ = traceback.extract_stack(sys._current_frames()[main])[-4:]
                live["stack"] = " < ".join(f"{pathlib.Path(f.filename).name}:{f.lineno}"
                                           for f in reversed(frames_))
            time.sleep(5e-4)

    gc.callbacks.append(on_gc)
    thread = threading.Thread(target=sampler, daemon=True)
    thread.start()
    trials = []
    end = time.perf_counter() + seconds
    try:
        while time.perf_counter() < end:
            stream.flush()
            first = stream.submit(frames[2])
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            live.update(t0=time.perf_counter(), gc=0.0, stack=None)
            stream.submit(frames[3])
            submit = 1e3 * (time.perf_counter() - live["t0"])
            live["t0"] = None
            trials.append((submit, not first._event.query(), live["gc"], live["stack"],
                           ms(lambda: sum(range(100_000))), ms(torch.cuda.mem_get_info),
                           ms(lambda: pinned.copy_(host)),
                           torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries))
    finally:
        done.set()
        thread.join()
        gc.callbacks.remove(on_gc)
    stream.flush()
    col = list(zip(*trials))
    windows = [statistics.median(col[0][i:i + 8]) for i in range(len(trials) - 7)]
    slow = [t for t in trials if t[0] > 3.5]
    print(f"soak, {len(trials)} submit trials over {seconds:.0f} s: submit ms median "
          f"{statistics.median(col[0]):.3f}, 99th {sorted(col[0])[int(0.99 * len(trials))]:.3f},"
          f" worst {max(col[0]):.3f}; worst median of 8 consecutive {max(windows):.3f}; "
          f"frame ahead done at return in {col[1].count(False)}; allocator retries "
          f"{sum(col[7])}; canary medians: loop {statistics.median(col[4]):.3f}, "
          f"mem_get_info {statistics.median(col[5]):.3f}, staging copy "
          f"{statistics.median(col[6]):.3f} ms")
    print(f"  {len(slow)} submits over 3.5 ms: {sum(t[2] > 0 for t in slow)} with a garbage "
          f"collection in them ({sum(t[2] for t in slow):.1f} ms of their "
          f"{sum(t[0] for t in slow):.1f}); the main thread after 4 ms:")
    for stack, count in collections.Counter(t[3] for t in slow).most_common(8):
        print(f"    {count:5d}  {stack}")
    for i in sorted(range(len(trials)), key=lambda i: -trials[i][0])[:8]:
        t = trials[i]
        print(f"  trial {i}: submit {t[0]:.3f} ms, frame ahead running {t[1]}, gc {t[2]:.3f} "
              f"ms, loop {t[4]:.3f}, mem_get_info {t[5]:.3f}, staging copy {t[6]:.3f}")


def submit_probe(seed: int, soak: float) -> None:
    """See the module docstring (``--submit-probe``)."""
    import statistics
    import time

    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc

    s, k, n = (chip_smoke.HEADLINE[key] for key in ("size", "k", "n"))
    rng = np.random.default_rng(seed + 4)
    frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(4)]
    bank = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32),
                           device="cuda")
    stream = fc.ConvStream.create((s, s, 1), bank, depth=3, algorithm="tiled", mode="same")
    stream.submit(frames[0]).result()
    pinned = torch.empty((s, s, 1), pin_memory=True)
    host = torch.as_tensor(frames[1])

    def submit():
        stream.flush()
        stream.submit(frames[2])
        t0 = time.perf_counter()
        stream.submit(frames[3])
        return time.perf_counter() - t0

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    probes = {
        "torch copy_": lambda: timed(lambda: pinned.copy_(host)),
        "numpy copyto": lambda: timed(lambda: np.copyto(pinned.numpy(), frames[1])),
        "ConvStream submit": submit,
    }
    print(f"device total memory: properties {torch.cuda.get_device_properties(0).total_memory}"
          f" B, cudaMemGetInfo {torch.cuda.mem_get_info()[1]} B")
    print(f"submit probe: {torch.get_num_threads()} intra-op threads, "
          f"{len(os.sched_getaffinity(0))} cores; host ms, median / worst of 32 "
          f"({chip_smoke.card()})")
    for hogs in (0, 2, 4, 8):
        procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                 for _ in range(hogs)]
        try:
            time.sleep(0.5)
            line = []
            for label, fn in probes.items():
                ms = [1e3 * fn() for _ in range(32)]
                line.append(f"{label} {statistics.median(ms):.3f} / {max(ms):.3f}")
            print(f"  {hogs} busy processes: " + "; ".join(line))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
    stream.flush()
    if soak > 0:
        submit_soak(stream, frames, pinned, host, soak)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--ab-parent", type=pathlib.Path, default=None,
                        help="a parent checkout's cuda_fft_convolution_torch/csrc")
    parser.add_argument("--submit-probe", action="store_true",
                        help="time a ConvStream submit and its staging copy beside "
                             "busy processes")
    parser.add_argument("--soak", type=float, default=0.0,
                        help="with --submit-probe: repeat the submit trial this many seconds")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    chip_smoke.env_report()
    if args.ab_parent is not None:
        ab_parent(args.ab_parent.resolve(), args.seed)
        return 0
    if args.submit_probe:
        submit_probe(args.seed, args.soak)
        return 0
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
    n = chip_smoke.DPM_DIRECT["n"]
    dsd = fc.fft_data(feats, k, k, store_dtype="bfloat16")
    dsk = fc.fft_kernels(dbank[:n].contiguous(), spectral=dsd, store_dtype="bfloat16")
    report(f"DPM direct conv_spectral fftmap, {n} filters resident, bf16 tier",
           lambda: fc.conv_spectral(dsd, dsk, mode="fftmap"), args.calls)
    del sd, sk, dsd, dsk, feats, dbank
    torch.cuda.empty_cache()

    image, cells, _, _ = chip_smoke.ragged_inputs(args.seed)
    image_d = torch.as_tensor(image, device="cuda")
    cells_d = [torch.as_tensor(c, device="cuda") for c in cells]
    report("ragged fft_conv (configs[1])",
           lambda: fc.fft_conv(image_d, kernels=cells_d, mode="same"), args.calls)
    ragged = fc.RaggedConvStream(image.shape, cells_d, depth=3, mode="same", algorithm="tiled")
    report("RaggedConvStream, tiled, depth 3, 8 host frames",
           lambda: serve(ragged, [image] * 8), args.calls, frames=8)
    del ragged, image_d, cells_d

    s, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["k"]
    rng = np.random.default_rng(args.seed + 4)
    frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(16)]
    hbank = torch.as_tensor(rng.standard_normal((chip_smoke.HEADLINE["n"], k, k, 1))
                            .astype(np.float32), device="cuda")
    for depth in (1, 3):
        stream = fc.ConvStream.create((s, s, 1), hbank, depth=depth, algorithm="tiled",
                                      mode="same")
        report(f"headline ConvStream, depth {depth}, 16 host frames",
               lambda: serve(stream, frames), args.calls, frames=len(frames))
        del stream
    del frames, hbank
    torch.cuda.empty_cache()

    from cuda_fft_convolution_torch import models

    feats, dbank, _ = chip_smoke.dpm_inputs(args.seed, store="float32")
    k = chip_smoke.DPM["k"]
    pyr = models.build_pyramid(feats, k, k, num_levels=chip_smoke.PYRAMID["levels"])
    report("pyramid detect_pyramid_peaks, 1024 filters, 5 levels",
           lambda: models.detect_pyramid_peaks(pyr, dbank), args.calls)
    del pyr, feats, dbank
    torch.cuda.empty_cache()
    images, _, model, targets = chip_smoke.trainer_inputs(fc, args.seed)
    opt = torch.optim.Adam(model.parameters(), lr=chip_smoke.TRAINER["lr"])
    report(f"trainer train_step, {tuple(images.shape)}, {model.num_filters} filters",
           lambda: models.train_step(model, opt, images, targets), args.calls)
    del images, model, targets, opt
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    frames, centres = chip_smoke.mosse_scene(gen, hog=True)
    estimates, filt = chip_smoke.mosse_track(fc, frames, centres, gen)
    win = chip_smoke.MOSSE["window"]
    centred = models.gaussian_target(win, win, (win // 2, win // 2), chip_smoke.MOSSE["sigma"])
    report("MOSSE frame, HOG cells (F=31)", lambda: chip_smoke.mosse_frame(
        fc, filt, frames[-1], estimates[-1], centred), args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
