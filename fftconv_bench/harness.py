"""One run of one cell: set-up, the timed window, the check.

The timed path is the port's serving loop over a resident bank: a
``ConvStream`` built at set-up (the bank's spectra computed once), then a
closed loop that keeps ``depth`` submissions in flight: when ``depth`` are
queued it resolves the oldest with ``ConvFuture.result()`` and drops it,
then submits the next frame, so ``submit`` always finds room. Frames cycle
through a pool made on the device at set-up; in a cell whose configuration
has a HOG front end, each frame goes through the port's ``hog_features``
and is cast to the features' dtype before ``submit``, as a DPM user does.

After the window the answers kept for the check are compared with the
float64 reference (``reference/``): ``check_frames`` answers drawn from the
seed over every frame submitted in the window (a reservoir sample), held
until then. A fixed number held keeps the allocator's pool from growing in
the window.
"""

from __future__ import annotations

import collections
import contextlib
import math
import random
import subprocess
import sys
import time

import numpy as np
import torch

from fftconv_bench import roofline, spec, trace, workload
from fftconv_bench.reference import compare
from fftconv_bench.reference.conv import conv_blocks
from fftconv_bench.reference.hog import hog

GIB = float(1 << 30)


def _front_end(config: dict):
    """The per-frame front end through the port, or None."""
    fe = config.get("front_end")
    if not fe:
        return None
    from cuda_fft_convolution_torch.models import hog_features

    cell, bins = fe["hog"]["cell"], fe["hog"]["bins"]
    dtype = getattr(torch, fe["dtype"])
    return lambda img: hog_features(img, cell=cell, bins=bins).to(dtype)


def _power_limit(device: torch.device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return smi.stdout.strip()


def reference_inputs(config: dict, pool: torch.Tensor, idx: list[int]) -> torch.Tensor:
    """(B, H, W, F) float64 inputs of the reference for pool frames ``idx``:
    the frames themselves, or their float64 HOG features."""
    fe = config.get("front_end")
    if not fe:
        return pool[idx].to(torch.float64)
    return torch.stack([hog(pool[i], fe["hog"]["cell"], fe["hog"]["bins"]) for i in idx])


def check(cell: spec.Cell, inputs: workload.Inputs, answers: dict) -> tuple[dict, int]:
    """The numbers that decide ``correct``, each the worst over the answers
    compared, and how many of them exceeded a limit (kept maps, or pool
    frames under a head). ``answers`` maps a pool frame to its answers: a
    list of maps, or of (values, positions)."""
    cfg, entry = cell.config, cell.traffic["entry"]
    frames = sorted(answers)
    if not frames:
        return {}, 0
    blocks = conv_blocks(
        reference_inputs(cfg, inputs.pool, frames), inputs.bank, mode=entry["mode"],
        correlation=cfg["entry"]["correlation"])
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    if entry.get("head") == "peaks":
        got = [(torch.stack([a[0] for a in answers[p]]), torch.stack([a[1] for a in answers[p]]))
               for p in frames]
        per_frame = [dict(zip(("peak_value_err", "peak_position_gap"), e))
                     for e in compare.peak_errs(got, blocks)]
    else:
        # one entry a kept answer: repeat a pool frame's reference for each
        flat = [(p, m) for p in frames for m in answers[p]]
        errs = compare.map_err([m for _, m in flat], _repeat(blocks, frames, flat))
        per_frame = [{"map_err": e} for e in errs]
    numbers = {k: max(pf[k] for pf in per_frame) for k in per_frame[0]}
    failed = sum(any(not v <= limits.get(k, -math.inf) for k, v in pf.items())
                 for pf in per_frame)
    return numbers, failed


def _repeat(blocks, frames, flat):
    """Reference blocks over ``frames`` → blocks over the kept answers."""
    at = {p: i for i, p in enumerate(frames)}
    rows = [at[p] for p, _ in flat]
    for n0, ref in blocks:
        yield n0, ref[rows]


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
        device="cuda", t_process: float | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_run = time.perf_counter()
    from cuda_fft_convolution_torch.runtime.stream import ConvStream

    t_process = t_run if t_process is None else t_process
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    if tr["loop"] != "closed":
        raise ValueError(f"loop {tr['loop']!r}: only 'closed' is implemented")
    depth, n_pool = int(tr["depth"]), int(tr["pool"])

    t_card = time.perf_counter()
    if cuda:
        torch.empty(0, device=dev)  # the card's context, timed apart
    t_inputs = time.perf_counter()
    inputs = workload.make_inputs(cfg, tr, seed, dev)
    front = _front_end(cfg)
    frame_shape, _ = roofline.conv_shapes(cfg)
    t_stream = time.perf_counter()
    stream = ConvStream.create(frame_shape, inputs.bank, depth=depth, device=dev,
                               **cfg["entry"], **tr["entry"])

    def frame(i):
        x = inputs.pool[i % n_pool]
        return front(x) if front else x

    inflight: collections.deque = collections.deque()
    mark = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())

    def drive(i, more, keep, latency, submit_s, hog_events=None):
        """The closed loop from frame ``i`` while ``more(i)``: with ``depth``
        submissions in flight, resolve the oldest (its latency to
        ``latency``, its answer to ``keep(i, answer)``), then submit the
        next frame (its host time to ``submit_s``). Returns the next frame."""
        while more(i):
            if len(inflight) == depth:
                latency.append(resolve(keep))
            with mark("bench.hog") if front else contextlib.nullcontext():
                if hog_events is not None:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    x = frame(i)
                    ev[1].record()
                    hog_events.append(ev)
                else:
                    x = frame(i)
            t_sub = time.perf_counter()
            with mark("bench.submit"):
                fut = stream.submit(x)
            submit_s.append(time.perf_counter() - t_sub)
            inflight.append((fut, t_sub, i))
            i += 1
        return i

    def resolve(keep):
        fut, t_sub, i = inflight.popleft()
        with mark("bench.result"):
            out = fut.result()
        t = time.perf_counter()
        keep(i, out)
        return t - t_sub

    def drain(keep):
        while inflight:
            resolve(keep)

    # Warm-up runs the window's loop: every shape, `depth` answers in flight
    # and as many held as the check holds, so the allocator's cache is full
    # and nothing is allocated or first launched inside the window.
    n_keep = int(tr["check_frames"])
    held: collections.deque = collections.deque(maxlen=n_keep)
    t_warm = time.perf_counter()
    n_warm = int(tr["warmup"])
    drive(0, lambda i: i < n_warm,
          lambda _, out: held.append(out), [], [])
    drain(lambda _, out: held.append(out))
    del held
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"setup: the port's import {t_card - t_run:.3f} s, "
          f"card {t_inputs - t_card:.3f} s, inputs {t_stream - t_inputs:.3f} s, "
          f"stream {t_warm - t_stream:.3f} s, warm-up {time.perf_counter() - t_warm:.3f} s "
          f"({n_warm} frames), since start {time.perf_counter() - t_process:.3f} s",
          file=sys.stderr, flush=True)

    # The answers the check compares: `n_keep` of them, a reservoir sample
    # drawn from the seed over every frame submitted in the window.
    reservoir: dict[int, tuple] = {}
    pick = random.Random(seed)

    def keep(i, out):
        slot = i if i < n_keep else pick.randrange(i + 1)
        if slot < n_keep:
            reservoir[slot] = (i, out)

    latency, submit_s = [], []
    hog_events = [] if traced and cuda and front else None
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(trace.profile()) if traced else None
        if cuda:
            torch.cuda.synchronize(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if prof:
            prof.step()  # records from here
        t0 = time.perf_counter()
        i = drive(0, lambda _: time.perf_counter() - t0 < seconds, keep, latency, submit_s,
                  hog_events)
        t_end = time.perf_counter()
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        drain(keep)  # submitted in the window: checked, not counted
        if cuda:
            torch.cuda.synchronize(dev)
        t_trace = time.perf_counter()
        if prof:
            prof.step()
    answers: dict[int, list] = collections.defaultdict(list)
    for j, out in reservoir.values():
        answers[j % n_pool].append(out)
    del reservoir
    attempted = i
    resolved = len(latency)

    result = {"correct": False, "attempted": attempted, "failed": 0, "metrics": {}}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips if cuda else 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0,
    }
    if traced:
        dev_ev, host_ev = trace.device_events(prof)
        busy_us, span_us = trace.busy_and_span([(s, e) for _, s, e in dev_ev])
        records = {
            "frames": attempted,
            "window_s": t_trace - t0,
            "submit_host_s": submit_s,
            "hog_ms": [a.elapsed_time(b) for a, b in hog_events or ()],
            "kernels": [ev for ev in dev_ev if trace.is_kernel(ev[0])],
            "busy_us": busy_us,
            "span_us": span_us,
            "roofline": roofline.counts(cfg, tr),
        }
        for m in cell.per_layer:
            v = spec.reader(m["name"])(records)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=busy_us * 1e-6, window_s=t_trace - t0)
        result["breakdown"] = trace.breakdown(dev_ev, host_ev)
        del prof, dev_ev, host_ev, records
    else:
        values = {
            "frames_per_s": resolved / (t_end - t0),
            "frame_p95_ms": float(np.percentile(latency, 95)) * 1e3 if latency else math.inf,
            "peak_mem_GiB": window_peak / GIB,
            "setup_s": t0 - t_process,
        }
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    if cuda:
        device_info["power_limit"] = _power_limit(dev)
    result["device"] = device_info

    # the check, once the window has closed and the program's state is freed
    del stream
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = check(cell, inputs, answers)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    result["correct"] = bool(numbers) and set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result["failed"] = failed
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result
