"""The traced run's records: the profiler's device events, the harness's
own host spans, and the breakdown the result line carries.

The harness marks its own calls with ``torch.profiler.record_function``
(names in ``SPANS``); the device events and those spans share the
profiler's clock, so an idle gap on the device is named by what the host
was doing when it began.
"""

from __future__ import annotations

import torch

SPANS = ("bench.hog", "bench.submit", "bench.result")
_COPIES = ("Memcpy", "Memset")


def busy_and_span(spans) -> tuple[float, float]:
    """(union of the (start, end) spans, first start to last end)."""
    spans = sorted(spans)
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


def profile():
    """A profiler that records from its first ``step()`` to its second: the
    CUPTI start-up falls before the window."""
    from torch.profiler import ProfilerActivity, schedule

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
    )


def device_events(prof) -> tuple[list, list]:
    """(device events as (name, start_us, end_us), host events likewise).
    The profiler also puts each host span on the device's timeline; those
    are left out of the device events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False) or _annotation(e.name)):
            dev.append(row)  # the device timeline's copies of host spans are not work
    return dev, host


def _annotation(name: str) -> bool:
    return name in SPANS or name.startswith("ProfilerStep")


def is_kernel(name: str) -> bool:
    return not name.startswith(_COPIES)


def _host_at(host: list, t: float) -> str:
    """The harness span and the innermost host op under way at ``t``."""
    span, op, op_len = "loop", "", float("inf")
    for name, s, e in host:
        if s <= t <= e:
            if name in SPANS:
                span = name.split(".", 1)[1]
            elif e - s < op_len and not _annotation(name):
                op, op_len = name, e - s
    return f"{span}/{op}" if op else span


def breakdown(dev: list, host: list, top: int = 10) -> dict:
    """The device operations with the most time, and the longest idle gaps
    by what the host was doing, in seconds."""
    by_name: dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e) for _, s, e in dev)
    gaps, reach = [], None
    for s, e in spans:
        if reach is not None and s > reach:
            gaps.append((s - reach, reach))
        reach = e if reach is None else max(reach, e)
    gaps.sort(reverse=True)
    return {
        "device_ops": [[n[:160], v] for n, v in ops],
        "idle_gaps": [[_host_at(host, t0), g * 1e-6] for g, t0 in gaps[:top]],
    }
