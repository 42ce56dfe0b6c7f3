"""Whole runs of each cell on the CPU at tiny sizes (the port's plain
versions), the look for a chip skipped: a sound run comes out correct;
with the timed path broken underneath it comes out not correct, once for
each fault a cell can have; the control (the reference one precision
below, in the program's place) fails the cell's limits. The last test runs
a cell on the card and skips without one."""

import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

from fftconv_bench import control, harness, spec
from fftconv_bench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 17


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = harness.run(tiny_cell(name), SEED, 1.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(spec.cell(name).limits)
    assert {m["name"] for m in spec.cell(name).end_to_end} == set(r["metrics"])


def test_traced_run_reports_per_layer_metrics_it_can_read():
    r = harness.run(tiny_cell("dpm.peaks"), SEED, 1.0, True, device="cpu")
    assert r["correct"]
    # on the CPU there is no device trace: only the host's readings remain
    assert set(r["metrics"]) == {"submit_host_ms"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def stale(prev):
    def tamper(value):
        out = prev[0] if prev[0] is not None else value
        prev[0] = value
        return out
    return tamper


def half(value):
    if isinstance(value, tuple):
        v, p = value
        v = v.clone()
        v[v.shape[0] // 2 :] = 0
        return v, p
    m = value.clone()
    m[m.shape[0] // 2 :] = 0
    return m


def altered(value):
    if isinstance(value, tuple):
        v, p = value
        p = p.clone()
        p[0] = (p[0] + 3) % 8
        return v, p
    m = value.clone()
    m[0, 1, 2] += m[0].abs().max()
    return m


FAULTS = {"stale": lambda: stale([None]), "half": lambda: half, "altered": lambda: altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from cuda_fft_convolution_torch.runtime.stream import ConvStream

    tamper = FAULTS[fault]()
    submit = ConvStream.submit

    def broken(self, frame):
        fut = submit(self, frame)
        fut._value = tamper(fut._value)
        return fut

    monkeypatch.setattr(ConvStream, "submit", broken)
    r = harness.run(tiny_cell(name), SEED, 1.0, False, device="cpu")
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0


@pytest.mark.parametrize("name", [w for w in CELLS if spec.cell(w).traffic["check_frames"] >= 8])
def test_a_fault_late_in_the_window_is_caught(name, monkeypatch):
    # the answers compared are drawn over the whole window, not its start
    from cuda_fft_convolution_torch.runtime.stream import ConvStream

    cell = tiny_cell(name)
    late = int(cell.traffic["warmup"]) + 16
    submit, count = ConvStream.submit, [0]

    def broken(self, frame):
        fut = submit(self, frame)
        count[0] += 1
        if count[0] > late:
            fut._value = altered(fut._value)
        return fut

    monkeypatch.setattr(ConvStream, "submit", broken)
    # a clock that ticks once a read: the window holds as many frames on any host
    ticks = itertools.count()
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(ticks) * 1e-3)
    r = harness.run(cell, SEED, 0.5, False, device="cpu")
    assert r["attempted"] > 2 * late
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    c = tiny_cell(name)
    res = control.readings(c, [SEED], [SEED + 1, SEED + 2], 1.0, device="cpu")
    limits = {k: v["limit"] for k, v in c.limits.items()}
    assert all(v <= limits[k] for k, v in res["program_max"].items())
    assert any(v > limits[k] for k, v in res["control_min"].items()), res


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "fftconv_bench.run", "--workload",
                        "headline.same", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=spec.ROOT, env=dict(os.environ),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
