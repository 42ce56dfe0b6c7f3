"""Each per-layer reader on a synthetic record of a traced run, and the
trace helpers that build the record."""

import pytest

from fftconv_bench import spec, trace

BLOCK = "void (anonymous namespace)::block_conv_kernel<float, 64, false, 3, 0>(...)"
MAC = "void (anonymous namespace)::spectral_mac_kernel<float, 1, 1>(...)"
FFT = "void regular_fft<2160u, EPT<6u, 10u>, 2u, 2u>(...)"
COPY = "void at::native::elementwise_kernel<128, 2, direct_copy_kernel>(...)"


def record(**kw):
    rec = {
        "frames": 4,
        "window_s": 0.05,
        "submit_host_s": [0.001, 0.002, 0.003, 0.002],
        "hog_ms": [],
        "kernels": [(BLOCK, 0, 10_000), (FFT, 10_000, 10_500), (COPY, 10_500, 10_600),
                    (BLOCK, 11_000, 21_000), (MAC, 21_000, 21_400)],
        "busy_us": 40_000.0,
        "span_us": 50_000.0,
        "roofline": {"bound_ms": 0.5},
    }
    rec.update(kw)
    return rec


def read(name, rec):
    return spec.reader(name)(rec)


def test_readers():
    rec = record()
    assert read("submit_host_ms", rec) == pytest.approx(2.0)
    assert read("launches_per_frame", rec) == pytest.approx(5 / 4)
    assert read("fft_ms", rec) == pytest.approx(0.5 / 4)
    assert read("block_conv_ms", rec) == pytest.approx(20.0 / 4)
    assert read("mac_ms", rec) == pytest.approx(0.4 / 4)
    assert read("device_idle_pct", rec) == pytest.approx(20.0)
    assert read("conv_roofline", rec) == pytest.approx(100 * 0.5 / 10.0)
    assert read("hog_ms", rec) is None


def test_hog_and_the_roofline_without_it():
    rec = record(hog_ms=[2.0, 4.0])
    assert read("hog_ms", rec) == pytest.approx(3.0)
    assert read("conv_roofline", rec) == pytest.approx(100 * 0.5 / (10.0 - 3.0))


@pytest.mark.parametrize("name", ["fft_ms", "block_conv_ms", "mac_ms", "launches_per_frame"])
def test_nothing_to_read_gives_none(name):
    assert read(name, record(kernels=[])) is None


def test_no_device_work_gives_none():
    assert read("conv_roofline", record(busy_us=0.0)) is None
    assert read("device_idle_pct", record(span_us=0.0)) is None


def test_busy_and_span():
    assert trace.busy_and_span([(0, 10), (5, 12), (20, 30)]) == (22.0, 30.0)
    assert trace.busy_and_span([]) == (0.0, 0.0)


def test_breakdown_names_gaps_by_the_host():
    dev = [(BLOCK, 0, 100), (FFT, 150, 200), (BLOCK, 500, 600)]
    host = [("bench.result", 190, 520), ("cudaEventSynchronize", 195, 510),
            ("ProfilerStep#1", 0, 1000), ("bench.submit", 120, 160), ("aten::copy_", 99, 149)]
    b = trace.breakdown(dev, host)
    assert b["device_ops"][0] == [BLOCK, pytest.approx(200e-6)]
    assert b["idle_gaps"] == [["result/cudaEventSynchronize", pytest.approx(300e-6)],
                              ["loop/aten::copy_", pytest.approx(50e-6)]]
