"""The roofline counts reproduce the table in PERF.md §4, from the cells'
shapes alone."""

import pytest

from fftconv_bench import roofline, spec

# cell: (GB, GFLOP, bound ms, bound by)
TABLE = {
    "headline.same": (1.696, 27.97, 0.506, "bytes"),
    "headline.fftmap": (1.885, 27.97, 0.563, "bytes"),
    "dpm.peaks": (0.0254, 51.13, 0.0517, "flops"),
    "dpm.maps": (0.562, 51.13, 0.168, "bytes"),
}


@pytest.mark.parametrize("name", sorted(TABLE))
def test_counts(name):
    c = spec.cell(name)
    r = roofline.counts(c.config, c.traffic)
    gb, gflop, ms, by = TABLE[name]
    assert r["bytes"] / 1e9 == pytest.approx(gb, rel=2e-3)
    assert r["flops"] / 1e9 == pytest.approx(gflop, rel=2e-3)
    assert r["bound_ms"] == pytest.approx(ms, rel=3e-3)
    assert r["bound_by"] == by


def test_canvas_is_5_smooth():
    c = spec.cell("headline.same")
    assert roofline.counts(c.config, c.traffic)["canvas"] == (2160, 2160)
    c = spec.cell("dpm.maps")
    assert roofline.counts(c.config, c.traffic)["canvas"] == (540, 540)


def test_bound_ignores_the_program():
    # the count is a function of the files alone: no import of the program
    import sys

    c = spec.cell("dpm.peaks")
    before = set(sys.modules)
    roofline.counts(c.config, c.traffic)
    assert not any(m.startswith("cuda_fft_convolution") for m in set(sys.modules) - before)
