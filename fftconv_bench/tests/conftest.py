"""Tiny copies of the benchmark's cells for CPU tests: the same files, the
shapes cut so that a run takes a fraction of a second on the CPU."""

import copy

import pytest

from fftconv_bench import spec


def tiny_cell(name: str) -> spec.Cell:
    c = spec.cell(name)
    cfg = copy.deepcopy(c.config)
    if cfg.get("front_end"):
        cfg["image"].update(shape=[128, 128], coarse=8)
        cfg["bank"]["shape"] = [6, 3, 3, cfg["front_end"]["hog"]["bins"]]
    else:
        cfg["image"]["shape"] = [64, 64, 1]
        cfg["bank"]["shape"] = [4, 8, 8, 1]
    c.config = cfg
    return c


@pytest.fixture
def tiny():
    return tiny_cell
