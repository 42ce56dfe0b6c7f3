"""BENCHMARK.json against its schema and limits, and every cell resolving to
its files by name; a new cell needs new files and entries only."""

import json
import re
import shutil

import pytest

from fftconv_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fftconv_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in BENCH["configs"]:
        assert 1 <= len(e["source"]) <= 200


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"frames_per_s", "frame_p95_ms", "peak_mem_GiB", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_name_their_cells_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frames_per_s"}
    assert c.per_layer
    assert c.limits and all("limit" in v for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    cfg_entry = next(e for e in BENCH["configs"]
                     if e["name"] == next(w for w in BENCH["workloads"]
                                          if w["name"] == name)["config"])
    assert cfg_entry["file"].startswith("fftconv_bench/")
    assert c.config["reduced"] == cfg_entry["reduced"]


def test_a_new_cell_needs_new_files_and_entries_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "fftconv_bench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "fftconv_bench").rglob("*") if p.is_file()}
    pkg = root / "fftconv_bench"
    cfg = json.loads((pkg / "configs" / "headline_2048_f32_100x64.json").read_text())
    cfg.update(name="bigk_2048_f32_16x512", bank={"shape": [16, 512, 512, 1], "kind": "normal"})
    (pkg / "configs" / "bigk_2048_f32_16x512.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiled_same_depth2.json").write_text(json.dumps(
        {"entry": {"algorithm": "tiled", "mode": "same"}, "loop": "closed", "depth": 2,
         "pool": 8, "warmup": 2, "check_frames": 1}))
    (pkg / "limits" / "bigk.same.json").write_text(json.dumps({"map_err": {"limit": 1e-5}}))
    (pkg / "metrics" / "bigk_extra_ms.py").write_text("def read(rec):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bigk_2048_f32_16x512", "source": "x",
                             "file": "fftconv_bench/configs/bigk_2048_f32_16x512.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "bigk.same", "config": "bigk_2048_f32_16x512",
                               "traffic": "tiled_same_depth2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "bigk_extra_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "frames_per_s", "workloads": ["bigk.same"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("bigk.same", root)
    assert c.config["bank"]["shape"] == [16, 512, 512, 1]
    assert c.traffic["depth"] == 2
    assert "bigk_extra_ms" in {m["name"] for m in c.per_layer}
    assert spec.reader("bigk_extra_ms", root)({}) is None
    assert "bigk_extra_ms" not in {m["name"] for m in spec.cell("headline.same", root).per_layer}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"
