"""BENCHMARK.json against the benchmark's contract, and every name found."""

import json
import re

import pytest

from qmri_bench.run import BENCH_DIR, ROOT, load_cell, metrics_of, reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["qmri_bench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[sec]}) == len(SPEC[sec])
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for e in SPEC["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"} and e["reduced"] == []
        assert e["file"].startswith("qmri_bench/") and len(e["why"]) <= 200
    for e in SPEC["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert e["chips"] == 1 and len(e["why"]) <= 200 and NAME.match(e["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec, entry, cfg, traffic, limits = load_cell(cell)
    assert cfg["name"] == entry["config"] and cfg["reduced"] == []
    # The host threads are the configuration's stated deployment.
    assert int(cfg["host_threads"]) >= 1 and "host_threads" in cfg["assumed"]
    assert (BENCH_DIR / "requests" / f"{traffic['request']}.py").is_file()
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in metrics_of(spec, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = metrics_of(spec, cell, "per_layer")
    assert per_layer
    # A per-layer metric moves an end-to-end metric that its cells report.
    assert all(m["moves"] in e2e for m in per_layer)
    for m in metrics_of(spec, cell, "end_to_end") + per_layer:
        assert callable(reader(m["name"]))


def test_listed_workloads_exist():
    cells = {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


HELD = json.loads((BENCH_DIR / "held.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in HELD["workloads"]])
def test_held_cell_finds_its_files_and_only_its_metrics(cell):
    assert cell not in {c["name"] for c in SPEC["workloads"]}
    spec, entry, cfg, traffic, limits = load_cell(cell)
    assert entry in HELD["workloads"] and cfg["name"] == entry["config"]
    assert entry["config"] in {c["name"] for c in SPEC["configs"]}
    e2e = [m["name"] for m in metrics_of(spec, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2 and limits
    # A held metric is reported by held cells alone, and named once.
    held_metrics = HELD["end_to_end"] + HELD["per_layer"]
    assert all(set(m["workloads"]) <= {c["name"] for c in HELD["workloads"]}
               for m in held_metrics)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    for m in metrics_of(spec, cell, "end_to_end") + metrics_of(spec, cell, "per_layer"):
        assert callable(reader(m["name"]))
