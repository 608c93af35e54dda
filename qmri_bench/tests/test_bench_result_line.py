"""The run's result object, its exits without a card or without the program,
and the check that no module of JAX or of the JAX package is loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from qmri_bench.run import ROOT, forbidden_modules, main
from qmri_bench.tests.conftest import CELLS, small_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_object(cell):
    r = small_run(cell)
    assert KEYS <= set(r) and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("names,found", [
    (["dosma_tpu_torch", "dosma_tpu_torch.ops.monoexp", "jaxtyping", "flaxen"], []),
    (["dosma_tpu.core.fitting", "numpy"], ["dosma_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert forbidden_modules(names) == found


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", "t2_config1.card_fit", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_cell_loads_no_jax():
    code = ("import sys, torch, dosma_tpu_torch as dt; dt.set_default_device('cpu');"
            "from qmri_bench.tests.conftest import small_run;"
            "from qmri_bench.run import forbidden_modules;"
            "small_run('t2_config1.card_fit'); print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qmri_bench", tmp_path / "qmri_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "qmri_bench.run", "--workload",
                          "t2_config1.card_fit", "--seed", "3", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
