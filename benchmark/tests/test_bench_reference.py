"""The reference stands apart from the program and agrees with the port's
CPU path at a tiny size; the run's guard against JAX compares whole
top-level names."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

ROOT = harness.ROOT


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.field, benchmark.reference.train, "
            "benchmark.reference.render, benchmark.counts.train, benchmark.counts.render, "
            "benchmark.inputs, benchmark.generator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120)
    top = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "scanerf_tpu", "scanerf_tpu_torch"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "scanerf_tpu_torch_probe", object())
    assert "scanerf_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "scanerf_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"scanerf_tpu.ops", "jaxlib"} <= set(run.forbidden_modules())


def test_run_refuses_without_cuda(capsys):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "tile2p24.train_b14", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_run_fails_where_the_program_is_missing(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark: the run
    prints no result and exits non-zero."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "tile2p24.train_b14", "--seed", "1", "--seconds", "1", "--device",
                          "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def result(capsys, cell: str, trace: int, seed: int = 2**31 + 11) -> dict:
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace",
                     str(trace), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("cell,trace", [("tile2p24.train_b14", 0), ("tile2p24.train_b16", 1),
                                        ("city2x2p24.overhead_720p", 1),
                                        ("city2x2p24.horizon_720p", 0)])
def test_tiny_run_agrees_with_the_reference(monkeypatch, capsys, cell, trace):
    tiny.patch(monkeypatch)
    line = result(capsys, cell, trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    kind = "train" if cell.startswith("tile") else "render"
    if trace:
        assert {n.split(".")[0] for n in line["metrics"]} == {kind}
    else:
        assert set(line["metrics"]) == {f"{kind}_rays_per_s", "setup_s"}
