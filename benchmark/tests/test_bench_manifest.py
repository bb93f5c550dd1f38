"""BENCHMARK.json against the rules of its format and against its own files."""

import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def reported(metric: dict) -> set:
    return set(metric.get("workloads", CELLS))


def test_names_and_units():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [c["name"] for c in MAN["configs"]] + list(CELLS)
    names += [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("end_to_end", "per_layer", "configs", "workloads"):
        seen = [m["name"] for m in MAN[kind]]
        assert len(seen) == len(set(seen)), kind
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [c["source"] for c in MAN["configs"]] + [w["why"] for w in MAN["workloads"]] \
            + [m["layer"] for m in MAN["per_layer"]] + MAN["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_every_moves_is_reported_in_the_same_cells():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        assert reported(m) <= reported(E2E[m["moves"]]), m["name"]


def test_every_configuration_has_a_cell_and_every_cell_its_files():
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}
    files = {c["name"]: c["file"] for c in MAN["configs"]}
    for name, w in CELLS.items():
        cell = harness.load_json("workloads", name)
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        cfg = harness.load_json("configs", w["config"])
        assert files[w["config"]] == f"benchmark/configs/{w['config']}.json"
        assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{cfg['driver']}.py"))
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
        assert set(cell["limits"]) == set(harness.load_module(
            "drivers", cfg["driver"]).CHECKS)
    for m in MAN["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")


def test_bounds_and_window():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25
    assert 1 <= MAN["run_seconds"] <= 51
    for name in CELLS:
        e2e = [m for m in MAN["end_to_end"] if name in reported(m)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2, name
        assert any(name in reported(m) for m in MAN["per_layer"]), name


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_metric_selection(cell):
    from benchmark import run

    e2e = {m["name"] for m in run.cell_metrics(MAN, cell, False)}
    layer = {m["name"] for m in run.cell_metrics(MAN, cell, True)}
    assert "setup_s" in e2e and layer
    assert {m["moves"] for m in MAN["per_layer"] if m["name"] in layer} <= e2e
