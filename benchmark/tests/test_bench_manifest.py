"""``BENCHMARK.json`` and the files it names hold together."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_cells_name_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["chips"] in (1, 4)
        cfg = json.load(open(os.path.join(ROOT, configs[cell["config"]]["file"])))
        assert cfg["name"] == cell["config"]
        assert cfg["reduced"] == configs[cell["config"]]["reduced"]
        for sub in (f"traffic/{cell['traffic']}.json",
                    f"limits/{cell['name']}.json"):
            assert os.path.isfile(os.path.join(ROOT, "benchmark", sub)), sub
        mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          cell["traffic"] + ".json")))
        assert mix["mode"] in ("thread", "process")
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "sources",
                                           mix["source"] + ".py"))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    cells = {c["name"] for c in BENCH["workloads"]}
    for w in metric["workloads"]:
        assert w in cells
        assert w in moved.get("workloads", cells)


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
