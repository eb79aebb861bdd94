"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

import json
import os
import re

import pytest
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(s["command"]) <= 32 and all(one_line(w) for w in s["command"])
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(REPO, p))
    for w in s["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in s["paths"]), w
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    cells = len(s["workloads"])
    # a full check of 24 cells fits the driver's 43,200 s
    for n in (cells, 24):
        assert (2 + 14 * n) * (s["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_names_and_units():
    s = spec()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in s[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_and_cells():
    s = spec()
    files = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and k in cfg.get("reduced_why", {})
        for part in ("", "_ref"):
            assert os.path.isfile(os.path.join(BENCH, "configs", c["name"] + part + ".py"))
        assert any(w["config"] == c["name"] for w in s["workloads"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert one_line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert any(c["name"] == w["config"] for c in s["configs"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(BENCH, "generators", traffic["generator"] + ".py"))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, len(s["workloads"]) // 4)


def test_metrics():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        layers.add(m["layer"])
    for w in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells) for m in s["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in s["per_layer"])


@pytest.mark.parametrize("name", [m["name"] for m in spec()["per_layer"]])
def test_metric_reader_loads(name):
    from harness import load_module

    assert callable(load_module("metrics", name + ".py").read)


def test_cells_resolve():
    from harness import Cell

    s = spec()
    for w in s["workloads"]:
        cell = Cell(s, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert cell.traffic["entry"] in ("pipeline", "eager")
