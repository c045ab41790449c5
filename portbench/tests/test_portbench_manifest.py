"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of the harness."""
from __future__ import annotations

import json
import re

import pytest

from portbench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def m():
    return harness.load_manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(m):
    assert set(m) == {"command", "paths", "run_seconds", *KEYS}
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check(m):
    cells = 24
    total = 2 + 14 * cells * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_names(m, section):
    items = m[section]
    assert items
    names = [it["name"] for it in items]
    assert len(names) == len(set(names))
    for it in items:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(it) <= KEYS[section] | extra
        assert NAME.match(it["name"])
        if "unit" in it:
            assert UNIT.match(it["unit"])
            assert it["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in it:
                assert _line(it[key])


def test_configs(m):
    used = {w["config"] for w in m["workloads"]}
    assert 1 <= len(m["configs"]) <= 24
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank"))
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_workloads(m):
    ws = m["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in ws)
    assert all(w["chips"] in (1, 4) for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert NAME.match(w["traffic"])
        traffic = harness.load_json(
            harness.BENCH / "traffic" / f"{w['traffic']}.json")
        assert (harness.BENCH / "entries" /
                f"{traffic['entry']}.py").is_file()


def test_metrics(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in e2e.values():
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in E2E_SOURCES
    assert 1 <= len(m["per_layer"]) <= 128
    cells = {w["name"] for w in m["workloads"]}
    layers = {}
    for x in m["per_layer"]:
        assert x["source"] in SOURCES
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[x["moves"]].get("workloads", cells)
        layers.setdefault(x["layer"], []).append(x["name"])
    for section in ("end_to_end", "per_layer"):
        for x in m[section]:
            assert (harness.BENCH / "metrics" / f"{x['name']}.py").is_file()
            if x["name"].endswith("_roofline"):
                assert x["unit"] == "%"


def test_every_cell_reports_enough(m):
    for w in m["workloads"]:
        cell = w["name"]
        e2e = harness.cell_metrics(m, cell, "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(m, cell, "per_layer")
