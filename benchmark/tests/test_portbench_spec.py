"""BENCHMARK.json against the form the benchmark's contract gives it: the
keys of every entry, names, units, lengths, bounds, and what each cell
reports."""

import json
import os
import re

import pytest

from conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    SPEC = json.load(_fh)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", *KEYS}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in SPEC["command"])
    files = [w for w in SPEC["command"] if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in SPEC["paths"])
                         for f in files)
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert 2 * 90 * 24 + (2 + 14 * 24) * (rs + 60) + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    need, may = KEYS[section]
    entries = SPEC[section]
    assert 1 <= len(entries) <= {"per_layer": 128, "end_to_end": 16}.get(
        section, 24)
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert need <= set(e) <= need | may, (section, e["name"])
        assert NAME.fullmatch(e["name"])
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower",
                                                                "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"])


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e

    def reports(m):
        return set(m.get("workloads", cells))

    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert reports(m) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert reports(m) <= reports(e2e[m["moves"]])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(_line(layer) for layer in layers)
    for cell in cells:
        got = {n for n, m in e2e.items() if cell in reports(m)}
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(cell in reports(m) for m in SPEC["per_layer"]), cell
