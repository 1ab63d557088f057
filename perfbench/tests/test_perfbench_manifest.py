"""``BENCHMARK.json`` holds to the form its contract gives it."""

import json
import os
import re

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _manifest():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fin:
        return json.load(fin)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_lines():
    b = _manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(b["end_to_end"]) + len(b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert _line(c["why"]) and _line(c["source"]) and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as fin:
            assert json.load(fin)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in {c["name"] for c in b["configs"]}


def test_metrics():
    b = _manifest()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:
        c = harness.load_cell(harness.ROOT, cell)
        assert [m["name"] for m in c.end_to_end][0] == "setup_s" and len(c.end_to_end) >= 2 and c.per_layer
