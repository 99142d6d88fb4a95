"""BENCHMARK.json keeps to its schema, and every cell's parts are found
by name."""
import json
import re

import pytest

from bench import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert len(B["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in B["command"])
    assert len(json.dumps(B)) <= 64 * 1024


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]]
             + [w[k] for w in B["workloads"] for k in ("config", "traffic")])
    assert all(NAME.match(n) for n in names)
    for group in (B["configs"], B["workloads"],
                  B["end_to_end"] + B["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    run = harness.make_run(B, cell, 1, 1.0, False, "cpu")
    assert harness.generator(run.traffic["generator"]).setup
    assert run.limits
    for trace in (False, True):
        for m in harness.metrics_of(B, cell, trace):
            assert callable(harness.reader(m["name"]).read)
    e2e = {m["name"] for m in harness.metrics_of(B, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(B, cell, True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_each_config_used_and_file_given():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        # each changed key is in the file (at the top or in one group) and
        # has its reason under "assumed"
        keys = set(cfg) | {k for v in cfg.values() if isinstance(v, dict)
                           for k in v}
        assert set(c["reduced"]) <= keys & set(cfg["assumed"])


def test_budget_and_chips():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
