"""``BENCHMARK.json`` against the rules it is written to: names, units and
lengths, the files each entry names, bounds, and which cell reports what."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def m():
    return harness.manifest()


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reports(m, cell, group):
    return {x["name"] for x in m[group] if "workloads" not in x or cell in x["workloads"]}


def test_shape_and_sizes(m):
    assert set(m) == KEYS["top"]
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p and not p.startswith("/")
        assert (harness.ROOT / p).is_dir() and not p.endswith("_torch")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert set(entry) <= KEYS[group], entry
            assert NAME.fullmatch(entry["name"]), entry["name"]
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names))


def test_run_length_fits_a_full_check_of_24_cells(m):
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells_name_their_files(m):
    used = {c["config"] for c in m["workloads"]}
    for cfg in m["configs"]:
        assert cfg["name"] in used and line(cfg["source"]) and line(cfg["why"])
        assert cfg["file"].startswith(tuple(p + "/" for p in m["paths"]))
        body = harness.read_json(harness.ROOT / cfg["file"])
        assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in cfg["reduced"])
    configs = {c["name"] for c in m["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in m["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4) and line(cell["why"])
        assert NAME.fullmatch(cell["traffic"])
        mix = harness.read_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
        assert (harness.HERE / "traffic" / f"{mix['driver']}.py").is_file()
        limits = harness.read_json(harness.HERE / "workloads" / f"{cell['name']}.json")["limits"]
        assert limits and all(v > 0 for v in limits.values())
    assert sum(c["chips"] == 4 for c in m["workloads"]) <= max(1, len(m["workloads"]) // 4)


def test_metrics(m):
    e2e = {x["name"] for x in m["end_to_end"]}
    cells = {c["name"] for c in m["workloads"]}
    assert "setup_s" in e2e and len(m["end_to_end"]) <= 16 and len(m["per_layer"]) <= 128
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(x["layer"]) and x["moves"] in e2e
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.fullmatch(x["unit"]) and x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= cells
        assert (harness.HERE / "metrics" / f"{x['name']}.py").is_file()
        if "_roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move(m):
    for cell in (c["name"] for c in m["workloads"]):
        e2e, layers = reports(m, cell, "end_to_end"), reports(m, cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for x in m["per_layer"]:
            if x["name"] in layers:
                assert x["moves"] in e2e, (cell, x["name"])
