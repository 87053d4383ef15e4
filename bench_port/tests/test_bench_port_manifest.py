"""``BENCHMARK.json`` against the benchmark's contract: its keys, names and
units, the files it names, and what each cell reports."""

import json
import math
import re

import pytest

from bench_port import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# reduced may never name a width
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts_per|width|size")


@pytest.fixture(scope="module")
def manifest():
    raw = core.MANIFEST.read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (core.ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w.split("/")
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells(manifest):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_file_is_found(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert c["file"] == f"bench_port/configs/{c['name']}.json"
        assert (core.ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert core.read_json(core.ROOT / c["file"])["name"] == c["name"]
    for w in manifest["workloads"]:
        cell, config, mix, limits, metrics = core.find_cell(w["name"], manifest)
        assert callable(core.runner(mix)) and limits
        for m in metrics["per_layer"]:
            assert callable(core.load_reader(m["name"]))


def test_each_cell_reports_setup_another_metric_and_a_layer(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        got = core.cell_metrics(manifest, w)
        names = {m["name"] for m in got["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert got["per_layer"]
        for m in got["per_layer"]:
            assert m["moves"] in e2e and m["moves"] in names


def test_one_layer_name_per_layer(manifest):
    """Metrics of one module share its layer name letter for letter."""
    by_prefix = {}
    for m in manifest["per_layer"]:
        by_prefix.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_limits_are_numbers(manifest):
    for w in manifest["workloads"]:
        limits = core.find_cell(w["name"], manifest)[3]
        assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
                   for v in limits.values())
