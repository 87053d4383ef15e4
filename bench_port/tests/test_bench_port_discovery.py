"""The harness finds a configuration, a traffic mix, limits and a metric
reader that are added as new files, by the names in the manifest, with no
edit to a file that is there."""

import json
import types

from bench_port import core


def write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj) if not isinstance(obj, str) else obj)


def test_new_files_are_found_by_name(tmp_path):
    manifest = core.read_json(core.MANIFEST)
    manifest["configs"].append({"name": "new-config", "source": "https://example.org",
                                "file": "bench_port/configs/new-config.json",
                                "reduced": [], "why": "added"})
    manifest["workloads"].append({"name": "new-cell", "config": "new-config",
                                  "traffic": "new-mix", "chips": 1, "why": "added"})
    manifest["end_to_end"].append({"name": "new_rate", "unit": "items/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["new-cell"]})
    manifest["per_layer"] += [
        {"name": "new_share.x", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "new layer", "moves": "new_rate", "workloads": ["new-cell"]},
        {"name": "silent.x", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "new layer", "moves": "new_rate", "workloads": ["new-cell"]}]
    write(tmp_path / "configs" / "new-config.json", {"name": "new-config", "width": 8})
    write(tmp_path / "mixes" / "new-mix.json", {"runner": "training", "batch": 3})
    write(tmp_path / "limits" / "new-cell.json", {"gap": 0.5})
    write(tmp_path / "metrics" / "new_share.x.py",
          "def read(ctx):\n    return 100.0 * ctx.hits / ctx.tries\n")
    write(tmp_path / "metrics" / "silent.x.py", "def read(ctx):\n    return None\n")

    cell, config, mix, limits, metrics = core.find_cell("new-cell", manifest, bench=tmp_path)
    assert (cell["traffic"], config["width"], mix["batch"], limits) == (
        "new-mix", 8, 3, {"gap": 0.5})
    assert sorted(m["name"] for m in metrics["end_to_end"]) == ["new_rate", "setup_s"]
    assert [m["name"] for m in metrics["per_layer"]] == ["new_share.x", "silent.x"]
    got = core.read_metrics(metrics["per_layer"], types.SimpleNamespace(hits=3, tries=4),
                            bench=tmp_path)
    # a reader that finds nothing leaves its metric out of the line
    assert got == {"new_share.x": {"value": 75.0, "unit": "%"}}


def test_the_committed_cells_report_their_metrics():
    manifest = core.read_json(core.MANIFEST)
    for w in manifest["workloads"]:
        got = core.cell_metrics(manifest, w["name"])
        for m in got["per_layer"]:
            assert w["name"] in m["workloads"]
