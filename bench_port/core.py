"""What every cell shares: the manifest and the files it names, seeds, the
device's description, the check that no JAX module was loaded, and the
result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. The harness finds, by name:

* ``bench_port/configs/<config>.json``, the configuration as it is run;
* ``bench_port/mixes/<traffic>.json``, the traffic mix, whose ``runner``
  names the module of ``bench_port`` that runs it (``training``);
* ``bench_port/limits/<workload>.json``, the limits of ``correct``;
* ``bench_port/metrics/<metric>.py``, one reader per per-layer metric.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mmdyn_tpu")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(name, manifest=None, bench=BENCH):
    """(cell, configuration, mix, limits, metrics) of the workload ``name``,
    the files found under ``bench``: ``metrics`` are the manifest's
    end-to-end and per-layer entries that this cell reports."""
    manifest = read_json(MANIFEST) if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}: {sorted(cells)}")
    cell = cells[name]
    config = read_json(Path(bench) / "configs" / f"{cell['config']}.json")
    mix = read_json(Path(bench) / "mixes" / f"{cell['traffic']}.json")
    limits = read_json(Path(bench) / "limits" / f"{name}.json")
    return cell, config, mix, limits, cell_metrics(manifest, name)


def runner(mix):
    """The ``run`` function of the module that the mix names."""
    return importlib.import_module(f"bench_port.{mix['runner']}").run


def cell_metrics(manifest, name):
    """The end-to-end and per-layer metrics that the cell ``name`` reports:
    those without a ``workloads`` key, and those that list it; a per-layer
    metric without the key goes with the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m
                                                   and m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def load_reader(metric, bench=BENCH):
    """The ``read(ctx)`` function of ``<bench>/metrics/<metric>.py``."""
    path = Path(bench) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, ctx, bench=BENCH):
    """{name: {"value", "unit"}} of the per-layer ``entries`` whose reader
    finds something to read; a reader returns None where it finds nothing."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], bench)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def seed_words(seed, stream):
    """A 63-bit seed for ``stream`` of a run seeded with ``seed`` (any whole
    number, negative or past 32 bits), independent of every other stream."""
    seq = np.random.SeedSequence([abs(int(seed)), int(seed < 0), int(stream)])
    return int(seq.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def median(values):
    return statistics.median(values) if values else math.nan


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN_MODULES``,
    compared whole (``mmdyn_tpu_torch`` is not ``mmdyn_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def device_info(torch, count=1):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def finish(result, checks):
    """Print the comparisons (each number beside its limit) as the last lines
    of standard error, then the result line as the last line of standard
    output, ``checks`` its last key. Refuses (exit 3, no result) when a JAX
    module has been loaded."""
    found = forbidden_modules()
    if found:
        print(f"loaded modules that the benchmark may not load: {found}", file=sys.stderr)
        sys.exit(3)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
