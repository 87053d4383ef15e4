"""The readings that the limits of ``correct`` are set from: a cell's runs on
many seeds, the program's numbers and the control's (the plain reference at
the next precision below the configuration's, in the program's place), in
one process, so that set-up's imports are paid once.

    python bench_port/readings.py --workload <name> --seeds 1,2,3 [--seconds 1]
        [--control fp8] [--fault half_batch]

Prints one JSON line per seed: the numbers compared and the details behind
them (each step's loss gap; the leaf gaps' median and worst leaves). Not
run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default=1.0, type=float)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    import torch

    from bench_port import core

    cell, config, mix, limits, metrics = core.find_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        ns = types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        result, checks = core.runner(mix)(ns, cell, config, mix, limits, metrics, t0, fault=args.fault,
                             control=args.control)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault, "correct": result["correct"],
                          "values": {k: c["value"] for k, c in checks.items()},
                          "readings": result.get("readings"),
                          "metrics": result["metrics"], "seconds": time.monotonic() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
