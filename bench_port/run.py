"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. Prints, as its last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, also printed as the last lines of standard error.

For measuring the benchmark itself, not used by its runs: ``--control
tf32|fp8`` puts the plain reference, computed at that precision, in the
program's place; ``--fault <name>`` breaks the timed path underneath
(``training.FAULTS``).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# this file's own directory would put the harness's modules before the
# standard library's on the path; the checkout's root holds both packages
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))
# CUDA's kernel cache (CUDA_CACHE_PATH) at a fixed place inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / ".bench_port_cache" / "nv"))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    p.add_argument("--control", default=None, choices=("tf32", "fp8"))
    p.add_argument("--fault", default=None)
    return p


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from bench_port import core

    cell, config, mix, limits, metrics = core.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, checks = core.runner(mix)(args, cell, config, mix, limits, metrics, T_START,
                                      fault=args.fault, control=args.control)
    print(f"card: {card_line()}", file=sys.stderr)
    core.finish(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
