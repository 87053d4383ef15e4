#!/usr/bin/env python3
"""Build the port's ``bce_sum.cu`` beside another tree's and time both in
one process on one NVIDIA Hopper card.

    python3 tools/bce_bf16_bench.py [--baseline OTHER/bce_sum.cu]

Builds the repository's ``mmdyn_tpu_torch/ops/csrc/bce_sum.cu`` (``committed``)
and, with ``--baseline``, another source with the same C interface (an older
tree's ``bce_sum.cu``) with ``build.NVCC_FLAGS``. For each library:

* both entry points against ``kernels.bce_sum_plain`` at K=4, B=512 and
  B=2048, P=12288, masked and not (rel 1e-5, bit-identical reruns);
* the mean device ms of 20 launches (``chip_smoke.Timer``: L2 flushed before
  each launch) at each of those shapes, the libraries timed in turn and then
  in reverse order, both readings printed;
* from ``cuobjdump -sass`` of the library, each pass-1 kernel's instruction
  count and the instruction count of each of its loops (a backward branch and
  the code it jumps back over), with the SASS and nvcc's output (built with
  ``-Xptxas -v``: registers and spills) written to ``chiprun_out/sass``.

Prints the card's name and power limit. Needs nvcc and a CUDA device.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import Timer, bound, card_line  # noqa: E402
from mmdyn_tpu_torch.ops import build, kernels  # noqa: E402

SHAPES = {"main": (4, 512, 64 * 64 * 3), "dyn": (4, 2048, 64 * 64 * 3)}
SASS_DIR = REPO / "chiprun_out" / "sass"


def build_libraries(sources, out_dir, log_dir):
    """{name: source} -> {name: loaded library}; one nvcc each, all started
    together, each one's output written to ``log_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    log_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name, src in sources.items():
        lib = out_dir / f"libbce_{name}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (log_dir / f"{name}.nvcc.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        if hasattr(libs[name], "bce_sum_bf16_num_partials"):
            build._declare("bce_sum", libs[name])
        else:
            _declare_old(libs[name])
    return libs


def _declare_old(lib):
    """An older library: one partial count for both element types."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bce_sum_num_partials.argtypes = [i64]
    lib.bce_sum_num_partials.restype = i32
    lib.bce_sum_bf16_num_partials = lib.bce_sum_num_partials
    for fn in (lib.bce_sum_f32, lib.bce_sum_bf16):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i64, ptr]
        fn.restype = i32


def launcher(lib, x, z, m):
    """A callable launching ``lib``'s entry for x's dtype; scratch made once."""
    bf16 = x.dtype == torch.bfloat16
    row = z.numel()
    n = (lib.bce_sum_bf16_num_partials if bf16 else lib.bce_sum_num_partials)(row)
    scratch = torch.empty(n + 1, device=x.device)
    fn = lib.bce_sum_bf16 if bf16 else lib.bce_sum_f32
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        build.check(fn(x.data_ptr(), z.data_ptr(), None if m is None else m.data_ptr(),
                       scratch.data_ptr(), scratch[n:].data_ptr(), x.shape[0], row, stream),
                    "bce_sum launch")
        return scratch[n]
    return run


def sass_report(lib_path, sass_dir, name):
    """{kernel: (instructions, [loop sizes])} of the pass-1 kernels."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    sass_dir.mkdir(parents=True, exist_ok=True)
    (sass_dir / f"{name}.sass").write_text(text)
    report = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        fname = block.split("\n", 1)[0].strip()
        if "bce_partial" not in fname:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, op in ins:
            hit = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if hit and int(hit.group(1), 16) <= addr:
                target = int(hit.group(1), 16)
                loops.append(sum(1 for a, _ in ins if target <= a <= addr))
        body = [op for _, op in ins if not op.strip().startswith("NOP")]
        report[fname] = (len(body), loops)
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another tree's bce_sum.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bce_bf16_bench: no CUDA device", file=sys.stderr)
        return 1

    sources = {"baseline": args.baseline} if args.baseline else {}
    sources["committed"] = build.CSRC / "bce_sum.cu"
    out_dir = build.BUILD_DIR / "bench"
    libs = build_libraries(sources, out_dir, SASS_DIR)
    print(card_line(), flush=True)

    for name in libs:
        for fname, (n, loops) in sass_report(out_dir / f"libbce_{name}.so",
                                             SASS_DIR, name).items():
            print(f"[sass] {name}: {fname[:90]}: {n} instructions, loops {loops}")

    dev = torch.device("cuda")
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for shape, (k, b, p) in SHAPES.items():
        x32 = torch.randn((k, b, p), generator=g, device=dev) * 3
        z = torch.rand((b, p), generator=g, device=dev)
        mask = (torch.rand((b, p), generator=g, device=dev) > 0.3).float()
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            nbytes = x.numel() * x.element_size() + z.numel() * 4 + 4
            for m in (None, mask):
                case = (f"{shape} {str(dtype).removeprefix('torch.')}"
                        f"{' masked' if m is not None else ''}")
                want = float(kernels.bce_sum_plain(x, z, m))
                runs = {name: launcher(lib, x, z, m) for name, lib in libs.items()}
                for name, run in runs.items():
                    got, again = run().clone(), run().clone()
                    rel = abs(float(got) - want) / abs(want)
                    if not torch.equal(got, again) or rel > 1e-5:
                        raise AssertionError(f"{name} {case}: {float(got)!r}, rerun "
                                             f"{float(again)!r}, plain {want!r}")
                    results.setdefault(case, {})[name] = {"rel_err": rel, "ms": []}
                order = list(runs)
                for names in (order, order[::-1]):
                    for name in names:
                        results[case][name]["ms"].append(timer(runs[name]))
                bound_ms, _ = bound(nbytes + (0 if m is None else z.numel() * 4), 0)
                print(f"[time] {case} (bound {bound_ms:.4f} ms): " + "; ".join(
                    f"{name} {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms "
                    f"({bound_ms / min(r['ms']):.0%}), rel err {r['rel_err']:.2g}"
                    for name, r in results[case].items()), flush=True)
        del x32, x, z, mask
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
