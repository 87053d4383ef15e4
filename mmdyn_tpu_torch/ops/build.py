"""Build and load the hand-written CUDA kernels under ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
All sources compile in parallel (one ``nvcc`` each, started together) at the
first call that needs a kernel, never at import. A library's file name carries
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. The build directory ``ops/_build`` is git-ignored.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("poe_reparam", "bce_sum", "conv_wgrad", "bn_swish", "conv_dgrad", "conv_fprop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once; returns
    the wall seconds spent. Raises with nvcc's output on a failed build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    if name == "poe_reparam":
        lib.poe_reparam_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i64, f32, ptr]
        lib.poe_reparam_f32.restype = i32
    elif name == "bce_sum":
        for fn in (lib.bce_sum_num_partials, lib.bce_sum_bf16_num_partials):
            fn.argtypes = [i64]
            fn.restype = i32
        for fn in (lib.bce_sum_f32, lib.bce_sum_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i64, ptr]
            fn.restype = i32
    elif name == "conv_wgrad":
        lib.conv_wgrad_f32_splits.argtypes = [i32, i32, i64]
        lib.conv_wgrad_f32_splits.restype = i32
        lib.conv_wgrad_f32.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 10 + [ptr]
        lib.conv_wgrad_f32.restype = i32
    elif name == "conv_dgrad":
        lib.conv_dgrad_f32_workspace.argtypes = [i32] * 5
        lib.conv_dgrad_f32_workspace.restype = i32
        lib.conv_dgrad_f32.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
        lib.conv_dgrad_f32.restype = i32
    elif name == "conv_fprop":
        lib.conv_fprop_f32_workspace.argtypes = [i32, i32]
        lib.conv_fprop_f32_workspace.restype = i64
        lib.conv_fprop_f32.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
        lib.conv_fprop_f32.restype = i32
    elif name == "bn_swish":
        lib.bn_swish_pieces.argtypes = [i32, i32]
        lib.bn_swish_pieces.restype = i32
        lib.bn_swish_forward.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        lib.bn_swish_forward.restype = i32
        lib.bn_swish_backward.argtypes = [ptr] * 11 + [i32] * 4 + [ptr]
        lib.bn_swish_backward.restype = i32
    else:
        raise ValueError(f"unknown kernel library {name!r}")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
