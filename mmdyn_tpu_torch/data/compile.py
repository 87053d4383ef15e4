"""The compiled corpus on disk (the reader part of
``mmdyn_tpu/data/compile.py``).

A compiled corpus is the packed per-sequence arrays of a dataset directory,
uint8 frames at the 64x64 training resolution, in one of two formats:

* an ``.npz`` archive, loaded into host memory;
* a packed directory of one raw ``.npy`` per key, memmapped, so a large
  corpus streams from disk.

Either sits at ``<dataset>/compiled_dataset_v2.npz`` (``_nocrop`` for the
variant compiled without the seg-bbox re-crop). Compiling simulator dumps
into a corpus is not ported yet: a missing corpus raises.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

COMPILED_NAME = "compiled_dataset_v2.npz"
NOCROP_NAME = "compiled_dataset_v2_nocrop.npz"


def compiled_name_for(crop=True):
    return COMPILED_NAME if crop else NOCROP_NAME


def save_packed_dir(out_dir, packed):
    """Write ``packed`` as one raw ``.npy`` per key. Writes a temporary
    sibling and renames it over the target, so an interrupted write never
    leaves a partial corpus and a rewrite never leaves stale keys."""
    out_dir = Path(out_dir)
    tmp_dir = out_dir.with_name(out_dir.name + ".tmp")
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    for k, v in packed.items():
        np.save(tmp_dir / f"{k}.npy", np.asarray(v))
    if out_dir.exists():
        shutil.rmtree(out_dir)
    tmp_dir.rename(out_dir)
    return out_dir


def load_packed(path):
    """A compiled corpus as a dict of arrays: an ``.npz`` file (in memory)
    or a packed directory (memmapped). Raises FileNotFoundError naming the
    path when there is none."""
    path = Path(path)
    if path.is_dir():
        return {f.stem: np.load(f, mmap_mode="r") for f in sorted(path.glob("*.npy"))}
    if not path.exists():
        raise FileNotFoundError(
            f"no compiled corpus at {path}: compiling simulator dumps into a "
            f"corpus is not ported to the PyTorch package yet; compile it with "
            f"the JAX package, or write a synthetic one with "
            f"mmdyn_tpu_torch.data.synthetic.make_compiled_arrays")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
