"""The compiled corpus on disk (the reader part of
``mmdyn_tpu/data/compile.py``).

A compiled corpus is the packed per-sequence arrays of a dataset directory,
uint8 frames at the 64x64 training resolution, in one of two formats:

* an ``.npz`` archive, loaded into host memory;
* a packed directory of one raw ``.npy`` per key, memmapped, so a large
  corpus streams from disk.

Either sits at ``<dataset>/compiled_dataset_v2.npz`` (``_nocrop`` for the
variant compiled without the seg-bbox re-crop). Compiling simulator dumps
into a corpus is not ported yet: a missing corpus raises. The compile's
three image helpers are here (``_bounding_box``, ``_load_image``,
``_to_train_res``): serving prepares frames with them, as the compile does. They
import Pillow when called, so importing this module needs none.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.config import COMPILE_SIZE, IMAGE_SIZE

COMPILED_NAME = "compiled_dataset_v2.npz"
NOCROP_NAME = "compiled_dataset_v2_nocrop.npz"


def compiled_name_for(crop=True):
    return COMPILED_NAME if crop else NOCROP_NAME


def _bounding_box(img):
    """Square-expanded bbox of the max-valued seg region (datasets.py:347-366)."""
    mask = np.where(img == np.max(img))
    ymin, ymax = np.min(mask[0]), np.max(mask[0])
    xmin, xmax = np.min(mask[1]), np.max(mask[1])
    height = ymax - ymin
    width = xmax - xmin
    diff = height - width
    if diff > 0:
        xmin = max(0, xmin - diff / 2)
        xmax = min(img.shape[1], xmax + diff / 2)
    elif diff < 0:
        ymin = max(0, ymin - abs(diff) / 2)
        ymax = min(img.shape[0], ymax + abs(diff) / 2)
    return xmin, ymin, xmax, ymax


def _load_image(img_path, bounding_box=None, resize=True):
    """PIL load + crop + 256x256 resize + 3-channel cast (datasets.py:318-345)."""
    from PIL import Image

    img = Image.open(img_path)
    if bounding_box is not None:
        img = img.crop(bounding_box)
    if resize:
        img = img.resize((COMPILE_SIZE, COMPILE_SIZE))
    np_img = np.array(img).copy()
    if np_img.ndim == 2:
        np_img = np.repeat(np_img[:, :, np.newaxis], 3, axis=2).astype(np.uint8)
    img.close()
    return np_img


def _to_train_res(np_img):
    """256x256 -> 64x64 bilinear, the train-time torchvision Resize
    (datasets.py:23-26 uses PIL-backed bilinear)."""
    from PIL import Image

    img = Image.fromarray(np_img[:, :, :3])
    img = img.resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR)
    return np.array(img, dtype=np.uint8)


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
