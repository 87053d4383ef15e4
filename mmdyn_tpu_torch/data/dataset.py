"""Train / test splits of a compiled corpus and their loaders (port of
``mmdyn_tpu/data/dataset.py``; reference mmdyn/pytorch/utils/datasets.py:
20-108). Frames stay uint8 on the host and become float32 / 255 on the
device (``data/loader.py::to_device_batch``)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from mmdyn_tpu_torch.data.compile import compiled_name_for, load_packed
from mmdyn_tpu_torch.data.loader import BatchLoader


class VisuoTactileArrays:
    """Train or test split view over the compiled arrays.

    The split is the reference's (datasets.py:100-108): the first 80% train,
    ``[frac:-1]`` test, so the test split drops the corpus's last sequence.
    """

    def __init__(self, dataset_path, train=True, crop=True):
        root = Path(os.path.expanduser(str(dataset_path)))
        arrays = load_packed(root / compiled_name_for(crop))
        self.seq_length = int(arrays.pop("seq_length"))
        self.has_shock = bool(arrays.pop("has_shock", False))
        self.crop = bool(arrays.pop("crop", True))
        # the min-max normalisation constants, recorded in norms.json
        self.norms = {k: np.asarray(arrays.pop(k)).tolist()
                      for k in ("pose_min", "pose_max", "shock_min", "shock_max")
                      if k in arrays}
        n = arrays["visual"].shape[0]
        frac_index = int(0.8 * n)
        sl = slice(0, frac_index) if train else slice(frac_index, n - 1)
        self.arrays = {k: v[sl] for k, v in arrays.items()}

    def __len__(self):
        return self.arrays["visual"].shape[0]

    @property
    def shock_dim(self):
        """condition_dim probe (problems.py:675-681): the shock's width, else
        that of the last per-frame field."""
        if "shock" in self.arrays:
            return int(self.arrays["shock"].shape[-1])
        return int(self.arrays["avail"].shape[-1])


def process_grid():
    """(index, count) of this process: ``torch.distributed``'s rank and world
    size when it is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def dataset_setup(dataset_path, problem_type, batchsize=128, seed=0, mask_loss=True,
                  crop=True):
    """Train / test splits and their loaders (datasets.py:20-66).

    Both loaders drop the last incomplete batch; only the train loader
    shuffles, with ``seed``. seq_modeling and regression read only frame 0 of each sequence
    (problems.py:648), so their loaders gather one frame; the seg masks are
    skipped unless the loss is masked. Under ``torch.distributed`` every
    process walks the same seeded global order and gathers its own row block.
    """
    print(f"Loading dataset from {dataset_path}" + ("" if crop else " (no-crop variant)"))
    train_dataset = VisuoTactileArrays(dataset_path, train=True, crop=crop)
    test_dataset = VisuoTactileArrays(dataset_path, train=False, crop=crop)
    frames = 1 if problem_type in ("seq_modeling", "regression") else None
    skip = () if mask_loss else ("seg",)
    pidx, pcnt = process_grid()
    proc = dict(process_index=pidx, process_count=pcnt) if pcnt > 1 else {}
    loader = lambda ds, shuffle: BatchLoader(  # noqa: E731
        ds.arrays, batchsize, shuffle=shuffle, seed=seed, frames=frames, skip=skip, **proc)
    return {
        "train_dataset": train_dataset,
        "test_dataset": test_dataset,
        "train_loader": loader(train_dataset, True),
        "test_loader": loader(test_dataset, False),
        "seq_length": train_dataset.seq_length,
    }
