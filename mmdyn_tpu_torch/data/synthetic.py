"""A synthetic compiled corpus (the port's copy of
``mmdyn_tpu/data/synthetic.py::make_compiled_arrays``): random uint8 frames
and uniform poses from a seed, the same arrays as the JAX package's for the
same arguments."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.data.compile import save_packed_dir


def make_compiled_arrays(out_path, n_sequences=16, seq_length=8, image_size=64,
                         with_shock=False, seed=0, packed_dir=False):
    """Write a compiled corpus at ``out_path``: a compressed ``.npz``, or with
    ``packed_dir`` a directory of uncompressed ``.npy`` files (compressing
    random bytes is slow and saves nothing at a full corpus's size)."""
    rng = np.random.default_rng(seed)
    n, t, s = n_sequences, seq_length, image_size
    imgs = lambda *sh: rng.integers(0, 256, size=sh, dtype=np.int64).astype(np.uint8)  # noqa: E731
    packed = {
        "visual": imgs(n, t, s, s, 3),
        "tactile": imgs(n, t, s, s, 3),
        "pose": rng.uniform(0, 1, size=(n, t, 7)).astype(np.float32),
        "avail": np.ones((n, t, 2), np.float32),
        "seg": (rng.uniform(size=(n, t, s, s, 3)) > 0.5).astype(np.uint8) * 255,
        "final_visual": imgs(n, s, s, 3),
        "final_tactile": imgs(n, s, s, 3),
        "final_pose": rng.uniform(0, 1, size=(n, 7)).astype(np.float32),
        "seq_length": np.int64(t),
        "has_shock": np.bool_(with_shock),
        "pose_min": np.zeros(7, np.float32),
        "pose_max": np.ones(7, np.float32),
    }
    if with_shock:
        packed["shock"] = rng.uniform(0, 1, size=(n, t, 1)).astype(np.float32)
        packed["shock_min"] = np.zeros(1, np.float32)
        packed["shock_max"] = np.ones(1, np.float32)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if packed_dir:
        return save_packed_dir(out_path, packed)
    np.savez_compressed(out_path, **packed)
    return out_path
