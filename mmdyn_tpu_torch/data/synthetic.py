"""Synthetic data (port of ``mmdyn_tpu/data/synthetic.py``), two levels:

* ``make_synthetic_dumps`` writes a tree shaped like the simulator's output
  (``visual_*`` / ``tactile_*`` / ``seg_*`` PNGs and a ``data.json`` per
  sequence, mmdyn/tact_sim/examples/demo.py:92-113) from an analytic
  falling-box scene, so the whole compile path runs without a simulator;
* ``make_compiled_arrays`` writes a compiled corpus directly: random uint8
  frames and uniform poses.

Both write the JAX package's bytes for the same arguments and seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.data.compile import save_packed_dir


def _render_scene(t_frac, size, rng_obj):
    """The analytic scene at normalised time ``t_frac`` in [0, 1]: a coloured
    box falls toward the sensor plane and comes to rest; the tactile image
    darkens where the box touches. Returns (visual, tactile, seg) uint8 of
    shape (H, W, 3), (H, W, 3), (H, W)."""
    h, w = size
    cx, cy, half, color = rng_obj
    # the box descends: its centre from 20% to 65% of the height
    oy = int(h * (0.2 + 0.45 * min(t_frac * 1.6, 1.0)))
    ox = int(w * cx)
    half = int(half * min(h, w))

    visual = np.full((h, w, 3), 40, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    box = (np.abs(yy - oy) < half) & (np.abs(xx - ox) < half)
    visual[box] = color

    tactile = np.full((h, w, 3), (178, 178, 204), np.uint8)
    contact_strength = max(0.0, t_frac * 1.6 - 0.6)
    if contact_strength > 0:
        r = half * min(contact_strength * 2, 1.0)
        blob = ((yy - int(h * 0.6)) ** 2 + (xx - ox) ** 2) < r ** 2
        tactile[blob] = (np.asarray((120, 60, 60), np.float64)
                         * min(1.0, 0.5 + contact_strength)).astype(np.uint8)

    seg = np.where(box, 200, 1).astype(np.uint8)
    return visual, tactile, seg


def make_synthetic_dumps(out_dir, n_sequences=6, seq_length=10,
                         image_size=(120, 160), with_shock=False, seed=0):
    """Write simulator-dump-shaped PNG / JSON trees under ``out_dir/dataset``;
    returns that directory."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(out_dir) / "dataset"
    for s in range(n_sequences):
        seq_dir = root / "synset0" / f"obj{s:03d}" / f"sequence_{s:04d}"
        seq_dir.mkdir(parents=True, exist_ok=True)
        scene = (rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7),
                 rng.uniform(0.08, 0.2),
                 rng.integers(60, 255, size=3, dtype=np.int64).tolist())
        data = {"time_step": [], "time": [], "position": [], "orientation": []}
        if with_shock:
            data["shock"] = []
        z0, z_rest = 1.3, 0.55
        for t in range(seq_length):
            frac = t / max(seq_length - 1, 1)
            visual, tactile, seg = _render_scene(frac, image_size, scene)
            Image.fromarray(visual).save(seq_dir / f"visual_{t:04d}.png")
            Image.fromarray(tactile).save(seq_dir / f"tactile_{t:04d}.png")
            Image.fromarray(seg).save(seq_dir / f"seg_{t:04d}.png")
            z = z0 + (z_rest - z0) * min(frac * 1.6, 1.0)
            data["time_step"].append(t * 10)
            data["time"].append(t * 10 / 240.0)
            data["position"].append([scene[0] - 0.5, scene[1] - 0.5, z])
            data["orientation"].append([0.0, 0.0, float(np.sin(frac)), float(np.cos(frac))])
            if with_shock:
                data["shock"].append([float(rng.normal(0, 1))])
        with open(seq_dir / "data.json", "w") as f:
            json.dump(data, f)
    return root


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
