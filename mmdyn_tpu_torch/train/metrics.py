"""Metric and image logging (port of ``mmdyn_tpu/train/metrics.py``):
``metrics.jsonl`` always, TensorBoard when ``torch.utils.tensorboard``
imports and the run asks for it. Both TensorBoard and matplotlib (figures,
for ``--vis-pose`` only) are imported only when used."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


def _scalarize(v):
    """TensorBoard hparams take bool / int / float / str; the rest as str."""
    return v if isinstance(v, (bool, int, float, str)) else str(v)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile (N, H, W, C) images into one (H', W', C) panel, as
    torchvision.utils.make_grid does."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrows = -(-n // nrow)
    grid = np.full((nrows * (h + padding) + padding, nrow * (w + padding) + padding, c),
                   pad_value, dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


class NullWriter:
    """``MetricWriter``'s interface, logging nothing: the writer of a rank
    other than 0."""

    tensorboard = False

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class MetricWriter:
    """Scalars and text to ``metrics.jsonl``; scalars, images, figures,
    histograms and hparams to TensorBoard when it is on and imports."""

    def __init__(self, log_dir, tensorboard=True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(self.log_dir))
            except ImportError:
                print("TensorBoard is not installed: logging to metrics.jsonl only")

    @property
    def tensorboard(self) -> bool:
        return self._tb is not None

    def _write(self, rec):
        self._jsonl.write(json.dumps(rec) + "\n")

    def scalar(self, tag, value, step):
        self._write({"tag": tag, "value": float(value), "step": int(step),
                     "time": time.time()})
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def image(self, tag, image_hwc, step):
        """Log one (H, W, C) float image in [0, 1]."""
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(image_hwc).transpose(2, 0, 1), int(step))

    def image_grid(self, tag, images_nhwc, step, nrow=8):
        """Log (N, H, W, C) float images in [0, 1] as one panel."""
        if self._tb is not None:
            self.image(tag, make_grid(np.asarray(images_nhwc), nrow=nrow), step)

    def text(self, tag, message, step=0):
        self._write({"tag": tag, "text": str(message), "step": int(step),
                     "time": time.time()})
        if self._tb is not None:
            self._tb.add_text(tag, str(message), int(step))

    def figure(self, tag, fig, step):
        """Log a matplotlib figure (reference add_figure, problems.py:607)."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, int(step))
        else:
            import matplotlib.pyplot as plt
            plt.close(fig)

    def histogram(self, tag, values, step):
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), int(step))

    def hparams(self, params: dict, metrics: dict):
        """End-of-run hyperparameters and final metrics (problems.py:208)."""
        rec = {"tag": "hparams", "params": {k: _scalarize(v) for k, v in params.items()},
               "metrics": {k: float(v) for k, v in metrics.items()}, "time": time.time()}
        self._write(rec)
        if self._tb is not None:
            self._tb.add_hparams(rec["params"], rec["metrics"], run_name=".")

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
