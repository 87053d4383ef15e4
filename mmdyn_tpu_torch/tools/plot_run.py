"""Render a training run's ELBO curves from its ``metrics.jsonl`` (port of
``tools/plot_run.py``).

    python -m mmdyn_tpu_torch.tools.plot_run --run <logdir> --out run.png

Reads the ``MetricWriter`` JSONL (train and validation epoch losses and
frames/s) and writes a two-series line chart and, beside it, a summary JSON
(the same keys, rounding and bytes as the JAX tool's): ``epochs``,
``train_first`` / ``train_last`` / ``train_min``, ``monotone_after_warmup``
(every epoch from the fourth within 2% of the one before), ``val_*`` when
the validation loss is not all zero, and ``median_frames_per_sec``. The
chart keeps the JAX tool's styling: categorical slots 1 / 2 (blue #2a78d6,
orange #eb6834), 2 px lines, a recessive grid, direct labels and a legend,
text in ink tokens. It runs on the host alone; matplotlib is imported when
the chart is drawn, and where it is not installed the tool writes the
summary alone and says so. ``main(argv)`` returns the summary.
"""

import argparse
import importlib.util
import json
from collections import defaultdict
from pathlib import Path

SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
SERIES = {"train": "#2a78d6", "validation": "#eb6834"}


def load_metrics(run_dir):
    """{tag: values in step order} of a run's scalar records."""
    path = Path(run_dir)
    jsonl = path / "tensorboard" / "metrics.jsonl"
    if not jsonl.exists():
        jsonl = path / "metrics.jsonl"
    series = defaultdict(dict)
    with open(jsonl) as f:
        for line in f:
            rec = json.loads(line)
            if "value" in rec:
                series[rec["tag"]][rec["step"]] = rec["value"]
    return {k: [v[s] for s in sorted(v)] for k, v in series.items()}


def summarize(m):
    """The summary of ``load_metrics``' series (train epochs required)."""
    train = m.get("Loss/train_epoch", [])
    val = m.get("Loss/validation_epoch", [])
    if val and not any(val):
        val = []          # an empty test loader (batch > split): no curve
    summary = {
        "epochs": len(train),
        "train_first": round(train[0], 2), "train_last": round(train[-1], 2),
        "train_min": round(min(train), 2),
        "monotone_after_warmup": all(b <= a * 1.02 for a, b in zip(train[3:], train[4:])),
    }
    if val:
        summary.update({"val_first": round(val[0], 2), "val_last": round(val[-1], 2),
                        "val_min": round(min(val), 2)})
    fps = m.get("Perf/frames_per_sec")
    if fps:
        summary["median_frames_per_sec"] = round(sorted(fps)[len(fps) // 2], 1)
    return summary


def plot(train, val, title, out):
    """The two-series chart of the epoch losses, written to ``out``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = list(range(len(train)))
    both = bool(val) and len(val) == len(train)
    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=144)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)
    ax.plot(epochs, train, color=SERIES["train"], lw=2, label="train")
    if both:
        ax.plot(epochs, val, color=SERIES["validation"], lw=2, label="validation")
    # direct labels at the line ends (selective, not every point)
    ax.annotate(f"train {train[-1]:,.0f}", (epochs[-1], train[-1]), xytext=(6, 0),
                textcoords="offset points", color=INK, fontsize=9, va="center")
    if both:
        ax.annotate(f"val {val[-1]:,.0f}", (epochs[-1], val[-1]), xytext=(6, -12),
                    textcoords="offset points", color=INK, fontsize=9, va="center")
    ax.set_title(title, color=INK, fontsize=11, loc="left")
    ax.set_xlabel("epoch", color=INK_2, fontsize=9)
    ax.set_ylabel("ELBO loss (sum / batch)", color=INK_2, fontsize=9)
    ax.tick_params(colors=INK_2, labelsize=8)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#d8d7d2")
    ax.grid(True, color="#e8e7e2", lw=0.6)
    ax.set_axisbelow(True)
    ax.margins(x=0.02)
    ax.legend(frameon=False, fontsize=9, labelcolor=INK)
    fig.tight_layout()
    fig.savefig(out, facecolor=SURFACE, bbox_inches="tight")
    plt.close(fig)


def build_parser():
    ap = argparse.ArgumentParser(description="Plot a run's ELBO curves")
    ap.add_argument("--run", required=True, help="run directory (its metrics.jsonl)")
    ap.add_argument("--out", required=True, help="the chart's path; the summary "
                    "JSON is written beside it")
    ap.add_argument("--title", default="cnn-mvae seq_modeling, reference defaults "
                    "(latent 256, batch 128, KL-anneal 50)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    m = load_metrics(args.run)
    train = m.get("Loss/train_epoch", [])
    if not train:
        raise ValueError(f"no Loss/train_epoch records in {args.run}")
    summary = summarize(m)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: the summary only, no chart")
    else:
        val = m.get("Loss/validation_epoch", [])
        plot(train, val if any(val) else [], args.title, out)
        print(f"wrote {out}")
    out.with_suffix(".json").write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
