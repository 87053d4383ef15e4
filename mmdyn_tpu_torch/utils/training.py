"""Terminal progress bar + pickle IO (a copy of ``mmdyn_tpu/utils/training.py``,
itself a port of mmdyn/pytorch/utils/training.py).

The reference shells out to ``stty size`` at import time (training.py:7),
which crashes in any non-TTY context; here the terminal width is probed
safely with a fallback.
"""

from __future__ import annotations

import pickle
import shutil
import sys
import time

TOTAL_BAR_LENGTH = 40.0
_last_time = time.time()
_begin_time = _last_time


def _term_width():
    return shutil.get_terminal_size(fallback=(80, 24)).columns


def progress_bar(current, total, msg=None):
    """In-place progress bar with per-step and total timing
    (training.py:15-56)."""
    global _last_time, _begin_time
    if current == 0:
        _begin_time = time.time()

    term_width = _term_width()
    cur_len = int(TOTAL_BAR_LENGTH * current / total)
    rest_len = int(TOTAL_BAR_LENGTH - cur_len) - 1

    sys.stdout.write(" [" + "=" * cur_len + ">" + "." * rest_len + "]")

    cur_time = time.time()
    step_time = cur_time - _last_time
    _last_time = cur_time
    tot_time = cur_time - _begin_time

    parts = [f"  Step: {format_time(step_time)}",
             f" | Tot: {format_time(tot_time)}"]
    if msg:
        parts.append(" | " + msg)
    text = "".join(parts)
    sys.stdout.write(text)
    sys.stdout.write(" " * max(0, term_width - int(TOTAL_BAR_LENGTH) - len(text) - 3))
    sys.stdout.write("\b" * max(0, term_width - int(TOTAL_BAR_LENGTH / 2) + 2))
    sys.stdout.write(f" {current}/{total} ")
    sys.stdout.write("\r" if current < total else "\n")
    sys.stdout.flush()


def format_time(seconds):
    """Compact 2-field duration formatting (training.py:59-89)."""
    days = int(seconds / 3600 / 24)
    seconds -= days * 3600 * 24
    hours = int(seconds / 3600)
    seconds -= hours * 3600
    minutes = int(seconds / 60)
    seconds -= minutes * 60
    secondsf = int(seconds)
    millis = int((seconds - secondsf) * 1000)

    out, i = "", 1
    for value, suffix in ((days, "D"), (hours, "h"), (minutes, "m"),
                          (secondsf, "s"), (millis, "ms")):
        if value > 0 and i <= 2:
            out += f"{value}{suffix}"
            i += 1
    return out or "0ms"


def save_pkl(data, filename):
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def load_pkl(filename):
    with open(filename, "rb") as f:
        return pickle.load(f)
