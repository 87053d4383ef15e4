"""Device -> host wire packing: run-length encoding on the device (port of
``mmdyn_tpu/utils/wire.py``).

The rendered frames are run-length friendly (flat backgrounds, clipped
depth, masked segmentation), so the dump path ships them as a run-length
encoding computed on the device:

    v0..v3[r]  - the run value's byte planes (a packed 24-bit RGB pixel and
                 a byte folded into the fourth)
    lengths[r] - the run length as uint16 (forced breaks every ``row_len``
                 elements bound every run below 2^16)

``planes`` + 2 bytes per run on the wire. The host decodes with
``np.repeat(vals, lengths)``. A whole chunk of frames, all of its streams,
is encoded as one stream, so a transfer is one scalar readback (the run
count) and one download. A stream that run-length encoding would grow
(noise) crosses raw instead (``RunLengthWire.get_raw``).

Streams are int32 tensors holding the uint32 bits of the JAX package's
streams: PyTorch has few uint32 operations on the card, and the byte
extraction ``(v >> 8p) & 0xFF`` is the same for a negative int32. The host
sees the JAX package's uint32 arrays and payload bit for bit.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def pack_rgb(img):
    """(..., H, W, 3) uint8 tensor -> (..., H*W) int32 pixel stream
    (r | g << 8 | b << 16)."""
    u = img.to(torch.int32)
    pix = u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
    return pix.reshape(*img.shape[:-3], -1)


def unpack_rgb(pix, h, w):
    """Inverse of pack_rgb (host numpy; int32 bits cast to uint32 unchanged)."""
    pix = np.asarray(pix, np.uint32)
    out = np.empty(pix.shape + (3,), np.uint8)
    out[..., 0] = pix & 0xFF
    out[..., 1] = (pix >> 8) & 0xFF
    out[..., 2] = (pix >> 16) & 0xFF
    return out.reshape(*pix.shape[:-1], h, w, 3)


def _encode(flat, row_len, planes):
    """Run-length encoding of a (M,) int32 stream with forced breaks every
    ``row_len`` elements: ``planes`` uint8 value planes, int16 lengths (the
    uint16 bits) and the run count, all on the stream's device; only the
    first n_runs entries of each are meaningful. The run starts are
    compacted by one sort of the indices, the non-starts mapped to the
    sentinel m (``mmdyn_tpu/utils/wire.py::_encode``), so nothing waits for
    the device."""
    m = flat.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=flat.device)
    prev = torch.cat([flat[:1], flat[:-1]])
    b = (flat != prev) | ((idx % row_len) == 0)
    n_runs = b.sum()
    # sorting yields [start_0 .. start_{r-1}, m, m, ...]
    starts = torch.sort(torch.where(b, idx, m)).values
    vals = torch.index_select(flat, 0, torch.clamp(starts, max=m - 1))
    # run r ends where run r+1 starts; the closing m ends the last run and
    # zeroes the tail (m - m)
    nxt = torch.cat([starts[1:], torch.full((1,), m, dtype=torch.int32, device=flat.device)])
    lengths = torch.clamp(nxt - starts, min=0).to(torch.int16)
    out = tuple(((vals >> (8 * p)) & 0xFF).to(torch.uint8) for p in range(planes))
    return out + (lengths, n_runs)


class RunLengthWire:
    """Device encode and sliced download of frame streams."""

    def encode(self, streams, row_len, planes=3):
        """Encode a list of (F, k*row_len) int32 tensors on one device
        (``planes`` significant bytes per element) as one stream with run
        breaks every ``row_len`` elements.

        Returns an opaque handle for :meth:`get`. The work is queued on the
        device; nothing is downloaded and nothing waits.
        """
        row_len = int(row_len)
        if not 0 < row_len < 65536:
            raise ValueError("row breaks must bound runs below 2^16")
        if not 1 <= planes <= 4:
            raise ValueError(f"planes must be 1..4, got {planes}")
        if any(s.dtype != torch.int32 for s in streams):
            raise TypeError("streams must be int32 tensors (the uint32 bits)")
        flat = torch.cat([s.reshape(-1) for s in streams])
        if flat.shape[0] % row_len:
            raise ValueError(f"stream length {flat.shape[0]} is not a multiple of {row_len}")
        out = _encode(flat, row_len, int(planes))
        return {"parts": out[:-1], "n_runs": out[-1], "planes": int(planes),
                "shapes": [tuple(s.shape) for s in streams], "streams": streams}

    def get_raw(self, handle):
        """Download the handle's wire payload without decoding.

        One scalar readback (the run count), then one download of the
        payload's first n_runs entries packed into one uint8 buffer; the raw
        streams instead when run-length encoding would move more bytes.
        Returns a host dict for :meth:`decode`: callers dispatch the next
        chunk's device work before they pay the host decode.
        """
        trace = os.environ.get("MMDYN_GEN_TRACE", "") not in ("", "0")
        t0 = time.perf_counter()
        m = sum(int(np.prod(s)) for s in handle["shapes"])
        n_runs = int(handle["n_runs"])
        t1 = time.perf_counter()
        planes = handle["planes"]
        if n_runs * (planes + 2) >= m * 4:
            # a pathological stream: raw is smaller
            return {"fallback": [s.cpu().numpy().view(np.uint32) for s in handle["streams"]],
                    "shapes": handle["shapes"]}
        *vals, lengths = handle["parts"]
        buf = torch.cat([lengths[:n_runs].view(torch.uint8)]
                        + [v[:n_runs] for v in vals]).cpu().numpy()
        if trace:
            print(f"# wire-trace: sync(encode)={t1 - t0:.2f}s "
                  f"dl[{buf.nbytes / 1e6:.1f}MB]={time.perf_counter() - t1:.2f}s "
                  f"runs={n_runs}", file=sys.stderr)
        raw = {"lengths": buf[:2 * n_runs].view(np.uint16)}
        raw.update({f"v{p}": buf[(2 + p) * n_runs:(3 + p) * n_runs] for p in range(planes)})
        raw.update(shapes=handle["shapes"], planes=planes)
        return raw

    @staticmethod
    def run_bounds(raw):
        """Per-stream [start, end) run-index ranges of a get_raw payload (row
        breaks align run boundaries with stream boundaries)."""
        ends = np.cumsum(raw["lengths"].astype(np.int64))
        offs = np.cumsum([0] + [int(np.prod(s)) for s in raw["shapes"]])
        marks = np.searchsorted(ends, offs[1:-1], side="right")
        return list(zip([0] + list(marks), list(marks) + [len(ends)]))

    @staticmethod
    def decode(raw):
        """get_raw payload -> list of host uint32 arrays with the original
        (F, k) stream shapes (the exact inverse of encode)."""
        if "fallback" in raw:
            return raw["fallback"]
        v = np.zeros(raw["v0"].shape[0], np.uint32)
        for p in range(raw["planes"]):
            v |= raw[f"v{p}"].astype(np.uint32) << (8 * p)
        flat = np.repeat(v, raw["lengths"])
        out, off = [], 0
        for shape in raw["shapes"]:
            k = int(np.prod(shape))
            out.append(flat[off:off + k].reshape(shape))
            off += k
        return out

    def get(self, handle):
        """Download and decode (see get_raw and decode)."""
        return self.decode(self.get_raw(handle))
