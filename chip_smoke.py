#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``mmdyn_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py              # from the repository root

Phases, any failure raises and exits non-zero:

1. torch version; TF32 off for cuDNN convolutions and for matmuls, so that
   float32 means float32 in every comparison below, and bf16 matmuls summed
   in float32 (``utils/device.py::set_reference_precision``, as the CLI).
2. Build the CUDA kernels from ``mmdyn_tpu_torch/ops/csrc`` with nvcc.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the seq flagship (batch 512) and of dyn_modeling (256 x 8 = 2048 rows)
   and at small, ragged and offset shapes: PoE with both subset tables,
   every M in 1..4 with K = 7 and K = 1, B * D % 4 in {1, 2, 3}, an input off
   16-byte alignment and batch 2048 (rtol 1e-5, atol 1e-6); BCE with and
   without mask at K=4, B=512 and B=2048, P=12288, and ragged (rel 1e-5, and
   bit-identical across two launches). Kernel, plain-version and
   library-call times (CUDA events, L2 flushed before every launch) beside
   the byte / operation bound of the H100 SXM (3.35 TB/s, 67 TFLOP/s f32),
   and the timer's floor: one launch of a one-float ``zero_()``. The bf16
   BCE kernel (bf16 logits, f32 target and mask) the same way, masked and
   not (rel 1e-5, bit-identical reruns), at the main and dyn shapes (timed,
   beside the f32 kernel's readings; its library call
   ``F.binary_cross_entropy_with_logits`` on the upcast logits), and on the
   inputs of its scalar-load path (K=3, B=3, P=7; B=5, P=12287; logits one
   element off 16-byte alignment, timed) and adversarial values (|x| up to
   90, exact zeros, a fully masked row).
4. Train steps on the card against the same steps on the CPU (same weights,
   no dropout, loss rel 1e-4 over two steps): the seq flagship at batch 32;
   dyn_modeling at 8 x 4 with ``mask_loss`` (the masked BCE kernel inside a
   step); the conditional MVAE with a 3-wide shock; cnn-vae seq_modeling
   visual; mlp-vae reconstruction tactile; the conditional regressor. The
   MVAEs run noise-free; the VAEs' reparameterisation noise is pinned to one
   CPU-drawn tensor on both devices for the check's duration. Then the seq
   flagship at batch 32 under ``bfloat16`` and ``bfloat16_full`` (loss rel
   1e-4, as in float32), the BCE launches taking the bf16 instantiation
   under ``bfloat16_full``; and one card step of it under each policy with
   the biases set to 0, every conv / Linear output bf16-representable under
   the bf16 policies and none under ``float32`` (the losses of float32 and
   ``bfloat16`` differ by about the card-vs-CPU gap, so only this shows that
   the card rounds).
5. The paths, each through ``setup_model`` / ``make_optimizer`` /
   ``make_train_step`` on one repeated synthetic batch, with the kernel
   counters set to 0 just before and read just after; losses finite and
   falling:
   (a) the seq flagship: cnn-mvae, visuotactile + pose, seq_modeling,
       latent 256, float32, batch 512; 5 steps, 1 PoE and 2 BCE launches
       each; 3 more under torch.profiler (the top 40 kernels and the port's
       own kernels whatever their rank, and the device's busy share);
   (b) dyn_modeling, the same model at 256 sequences x 8 frames (2048 rows
       per step): 1 warm-up and 4 timed steps, 1 PoE and 2 BCE launches
       each, then 2 profiled steps (the top 25 kernels and the port's own);
   (c) cnn-vae, visual, seq_modeling, batch 1024: 5 steps, no kernel
       launch (its loss has no kernel in the JAX package either);
   (d) the seq flagship under ``bfloat16_full`` (``bench.py``'s policy):
       5 steps and 3 profiled, 2 BCE launches a step on bf16 logits;
   (e) dyn_modeling 256 x 8 under ``bfloat16_full``: 5 steps and 2 profiled;
   ms/step and frames/s of each (frames: B rows per step, B * T for dyn);
   (f) the training CLI in process (``cli.main.main``): a 2,600-sequence x
       2-frame corpus written once by the port's ``make_compiled_arrays``
       (packed directory) into a temporary directory; cnn-mvae visuotactile
       + pose seq_modeling, batch 512, ``--dtype auto`` (float32), 2 epochs
       of 4 steps and 1 validation batch; the loop's frames/s beside (a)'s.
       Then: one train step run twice from the same state and a second
       uninterrupted run (is the card step run-to-run deterministic with
       torch's default cuDNN algorithms?). Then, with cuDNN's deterministic
       algorithms for these runs only: an uninterrupted run, whose step
       must rerun bit for bit; a 1-epoch run, whose ``latest`` checkpoint
       restored into a fresh state must equal its state bit for bit
       (parameters, Adam's moments and step counts, the generator); and that
       run continued with ``--resume`` to 2, whose parameters must equal the
       uninterrupted ones bit for bit. Then ``cli.evaluate.main`` on the run
       when Pillow imports.
   (g) serving (``mmdyn_tpu_torch.serve``) of (f)'s first run, no kernel
       launch (the JAX session has no kernel on this path either), no
       Pillow: ``InferenceSession.from_run`` on the card against the same
       run on the CPU at batch 32 (probabilities atol 1e-4; mu, logvar and
       pose max gap over max |cpu| 1e-4; uint8 images at most 1 apart on at
       most 0.1% of pixels); ``predict(uint8_images=True)`` eager and as the
       ``aot_predict`` CUDA graph at batches 1, 8, 64, 256 and 1024, round
       trip (host arrays to host arrays) and pipelined (device inputs, one
       synchronise), the graph equal to eager bit for bit; a parity
       session's graph with live dropout; ``rollout`` of 16 steps at batch
       64; ``freeze_bn`` on 256 rows, a row served alone (padded to 64)
       equal to the same row inside a batch of 64 bit for bit;
       ``export_session`` / ``load_exported`` at batch 64 (atol 1e-5); the
       HTTP server on port 0 (/healthz, /predict at batch 1 and 64 timed,
       /rollout, /sample, and 8 concurrent clients through the micro-batcher
       on the frozen session, equal to their solo replies bit for bit); and
       ``cli.infer --export``.
   (h) compiling simulator dumps into a corpus, where Pillow imports (the
       dumps are PNGs): ``make_synthetic_dumps`` writes 32 sequences x 10
       frames at the simulator's 480 x 640; ``compile_dataset`` with the PIL
       and the native engine (``native/ingest.cpp`` built by g++ into
       ``mmdyn_tpu_torch/data/_build/``; g++'s error is printed and fails the
       path if it does not build), uint8 keys within 1 and the others equal,
       frames/s of each; then ``cli.main`` on two copies of the dump
       directory without a corpus: it compiles 31 sequences (strict parity)
       and 32 (``--no-strict-parity``) and trains cnn-mvae seq_modeling at
       batch 4 for 1 epoch on the card, 1 PoE and 2 BCE launches per forward
       (6 train steps and 1 validation batch per run).
   (i) data generation at full width, on exp_1's scene (``make_sensor``'s
       sensor and a box dropped from (0, 0, 1.5); no Pillow): the rollout of
       ``SimulatorTorch``, 500 steps from seeded drop orientations, at
       exp_1's batch of 10 trials (one object's ``--trial_per_obj``) and at
       1024 trials (a many-trials reading), ms per rollout and trials/s, and
       a profiled 100-step rollout at each (the device's busy share); card
       vs the same module on the CPU for 8 trials
       (max |d pos| <= 1e-4, max |d force| <= 1e-4 of the largest force) and
       vs the host ``AnalyticBackend`` for 2 (test_physics_jax.py's bounds).
       Then the frames of 8 trials x 50 snapshots (every 10th step), 400 at
       640 x 480 in chunks of 128: ``RaycastTorch.render_frames_packed`` and
       ``TactileRendererTorch.render_frames`` on the card, frames/s over
       three timed passes after a warm chunk of 128, the download of the
       uint8 payloads, peak GiB; one chunk against the CPU
       (seg mismatch <= 1e-3, depth gap <= 1e-5 where seg agrees, rgb and
       tactile bytes more than 1 apart <= 1e-4 each) and rerun bit for bit;
       one chunk profiled (device time by kernel family). No kernel of the
       port launches.
6. A ``kernels`` JSON line, the card's name and power limit from nvidia-smi,
   and last the result line.

Without a CUDA device the script prints no result and exits 1.
"""

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 64 << 20       # more than the 50 MB L2
POE_REPLACES = "mmdyn_tpu/ops/kernels.py:110"   # _poe_reparam_pallas -> _poe_kernel
BCE_REPLACES = "mmdyn_tpu/ops/kernels.py:247"   # _bce_pallas -> _bce_kernel(_nomask)
PORT_KERNELS = ("poe_reparam", "bce_partial", "bce_final")   # device kernel names
CONV_KERNELS = ("fprop", "dgrad", "wgrad", "fft", "conv", "cgemm")   # by kernel name


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class Timer:
    """Mean device ms of a callable over ``reps`` launches, each between two
    CUDA events after an L2 flush (the main path's 100 MB of logits would not
    fit in L2 either).

    * The flush reads a buffer larger than L2: a write would leave dirty
      lines whose write-back the timed launch would pay for.
    * A device-side sleep queued first keeps the device busy while the host
      enqueues every launch, so no event pair spans device idle time spent
      waiting for the wrapper's host code.
    """

    def __init__(self, device):
        self.flush = torch.ones(L2_FLUSH_BYTES // 4, device=device)
        self.flush.sum()                  # load the reduction kernel now

    def __call__(self, fn, reps=20):
        fn()                              # warm-up: lazy module loading stalls the host
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)    # ~100 ms at the H100's clocks
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for _ in range(reps):
            self.flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        if slept.query():
            raise RuntimeError("the host fell behind the device: timing invalid")
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(bytes_moved, flops):
    """(ms, 'bytes' or 'operations'): the larger of the two floor times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_batch(b, seed=0, seq_len=2, shock=0, random_seg=False):
    """The bench.py synthetic batch: uniform images and pose, NHWC, an
    all-ones ``seg``. ``shock`` adds a (b, seq_len, shock) uniform condition;
    ``random_seg`` makes ``seg`` a random 0/1 loss mask."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    batch = {
        "visual": f(b, seq_len, 64, 64, 3), "tactile": f(b, seq_len, 64, 64, 3),
        "pose": f(b, seq_len, 7), "avail": np.ones((b, seq_len, 2), np.float32),
        "final_visual": f(b, 64, 64, 3), "final_tactile": f(b, 64, 64, 3),
        "final_pose": f(b, 7), "seg": np.ones((b, seq_len, 64, 64, 3), np.float32),
    }
    if shock:
        batch["shock"] = f(b, seq_len, shock)
    if random_seg:
        batch["seg"] = (f(b, seq_len, 64, 64, 3) > 0.2).astype(np.float32)
    return batch


def subset_mask(k, m, seed):
    """A (K, M) 0/1 mask whose every row holds expert 0, as the prior expert
    is in every subset of the model's tables."""
    rows = np.random.default_rng(seed).integers(0, 2, size=(k, m))
    rows[:, 0] = 1
    return rows.tolist()


def poe_inputs(g, dev, mask, b, d, offset=False):
    """mu, logvar (M, B, D) and noise (K, B, D); ``offset`` puts each one
    float past a fresh allocation: contiguous, but off 16-byte alignment."""
    k, m = mask.shape

    def planes(count):
        flat = torch.randn(count * b * d + int(offset), generator=g, device=dev)
        return flat[int(offset):].view(count, b, d)

    return planes(m), planes(m), planes(k)


def check_poe(kernels, recon, timer, dev, b=512, d=256):
    g = torch.Generator(device=dev).manual_seed(1)
    pose = recon.SUBSETS_POSE
    cases = [("no_pose", recon.SUBSETS_NO_POSE, b, d, False),
             ("pose", pose, b, d, False),
             ("ragged", [r[1:3] for r in pose[3:5]], 3, 5, False)]
    cases += [(f"M={m} K={k}", subset_mask(k, m, 10 * m + k), 64, d, False)
              for m in range(1, 5) for k in (7, 1)]
    cases += [(f"n%4={(bb * 257) % 4}", pose, bb, 257, False) for bb in (513, 514, 515)]
    cases += [("misaligned", pose, b, d, True), ("B=2048", pose, 4 * b, d, False)]
    worst, entry = 0.0, None
    for name, rows, bb, dd, offset in cases:
        mask = torch.tensor(rows, dtype=torch.float32, device=dev)
        k, m = mask.shape
        mu, lv, noise = poe_inputs(g, dev, mask, bb, dd, offset)
        if offset and mu.data_ptr() % 16 == 0:
            raise AssertionError("the misaligned case is aligned")
        got = kernels._poe_reparam_cuda(mu, lv, mask, noise)
        want = kernels.poe_reparam_plain(mu, lv, mask, noise)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            worst = max(worst, float((x - y).abs().max()))
        if name in ("pose", "B=2048"):
            n = bb * dd
            bytes_moved = (2 * m + k) * n * 4 + 3 * k * n * 4 + mask.numel() * 4
            # per element: M x (exp, 2 add, div, mul); per subset: 2M fma,
            # div, div, add, log, mul, exp, fma
            bound_ms, bound_by = bound(bytes_moved, n * (5 * m + k * (4 * m + 8)))
            timed = {"shape": f"M={m} K={k} B={bb} D={dd}",
                     "ms": timer(lambda: kernels._poe_reparam_cuda(mu, lv, mask, noise)),
                     "plain_ms": timer(lambda: kernels.poe_reparam_plain(mu, lv, mask, noise)),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "bytes": bytes_moved}
            if name == "pose":
                entry = {"name": "poe_reparam", "route": "cuda",
                         "source": "mmdyn_tpu_torch/ops/csrc/poe_reparam.cu",
                         "replaces": POE_REPLACES, **timed}
            else:
                dyn = timed
    entry["max_abs_err"] = worst
    entry["dyn"] = dyn                   # the dyn_modeling shape: B*T = 2048 rows
    say(f"[3/6] poe_reparam ok ({', '.join(c[0] for c in cases)}): max |kernel - "
        f"plain| {worst:.3g}; {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({entry['bytes'] / 1e6:.2f} MB); dyn {dyn['shape']}: {dyn['ms']:.4f} ms "
        f"vs plain {dyn['plain_ms']:.4f} ms, bound {dyn['bound_ms']:.4f} ms "
        f"({dyn['bytes'] / 1e6:.2f} MB)")
    return entry


def check_bce(kernels, timer, dev, k=4, b=512, p=64 * 64 * 3, dyn_rows=2048):
    """The kernel against its plain version, masked and not, at the seq
    flagship's shape, the dyn_modeling shape (25.2 M columns, 402.7 MB of
    logits: far more columns than the 1,024 x 256 threads of its grid) and a
    ragged one; timed at the first two, unmasked as on the main paths."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(2)
    worst_rel, timed = 0.0, {}
    for name, kk, bb, pp in (("main", k, b, p), ("dyn", k, dyn_rows, p),
                             ("ragged", 3, 3, 7)):
        x = torch.randn((kk, bb, pp), generator=g, device=dev) * 3
        z = torch.rand((bb, pp), generator=g, device=dev)
        mask = (torch.rand((bb, pp), generator=g, device=dev) > 0.3).float()
        for m in (None, mask):
            got = kernels._bce_sum_cuda(x, z, m)
            again = kernels._bce_sum_cuda(x, z, m)
            if not torch.equal(got, again):
                raise AssertionError(f"bce_sum {name} differs between two launches: "
                                     f"{float(got)!r} vs {float(again)!r}")
            want = kernels.bce_sum_plain(x, z, m)
            rel = abs(float(got) - float(want)) / abs(float(want))
            if rel > 1e-5:
                raise AssertionError(f"bce_sum {name} mask={m is not None}: "
                                     f"{float(got)!r} vs plain {float(want)!r}")
            worst_rel = max(worst_rel, rel)
            if name != "ragged" and m is None:
                bytes_moved = (x.numel() + z.numel()) * 4 + 4
                # per logit: max, mul, sub, abs, exp, log1p, 2 add
                bound_ms, bound_by = bound(bytes_moved, 8 * x.numel())
                timed[name] = {
                    "shape": f"K={kk} B={bb} P={pp}",
                    "max_abs_err": abs(float(got) - float(want)),
                    "ms": timer(lambda: kernels._bce_sum_cuda(x, z, None)),
                    "plain_ms": timer(lambda: kernels.bce_sum_plain(x, z, None)),
                    "library_ms": timer(lambda: F.binary_cross_entropy_with_logits(
                        x, z.expand_as(x), reduction="sum")),
                    "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved}
        if name != "ragged":
            timed[name]["masked_ms"] = timer(lambda: kernels._bce_sum_cuda(x, z, mask))
        del x, z, mask
    entry = {"name": "bce_sum", "route": "cuda",
             "source": "mmdyn_tpu_torch/ops/csrc/bce_sum.cu",
             "replaces": BCE_REPLACES, **timed["main"], "dyn": timed["dyn"]}
    say(f"[3/6] bce_sum ok (main, dyn, ragged; mask and none; bit-identical reruns): "
        f"max rel err {worst_rel:.3g}" + "".join(
            f"; {t['shape']}: {t['ms']:.4f} ms (masked {t['masked_ms']:.4f}) vs plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bytes'] / 1e6:.1f} MB)" for t in timed.values()))
    return entry


def bf16_cases(g, dev, k, b, p, dyn_rows):
    """(name, logits, target, mask) of the bf16 check: the main and dyn
    shapes; shapes and views that take the scalar-load path (K=3, B=3, P=7;
    a row that is not a multiple of 8; logits one element off 16-byte
    alignment); and adversarial values on the 16-byte path: |x| up to 90 (exp
    underflows), exact zeros, 0/1 targets, a fully masked row."""
    def normal(kk, bb, pp, offset=0):
        flat = torch.randn(kk * bb * pp + offset, generator=g, device=dev) * 3
        x = flat.to(torch.bfloat16)[offset:].view(kk, bb, pp)
        z = torch.rand((bb, pp), generator=g, device=dev)
        mask = (torch.rand((bb, pp), generator=g, device=dev) > 0.3).float()
        return x, z, mask

    yield ("main", *normal(k, b, p))
    yield ("dyn", *normal(k, dyn_rows, p))
    yield ("ragged", *normal(3, 3, 7))
    yield ("row%8=3", *normal(k, 5, p - 1))
    x, z, mask = normal(k, b, p, offset=1)
    if x.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned case is aligned")
    yield ("misaligned", x, z, mask)
    bb = 16
    u = lambda *s: torch.rand(s, generator=g, device=dev)  # noqa: E731
    x = (u(k, bb, p) * 180 - 90) * (u(k, bb, p) > 0.2)       # 20% exact zeros
    z = torch.where(u(bb, p) > 0.5, (u(bb, p) > 0.5).float(), u(bb, p))
    mask = (u(bb, p) > 0.3).float()
    mask[0] = 0.0                                            # a fully masked row
    yield ("adversarial", x.to(torch.bfloat16), z, mask)


def check_bce_bf16(kernels, timer, dev, f32, k=4, b=512, p=64 * 64 * 3, dyn_rows=2048):
    """The bf16-logit kernel against the plain version on the same bf16
    logits (f32 target and mask), masked and not, on every case of
    ``bf16_cases``, with bit-identical reruns; timed unmasked at the main and
    dyn shapes, as ``bfloat16_full`` runs it, beside its byte bound, the
    library call on the upcast logits and the f32 kernel's readings
    (``f32``: ``check_bce``'s entry)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(3)
    worst_rel, timed = 0.0, {}
    names = []
    for name, x, z, mask in bf16_cases(g, dev, k, b, p, dyn_rows):
        names.append(name)
        vector = z.numel() % 8 == 0 and x.data_ptr() % 16 == 0
        if vector != (name in ("main", "dyn", "adversarial")):
            raise AssertionError(f"bce_sum bf16 {name}: 16-byte path {vector}")
        for m in (None, mask):
            got = kernels._bce_sum_cuda(x, z, m)
            again = kernels._bce_sum_cuda(x, z, m)
            if not torch.equal(got, again):
                raise AssertionError(f"bce_sum bf16 {name} differs between two launches: "
                                     f"{float(got)!r} vs {float(again)!r}")
            want = kernels.bce_sum_plain(x, z, m)
            rel = abs(float(got) - float(want)) / abs(float(want))
            if rel > 1e-5:
                raise AssertionError(f"bce_sum bf16 {name} mask={m is not None}: "
                                     f"{float(got)!r} vs plain {float(want)!r}")
            worst_rel = max(worst_rel, rel)
            if name in ("main", "dyn") and m is None:
                bytes_moved = x.numel() * 2 + z.numel() * 4 + 4
                bound_ms, bound_by = bound(bytes_moved, 8 * x.numel())
                timed[name] = {
                    "shape": f"K={x.shape[0]} B={x.shape[1]} P={x.shape[2]} bf16",
                    "max_abs_err": abs(float(got) - float(want)),
                    "ms": timer(lambda: kernels._bce_sum_cuda(x, z, None)),
                    "plain_ms": timer(lambda: kernels.bce_sum_plain(x, z, None)),
                    "library_ms": timer(lambda: F.binary_cross_entropy_with_logits(
                        x.float(), z.expand_as(x), reduction="sum")),
                    "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
                    "masked_ms": timer(lambda: kernels._bce_sum_cuda(x, z, mask)),
                    "masked_bound_ms": bound(bytes_moved + z.numel() * 4, 0)[0]}
            if name == "misaligned" and m is None:
                scalar_ms = timer(lambda: kernels._bce_sum_cuda(x, z, None))
        del x, z, mask
    f32s = {"main": f32, "dyn": f32["dyn"]}
    say(f"[3/6] bce_sum bf16 logits ok ({', '.join(names)}; mask and none; bit-identical "
        f"reruns): max rel err {worst_rel:.3g}" + "".join(
            f"; {t['shape']}: {t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.0%} of bound "
            f"{t['bound_ms']:.4f} ms, {t['bytes'] / 1e6:.1f} MB), masked "
            f"{t['masked_ms']:.4f} ms ({t['masked_bound_ms'] / t['masked_ms']:.0%}) vs plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms; f32 logits "
            f"{f32s[n]['ms']:.4f} ms, masked {f32s[n]['masked_ms']:.4f} ms"
            for n, t in timed.items())
        + f"; the scalar-load path on the misaligned main shape {scalar_ms:.4f} ms")
    return {"name": "bce_sum_bf16", "route": "cuda",
            "source": "mmdyn_tpu_torch/ops/csrc/bce_sum.cu", "replaces": BCE_REPLACES,
            **timed["main"], "dyn": timed["dyn"],
            "misaligned_ms": scalar_ms}


def reset_counters(kernels):
    kernels.fused_poe_reparam.launches = 0
    kernels.fused_masked_bce_sum.launches = 0
    kernels.fused_masked_bce_sum.launches_bf16 = 0


def read_counters(kernels):
    return {"poe_reparam": kernels.fused_poe_reparam.launches,
            "bce_sum": kernels.fused_masked_bce_sum.launches,
            "bce_sum_bf16": kernels.fused_masked_bce_sum.launches_bf16}


def train_state(cfg, device, seed=0, **overrides):
    from mmdyn_tpu_torch.models import model_kwargs, setup_model
    from mmdyn_tpu_torch.problems import make_optimizer
    from mmdyn_tpu_torch.train import create_train_state, make_train_step

    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device=device,
                        seed=seed, **model_kwargs(cfg), **overrides)
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    return state, make_train_step(cfg, device=device)


@contextlib.contextmanager
def pinned_vae_noise():
    """Inside the block the port's VAE reparameterises with noise drawn on
    the CPU from one seed, the same on every device: the CUDA and CPU
    generators draw different numbers."""
    from mmdyn_tpu_torch.models import vae

    def reparametrize(generator, mu, logvar):
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(11))
        return eps.to(mu.device) * torch.exp(0.5 * logvar) + mu

    real, vae.reparametrize = vae.reparametrize, reparametrize
    try:
        yield
    finally:
        vae.reparametrize = real


def check_card_vs_cpu(kernels, cfg, b, seq_len=2, shock=0, launches=(0, 0), steps=2,
                      rel=1e-4):
    """Two train steps on the card and on the CPU from the same weights,
    batch and policy, no dropout: the losses agree to ``rel``, and each card
    step launched (PoE, BCE) = ``launches`` kernels, the BCE ones on bf16
    logits under ``bfloat16_full``."""
    cfg = dataclasses.replace(cfg, batchsize=b, noise_free=cfg.is_mvae)
    batch = synthetic_batch(b, seed=3, seq_len=seq_len, shock=shock,
                            random_seg=cfg.mask_loss)
    losses = {}
    with pinned_vae_noise():
        for dev in ("cuda", "cpu"):
            state, step = train_state(cfg, dev, dropout_rate=0.0)
            gen = torch.Generator(device=dev).manual_seed(0)
            reset_counters(kernels)
            losses[dev] = [float(step(state, batch, gen, 1.0)[1]["loss"])
                           for _ in range(steps)]
            if dev == "cuda":
                got = read_counters(kernels)
                bf16 = launches[1] if cfg.compute_dtype == "bfloat16_full" else 0
                if got != dict(zip(got, (steps * n for n in launches + (bf16,)))):
                    raise AssertionError(f"{cfg.model_name} {cfg.problem_type} "
                                         f"{cfg.compute_dtype}: launches {got} over "
                                         f"{steps} steps")
    gaps = [abs(a - c) / abs(c) for a, c in zip(losses["cuda"], losses["cpu"])]
    for i, (a, c) in enumerate(zip(losses["cuda"], losses["cpu"])):
        if not math.isclose(a, c, rel_tol=rel):
            raise AssertionError(f"{cfg.model_name} {cfg.problem_type} "
                                 f"{cfg.compute_dtype} step {i}: card loss {a!r} vs cpu {c!r}")
    rows = b * seq_len if cfg.problem_type == "dyn_modeling" else b
    say(f"[4/6] {cfg.model_name} {cfg.problem_type} {cfg.input_type}"
        f"{' +pose' if cfg.use_pose and cfg.is_mvae else ''}"
        f"{f' cond S={shock}' if cfg.conditional else ''}"
        f"{' mask' if cfg.mask_loss else ''} {cfg.compute_dtype}, {rows} rows: card "
        f"matches cpu over {steps} steps (rel {rel:g}; gap {max(gaps):.3g}), (PoE, BCE) "
        f"launches per step {launches}: card {losses['cuda']} cpu {losses['cpu']}")


def check_bf16_rounding(cfg, b=32):
    """One card train step of ``cfg`` at batch ``b`` under each policy, every
    bias set to 0, each Linear / Conv2d / ConvTranspose2d output read by a
    forward hook. With no bias to add, a product rounded to bf16 is
    bf16-representable whatever dtype carries it: under ``bfloat16`` every
    output must be float32 holding bf16 values, under ``bfloat16_full`` bf16,
    and under ``float32`` none may be. So a policy that silently ran float32
    fails here, which the losses cannot show: the float32 and ``bfloat16``
    losses of the card-vs-CPU checks differ by about those checks'
    card-vs-CPU gap."""
    batch = synthetic_batch(b, seed=4)
    read = {}
    for policy in ("float32", "bfloat16", "bfloat16_full"):
        state, step = train_state(dataclasses.replace(
            cfg, batchsize=b, compute_dtype=policy, noise_free=True), "cuda", dropout_rate=0.0)
        layers = [m for m in state.model.modules() if isinstance(
            m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        outputs = []

        def hook(module, args, out):
            out = out.detach()
            outputs.append((out.dtype, torch.equal(out, out.to(torch.bfloat16).to(out.dtype))))

        with torch.no_grad():
            for m in layers:
                if m.bias is not None:
                    m.bias.zero_()
        for m in layers:
            m.register_forward_hook(hook)
        step(state, batch, torch.Generator(device="cuda").manual_seed(0), 1.0)
        read[policy] = (sum(r for _, r in outputs), len(outputs),
                        sorted({str(d).removeprefix("torch.") for d, _ in outputs}))
    want = {"float32": (0, ["float32"]), "bfloat16": (None, ["float32"]),
            "bfloat16_full": (None, ["bfloat16"])}
    for policy, (rounded, n, dtypes) in read.items():
        must_round, must_dtypes = want[policy]
        if n < 10 or dtypes != must_dtypes or rounded != (n if must_round is None else 0):
            raise AssertionError(f"bf16 rounding under {policy}: {rounded} of {n} layer "
                                 f"outputs bf16-representable, dtypes {dtypes}")
    say(f"[4/6] bf16 rounding, seq flagship batch {b}, biases 0: layer outputs "
        f"bf16-representable / hooked (dtype): " + "; ".join(
            f"{p} {r}/{n} ({', '.join(d)})" for p, (r, n, d) in read.items()))


def run_path(label, cfg, kernels, card, per_step, seq_len=2, steps=5, profile_steps=0,
             top=40):
    """One path on the card: ``steps`` train steps on one synthetic batch
    (the first also warms up, the others are timed), the kernel counters set
    to 0 just before and read just after and held to ``per_step`` launches
    per step, losses finite and falling; then ``profile_steps`` profiled
    steps. Returns the path's summary for the result lines."""
    state, step = train_state(cfg, None)              # the card, by default
    dev = next(state.model.parameters()).device
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg.batchsize, seq_len=seq_len).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    kl = torch.tensor(1.0, device=dev)
    reset_counters(kernels)
    losses = [step(state, batch, gen, kl)[1]["loss"]]  # step 1 also warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(step(state, batch, gen, kl)[1]["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    launches = read_counters(kernels)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite and falling: {losses}")
    want = {name: n * steps for name, n in per_step.items()}
    want["bce_sum_bf16"] = want["bce_sum"] if cfg.compute_dtype == "bfloat16_full" else 0
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} over {steps} "
                             f"steps, expected {want}")
    dyn = cfg.problem_type == "dyn_modeling"
    frames = cfg.batchsize * (seq_len if dyn else 1)
    say(f"[5/6] {label}: {cfg.model_name} {cfg.input_type}"
        f"{'+pose' if cfg.use_pose and cfg.is_mvae else ''} {cfg.problem_type} "
        f"latent {cfg.latent_size} {cfg.compute_dtype}, batch {cfg.batchsize}"
        f"{f' x {seq_len}' if dyn else ''}: {step_s * 1e3:.3f} ms/step, "
        f"{frames / step_s:.1f} frames/s on {card}; losses {losses}; launches "
        f"{launches} over {steps} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = {"step_ms": step_s * 1e3, "frames_per_s": frames / step_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    if profile_steps:
        out.update(profile(step, state, batch, gen, kl, steps=profile_steps, top=top))
    del state, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def kernel_family(name):
    for key, family in (("Cat", "cat"), ("copy", "copy / cast"), ("reduce", "reduce"),
                        ("index", "index"), ("elementwise", "elementwise")):
        if key in name:
            return family
    return "other"


def dev_us(event):
    """A profiler event's own device time in us (the attribute's name
    differs across torch versions)."""
    return getattr(event, "self_device_time_total", None) or \
        getattr(event, "self_cuda_time_total", 0)


def device_profile(fn, label, calls=1, top=12):
    """``fn`` once under torch.profiler, where it makes ``calls`` calls of
    the work named by ``label``: wall time, the device's busy share, device
    time by kernel family and the top kernels per call. Returns the readings
    and the device events, heaviest first."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profile shows no device time")
    families = {}
    for e in events:
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + dev_us(e) / 1e3
    shares = {f: ms / busy_ms for f, ms in sorted(families.items(), key=lambda x: -x[1])}
    launches = sum(e.count for e in events)
    say(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.1%}), {launches} kernel launches; device time by family "
        + ", ".join(f"{f} {s:.1%}" for f, s in shares.items())
        + f"; top kernels{' per call' if calls > 1 else ''}:")
    for e in events[:top]:
        say(f"  {dev_us(e) / 1e3 / calls:10.4f} ms {e.count // calls:6d}x  {e.key[:130]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "launches": launches, "family_shares": shares}, events


def profile(step, state, batch, gen, kl, steps=3, top=40):
    """``device_profile`` over a few train steps, plus the convolutions'
    share of device time and the port's own kernels per step."""
    def run():
        for _ in range(steps):
            step(state, batch, gen, kl)

    prof, events = device_profile(run, f"{steps} train steps", calls=steps, top=top)
    busy_ms = prof["busy_ms"]
    conv_ms = sum(dev_us(e) for e in events
                  if any(c in e.key.lower() for c in CONV_KERNELS)) / 1e3
    say(f"[profile] convolution kernels by name {conv_ms:.3f} ms "
        f"({conv_ms / busy_ms:.1%} of busy)")
    # the port's own kernels, whatever their rank (L2 as the step leaves it)
    ours = [e for e in events if any(k in e.key for k in PORT_KERNELS)]
    if not ours:
        raise AssertionError(f"the profile shows none of {PORT_KERNELS}")
    say("[profile] the port's kernels per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / steps:.4f} ms in {e.count // steps}x "
        f"({dev_us(e) / e.count:.2f} us each)" for e in ours))
    return {"busy_share": prof["busy_share"], "conv_share": conv_ms / busy_ms}


@torch.no_grad()
def param_diffs(a, b):
    """|a - b| per parameter of two models of one architecture, by name."""
    return {name: float((p - q).abs().max())
            for (name, p), q in zip(a.named_parameters(), b.parameters())}


def max_param_diff(a, b):
    """The largest |a - b| over the parameters of two models."""
    return max(param_diffs(a, b).values())


def step_rerun_diff(problem):
    """One train step of ``problem`` run twice from the same model, optimizer
    and generator state on the same batch: the largest parameter difference
    between the two results (0.0 if the card step is deterministic) and the
    names of the parameters that differ."""
    from mmdyn_tpu_torch.data.loader import to_device_batch

    state, gen = problem.state, problem.generator
    model_sd = copy.deepcopy(state.model.state_dict())
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    gen_sd = gen.get_state()
    batch = to_device_batch(next(iter(problem.train_loader)), problem.device)
    results = []
    for _ in range(2):
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(copy.deepcopy(opt_sd))   # Adam updates in place
        gen.set_state(gen_sd)
        problem.train_step(state, batch, gen, 1.0)
        results.append(copy.deepcopy(state.model))
    diffs = param_diffs(*results)
    return max(diffs.values()), sorted(name for name, d in diffs.items() if d > 0)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block only: the paths and
    the determinism reading outside it run with torch's defaults."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def check_restore(problem):
    """``problem``'s ``latest`` checkpoint restored into a fresh train state
    (other initial weights) on the card, as ``--resume`` restores it, equals
    ``problem``'s state in memory bit for bit: every parameter, Adam's moments
    and step counts, the step, the epoch and the generator's state. Returns
    the number of tensors compared."""
    from mmdyn_tpu_torch.train.checkpoint import restore_checkpoint

    fresh, _ = train_state(problem.cfg, problem.device, seed=1)
    epoch, _, gen_state, batch_in_epoch = restore_checkpoint(
        problem.checkpoint_dir / "latest", fresh)

    def tensors(state):
        out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
        for i, s in state.optimizer.state_dict()["state"].items():
            out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in s.items()})
        return out

    got, want = tensors(fresh), tensors(problem.state)
    differ = sorted(k for k in want if k not in got
                    or not torch.equal(got[k].cpu(), want[k].cpu()))
    if (differ or got.keys() != want.keys() or fresh.step != problem.state.step
            or (epoch, batch_in_epoch) != (problem.cfg.num_epochs - 1, 0)
            or not torch.equal(gen_state, problem.generator.get_state())):
        raise AssertionError(f"(f): the restored checkpoint differs from the run's state: "
                             f"{differ[:10]}, step {fresh.step} vs {problem.state.step}, "
                             f"epoch {epoch}, batch_in_epoch {batch_in_epoch}")
    return len(want)


def cli_path(kernels, card, bare_frames_per_s, tmp):
    """(f): the training CLI in process on a corpus written for it under
    ``tmp``, then the determinism probe and a second uninterrupted run with
    torch's default cuDNN algorithms; with deterministic ones, an
    uninterrupted run, the probe again, a 1-epoch run whose checkpoint is
    restored and compared, and its ``--resume`` to epoch 2; then the
    evaluation CLI. The first run, ``tmp / "run"``, is the one (g) serves."""
    import importlib.util

    from mmdyn_tpu_torch.cli import evaluate as cli_evaluate
    from mmdyn_tpu_torch.cli import main as cli_main
    from mmdyn_tpu_torch.data.compile import COMPILED_NAME
    from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays

    t0 = time.perf_counter()
    make_compiled_arrays(tmp / "ds" / COMPILED_NAME, n_sequences=2600, seq_length=2,
                         seed=0, packed_dir=True)
    corpus_s = time.perf_counter() - t0
    argv = ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose", "--dataset-path",
            str(tmp / "ds"), "--batchsize", "512", "--dtype", "auto",
            "--no-tensorboard", "--logs-root", str(tmp / "logs")]
    reset_counters(kernels)
    t0 = time.perf_counter()
    run = cli_main.main(argv + ["--num-epochs", "2", "--log-dir", str(tmp / "run")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters(kernels)
    logs = run._logger_dict
    losses = logs["Loss/train_epoch"] + logs["Loss/validation_epoch"]
    shape = (run.cfg.compute_dtype, len(run.train_loader), len(run.test_loader))
    if shape != ("float32", 4, 1):
        raise AssertionError(f"(f): (policy, train batches, test batches) {shape}")
    # 2 epochs x (4 train + 1 validation) forwards
    if launches != {"poe_reparam": 10, "bce_sum": 20, "bce_sum_bf16": 0}:
        raise AssertionError(f"(f): kernel launches {launches} over 2 epochs")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"(f): losses not finite: {losses}")
    fps = logs["Perf/frames_per_sec"]
    say(f"[5/6] (f) cli.main: cnn-mvae visuotactile+pose seq_modeling, batch 512, "
        f"--dtype auto -> {run.cfg.compute_dtype}, 2 epochs of 4 steps + 1 validation "
        f"batch on {card}: {wall_s:.2f} s (corpus written in {corpus_s:.2f} s); "
        f"loop frames/s by epoch {fps} against (a)'s bare step "
        f"{bare_frames_per_s:.1f} ({fps[-1] / bare_frames_per_s:.1%}); train losses "
        f"{logs['Loss/train_epoch']}, validation {logs['Loss/validation_epoch']}; "
        f"launches {launches}")

    final = copy.deepcopy(run.state.model)
    step_diff, differing = step_rerun_diff(run)
    again = cli_main.main(argv + ["--num-epochs", "2", "--log-dir", str(tmp / "again")])
    rerun_diff = max_param_diff(final, again.state.model)
    deterministic = step_diff == 0.0 and rerun_diff == 0.0
    say(f"[5/6] (f) determinism, torch's default cuDNN algorithms: one step run twice "
        f"from one state differs by {step_diff!r} (max |param|), two uninterrupted "
        f"2-epoch runs by {rerun_diff!r}: the card step is "
        f"{'deterministic' if deterministic else 'NOT run-to-run deterministic'}; after "
        f"one step {len(differing)} parameters differ: {differing}")

    # A rerun's spread is as large as what a resume that lost Adam's or the
    # generator's state would show, so the resume is held bit for bit, with
    # cuDNN's deterministic algorithms for these three runs only.
    with deterministic_cudnn():
        full = cli_main.main(argv + ["--num-epochs", "2", "--log-dir", str(tmp / "det")])
        det_final = copy.deepcopy(full.state.model)
        det_step_diff, det_differing = step_rerun_diff(full)
        first = cli_main.main(argv + ["--num-epochs", "1", "--log-dir",
                                      str(tmp / "resumed")])
        n_restored = check_restore(first)
        resumed = cli_main.main(argv + ["--num-epochs", "2", "--log-dir",
                                        str(tmp / "resumed"), "--resume"])
    resume_diff = max_param_diff(det_final, resumed.state.model)
    det_fps = full._logger_dict["Perf/frames_per_sec"]
    say(f"[5/6] (f) resume, cuDNN deterministic algorithms: one step run twice differs "
        f"by {det_step_diff!r} ({len(det_differing)} parameters); the 1-epoch run's "
        f"'latest' restored into a fresh state on the card equals the run's state bit "
        f"for bit ({n_restored} tensors: parameters, Adam moments and step counts; the "
        f"step, the epoch and the generator's state); 1 epoch + --resume to 2 vs "
        f"uninterrupted: {resume_diff!r}; loop frames/s by epoch {det_fps} (default "
        f"algorithms {fps})")
    if det_step_diff != 0.0 or resume_diff != 0.0:
        raise AssertionError(f"(f): with deterministic cuDNN one step reruns to "
                             f"{det_step_diff!r} and the resumed run differs by "
                             f"{resume_diff!r} from the uninterrupted one; both must be 0")

    if importlib.util.find_spec("PIL") is None:
        say("[5/6] (f) cli.evaluate: Pillow does not import here, so the evaluation "
            "CLI (PNG grids) is covered by the CPU tests only")
    else:
        metrics = cli_evaluate.main(["--run", str(tmp / "run"), "--batchsize", "512"])
        plots = sorted(p.name for p in (tmp / "run" / "plot").iterdir())
        if not math.isfinite(metrics["test_loss_total"]) or "recon_visual.png" not in plots:
            raise AssertionError(f"(f) evaluate: {metrics}, {plots}")
        say(f"[5/6] (f) cli.evaluate: test loss {metrics['test_loss_total']!r}; "
            f"wrote {plots}")
    del run, again, full, first, resumed, final, det_final
    torch.cuda.empty_cache()
    return {"frames_per_s": fps, "launches": launches, "step_rerun_diff": step_diff,
            "rerun_diff": rerun_diff, "deterministic": deterministic,
            "det_step_rerun_diff": det_step_diff, "det_resume_diff": resume_diff,
            "det_frames_per_s": det_fps}


def serving_inputs(b, seed=5):
    """A seeded serving batch: uniform visual and tactile images in [0, 1]
    and a uniform normalised pose, float32 NHWC."""
    rng = np.random.default_rng(seed)
    return {"visual": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
            "tactile": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
            "pose": rng.uniform(size=(b, 7)).astype(np.float32)}


def host(out):
    """Tensors of a prediction on the host, as numpy (the readback syncs)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def mean_ms(fn, reps, warm=2):
    """Host ms per call of ``fn`` over ``reps`` calls after ``warm``, the
    device synchronised before and after."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_card_vs_cpu_serving(session, cpu, x):
    """(g) 1: the card's and the CPU's predictions of one batch: probabilities
    atol 1e-4; mu, logvar and pose max |card - cpu| / max |cpu| <= 1e-4;
    uint8 images differ by at most 1 on at most 0.1% of pixels."""
    card, ref = host(session.predict(**x)), host(cpu.predict(**x))
    worst = {}
    for k, want in ref.items():
        err = float(np.abs(card[k] - want).max())
        if k in ("visual", "tactile"):
            worst[k] = err
            ok = err <= 1e-4
        else:
            worst[k] = err / float(np.abs(want).max())
            ok = worst[k] <= 1e-4
        if not ok:
            raise AssertionError(f"(g) card vs cpu {k}: {worst[k]!r}")
    q_card = host(session.predict(**x, uint8_images=True))
    q_cpu = host(cpu.predict(**x, uint8_images=True))
    for k in ("visual", "tactile"):
        diff = np.abs(q_card[k].astype(np.int16) - q_cpu[k].astype(np.int16))
        worst[f"{k}_uint8_max"] = int(diff.max())
        worst[f"{k}_uint8_share"] = float((diff > 0).mean())
        if diff.max() > 1 or (diff > 0).mean() > 1e-3:
            raise AssertionError(f"(g) card vs cpu uint8 {k}: max {diff.max()}, "
                                 f"share {(diff > 0).mean()}")
    return worst


def time_predict(session, x, batches=(1, 8, 64, 256, 1024)):
    """(g) 2: ``predict(uint8_images=True)`` eager and through
    ``aot_predict`` (a CUDA graph) at each batch. Round trip: host arrays to
    host arrays, copies included. Pipelined: calls on device-resident inputs
    with no readback, one synchronise at the end: the device time per call a
    saturated loop sees. The graph's outputs must equal the eager ones bit
    for bit."""
    mods = tuple(sorted(x))
    table = []
    for b in batches:
        xb = {k: v[:b] for k, v in x.items()}
        xd = {k: torch.as_tensor(v, device=session.device) for k, v in xb.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graph = session.aot_predict(b, mods, uint8_images=True)
        eager_out = host(session.predict(**xb, uint8_images=True))
        graph_out = host(graph(xb))
        differ = [k for k in eager_out if not np.array_equal(eager_out[k], graph_out[k])]
        if differ:
            raise AssertionError(f"(g) batch {b}: graph != eager in {differ}")
        reps = 20 if b <= 64 else 8
        row = {
            "batch": b,
            "eager_rt_ms": mean_ms(lambda: host(session.predict(**xb, uint8_images=True)), reps),
            "graph_rt_ms": mean_ms(lambda: host(graph(xb)), reps),
            "eager_pipe_ms": mean_ms(lambda: session.predict(**xd, uint8_images=True), reps),
            "graph_pipe_ms": mean_ms(lambda: graph(xd), reps),
        }
        row.update({f"{k[:-3]}_frames_per_s": b / row[k] * 1e3
                    for k in ("eager_rt_ms", "graph_rt_ms", "eager_pipe_ms", "graph_pipe_ms")})
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        table.append(row)
        say(f"[5/6] (g) predict uint8, batch {b}: round trip eager {row['eager_rt_ms']:.3f} "
            f"ms, graph {row['graph_rt_ms']:.3f} ms; pipelined eager "
            f"{row['eager_pipe_ms']:.3f} ms, graph {row['graph_pipe_ms']:.3f} ms per call; "
            f"frames/s {row['eager_rt_frames_per_s']:.1f} / {row['graph_rt_frames_per_s']:.1f} "
            f"round trip, {row['eager_pipe_frames_per_s']:.1f} / "
            f"{row['graph_pipe_frames_per_s']:.1f} pipelined; peak {row['peak_gib']:.2f} GiB; "
            f"graph == eager bit for bit")
    session._aot_cache.clear()
    torch.cuda.empty_cache()
    return table


def default_algorithms_rerun_gap(session, x, b=64):
    """The largest |difference| between two eager predictions of one batch
    with cuDNN's default (not deterministic) algorithms, which the session
    replaces; the session's own setting is restored after."""
    xb = {k: v[:b] for k, v in x.items()}
    torch.backends.cudnn.deterministic = False
    try:
        first, second = host(session.predict(**xb)), host(session.predict(**xb))
    finally:
        torch.backends.cudnn.deterministic = True
    return max(float(np.abs(first[k] - second[k]).max()) for k in first)


def check_parity_graph(session, x, b=8):
    """(g) 2b: a ``parity`` session's graph predictor, its dropout drawing
    from the session's generator registered with the graph: two replays on
    one batch differ, and hold finite values."""
    from mmdyn_tpu_torch.serve import InferenceSession

    parity = InferenceSession(session.cfg, session.params, parity=True)
    graph = parity.aot_predict(b, tuple(sorted(x)))
    xb = {k: v[:b] for k, v in x.items()}
    first, second = host(graph(xb)), host(graph(xb))
    if np.array_equal(first["mu"], second["mu"]) or not all(
            np.isfinite(v).all() for v in (*first.values(), *second.values())):
        raise AssertionError("(g) parity graph: dropout not live or values not finite")
    say(f"[5/6] (g) parity session's graph at batch {b}: dropout live across replays "
        f"(max |mu| change {float(np.abs(first['mu'] - second['mu']).max())!r})")


def check_frozen(session, x, rows=(0, 17, 40, 63)):
    """(g) 4: ``freeze_bn`` on 256 rows, then per-example determinism at the
    fixed serving shape: row i served alone (padded to the batch of 64 by
    repeating it, as the server pads) equals row i inside a batch of 64 of
    other rows, bit for bit, through the frozen session's graph predictor.
    Also reads the eager batch-1 against batch-64 gap (other shapes may take
    other cuDNN algorithms)."""
    frozen = session.freeze_bn(**{k: v[:256] for k, v in x.items()})
    mods = tuple(sorted(x))
    graph = frozen.aot_predict(64, mods, uint8_images=True)
    batch = {k: v[256:320] for k, v in x.items()}
    together = host(graph(batch))
    for i in rows:
        alone = host(graph({k: np.repeat(v[i:i + 1], 64, axis=0) for k, v in batch.items()}))
        differ = [k for k in together if not np.array_equal(alone[k][0], together[k][i])]
        if differ:
            raise AssertionError(f"(g) frozen row {i}: alone != in the batch in {differ}")
    one = host(frozen.predict(**{k: v[:1] for k, v in batch.items()}, uint8_images=True))
    eager64 = host(frozen.predict(**batch, uint8_images=True))
    gap = {"mu": float(np.abs(one["mu"][0] - eager64["mu"][0]).max()),
           "visual_uint8": int(np.abs(one["visual"][0].astype(np.int16)
                                      - eager64["visual"][0].astype(np.int16)).max())}
    say(f"[5/6] (g) freeze_bn on 256 rows ({len(frozen.bn_stats)} BatchNorm layers): rows "
        f"{list(rows)} alone (padded to 64) == inside a batch of 64, bit for bit; eager "
        f"batch 1 vs batch 64: max |mu| gap {gap['mu']!r}, uint8 gap {gap['visual_uint8']}")
    frozen._aot_cache.clear()
    return frozen, gap


def http_post(port, path, arrays=None):
    """(status, ms, npz or error) of one POST with an npz body."""
    import http.client
    import io

    body = b""
    if arrays is not None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        raise AssertionError(f"(g) POST {path}: {resp.status} {data[:300]!r}")
    return ms, np.load(io.BytesIO(data))


@contextlib.contextmanager
def running(server):
    """``server`` serving from a thread inside the block; shut down and
    closed after it."""
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_port
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def first_call_in_new_thread_ms(fn):
    """Host ms of ``fn`` as the first call of a new thread (torch builds
    cuDNN's execution plans once per thread)."""
    import threading

    out = []
    thread = threading.Thread(target=lambda: out.append(mean_ms(fn, 1, warm=0)))
    thread.start()
    thread.join()
    return out[0]


def check_http(session, frozen, x):
    """(g) 6: the HTTP server on 127.0.0.1, port 0, batch 64: /healthz, then
    /predict with uint8 npz bodies at batch 1 and 64 (round trip ms), then
    /rollout?steps=5 and /sample?n=5; then 8 concurrent batch-1 clients
    through the micro-batcher on the frozen session, whose rows must equal
    the same requests served one by one, bit for bit."""
    import http.client
    import threading

    from mmdyn_tpu_torch.serve.server import make_server

    def wire(b, off=0):
        sl = slice(off, off + b)
        return {"visual": (x["visual"][sl] * 255).astype(np.uint8),
                "tactile": (x["tactile"][sl] * 255).astype(np.uint8), "pose": x["pose"][sl]}

    out = {}
    with running(make_server(session, port=0, batch_size=64)) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        if health["status"] != "ok" or health["batch_size"] != 64:
            raise AssertionError(f"(g) /healthz: {health}")
        for b in (1, 64):
            ms = [http_post(port, "/predict", wire(b))[0] for _ in range(12)][2:]
            out[f"predict_{b}_ms"] = float(np.median(ms))
            out[f"predict_{b}_max_ms"] = float(max(ms))
        _, traj = http_post(port, "/rollout?steps=5", wire(1))
        _, samples = http_post(port, "/sample?n=5&seed=3")
        if traj["visual"].shape != (5, 1, 64, 64, 3) or samples["visual"].shape != (5, 64, 64, 3):
            raise AssertionError(f"(g) rollout {traj['visual'].shape}, sample "
                                 f"{samples['visual'].shape}")
    with running(make_server(frozen, port=0, batch_size=64)) as port:
        solo = [http_post(port, "/predict", wire(1, i))[1] for i in range(8)]
    server = make_server(frozen, port=0, batch_size=64, microbatch_wait_ms=50.0)
    app = server.RequestHandlerClass.app
    coalesced = [None] * 8
    with running(server) as port:
        def client(i):
            coalesced[i] = http_post(port, "/predict", wire(1, i))[1]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    for i, (a, b) in enumerate(zip(coalesced, solo)):
        differ = [k for k in b.files if a is None or not np.array_equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"(g) micro-batched client {i} != solo in {differ}")
    out["microbatch_batches"] = app._batches
    x64 = {k: v[:64] for k, v in x.items()}
    call = lambda: host(session.predict(**x64, uint8_images=True))  # noqa: E731
    out["new_thread_first_predict_ms"] = [first_call_in_new_thread_ms(call) for _ in range(3)]
    out["warm_thread_predict_ms"] = mean_ms(call, 5)
    say(f"[5/6] (g) HTTP /predict round trip (uint8 npz, median of 10): batch 1 "
        f"{out['predict_1_ms']:.3f} ms (max {out['predict_1_max_ms']:.3f}), batch 64 "
        f"{out['predict_64_ms']:.3f} ms (max {out['predict_64_max_ms']:.3f}); /rollout "
        f"steps=5 and /sample n=5 ok; 8 concurrent batch-1 clients on the frozen session "
        f"served in {app._batches} device batches, each row == its solo reply bit for bit; "
        f"predict at batch 64 as a new thread's first call "
        f"{[round(v, 3) for v in out['new_thread_first_predict_ms']]} ms, on a warm thread "
        f"{out['warm_thread_predict_ms']:.3f} ms (why the server keeps one device thread)")
    return out


def serve_path(kernels, card, tmp):
    """(g): serving the run (f) trained, ``tmp / "run"`` (cnn-mvae,
    visuotactile + pose, latent 256, float32), with the kernel counters set
    to 0 just before and read just after: every counter must read 0, as the
    JAX session fuses with the plain product of experts and has no loss."""
    from mmdyn_tpu_torch.cli import infer as cli_infer
    from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported

    run = tmp / "run"
    x = serving_inputs(1024)
    torch.cuda.empty_cache()
    reset_counters(kernels)
    t0 = time.perf_counter()
    session = InferenceSession.from_run(run)
    load_s = time.perf_counter() - t0
    cpu = InferenceSession.from_run(run, device="cpu")
    worst = check_card_vs_cpu_serving(session, cpu, {k: v[:32] for k, v in x.items()})
    del cpu
    say(f"[5/6] (g) InferenceSession.from_run of (f)'s run on the card in {load_s:.2f} s: "
        f"batch 32 matches the CPU session ({json.dumps(worst)}; probabilities atol 1e-4, "
        f"mu / logvar / pose max gap over max |cpu| 1e-4, uint8 <= 1 on <= 0.1%)")
    table = time_predict(session, x)
    rerun_gap = default_algorithms_rerun_gap(session, x)
    say(f"[5/6] (g) with cuDNN's default algorithms two eager predictions of one batch of "
        f"64 differ by {rerun_gap!r} (max |a - b|); the session's deterministic ones: 0, "
        f"the graph == eager checks above")
    check_parity_graph(session, x)

    x64 = {k: v[:64] for k, v in x.items()}
    session.rollout(2, **x64)                             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = host(session.rollout(16, **x64, uint8_images=True))
    rollout_ms = (time.perf_counter() - t0) * 1e3 / 16
    if traj["visual"].shape != (16, 64, 64, 64, 3) or not np.isfinite(traj["mu"]).all():
        raise AssertionError(f"(g) rollout: {traj['visual'].shape}")
    say(f"[5/6] (g) rollout 16 steps at batch 64: {rollout_ms:.3f} ms per step "
        f"(host arrays in, uint8 trajectory out)")

    frozen, frozen_gap = check_frozen(session, x)

    t0 = time.perf_counter()
    manifest = export_session(session, tmp / "artifact", batch_size=64,
                              modalities=tuple(sorted(x)))
    export_s = time.perf_counter() - t0
    art = load_exported(tmp / "artifact")(**x64)
    live = session.predict(**x64)
    export_gap = max(float((art[k] - live[k]).abs().max()) for k in manifest["outputs"])
    if manifest["platforms"] != [session.device.type] or export_gap > 1e-5:
        raise AssertionError(f"(g) export: {manifest['platforms']}, gap {export_gap!r}")
    say(f"[5/6] (g) export_session at batch 64 in {export_s:.2f} s; load_exported's "
        f"outputs {manifest['outputs']} match predict's, max gap {export_gap!r} (atol 1e-5)")

    http = check_http(session, frozen, x)
    cli = cli_infer.main(["--run", str(run), "--export", str(tmp / "cli_artifact")])
    if cli["platforms"] != [session.device.type] or cli["batch_size"] != 64:
        raise AssertionError(f"(g) cli.infer --export: {cli}")
    launches = read_counters(kernels)
    if any(launches.values()):
        raise AssertionError(f"(g): kernel launches {launches}, expected none")
    say(f"[5/6] (g) cli.infer --export wrote a {cli['platforms']} artifact at batch "
        f"{cli['batch_size']}; launches {launches}")
    del session, frozen
    torch.cuda.empty_cache()
    return {"predict": table, "rollout_ms_per_step": rollout_ms, "http": http,
            "card_vs_cpu": worst, "frozen_gap": frozen_gap, "export_gap": export_gap,
            "default_algorithms_rerun_gap": rerun_gap,
            "launches": launches}


ZERO_LAUNCHES = {"poe_reparam": 0, "bce_sum": 0, "bce_sum_bf16": 0}
CORPUS_SEQS, CORPUS_FRAMES = 32, 10      # (h): dumps at the simulator's 480 x 640
DROP_STEPS, INTERVAL = 500, 10           # (i): exp_1's --n_timesteps, --interval
# (i): exp_1's --trial_per_obj (one object's trials are one batch), and many
EXP1_TRIALS, MANY_TRIALS = 10, 1024
FRAME_TRIALS, CHUNK = 8, 128             # (i): 8 trials x 50 snapshots, the dump path's chunk


def corpus_path(kernels, card, tmp):
    """(h): simulator-shaped PNG dumps written by ``make_synthetic_dumps``
    (32 sequences x 10 frames at 480 x 640), compiled by the PIL and the
    native engine (uint8 keys within 1, the others equal), then the training
    CLI on copies of the dump directory without a corpus: it must compile it
    (31 sequences under strict parity, 32 with ``--no-strict-parity``) and
    train cnn-mvae seq_modeling at batch 4 for 1 epoch on the card. The
    kernel counters are set to 0 before the compiles and read after the two
    runs. Only where Pillow imports: the dumps are PNGs."""
    import importlib.util
    import shutil

    if importlib.util.find_spec("PIL") is None:
        say("[5/6] (h) corpus: Pillow does not import here, so writing and compiling PNG "
            "dumps is covered by the CPU tests only (tests/test_torch_compile.py)")
        return {"skipped": "no Pillow", "launches": dict(ZERO_LAUNCHES)}
    from mmdyn_tpu_torch.cli import main as cli_main
    from mmdyn_tpu_torch.data import native
    from mmdyn_tpu_torch.data.compile import COMPILED_NAME, compile_dataset, load_packed
    from mmdyn_tpu_torch.data.synthetic import make_synthetic_dumps

    reset_counters(kernels)
    dumps = tmp / "dumps"
    t0 = time.perf_counter()
    make_synthetic_dumps(dumps, n_sequences=CORPUS_SEQS, seq_length=CORPUS_FRAMES,
                         image_size=(480, 640), seed=0)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        say(f"[5/6] (h) g++ failed to build native/ingest.cpp: {native.build_error()}")
        raise AssertionError("(h): the native ingest library did not build")
    build_s = time.perf_counter() - t0
    # every frame of the 31 emitted sequences, 3 PNG streams each, and their finals
    frames = (CORPUS_SEQS - 1) * CORPUS_FRAMES
    seconds, corpora = {}, {}
    for engine in ("pil", "native"):
        t0 = time.perf_counter()
        path = compile_dataset(dumps, seed=0, compiled_name=f"{engine}.npz", verbose=False,
                               engine=engine)
        seconds[engine] = time.perf_counter() - t0
        corpora[engine] = load_packed(path)
    pil, nat = corpora["pil"], corpora["native"]
    gaps = {}
    for k in pil:
        if pil[k].dtype == np.uint8:
            gaps[k] = int(np.abs(pil[k].astype(int) - nat[k].astype(int)).max())
        elif not np.array_equal(pil[k], nat[k]):
            raise AssertionError(f"(h): key {k} differs between the engines")
    if sorted(pil) != sorted(nat) or max(gaps.values()) > 1 or \
            pil["visual"].shape != (CORPUS_SEQS - 1, CORPUS_FRAMES, 64, 64, 3):
        raise AssertionError(f"(h): engines disagree: uint8 gaps {gaps}, "
                             f"shape {pil['visual'].shape}")
    fps = {e: frames / s for e, s in seconds.items()}
    say(f"[5/6] (h) corpus: {CORPUS_SEQS} x {CORPUS_FRAMES} dumps at 480 x 640 written in "
        f"{write_s:.2f} s; native/ingest.cpp built in {build_s:.2f} s; compile of {frames} "
        f"frames (3 streams each): PIL {seconds['pil']:.3f} s ({fps['pil']:.1f} frames/s), "
        f"native {seconds['native']:.3f} s ({fps['native']:.1f} frames/s); uint8 keys "
        f"within {max(gaps.values())} ({gaps}), the others equal")

    argv = ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae", "--input-type",
            "visuotactile", "--use-pose", "--batchsize", "4", "--num-epochs", "1",
            "--no-tensorboard"]
    runs = {}
    for name, extra, n in (("strict", [], CORPUS_SEQS - 1),
                           ("no-strict", ["--no-strict-parity"], CORPUS_SEQS)):
        ds = tmp / f"ds_{name}"
        shutil.copytree(dumps / "dataset", ds / "dataset")
        t0 = time.perf_counter()
        run = cli_main.main(argv + extra + ["--dataset-path", str(ds), "--log-dir",
                                            str(tmp / f"run_{name}")])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        rows = load_packed(ds / COMPILED_NAME)["visual"].shape[0]
        logs = run._logger_dict
        losses = logs["Loss/train_epoch"] + logs["Loss/validation_epoch"]
        shape = (rows, len(run.train_loader), len(run.test_loader), run.device.type)
        if shape != (n, 6, 1, "cuda") or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"(h) {name}: (sequences, train batches, test batches, "
                                 f"device) {shape}, losses {losses}")
        runs[name] = {"sequences": rows, "wall_s": wall_s, "losses": losses}
        say(f"[5/6] (h) cli.main {' '.join(extra) or '(strict parity)'} on a dump directory "
            f"without a corpus: compiled {rows} sequences, trained 6 steps + 1 validation "
            f"batch on the card in {wall_s:.2f} s; losses {losses}")
        del run
    launches = read_counters(kernels)
    # 2 runs x (6 train + 1 validation) forwards of the MVAE
    if launches != {"poe_reparam": 14, "bce_sum": 28, "bce_sum_bf16": 0}:
        raise AssertionError(f"(h): kernel launches {launches}")
    return {"write_s": write_s, "build_s": build_s, "compile_s": seconds,
            "frames_per_s": fps, "uint8_gaps": gaps, "runs": runs, "launches": launches}


def exp1_scene(seed=0):
    """exp_1's scene as ``mmdyn_tpu/cli/exp_1_flat_plane.py`` builds it on the
    analytic engine: ``make_sensor``'s sensor (1.5 x 1.5 x 1 at z 0.5, its
    640 x 480 camera, a 0.005 gel layer) and one box of the synthetic
    catalog's sizes and colours, at the reference drop point (0, 0, 1.5)."""
    from mmdyn_tpu_torch.sim import config as sim_config
    from mmdyn_tpu_torch.sim.physics import setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor

    backend = setup_backend(time_step=sim_config.TIME_STEP, gravity=True, engine="analytic")
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.005, use_force=False,
                         constrained=False)
    rng = np.random.default_rng(seed)
    obj = backend.add_box(rng.uniform(0.06, 0.2, size=3), [0.0, 0.0, 1.5], mass=1,
                          color=rng.uniform(0.2, 1.0, size=3))
    return backend, sensor, obj


def drop_orientations(k, seed=1):
    """``sample_pose(random_orn=True, random_chance=0.8)``'s orientations for
    ``k`` trials from one seed: a uniform quaternion (Shoemake) with chance
    0.8, else the identity."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, 3))
    q = np.stack([np.sqrt(1 - x[:, 0]) * np.sin(2 * np.pi * x[:, 1]),
                  np.sqrt(1 - x[:, 0]) * np.cos(2 * np.pi * x[:, 1]),
                  np.sqrt(x[:, 0]) * np.sin(2 * np.pi * x[:, 2]),
                  np.sqrt(x[:, 0]) * np.cos(2 * np.pi * x[:, 2])], axis=1)
    q[rng.random(k) >= 0.8] = [0.0, 0.0, 0.0, 1.0]
    return q


def host_rollout(quat, n_steps):
    """Pre-step positions of every body and the sensor <-> object pair force
    of one exp_1 trial on the host's float64 AnalyticBackend."""
    backend, sensor, obj = exp1_scene()
    backend.set_pose(obj, [0.0, 0.0, 1.5], quat)
    ids = sorted(backend.bodies)
    traj, force = np.zeros((n_steps, len(ids), 3)), np.zeros(n_steps)
    for t in range(n_steps):
        traj[t] = [backend.bodies[b].position for b in ids]
        backend.step()
        force[t] = sum(c.normal_force for c in backend._contacts
                       if {c.body_a, c.body_b} == {sensor.sensor_id, obj})
    return traj, force


def datagen_path(kernels, card):
    """(i): exp_1's data generation at full width on the card. The rollout:
    500 steps of ``SimulatorTorch`` from seeded drop orientations, at
    exp_1's batch (10 trials) and at 1024 trials, each timed twice and
    profiled over 100 steps; the 1024 trials against the same module on
    the CPU (8 trials) and the host engine (2 trials, test_physics_jax.py's
    bounds). The frames: 8 trials x 50 snapshots (every 10th step) at
    640 x 480, in chunks of 128, through ``render_frames_packed`` and
    ``TactileRendererTorch.render_frames``, timed three times after a warm
    chunk; one chunk against the CPU and rerun bit for bit; one chunk
    profiled. No kernel of the port launches."""
    from mmdyn_tpu_torch.sim.physics_torch import pack_scene
    from mmdyn_tpu_torch.sim.raycast_torch import RaycastTorch, capture_scene
    from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch

    backend, sensor, obj = exp1_scene()
    reset_counters(kernels)
    sim, ids, consts = pack_scene(backend)                 # the card, by default
    dev = sim.device
    row = {bid: r for r, bid in enumerate(ids)}
    k, steps = MANY_TRIALS, DROP_STEPS
    tile = lambda a: np.tile(a[None], (k,) + (1,) * a.ndim)  # noqa: E731
    quat = tile(consts["quat"])
    quat[:, row[obj]] = drop_orientations(k)
    args = (tile(consts["pos"]), tile(consts["vel"]), quat, tile(consts["sizes"]),
            tile(consts["mass"]))
    sim.simulate(*args, 10)                                # loads the kernels
    torch.cuda.synchronize()
    rollouts = {}
    for n in (EXP1_TRIALS, MANY_TRIALS):
        sub = tuple(a[:n] for a in args)
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = sim.simulate(*sub, steps)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        prof, _ = device_profile(lambda: sim.simulate(*sub, 100),
                                 f"(i) rollout {n} trials x 100 steps")
        rollouts[n] = {"ms": ms, "trials_per_s": [n / m * 1e3 for m in ms],
                       "profile": prof}
        say(f"[5/6] (i) rollout of {n} trials x {steps} steps on {card}: "
            f"{ms[0]:.1f} / {ms[1]:.1f} ms ({n / ms[0] * 1e3:.1f} / {n / ms[1] * 1e3:.1f} "
            f"trials/s)")
    pos, cf = out["pos"], out["contact_force"]                 # the 1024 trials
    slot = sim.support_slot(row[sensor.sensor_id])
    final = out["final_pos"][:, row[obj]]
    if not (torch.isfinite(pos).all() and torch.isfinite(cf).all()
            and bool((final[:, 2] > 1.0).all()) and bool((final[:, 2] < 1.5).all())):
        raise AssertionError("(i): the rollout is not finite or the objects do not rest on "
                             "the sensor")

    cpu_sim, _, _ = pack_scene(backend, device="cpu")
    cpu = cpu_sim.simulate(*(a[:FRAME_TRIALS] for a in args), steps)
    d_pos = float((pos[:FRAME_TRIALS].cpu() - cpu["pos"]).abs().max())
    d_force = float((cf[:FRAME_TRIALS].cpu() - cpu["contact_force"]).abs().max())
    if d_pos > 1e-4 or d_force > 1e-4 * float(cpu["contact_force"].abs().max()):
        raise AssertionError(f"(i): card vs CPU rollout: pos {d_pos!r}, force {d_force!r}")
    host_gaps = []
    for trial in range(2):
        traj_h, force_h = host_rollout(quat[trial, row[obj]], steps)
        traj_d = pos[trial].cpu().numpy()
        force_d = cf[trial, :, row[obj], slot].cpu().numpy()
        np.testing.assert_allclose(traj_d, traj_h, atol=2e-3)
        np.testing.assert_allclose(traj_d[-1], traj_h[-1], atol=5e-4)
        np.testing.assert_allclose(force_d[-50:], force_h[-50:], rtol=1e-4)
        host_gaps.append(float(np.abs(traj_d - traj_h).max()))
    say(f"[5/6] (i) rollout: exp_1 (sensor + one box, {len(ids)} bodies), {k} trials x "
        f"{steps} steps: card vs CPU (8 trials) max |d pos| {d_pos!r}, max |d force| "
        f"{d_force!r}; card vs the host engine (2 trials) max |d pos| {max(host_gaps)!r} "
        f"(atol 2e-3, resting force rtol 1e-4)")

    # --- the frames of 8 trials x 50 snapshots ---
    sensor._update_pose()
    sensor._update_sensor()
    rc = RaycastTorch.from_camera(sensor.camera)
    tac = TactileRendererTorch.cached_from_sensor(sensor)
    _, static, _ = capture_scene(backend)
    box_rows = [row[int(i)] for i in static["box_id"]]
    sph_rows = [row[int(i)] for i in static["sph_id"]]
    snaps = [t for t in range(steps) if (t + 1) % INTERVAL == 0]
    sel_k = torch.tensor([tr for tr in range(FRAME_TRIALS) for _ in snaps], device=dev)
    sel_t = torch.tensor([t for _ in range(FRAME_TRIALS) for t in snaps], device=dev)
    pos_f = pos[sel_k, sel_t]                                  # (F, NB, 3), on the card
    quat_f = torch.as_tensor(quat, dtype=torch.float32, device=dev)[sel_k]
    n_frames = len(sel_k)
    cam = RaycastTorch.capture_camera_state(sensor.camera)
    tac_state = TactileRendererTorch.capture_frame_state(sensor)
    mbd = float(sensor.max_buffer_depth)

    def chunk(lo, hi, on=dev, rc=rc, tac=tac):
        n = hi - lo
        scene = dict(static, sph_pos=pos_f[lo:hi, sph_rows].to(on),
                     box_pos=pos_f[lo:hi, box_rows].to(on), box_q=quat_f[lo:hi, box_rows].to(on))
        states = {key: np.stack([v] * n) for key, v in zip(("m_inv", "eye", "forward"), cam)}
        rgb, depth_clip, depth_png, seg_png = rc.render_frames_packed(
            states, scene, mbd, np.full(n, obj))
        tactile = tac.render_frames(depth_clip, *(np.stack([v] * n) for v in tac_state))
        return {"rgb": rgb, "depth_clip": depth_clip, "depth_png": depth_png,
                "seg_png": seg_png, "tactile": tactile}

    chunk(0, CHUNK)                  # warm: the kernels and the allocator's blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_ms = []
    for _ in range(3):
        frames = None                                          # free the last pass's
        t0 = time.perf_counter()
        frames = [chunk(lo, min(lo + CHUNK, n_frames)) for lo in range(0, n_frames, CHUNK)]
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    host = {key: torch.cat([f[key] for f in frames]).cpu().numpy()
            for key in ("rgb", "depth_png", "seg_png", "tactile")}
    download_s = time.perf_counter() - t0
    first = {key: v.clone() for key, v in frames[0].items()}
    del frames
    again = chunk(0, CHUNK)
    rerun_equal = all(torch.equal(first[key], again[key]) for key in first)
    del again
    if not rerun_equal:
        raise AssertionError("(i): a rerun of the first chunk differs")
    cpu_rc = RaycastTorch.from_camera(sensor.camera, device="cpu")
    cpu_tac = TactileRendererTorch.from_sensor(sensor, device="cpu")
    want = chunk(0, CHUNK, on=torch.device("cpu"), rc=cpu_rc, tac=cpu_tac)
    got = {key: v.cpu() for key, v in first.items()}
    agree = got["seg_png"] == want["seg_png"]
    seg_share = 1.0 - float(agree.float().mean())
    depth_gap = float((got["depth_clip"] - want["depth_clip"]).abs()[agree].max())
    apart = lambda key: float(((got[key].int() - want[key].int()).abs() > 1)  # noqa: E731
                              .float().mean())
    rgb_share, tac_share = apart("rgb"), apart("tactile")
    if seg_share > 1e-3 or depth_gap > 1e-5 or rgb_share > 1e-4 or tac_share > 1e-4:
        raise AssertionError(f"(i): card vs CPU chunk: seg mismatch {seg_share!r}, depth "
                             f"{depth_gap!r}, rgb {rgb_share!r}, tactile {tac_share!r}")
    # what comes out: the object in every frame, seg only background (1) or the
    # object (id 2 -> 254), and a tactile imprint once the object rests
    seg_vals = set(np.unique(host["seg_png"]).tolist())
    visible = (host["seg_png"] == (obj * 255) % 256).reshape(n_frames, -1).any(1)
    tac_frames = host["tactile"].reshape(FRAME_TRIALS, len(snaps), -1)
    touched = [not np.array_equal(t[0], t[-1]) for t in tac_frames]
    if seg_vals - {1, (obj * 255) % 256} or not visible.all() or not all(touched):
        raise AssertionError(f"(i) frames: seg values {seg_vals}, object visible in "
                             f"{visible.mean():.1%} of frames, contact imprint {touched}")
    fprof, _ = device_profile(lambda: chunk(0, CHUNK), f"(i) one chunk of {CHUNK} frames")
    launches = read_counters(kernels)
    if any(launches.values()):
        raise AssertionError(f"(i): kernel launches {launches}, expected none")
    fps = [n_frames / ms * 1e3 for ms in render_ms]
    say(f"[5/6] (i) frames: {n_frames} at 640 x 480 (raycast RGB, depth, seg + tactile) in "
        f"chunks of {CHUNK} on {card}, three passes: "
        + " / ".join(f"{ms:.1f} ms ({f:.1f} frames/s)" for ms, f in zip(render_ms, fps))
        + f"; the uint8 payloads downloaded in {download_s * 1e3:.1f} ms; peak "
        f"{peak_gib:.2f} GiB; rerun bit-identical; card vs CPU (one chunk): seg mismatch "
        f"{seg_share!r}, depth max gap {depth_gap!r} where seg agrees, bytes more than 1 "
        f"apart: rgb {rgb_share!r}, tactile {tac_share!r}; launches {launches}")
    return {"rollouts": rollouts, "card_vs_cpu_pos": d_pos,
            "card_vs_cpu_force": d_force, "card_vs_host_pos": max(host_gaps),
            "frames": n_frames, "render_ms": render_ms, "frames_per_s": fps,
            "download_ms": download_s * 1e3, "peak_gib": peak_gib,
            "frames_profile": fprof, "seg_mismatch": seg_share, "depth_gap": depth_gap,
            "rgb_apart": rgb_share, "tactile_apart": tac_share, "launches": launches}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mmdyn_tpu_torch.ops import build, kernels
    from mmdyn_tpu_torch.problems import ProblemConfig
    from mmdyn_tpu_torch.problems import reconstruction as recon

    from mmdyn_tpu_torch.utils.device import set_reference_precision

    set_reference_precision()
    card = card_line()
    say(f"[1/6] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card}); TF32 off (cuDNN and matmul), "
        f"bf16 matmuls sum in f32")

    secs = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    say(f"[2/6] built {', '.join(build.SOURCES)} for sm_90a in {secs:.1f} s")

    dev = torch.device("cuda")
    timer = Timer(dev)
    entries = [check_poe(kernels, recon, timer, dev), check_bce(kernels, timer, dev)]
    entries.append(check_bce_bf16(kernels, timer, dev, entries[1]))
    one = torch.zeros(1, device=dev)
    say(f"[3/6] timer floor: a one-float zero_() reads {timer(one.zero_):.5f} ms "
        f"(the event pair and one launch)")

    # the seq flagship's configuration; the other paths and checks vary it
    flag = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                         input_type="visuotactile", use_pose=True, latent_size=256,
                         batchsize=512, compute_dtype="float32")
    dyn = dataclasses.replace(flag, problem_type="dyn_modeling", batchsize=256)
    vae = dataclasses.replace(flag, model_name="cnn-vae", input_type="visual",
                              use_pose=False, batchsize=1024)
    check_card_vs_cpu(kernels, flag, 32, launches=(1, 2))
    check_card_vs_cpu(kernels, dataclasses.replace(dyn, mask_loss=True), 8, seq_len=4,
                      launches=(1, 2))
    check_card_vs_cpu(kernels, dataclasses.replace(
        flag, use_pose=False, conditional=True, condition_dim=3), 8, shock=3,
        launches=(1, 2))
    check_card_vs_cpu(kernels, vae, 8)
    check_card_vs_cpu(kernels, dataclasses.replace(
        vae, problem_type="reconstruction", model_name="mlp-vae", input_type="tactile"), 8)
    check_card_vs_cpu(kernels, ProblemConfig(
        problem_type="regression", model_name="regressor", input_type="visual",
        conditional=True, condition_dim=3), 8, shock=3)
    for policy in ("bfloat16", "bfloat16_full"):
        check_card_vs_cpu(kernels, dataclasses.replace(flag, compute_dtype=policy), 32,
                          launches=(1, 2))
    check_bf16_rounding(flag)

    mvae_per_step = {"poe_reparam": 1, "bce_sum": 2}
    torch.cuda.reset_peak_memory_stats()
    paths = {
        "seq_modeling": run_path("(a) seq flagship", flag, kernels, card, mvae_per_step,
                                 profile_steps=3),
        "dyn_modeling": run_path("(b) dyn_modeling", dyn, kernels, card, mvae_per_step,
                                 seq_len=8, profile_steps=2, top=25),
        "cnn-vae": run_path("(c) cnn-vae", vae, kernels, card,
                            {"poe_reparam": 0, "bce_sum": 0}),
        "seq_bf16_full": run_path("(d) seq flagship", dataclasses.replace(
            flag, compute_dtype="bfloat16_full"), kernels, card, mvae_per_step,
            profile_steps=3),
        "dyn_bf16_full": run_path("(e) dyn_modeling", dataclasses.replace(
            dyn, compute_dtype="bfloat16_full"), kernels, card, mvae_per_step, seq_len=8,
            profile_steps=2, top=25),
    }
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_path(kernels, card, paths["seq_modeling"]["frames_per_s"], Path(tmp))
        serve = serve_path(kernels, card, Path(tmp))
        corpus = corpus_path(kernels, card, Path(tmp))
    datagen = datagen_path(kernels, card)

    for e in entries:
        # the bf16 kernel's main path is (d), the others' (a)
        main = "seq_bf16_full" if e["name"] == "bce_sum_bf16" else "seq_modeling"
        e["launches"] = paths[main]["launches"][e["name"]]
        e["launches_by_path"] = {name: p["launches"][e["name"]] for name, p in paths.items()}
        e["launches_by_path"]["cli"] = cli["launches"][e["name"]]
        e["launches_by_path"]["serve"] = serve["launches"][e["name"]]
        e["launches_by_path"]["corpus"] = corpus["launches"][e["name"]]
        e["launches_by_path"]["datagen"] = datagen["launches"][e["name"]]
    if any(m.split(".")[0] in ("jax", "mmdyn_tpu") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")
    say("[6/6] " + json.dumps({**{name: {k: p[k] for k in (
        "step_ms", "frames_per_s", "peak_gib", "busy_share", "conv_share") if k in p}
        for name, p in paths.items()}, "cli": cli, "serve": serve, "corpus": corpus,
        "datagen": datagen}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
