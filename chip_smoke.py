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
       each; the determinism reading at batch 512 and 128 (every
       convolution of one step replayed three times with cuDNN's default
       algorithms and three with its deterministic ones: the outputs that
       differ, by layer family and output, which under the deterministic
       ones must be none; the convolutions' device ms and ms/step with
       each, in turns); 3 more under torch.profiler (the top 40 kernels and
       the port's own kernels whatever their rank, and the device's busy
       share);
   (b) dyn_modeling, the same model at 256 sequences x 8 frames (2048 rows
       per step): 1 warm-up and 4 timed steps, 1 PoE and 2 BCE launches
       each, then 2 profiled steps (the top 25 kernels and the port's own);
   (c) cnn-vae, visual, seq_modeling, batch 1024: 5 steps, no kernel
       launch (its loss has no kernel in the JAX package either);
   (d) the seq flagship under ``bfloat16_full`` (``bench.py``'s policy):
       5 steps, the determinism reading at 512 and 128, and 3 profiled, 2
       BCE launches a step on bf16 logits;
   (e) dyn_modeling 256 x 8 under ``bfloat16_full``: 5 steps and 2 profiled;
   ms/step and frames/s of each (frames: B rows per step, B * T for dyn);
   (f) the training CLI in process (``cli.main.main``): a 2,600-sequence x
       2-frame corpus written once by the port's ``make_compiled_arrays``
       (packed directory) into a temporary directory; cnn-mvae visuotactile
       + pose seq_modeling, batch 512, ``--dtype auto`` (float32), 2 epochs
       of 4 steps and 1 validation batch; the loop's frames/s beside (a)'s.
       The loop's steps run cuDNN's deterministic algorithms on the card
       (``utils/device.py::cudnn_deterministic``): one train step run twice
       from the same state and a second uninterrupted run must equal the
       first bit for bit; a run with that repair bypassed (torch's default
       algorithms) gives the baseline of its cost (loop frames/s) and its
       step's rerun gap (a reading); a 1-epoch run, whose ``latest``
       checkpoint restored into a fresh state must equal its state bit for
       bit (parameters, Adam's moments and step counts, the generator); and
       that run continued with ``--resume`` to 2, whose parameters must
       equal the uninterrupted ones bit for bit. Then ``cli.evaluate.main``
       on the run when Pillow imports.
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
   (j) the simulator's dump CLIs (``mmdyn_tpu_torch/cli``), where cv2
       imports (it writes the PNGs; without it (j) fails): (j1) the
       run-length wire (``utils/wire.py``) on (i)'s first chunk of 128
       frames, folded as ``DeferredFrames`` folds it into two int32 streams
       of 128 x 307,200 (row breaks at 640, 4 planes): encode device ms and
       host enqueue, runs, wire MB against raw MB, ``get_raw`` against the
       pageable raw download, the host decode, peak GiB; decoded equal to
       downloaded bit for bit; one encode profiled. (j2) ``exp_1_flat_plane
       --device-physics`` in process at its defaults (500 steps, interval 10,
       10 trials) on 2 objects (8 cut to 2), ``MMDYN_GEN_TRACE=1``: wall
       seconds, trials/s, snapshots written/s, the stage split; every kept
       sequence 50 snapshots and 50 PNGs of each stream; the native compile
       of the dumps (kept - 1) x 50 frames. (j3) ``demo`` and ``exp_{1,2,3}``
       with ``--device-physics`` against their host paths, and ``demo
       --device-render``, at the JAX tests' argv and bounds. No kernel of the
       port launches.
   (k) the tools (``mmdyn_tpu_torch/tools``), where Pillow and cv2 import
       (without them (k) fails), in two parts. After (g), in (f)'s temporary
       directory: (k0) a shock corpus of 520 sequences x 4 frames
       (``make_compiled_arrays``, packed directory) and four runs trained on
       it through ``cli.main`` on the card, 1 epoch at batch 64, float32,
       latent 256: the regressor, cnn-mvae visuotactile + pose on
       seq_modeling and on dyn_modeling, and the conditional cnn-mvae
       (visuotactile + pose, the shock as condition), the counters read
       around each run (MVAE: 1 PoE and 2 BCE launches per forward; the
       regressor none), and simulator-shaped dumps of 2 sequences x 10
       frames at 480 x 640; (k1) ``bench_infer`` on (f)'s run at batches 1,
       8, 64 and 256, 30 iterations, rollout 50; (k2) ``bench_http`` on
       (f)'s run at its defaults (8 clients x 40 requests, batch 16, waits
       of 0 and 5 ms, 8 calibration frames); (k3) ``rollout_eval`` of the
       dyn run and ``counterfactual`` of the conditional run (sweep 0, 0.25,
       0.5, 0.75, 1) on the dumps, every number finite, the condition
       moving the prediction, and the card's report equal to the same
       tool's ``--platform cpu`` report (numbers within atol 1e-4; keys,
       booleans, counts and strings exactly); (k4) ``accuracy_suite`` of
       the four runs on the shock corpus, four sections, every number
       finite. After (j), in (j)'s temporary directory: (k5)
       ``rerender_dataset`` of (j2)'s first object (10 sequences x 50
       frames at 640 x 480), batch 128: every frame within a mean of 6
       counts of the dumped tactile frame, and the read / render / write
       split; (k6) ``bullet_diff`` of ``demo --device-physics`` against
       itself (ok, position and image diffs 0), then ``--skip-run`` on a
       winebottle and a bowl demo dump with tight tolerances (exit 1,
       failures named). (k1)-(k6) launch no kernel of the port.
   (l) data parallelism (``mmdyn_tpu_torch/parallel``), after (k) part 1 in
       (f)'s temporary directory: (l1) ``cli.main --num-devices 1`` (a
       one-rank NCCL group) on (f)'s corpus and flags, its parameters equal
       to (f)'s first run's bit for bit, 1 PoE and 2 BCE launches per
       forward; then the seq flagship's bare step at batch 512 in a one-rank
       NCCL group with the default algorithms: ms/step against (a)'s, the
       collectives per step, and the NCCL kernels' device time from a
       profile. (l2) two ranks spawned on ``cuda:0``, joined by gloo (NCCL
       refuses two ranks on one card): the seq flagship at full width
       (latent 256, float32), 256 of the global 512 rows each, 4 steps from
       one state against one process on the global batch (every step's
       loss within rel 1e-4, the first step's gradients within 1e-4 and the
       parameters within 1e-3 in relative L2 norm, their largest single gap
       printed beside the one process's own gaps under cuDNN's default
       algorithms), the counters in each rank read 1 PoE and 2 BCE
       launches per step, ms/step, peak GiB and the collectives per step of
       each rank, and one more step with every all-reduce timed between
       synchronisations (gloo's share of the step). (l3) in the same two
       ranks, ``InferenceSession(mesh=)`` predicts the 64-row serving batch
       within atol 1e-5 of one process. (l2)'s runs draw their dropout masks
       and noise from one pinned CPU generator (``pinned_draws``). (l4)
       ``cli.main --num-devices`` one more than the visible cards exits
       non-zero, naming both counts. (l5) serving across ranks: (f)'s run
       served over HTTP at batch 64 by one process, then by two gloo ranks
       sharing ``cuda:0`` (rank 0 serves and posts to itself, rank 1
       follows): /predict at 1 and 64 rows, /predict?sample=1, /rollout of 8
       rows, /sample, each reply within 1 uint8 level and atol 1e-5 of one
       process's (/sample equal), and the /predict round trip of both at 1
       and 64 rows. (l6) in the same ranks, ``export_session`` at batch 8:
       rank 0's one-device artifact equals the one-process card artifact's
       outputs bit for bit; ``aot_predict`` on the card group refuses. (l7)
       ``multihost_smoke --spawn 2`` on the card (losses within 1e-5 of its
       golden run) while the first step of (l2)'s reference runs in float64
       on the host CPU: each float32 run's first-step gradients (one
       process, (l2)'s rank 0, the floor) at their relative L2 distance to
       it, over all tensors and per tensor. Two ranks on one card are no
       evidence of scaling.
   (m) convergence: ``mmdyn_tpu_torch.tools.elbo_parity.main`` in process,
       after (k) part 2 in (j)'s temporary directory, the port's production
       step against the reference-semantics golden model (``tools/gold.py``,
       float32, the reference's 7 sequential subset passes) on the same
       batches, Adam and KL schedule; synthetic runs at 4 frames, latent 64,
       lr 1e-3, anneal 3; every gated run under cuDNN's deterministic
       algorithms; the counters set to 0 around each run and held to 1 PoE
       and 2 BCE launches per port MVAE step (bf16 BCE under
       ``bfloat16_full``), none for the regressor. (m1) 64 sequences, batch
       8, 30 epochs, ``--shared-init --noise-free --no-dropout``: the first
       epoch within 1e-5 of the golden run and every epoch within 1% (the
       epochs inside the JAX record's 0.15% counted, a reading); then twice
       with the default algorithms (the run-to-run gap at epoch 30, a
       reading). (m2)
       ``docs/PARITY.md``'s conditional run (64 x 4, batch 8, 30 epochs, free
       noise and dropout): the last-5 mean within 1% of the golden run's and
       of ``docs/convergence/parity_conditional.json``'s ``jax_elbo``. (m3)
       dyn_modeling 32 x 4, batch 8, 15 epochs: last-5 means within 1%.
       (m4) the regressor, controlled, 3 epochs: every epoch within 1e-4;
       then ``--seeds 0,1,2,3``, 30 epochs (a reading). (m5) (m2)'s
       unconditional run under ``bfloat16_full``: finite and falling, its
       drift from the float32 golden run a reading. (m6) (j2)'s compiled
       exp_1 corpus, latent 256, batch 4, 30 epochs, anneal 15: last-5 means
       within 1%. The gates read the unrounded trajectories.
   (n) the reference configuration (``docs/PARITY.md:673-730``) through the
       normal entry points, each stage a fresh process (``python -c`` of
       the entry point's ``main``, printing its kernel counters after), in
       a temporary directory of its own: (n1) ``exp_1_flat_plane
       --device-physics`` at the record's flags (16 objects, 10 trials, 300
       steps, interval 15) with a 17th catalog object as the record's
       top-up (160 dumps would leave 127 train sequences: no step at batch
       128), ``MMDYN_GEN_TRACE=1``: wall seconds, the stage split, every
       sequence 20 snapshots of each stream. (n2) ``cli.main`` at the
       reference defaults (latent 256, batch 128, 100 epochs, anneal 50,
       ``--bf16-full``, image and checkpoint intervals 10) on the dumps (the
       CLI compiles them): 100 PoE and 200 bf16 BCE launches (one step an
       epoch, no validation batch, as in the record); then ``plot_run``:
       ``monotone_after_warmup``, epoch 0 within 2% and the last-5 mean
       within 1% of ``docs/convergence/refcfg_exp1*``'s, the loop's
       frames/s (a reading). (n3) ``cli.evaluate --batchsize 16`` (the
       record's 2 test batches): the test loss per batch within 1% of the
       record's, the pose, tactile and visual measures beside it. (n4) (n2)'s
       flags at 20 epochs (cut from 100), uninterrupted and sent SIGTERM
       once its metrics hold 8 step losses, then ``--resume``d: the final
       parameters, Adam's state and the generator bit for bit, every step's
       loss and the replayed epochs' validation losses equal. (n5) a fresh
       process trains the seq flagship one epoch at batch 512 through
       ``cli.main`` under float32 and ``bfloat16_full``, then runs the
       loop's step twice from one state (0.0, with nothing set around it)
       and the unwrapped step (torch's defaults, a reading), both timed in
       turns.
6. A ``kernels`` JSON line, the card's name and power limit from nvidia-smi,
   and last the result line.

Without a CUDA device the script prints no result and exits 1.
"""

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import pickle
import signal
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


@contextlib.contextmanager
def pinned_draws(seed=11):
    """Inside the block the MVAE train step's random numbers (the dropout
    masks of ``models/layers.py`` and the subsets' noise of
    ``problems/reconstruction.py``, both drawn through
    ``parallel.mesh.global_draw``) come from one CPU generator seeded once,
    in float32, at the global shape with this rank's rows kept, then moved
    to the step's device and dtype: the same numbers on the card and on the
    CPU, in float32 and in float64, in one process and in every rank. The
    uniforms are odd multiples of 2^-17, so a dropout mask (``u < 0.9``)
    compares alike in float32 and float64."""
    from mmdyn_tpu_torch.models import layers
    from mmdyn_tpu_torch.parallel.mesh import active_mesh
    from mmdyn_tpu_torch.problems import reconstruction

    gen = torch.Generator().manual_seed(seed)

    def pinned(real, sample):
        def global_draw(draw, shape, dim=0):
            like = real(draw, shape, dim)          # this rank's block, as placed
            mesh = active_mesh()
            rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
            n = like.shape[dim]
            full = like.shape[:dim] + (n * size,) + like.shape[dim + 1:]
            return sample(full).narrow(dim, rank * n, n).to(like.device, like.dtype)
        return global_draw

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (torch.floor(u * 2**16) + 0.5) / 2**16

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    saved = layers.global_draw, reconstruction.global_draw
    layers.global_draw = pinned(saved[0], uniform)
    reconstruction.global_draw = pinned(saved[1], normal)
    try:
        yield
    finally:
        layers.global_draw, reconstruction.global_draw = saved


@contextlib.contextmanager
def relu_signs(model, signs):
    """Inside the block each ``nn.ReLU`` of ``model`` (the pose encoder's and
    decoder's MLPs; the image paths use swish) records into ``signs[name]``
    its first input's ``x > 0`` on the CPU: the side of the kink each
    element took, which (l7) compares across runs."""
    def hook(name):
        def record(module, args, out):
            if name not in signs:
                signs[name] = (args[0] > 0).cpu()
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()
               if isinstance(m, torch.nn.ReLU)]
    try:
        yield signs
    finally:
        for h in handles:
            h.remove()


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
             top=40, determinism_rows=()):
    """One path on the card: ``steps`` train steps on one synthetic batch
    (the first also warms up, the others are timed), the kernel counters set
    to 0 just before and read just after and held to ``per_step`` launches
    per step, losses finite and falling; then ``determinism_reading`` on the
    batch's first rows for each count in ``determinism_rows``; then
    ``profile_steps`` profiled steps. Returns the path's summary for the
    result lines."""
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
    for rows in determinism_rows:
        out[f"determinism_{rows}"] = determinism_reading(
            label, step, state, {k: v[:rows] for k, v in batch.items()}, gen, kl, card)
    if profile_steps:
        out.update(profile(step, state, batch, gen, kl, steps=profile_steps, top=top))
    del state, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def conv_calls(step, state, batch, gen, kl):
    """The convolutions one train step issues (``aten.convolution`` and its
    backward) with their arguments, captured by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    calls = []

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (aten.convolution.default, aten.convolution_backward.default):
                calls.append((func, args, kwargs or {}))
            return out

    with Capture():
        step(state, batch, gen, kl)
    torch.cuda.synchronize()
    return calls


def determinism_reading(label, step, state, batch, gen, kl, card, steps=4):
    """Which convolutions of one train step rerun to other bits with cuDNN's
    default algorithms, and what its deterministic ones cost. Each
    convolution the step issues is replayed three times with each setting;
    the outputs (a forward's result, a backward's data and weight gradients;
    cuDNN runs a transposed convolution's forward as a data gradient) that
    differ between replays are counted by layer family and output, and the
    replays' device time summed per setting. Then ms/step over ``steps``
    steps with each setting, in turns (default, deterministic,
    deterministic, default). Under the deterministic algorithms every
    output must replay bit for bit."""
    aten = torch.ops.aten
    calls, differ = {}, {"default": {}, "deterministic": {}}
    conv_ms = {"default": 0.0, "deterministic": 0.0}
    for func, args, kwargs in conv_calls(step, state, batch, gen, kl):
        backward = func is aten.convolution_backward.default
        family = "decoder convT" if args[7 if backward else 6] else "encoder conv"
        names = ("data grad", "weight grad", "bias grad") if backward else ("forward",)
        for setting, det in (("default", False), ("deterministic", True)):
            with deterministic_cudnn(det):
                outs = [func(*args, **kwargs) for _ in range(3)]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                func(*args, **kwargs)
                end.record()
                end.synchronize()
            conv_ms[setting] += start.elapsed_time(end)
            outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
            for i, name in enumerate(names):
                if outs[0][i] is None:
                    continue
                key = f"{family} {name}"
                calls[key] = calls.get(key, 0) + (setting == "default")
                n = any(not torch.equal(outs[0][i], o[i]) for o in outs[1:])
                differ[setting][key] = differ[setting].get(key, 0) + n
    step_ms = {"default": [], "deterministic": []}
    for setting in ("default", "deterministic", "deterministic", "default"):
        with deterministic_cudnn(setting == "deterministic"):
            step(state, batch, gen, kl)            # the setting's algorithms, warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch, gen, kl)
            torch.cuda.synchronize()
        step_ms[setting].append((time.perf_counter() - t0) * 1e3 / steps)
    rows = next(iter(batch.values())).shape[0]
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    say(f"[5/6] {label} determinism at batch {rows} on {card}: outputs that rerun to "
        f"other bits with cuDNN's default algorithms: "
        + (", ".join(f"{k} {n}/{calls[k]}" for k, n in differ["default"].items() if n)
           or "none")
        + f" (of {', '.join(f'{k} {n}' for k, n in calls.items())}); with the "
        f"deterministic algorithms: "
        + (", ".join(f"{k} {n}" for k, n in differ["deterministic"].items() if n) or "none")
        + f"; the convolutions' device ms {conv_ms['default']:.3f} default, "
        f"{conv_ms['deterministic']:.3f} deterministic; ms/step in turns "
        f"{[round(t, 3) for t in step_ms['default']]} default, "
        f"{[round(t, 3) for t in step_ms['deterministic']]} deterministic "
        f"({mean['deterministic'] / mean['default'] - 1:+.1%})")
    if any(differ["deterministic"].values()):
        raise AssertionError(f"{label}: with cuDNN's deterministic algorithms these "
                             f"convolutions replay to other bits: {differ['deterministic']}")
    return {"calls": calls, "differ_default": differ["default"], "conv_ms": conv_ms,
            "step_ms": step_ms}


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


def step_rerun_diff(problem, step=None):
    """One train step of ``problem`` (its own, or ``step``) run twice from the
    same model, optimizer and generator state on the same batch: the largest
    parameter difference between the two results (0.0 if the card step is
    deterministic) and the names of the parameters that differ."""
    from mmdyn_tpu_torch.data.loader import to_device_batch

    state, gen = problem.state, problem.generator
    step = step or problem.train_step
    model_sd = copy.deepcopy(state.model.state_dict())
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    gen_sd = gen.get_state()
    batch = to_device_batch(next(iter(problem.train_loader)), problem.device)
    results = []
    for _ in range(2):
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(copy.deepcopy(opt_sd))   # Adam updates in place
        gen.set_state(gen_sd)
        step(state, batch, gen, 1.0)
        results.append(copy.deepcopy(state.model))
    diffs = param_diffs(*results)
    return max(diffs.values()), sorted(name for name, d in diffs.items() if d > 0)


@contextlib.contextmanager
def repair_bypassed():
    """Inside the block a training ``Problem`` built on the card keeps
    torch's default cuDNN algorithms, as the loop did before its steps
    selected the deterministic ones: the baseline of the repair's cost and
    of its effect, for readings only."""
    from unittest import mock

    from mmdyn_tpu_torch.train import loop

    with deterministic_cudnn(False), mock.patch.object(
            loop, "cudnn_deterministic", lambda fn, device: fn):
        yield


@contextlib.contextmanager
def deterministic_cudnn(enabled=True):
    """cuDNN's deterministic algorithms inside the block only, for the steps
    built outside a training ``Problem`` (whose steps select them
    themselves): the bare paths run with torch's defaults. With ``enabled``
    False the block runs with the default algorithms, whatever the process
    set before (a serving session, (g), selects the deterministic ones for
    the process)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = enabled
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


def cli_argv(tmp):
    """(f)'s flags: the seq flagship on (f)'s corpus, batch 512."""
    return ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose", "--dataset-path",
            str(tmp / "ds"), "--batchsize", "512", "--dtype", "auto",
            "--no-tensorboard", "--logs-root", str(tmp / "logs")]


def cli_path(kernels, card, bare_frames_per_s, tmp):
    """(f): the training CLI in process on a corpus written for it under
    ``tmp``, whose steps run cuDNN's deterministic algorithms on the card:
    one step run twice from one state and a second uninterrupted run must
    equal the first bit for bit; a run with the repair bypassed (the
    default algorithms: the loop's cost and the probe's gap without it); a
    1-epoch run whose checkpoint is restored and compared, and its
    ``--resume`` to epoch 2, bit for bit the uninterrupted run; then the
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
    argv = cli_argv(tmp)
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
    with repair_bypassed():
        bypassed = cli_main.main(argv + ["--num-epochs", "2", "--log-dir",
                                         str(tmp / "bypassed")])
        raw_step_diff, raw_differing = step_rerun_diff(bypassed)
    raw_fps = bypassed._logger_dict["Perf/frames_per_sec"]
    say(f"[5/6] (f) determinism: the loop's step run twice from one state differs by "
        f"{step_diff!r} (max |param|), two uninterrupted 2-epoch runs by {rerun_diff!r}; "
        f"with the repair bypassed (torch's default cuDNN algorithms) the step reruns "
        f"to {raw_step_diff!r} in {len(raw_differing)} parameters "
        f"({raw_differing[:6]}...); loop frames/s by epoch {fps} deterministic, "
        f"{raw_fps} default ({fps[-1] / raw_fps[-1] - 1:+.1%} at epoch 2)")

    first = cli_main.main(argv + ["--num-epochs", "1", "--log-dir", str(tmp / "resumed")])
    n_restored = check_restore(first)
    resumed = cli_main.main(argv + ["--num-epochs", "2", "--log-dir", str(tmp / "resumed"),
                                    "--resume"])
    resume_diff = max_param_diff(final, resumed.state.model)
    say(f"[5/6] (f) resume: the 1-epoch run's 'latest' restored into a fresh state on "
        f"the card equals the run's state bit for bit ({n_restored} tensors: parameters, "
        f"Adam moments and step counts; the step, the epoch and the generator's state); "
        f"1 epoch + --resume to 2 vs uninterrupted: {resume_diff!r}")
    if step_diff != 0.0 or rerun_diff != 0.0 or resume_diff != 0.0:
        raise AssertionError(f"(f): one step reruns to {step_diff!r}, a second run to "
                             f"{rerun_diff!r} and the resumed run to {resume_diff!r} from "
                             f"the uninterrupted one; each must be 0")

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
    det_params = {k: v.detach().cpu().clone() for k, v in final.state_dict().items()}
    del run, again, bypassed, first, resumed, final
    torch.cuda.empty_cache()
    return {"frames_per_s": fps, "launches": launches, "step_rerun_diff": step_diff,
            "rerun_diff": rerun_diff, "resume_diff": resume_diff,
            "default_algorithms": {"step_rerun_diff": raw_step_diff,
                                   "frames_per_s": raw_fps},
            "_det_params": det_params}


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
            "rgb_apart": rgb_share, "tactile_apart": tac_share, "launches": launches,
            "_chunk": first}


GEN_OBJECTS = 2                  # (j2): exp_1's --n_objects cut from 8
GEN_SNAPSHOTS = DROP_STEPS // INTERVAL
# (j3): the argv of the JAX package's CLI tests (tests/test_physics_jax.py:131-225)
PARITY_ARGV = {
    "exp_1_flat_plane": ["--n_objects", "2", "--trial_per_obj", "1", "--n_timesteps", "40",
                         "--interval", "10", "--seed", "5"],
    "exp_2_inclined_plane": ["--n_objects", "1", "--trial_per_obj", "2", "--n_timesteps",
                             "60", "--interval", "10", "--seed", "4", "--slope", "0.2"],
    "exp_3_force_pert": ["--n_objects", "1", "--trial_per_obj", "2", "--n_timesteps", "200",
                         "--interval", "10", "--snapshot_from", "100", "--seed", "9",
                         "--force", "0.05"],
    "demo": ["--n_timesteps", "60", "--interval", "10", "--object", "winebottle"],
}


def wire_path(frames, card):
    """(j1): the run-length wire on one 128-frame chunk of (i), folded as
    ``DeferredFrames._dispatch_chunk`` folds it (``rgb | depth_png << 24``,
    ``tactile | seg_png << 24``, row_len 640, planes 4): encode (device ms
    between CUDA events, and the host's enqueue), ``get_raw`` against the
    pageable download of the raw streams, the host decode; the decoded
    streams must equal the downloaded ones bit for bit."""
    from mmdyn_tpu_torch.utils.wire import RunLengthWire, pack_rgb

    n, h, wd = frames["rgb"].shape[:3]
    s0 = pack_rgb(frames["rgb"]) | (frames["depth_png"].to(torch.int32).reshape(n, -1) << 24)
    s1 = pack_rgb(frames["tactile"]) | (frames["seg_png"].to(torch.int32).reshape(n, -1) << 24)
    wire = RunLengthWire()
    wire.get_raw(wire.encode([s0, s1], row_len=wd, planes=4))     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    encode_ms, enqueue_ms, get_raw_ms, raw_dl_ms = [], [], [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        handle = wire.encode([s0, s1], row_len=wd, planes=4)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        encode_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        raw = wire.get_raw(handle)
        get_raw_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain = [s.cpu().numpy().view(np.uint32) for s in (s0, s1)]
        raw_dl_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    decoded = RunLengthWire.decode(raw)
    decode_ms = (time.perf_counter() - t0) * 1e3
    if "fallback" in raw or not all(np.array_equal(a, b) for a, b in zip(decoded, plain)):
        raise AssertionError("(j1): the decoded streams differ from the downloaded ones")
    runs = int(handle["n_runs"])
    wire_mb, raw_mb = runs * 6 / 1e6, sum(s.numel() * 4 for s in (s0, s1)) / 1e6
    prof, _ = device_profile(lambda: wire.encode([s0, s1], row_len=wd, planes=4),
                             f"(j1) encode of one chunk of {n} frames")
    say(f"[5/6] (j1) wire on {card}: {n} frames x 2 streams ({n * h * wd * 2:,} elements): "
        f"encode {' / '.join(f'{x:.2f}' for x in encode_ms)} ms on the device (host enqueue "
        f"{' / '.join(f'{x:.2f}' for x in enqueue_ms)} ms); {runs:,} runs, {wire_mb:.2f} MB "
        f"on the wire against {raw_mb:.1f} MB raw; get_raw "
        f"{' / '.join(f'{x:.1f}' for x in get_raw_ms)} ms against the pageable raw download "
        f"{' / '.join(f'{x:.1f}' for x in raw_dl_ms)} ms; host decode {decode_ms:.1f} ms; "
        f"peak {peak_gib:.2f} GiB; decoded == downloaded bit for bit")
    return {"frames": n, "encode_ms": encode_ms, "enqueue_ms": enqueue_ms, "runs": runs,
            "wire_mb": wire_mb, "raw_mb": raw_mb, "get_raw_ms": get_raw_ms,
            "raw_download_ms": raw_dl_ms, "decode_ms": decode_ms, "peak_gib": peak_gib,
            "encode_profile": prof}


def gen_path(card, tmp):
    """(j2): exp_1 through the port's CLI in process at its defaults
    (--n_timesteps 500 --interval 10 --trial_per_obj 10) with --device-physics
    on the card, the object count cut to ``GEN_OBJECTS``, under
    ``MMDYN_GEN_TRACE=1``; every kept sequence must hold 50 snapshots of each
    stream; then the native compile of the dumps must give (kept - 1)
    sequences of 50 frames."""
    import cv2

    from mmdyn_tpu_torch.cli import exp_1_flat_plane
    from mmdyn_tpu_torch.data.compile import compile_dataset, load_packed

    gen = tmp / "gen"
    argv = ["--device-physics", "--engine", "analytic", "--headless", "--seed", "0",
            "--n_objects", str(GEN_OBJECTS), "--logdir", str(gen / "dataset")]
    trace = io.StringIO()
    old = os.environ.get("MMDYN_GEN_TRACE")
    os.environ["MMDYN_GEN_TRACE"] = "1"
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(trace):
            exp_1_flat_plane.main(argv)
        wall_s = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["MMDYN_GEN_TRACE"]
        else:
            os.environ["MMDYN_GEN_TRACE"] = old
    lines = [ln for ln in trace.getvalue().splitlines() if ln.startswith("# ")]
    stages = {}
    for ln in lines:
        if ln.startswith("# gen-trace"):
            for part in ln.split(": ", 1)[1].split()[1:]:
                key, val = part.split("=")
                stages[key] = stages.get(key, 0.0) + float(val.rstrip("s"))
    seqs = sorted((gen / "dataset").glob("*/*/sequence_*"))
    for seq in seqs:
        data = json.loads((seq / "data.json").read_text())
        counts = [len(list(seq.glob(f"{stem}_*.png")))
                  for stem in ("visual", "tactile", "seg", "depth")]
        if len(data["time_step"]) != GEN_SNAPSHOTS or counts != [GEN_SNAPSHOTS] * 4:
            raise AssertionError(f"(j2): {seq}: {len(data['time_step'])} snapshots, PNGs {counts}")
    img = cv2.imread(str(seqs[0] / f"visual_{GEN_SNAPSHOTS - 1:04d}.png"))
    if len(seqs) < 2 or img is None or img.shape != (480, 640, 3):
        raise AssertionError(f"(j2): {len(seqs)} sequences kept; a visual PNG reads "
                             f"{None if img is None else img.shape}")
    trials = GEN_OBJECTS * 10
    t0 = time.perf_counter()
    corpus = load_packed(compile_dataset(gen, seed=0, engine="native", verbose=False,
                                         compiled_name="compiled.npz"))
    compile_s = time.perf_counter() - t0
    if corpus["visual"].shape != (len(seqs) - 1, GEN_SNAPSHOTS, 64, 64, 3):
        raise AssertionError(f"(j2): the compiled corpus is {corpus['visual'].shape}")
    snaps = len(seqs) * GEN_SNAPSHOTS
    for ln in lines:
        say(f"  {ln}")
    say(f"[5/6] (j2) exp_1 --device-physics on {card}: {GEN_OBJECTS} objects x 10 trials x "
        f"{DROP_STEPS} steps in {wall_s:.2f} s ({trials / wall_s:.2f} trials/s); "
        f"{len(seqs)} sequences kept, {snaps} snapshots x 4 PNGs ({snaps / wall_s:.1f} "
        f"snapshots written/s); stages summed: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; the native compile of the dumps: {corpus['visual'].shape[0]} sequences x "
        f"{GEN_SNAPSHOTS} frames in {compile_s:.2f} s")
    return {"wall_s": wall_s, "trials_per_s": trials / wall_s, "sequences": len(seqs),
            "snapshots_per_s": snaps / wall_s, "stages_s": stages, "compile_s": compile_s}


def parity_path(tmp):
    """(j3): demo and exp_{1,2,3} with --device-physics (on the card) against
    their own host paths, and demo --device-render, at the argv and bounds of
    the JAX package's tests (tests/test_physics_jax.py:131-225,
    tests/test_tactile_jax.py:62-94)."""
    import importlib

    import cv2

    seconds = {}
    for cli, argv in PARITY_ARGV.items():
        main = importlib.import_module(f"mmdyn_tpu_torch.cli.{cli}").main
        argv = argv + ["--engine", "analytic", "--headless"]
        host, dev = tmp / cli / "host", tmp / cli / "dev"
        main(argv + ["--logdir", str(host)])
        t0 = time.perf_counter()
        main(argv + ["--device-physics", "--logdir", str(dev)])
        seconds[cli] = time.perf_counter() - t0
        host_seqs = sorted(p.parent for p in host.glob("**/data.json"))
        dev_seqs = sorted(p.parent for p in dev.glob("**/data.json"))
        if not host_seqs or [s.relative_to(host) for s in host_seqs] != \
                [s.relative_to(dev) for s in dev_seqs]:
            raise AssertionError(f"(j3) {cli}: layouts differ")
        atol = 2e-3 if cli in ("exp_1_flat_plane", "demo") else 5e-3
        for hs, ds in zip(host_seqs, dev_seqs):
            dh = json.loads((hs / "data.json").read_text())
            dd = json.loads((ds / "data.json").read_text())
            assert dh["time_step"] == dd["time_step"], (cli, hs)
            np.testing.assert_allclose(dd["position"], dh["position"], atol=atol)
            np.testing.assert_allclose(dd["orientation"], dh["orientation"], atol=1e-6)
            if "force" in dh:
                np.testing.assert_allclose(dd["force"], dh["force"], rtol=0.05, atol=1.0)
            if "shock" in dh:
                np.testing.assert_allclose(dd["shock"], dh["shock"], rtol=1e-12)
            last = len(dh["time_step"]) - 1
            for stem in ("visual", "tactile", "seg", "depth"):
                if not (ds / f"{stem}_{last:04d}.png").exists():
                    raise AssertionError(f"(j3) {cli}: no {stem}_{last:04d}.png in {ds}")
    # demo --device-render against the host path (tests/test_tactile_jax.py:62-94)
    from mmdyn_tpu_torch.cli import demo

    argv = ["--headless", "--engine", "analytic", "--n_timesteps", "120", "--interval", "20",
            "--seed", "3", "--object", "bowl"]
    host, dev = tmp / "render" / "host" / "dataset", tmp / "render" / "dev" / "dataset"
    demo.main(argv + ["--logdir", str(host.parent)])
    t0 = time.perf_counter()
    demo.main(argv + ["--device-render", "--logdir", str(dev.parent)])
    seconds["demo --device-render"] = time.perf_counter() - t0
    worst = {"within_1": 1.0, "depth": 0, "seg": 0.0}
    for k in range(6):
        for stream in ("tactile", "visual"):
            a, b = (cv2.imread(str(d / f"{stream}_{k:04d}.png")).astype(int) for d in (host, dev))
            worst["within_1"] = min(worst["within_1"], float((np.abs(a - b) <= 1).mean()))
        a, b = (cv2.imread(str(d / f"depth_{k:04d}.png")).astype(int) for d in (host, dev))
        worst["depth"] = max(worst["depth"], int(np.abs(a - b).max()))
        a, b = (cv2.imread(str(d / f"seg_{k:04d}.png")) for d in (host, dev))
        worst["seg"] = max(worst["seg"], float((a != b).mean()))
    if worst["within_1"] <= 0.998 or worst["depth"] > 1 or worst["seg"] >= 0.002:
        raise AssertionError(f"(j3) demo --device-render against the host path: {worst}")
    say("[5/6] (j3) device paths against the host paths at the JAX tests' argv and bounds: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; demo --device-render: visual / tactile within 1 on >= {worst['within_1']:.5f}, "
        f"depth within {worst['depth']}, seg mismatch {worst['seg']!r}")
    return {"device_s": seconds, "render_worst": worst}


def simcli_path(kernels, card, frames, tmp):
    """(j): the simulator's dump CLIs on the card, the kernel counters set to
    0 before and read after: (j1) the wire, (j2) exp_1's data generation
    through the CLI, (j3) the device paths against the host paths. No kernel
    of the port launches."""
    t0 = time.perf_counter()
    reset_counters(kernels)
    out = {"wire": wire_path(frames, card), "gen": gen_path(card, tmp),
           "parity": parity_path(tmp)}
    out["launches"] = read_counters(kernels)
    if any(out["launches"].values()):
        raise AssertionError(f"(j): kernel launches {out['launches']}, expected none")
    out["seconds"] = time.perf_counter() - t0
    say(f"[5/6] (j) the dump CLIs took {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# (k): the tools of mmdyn_tpu_torch/tools on the card
SHOCK_SEQS, SHOCK_FRAMES, TOOL_BATCH = 520, 4, 64     # (k0): the shock corpus, its batch
K0_RUNS = {   # (k0): the runs the tools evaluate, trained through cli.main
    "reg": ["--problem-type", "regression", "--model-name", "regressor",
            "--input-type", "visual"],
    "seq": ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose"],
    "dyn": ["--problem-type", "dyn_modeling", "--model-name", "cnn-mvae",
            "--input-type", "visuotactile", "--use-pose"],
    "cond": ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
             "--input-type", "visuotactile", "--use-pose", "--conditional"],
}
CPU = ["--platform", "cpu"]


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept out of the script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def numbers(report, where="report"):
    """(path, value) of every number of a nested report."""
    if isinstance(report, dict):
        return [x for k, v in report.items() for x in numbers(v, f"{where}.{k}")]
    if isinstance(report, (list, tuple)):
        return [x for i, v in enumerate(report) for x in numbers(v, f"{where}[{i}]")]
    if isinstance(report, (int, float)) and not isinstance(report, bool):
        return [(where, report)]
    return []


def report_gap(card, cpu, where="report"):
    """The largest |card - cpu| over the numbers of two reports of one tool;
    raises where their keys, lengths, booleans, counts or strings differ."""
    if isinstance(cpu, dict):
        if set(card) != set(cpu):
            raise AssertionError(f"(k3) {where}: keys {sorted(set(card) ^ set(cpu))}")
        return max([report_gap(card[k], cpu[k], f"{where}.{k}") for k in cpu] + [0.0])
    if isinstance(cpu, (list, tuple)):
        if len(card) != len(cpu):
            raise AssertionError(f"(k3) {where}: lengths {len(card)} vs {len(cpu)}")
        return max([report_gap(a, b, f"{where}[{i}]")
                    for i, (a, b) in enumerate(zip(card, cpu))] + [0.0])
    if isinstance(cpu, float):
        return abs(card - cpu)
    if type(card) is not type(cpu) or card != cpu:
        raise AssertionError(f"(k3) {where}: card {card!r} vs cpu {cpu!r}")
    return 0.0


def train_tool_runs(kernels, tmp):
    """(k0): a shock corpus of 520 x 4 frames written by
    ``make_compiled_arrays``, and the four runs the tools evaluate trained on
    it through ``cli.main`` for 1 epoch at batch 64, float32, latent 256,
    the counters read around each (the MVAE runs launch 1 PoE and 2 BCE per
    forward, the regressor none); then simulator-shaped dumps of 2 sequences
    x 10 frames at 480 x 640 for (k3)."""
    from mmdyn_tpu_torch.cli import main as cli_main
    from mmdyn_tpu_torch.data.compile import COMPILED_NAME
    from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays, make_synthetic_dumps

    t0 = time.perf_counter()
    make_compiled_arrays(tmp / "shock" / COMPILED_NAME, n_sequences=SHOCK_SEQS,
                         seq_length=SHOCK_FRAMES, with_shock=True, seed=0, packed_dir=True)
    corpus_s = time.perf_counter() - t0
    out = {"corpus_s": corpus_s, "runs": {}}
    total = dict(ZERO_LAUNCHES)
    for name, argv in K0_RUNS.items():
        reset_counters(kernels)
        t0 = time.perf_counter()
        run = quiet(cli_main.main, argv + [
            "--dataset-path", str(tmp / "shock"), "--batchsize", str(TOOL_BATCH),
            "--num-epochs", "1", "--dtype", "float32", "--no-tensorboard",
            "--log-dir", str(tmp / f"tool_{name}"), "--logs-root", str(tmp / "logs")])
        wall_s = time.perf_counter() - t0
        launches = read_counters(kernels)
        forwards = len(run.train_loader) + len(run.test_loader)
        per = 0 if name == "reg" else forwards
        if launches != {"poe_reparam": per, "bce_sum": 2 * per, "bce_sum_bf16": 0}:
            raise AssertionError(f"(k0) {name}: kernel launches {launches} over {forwards} "
                                 f"forwards")
        losses = run._logger_dict["Loss/train_epoch"] + run._logger_dict["Loss/validation_epoch"]
        if not all(math.isfinite(v) for v in losses) or run.cfg.latent_size != 256:
            raise AssertionError(f"(k0) {name}: losses {losses}, latent {run.cfg.latent_size}")
        total = {k: total[k] + v for k, v in launches.items()}
        out["runs"][name] = {"wall_s": wall_s, "forwards": forwards, "launches": launches,
                             "losses": losses}
        del run
    t0 = time.perf_counter()
    make_synthetic_dumps(tmp / "tool_dumps", n_sequences=2, seq_length=10,
                         image_size=(480, 640), seed=0)
    out["dumps_s"] = time.perf_counter() - t0
    out["launches"] = total
    say(f"[5/6] (k0) shock corpus {SHOCK_SEQS} x {SHOCK_FRAMES} written in {corpus_s:.2f} s; "
        f"cli.main 1 epoch at batch {TOOL_BATCH}, float32, latent 256: "
        + "; ".join(f"{n} {r['wall_s']:.2f} s, {r['forwards']} forwards, launches "
                    f"{r['launches']}" for n, r in out["runs"].items())
        + f"; dumps 2 x 10 at 480 x 640 in {out['dumps_s']:.2f} s")
    return out


def tool_reports(tmp):
    """(k1)-(k4): the serving benches on (f)'s run, ``rollout_eval`` and
    ``counterfactual`` on the card and on the CPU, ``accuracy_suite`` on the
    shock corpus. Returns the benches' rows, the card vs CPU gaps and the
    seconds of each."""
    from mmdyn_tpu_torch.tools import (accuracy_suite, bench_http, bench_infer,
                                       counterfactual, rollout_eval)

    out = {"seconds": {}}
    t0 = time.perf_counter()
    out["bench_infer"] = quiet(bench_infer.main, ["--run", str(tmp / "run"), "--batch-sizes",
                                                  "1,8,64,256", "--iters", "30",
                                                  "--rollout", "50"])
    out["seconds"]["k1"] = time.perf_counter() - t0
    for row in out["bench_infer"]:
        say(f"[5/6] (k1) bench_infer {json.dumps(row)}")

    t0 = time.perf_counter()
    out["bench_http"] = quiet(bench_http.main, ["--run", str(tmp / "run")])
    out["seconds"]["k2"] = time.perf_counter() - t0
    for row in out["bench_http"]:
        say(f"[5/6] (k2) bench_http {json.dumps(row)}")

    t0 = time.perf_counter()
    seq = sorted(p.parent for p in (tmp / "tool_dumps").glob("**/data.json"))[0]
    argv = {"rollout_eval": ["--run", str(tmp / "tool_dyn"), "--frames", str(seq)],
            "counterfactual": ["--run", str(tmp / "tool_cond"), "--frames", str(seq),
                               "--sweep", "0,0.25,0.5,0.75,1"]}
    for name, tool in (("rollout_eval", rollout_eval), ("counterfactual", counterfactual)):
        card = quiet(tool.main, argv[name])
        cpu = quiet(tool.main, argv[name] + CPU)
        gap = report_gap(card, cpu)
        bad = [p for p, v in numbers(card) if not math.isfinite(v)]
        if bad or gap > 1e-4:
            raise AssertionError(f"(k3) {name}: not finite {bad}; card vs cpu {gap!r}")
        out[name] = {"card_vs_cpu": gap}
        say(f"[5/6] (k3) {name}: card == cpu within {gap!r} (atol 1e-4; booleans, "
            f"counts and keys equal); {json.dumps(card)}")
        if name == "counterfactual" and not card["condition_sensitivity"] > 0:
            raise AssertionError("(k3) counterfactual: the condition moves nothing")
    out["seconds"]["k3"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    acc = quiet(accuracy_suite.main, ["--dataset", str(tmp / "shock")] + [
        a for name in K0_RUNS for a in (f"--{name}-run", str(tmp / f"tool_{name}"))])
    out["seconds"]["k4"] = time.perf_counter() - t0
    bad = [p for p, v in numbers(acc) if not math.isfinite(v)]
    sections = ("regression", "seq_modeling", "dyn_modeling", "conditional")
    if bad or not all(s in acc for s in sections):
        raise AssertionError(f"(k4) accuracy_suite: not finite {bad}, sections {sorted(acc)}")
    say(f"[5/6] (k4) accuracy_suite on the shock corpus ({acc['n_train']} train, "
        f"{acc['n_test']} test sequences) in {out['seconds']['k4']:.2f} s: {json.dumps(acc)}")
    return out


def tools_path(kernels, card, tmp):
    """(k), part 1, in (f)'s temporary directory after (g): (k0) the runs
    the tools evaluate, trained on the card; then (k1)-(k4), which must
    launch no kernel of the port."""
    t0 = time.perf_counter()
    out = {"train": train_tool_runs(kernels, tmp)}
    reset_counters(kernels)
    out.update(tool_reports(tmp))
    tools_launches = read_counters(kernels)
    if any(tools_launches.values()):
        raise AssertionError(f"(k1)-(k4): kernel launches {tools_launches}, expected none")
    out["launches"] = out["train"]["launches"]
    out["seconds"]["total"] = time.perf_counter() - t0
    say(f"[5/6] (k) part 1 on {card} took {out['seconds']['total']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in out['seconds'].items() if k != 'total')}); "
        f"launches: training {out['launches']}, the tools {tools_launches}")
    return out


def rerender_path(tmp):
    """(k5): ``rerender_dataset`` on the first object's sequences of (j2)'s
    dump at exp_1's sensor geometry (the tool's defaults), batch 128, suffix
    ``-re``; every frame's mean |re-rendered - dumped tactile| must stay
    below 6 counts (``tests/test_tools.py::TestRerenderDataset``)."""
    import cv2

    from mmdyn_tpu_torch.tools import rerender_dataset

    first = sorted((tmp / "gen" / "dataset").glob("*/*"))[0]
    (tmp / "rerender").mkdir()
    (tmp / "rerender" / "dataset").symlink_to(first, target_is_directory=True)
    report = quiet(rerender_dataset.main, ["--dataset", str(tmp / "rerender"), "--batch",
                                           "128", "--suffix=-re"])
    diffs = []
    for depth in sorted(first.glob("**/depth_*.png")):
        ours = cv2.imread(str(depth.with_name(depth.name.replace("depth_", "tactile-re_"))))
        dumped = cv2.imread(str(depth.with_name(depth.name.replace("depth_", "tactile_"))))
        diffs.append(float(np.abs(ours.astype(int) - dumped.astype(int)).mean()))
    if len(diffs) != report["frames"] or not diffs or max(diffs) >= 6.0:
        raise AssertionError(f"(k5) rerender_dataset: {report}, {len(diffs)} frames, "
                             f"largest mean diff {max(diffs, default=None)}")
    say(f"[5/6] (k5) rerender_dataset of {first.relative_to(tmp / 'gen')}: {report['frames']} "
        f"frames at 640 x 480 in {report['seconds']} s ({report['frames_per_sec']} frames/s): "
        f"PNG reads {report['host_read_s']} s, render {report['render_s']} s (device), "
        f"download and PNG writes {report['write_s']} s; mean |re-rendered - dumped| per "
        f"frame {np.mean(diffs):.3f} on average, {max(diffs):.3f} at most (bound 6)")
    return {"report": report, "mean_diff": float(np.mean(diffs)), "max_diff": max(diffs)}


def bullet_diff_runs(tmp):
    """(k6): ``bullet_diff`` of demo --device-physics against itself (same
    engine, same seed) must report ok with zero position and image diffs;
    ``--skip-run`` on a winebottle and a bowl demo dump with tight
    tolerances must exit 1 and name failures (the JAX test's argv)."""
    from mmdyn_tpu_torch.cli import demo
    from mmdyn_tpu_torch.tools import bullet_diff

    def run(argv):
        """(report, exit code): the report is the last line the tool prints."""
        buf, code = io.StringIO(), 0
        with contextlib.redirect_stdout(buf):
            try:
                bullet_diff.main(argv)
            except SystemExit as e:
                code = e.code
        return json.loads(buf.getvalue().strip().splitlines()[-1]), code

    t0 = time.perf_counter()
    same, code = run(["--script", "demo", "--engines", "analytic,analytic", "--seed", "3",
                      "--extra=--device-physics", "--workdir", str(tmp / "bd_same")])
    same_s = time.perf_counter() - t0
    seq = same["sequences"][0]
    if code != 0 or not same["ok"] or seq["pos_l2_max"] != 0.0 or \
            seq["visual_mad_max"] != 0.0 or seq["tactile_mad_max"] != 0.0:
        raise AssertionError(f"(k6) bullet_diff same seed: exit {code}, {same}")
    common = ["--headless", "--engine", "analytic", "--n_timesteps", "60", "--interval",
              "20", "--seed", "3"]
    for obj, name in (("winebottle", "a"), ("bowl", "b")):
        quiet(demo.main, common + ["--object", obj, "--logdir", str(tmp / "bd_skip" / name)])
    skip, code = run(["--skip-run", "--engines", "a,b", "--workdir", str(tmp / "bd_skip"),
                      "--tol-pos-final", "1e-6", "--tol-img-mad", "1e-6"])
    if code != 1 or skip["ok"] or not skip["failures"]:
        raise AssertionError(f"(k6) bullet_diff --skip-run: exit {code}, {skip}")
    say(f"[5/6] (k6) bullet_diff demo --device-physics, same engine and seed: ok, "
        f"{seq['frames']} frames, position and image diffs 0 ({same_s:.2f} s for both runs "
        f"and the diff); --skip-run winebottle vs bowl: exit 1, failures {skip['failures']}")
    return {"same_seed_frames": seq["frames"], "same_s": same_s,
            "divergence_failures": len(skip["failures"])}


def tools_dump_path(kernels, card, tmp):
    """(k), part 2, in (j)'s temporary directory after (j): (k5) and (k6),
    which must launch no kernel of the port."""
    t0 = time.perf_counter()
    reset_counters(kernels)
    out = {"rerender": rerender_path(tmp), "bullet_diff": bullet_diff_runs(tmp)}
    out["launches"] = read_counters(kernels)
    if any(out["launches"].values()):
        raise AssertionError(f"(k5)-(k6): kernel launches {out['launches']}, expected none")
    out["seconds"] = time.perf_counter() - t0
    say(f"[5/6] (k) part 2 on {card} took {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# (m): the training-trajectory harness (mmdyn_tpu_torch/tools/elbo_parity.py)
M_SYNTH = ["--n-seq", "64", "--batch", "8", "--epochs", "30"]   # latent 64, anneal 3
M_CONTROLLED = ["--shared-init", "--noise-free", "--no-dropout"]
M_JAX_RECORD = REPO / "docs" / "convergence" / "parity_conditional.json"
# (m1): the first epoch (8 steps, before rounding compounds) within 1e-5; the
# JAX record's band, 0.15% (docs/PARITY.md "Root cause", item 1:
# parity_controlled.json, 128 sequences at batch 64 for 30 epochs, 60 Adam
# steps), over the same first 60 steps, rounded up to whole epochs (0-7, 64
# steps); every epoch within BASELINE.md's 1%. Over the 240 steps the
# record's band is printed, not gated: float32 rounding grows past it (in
# float64 on the CPU the port stays within 1.5e-14 of the golden run over
# all 30 epochs, tests/test_torch_elbo_parity.py::controlled_gaps)
M_STEP_BAND = 1e-5
M_JAX_CONTROLLED_BAND = 1.5e-3
M_JAX_CONTROLLED_STEPS = 60
M_LAST5_BAND = 0.01            # BASELINE.md:36: final ELBO within 1%
M_REGRESSION_BAND = 1e-4       # (m4): docs/PARITY.md, "per-step dynamics are identical"


def last5(history):
    return sum(history[-5:]) / len(history[-5:])


def rel_gap(a, b):
    return abs(a - b) / abs(b)


def parity_run(kernels, label, call, port_steps, mvae=True, bf16=False):
    """One run of the harness on the card, in process (``call()``: its
    ``main`` or its run functions), its report and epoch lines kept out of
    the script's output; the kernel counters set to 0 before and read after,
    held to 1 PoE and 2 BCE launches per port MVAE step (the BCE ones bf16
    under ``bfloat16_full``) and none for the regressor; the golden side
    launches none. Returns (what ``call`` returned, seconds, launches)."""
    reset_counters(kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        got = call()
    seconds = time.perf_counter() - t0
    launches = read_counters(kernels)
    n = port_steps if mvae else 0
    want = {"poe_reparam": n, "bce_sum": 2 * n, "bce_sum_bf16": 2 * n if bf16 else 0}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} over {port_steps} port "
                             f"steps, expected {want}")
    return got, seconds, launches


def trajectories(label, report):
    """The report's trajectories (the port's, per seed or one; the golden
    one), each checked finite."""
    every = dict(report.get("port_elbo_by_seed", {}))
    for key in ("port_elbo", "torch_elbo"):
        if key in report:
            every[key] = report[key]
    if not every or not all(math.isfinite(x) for h in every.values() for x in h):
        raise AssertionError(f"{label}: a trajectory is not finite: {report}")
    return report.get("port_elbo"), report.get("torch_elbo")


def regression_controlled(argv, device):
    """(m4)'s controlled run through the harness's own functions, as
    ``main`` makes it, for the unrounded trajectories: the report's two
    decimals are too coarse for a 1e-4 gate on a loss near 10."""
    from mmdyn_tpu_torch.tools import elbo_parity
    from mmdyn_tpu_torch.utils.device import set_reference_precision

    args = elbo_parity.parse_args(argv)
    set_reference_precision()
    seqs = elbo_parity.make_synthetic_sequences(args.n_seq, args.seq_len)
    model = elbo_parity.port_model(args, 0, device, seed=args.seed)
    golden = elbo_parity.gold_model(args, 0, device, seed=args.seed)
    golden.load_state_dict(model.state_dict())
    return (elbo_parity.run_port(seqs, args, model, device, seed=args.seed),
            elbo_parity.run_torch(seqs, args, golden, device, seed=args.seed))


def convergence_path(kernels, card, tmp):
    """(m): ``elbo_parity.main`` on the card, the port's production step
    against the reference-semantics golden model on the same batches, over
    hundreds of Adam steps; every gated comparison under cuDNN's
    deterministic algorithms. Synthetic runs: 4 frames, latent 64, lr 1e-3,
    anneal 3 (the tool's defaults)."""
    from mmdyn_tpu_torch.tools import elbo_parity

    t0 = time.perf_counter()
    out, total = {}, dict(ZERO_LAUNCHES)
    steps = {}

    def timed(label, call, port_steps, **kw):
        got, secs, launches = parity_run(kernels, label, call, port_steps, **kw)
        for k, v in launches.items():
            total[k] += v
        steps[label] = port_steps
        out.setdefault("seconds", {})[label] = secs
        return got

    def run(label, argv, port_steps, **kw):
        report = timed(label, lambda: elbo_parity.main(argv), port_steps, **kw)
        return (report,) + trajectories(label, report)

    # (m1): controlled; the first epoch within 1e-5 of the golden run, the
    # epochs of the JAX record's first 60 steps within its 0.15%, every epoch
    # within 1%
    with deterministic_cudnn():
        report, port, gold_h = run("m1", M_SYNTH + M_CONTROLLED, 30 * 8)
    gaps = [rel_gap(a, b) for a, b in zip(port, gold_h)]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    early = -(-M_JAX_CONTROLLED_STEPS // 8)      # epochs of 8 steps
    early_worst = max(range(early), key=gaps.__getitem__)
    within = sum(g <= M_JAX_CONTROLLED_BAND for g in gaps)
    if (gaps[0] > M_STEP_BAND or gaps[early_worst] > M_JAX_CONTROLLED_BAND
            or gaps[worst] > M_LAST5_BAND):
        raise AssertionError(f"(m1): epoch 0 is {gaps[0]:.3e} (band {M_STEP_BAND}), epoch "
                             f"{early_worst} {gaps[early_worst]:.3e} (band "
                             f"{M_JAX_CONTROLLED_BAND} over epochs 0-{early - 1}), epoch "
                             f"{worst} {gaps[worst]:.3e} (band {M_LAST5_BAND}) from the golden "
                             f"run: port {port} golden {gold_h}")
    # the same run twice more with cuDNN's default algorithms: a reading
    with deterministic_cudnn(False):
        reruns = [run(f"m1 default algorithms {i}", M_SYNTH + M_CONTROLLED + ["--skip-torch"],
                      30 * 8)[1] for i in (1, 2)]
    free = [h[-1] for h in reruns]
    spread = max(rel_gap(a, b) for x, y in ((reruns[0], reruns[1]), (reruns[0], port),
                                            (reruns[1], port)) for a, b in zip(x, y))
    out["m1"] = {"first_epoch_gap": gaps[0], "early_epochs": early,
                 "early_worst_epoch": early_worst, "early_worst_gap": gaps[early_worst],
                 "worst_epoch": worst, "worst_gap": gaps[worst],
                 "epochs_within_jax_band": within,
                 "final_gap_pct": report["final_gap_pct"], "port_final": port[-1],
                 "golden_final": gold_h[-1], "default_algorithms_finals": free,
                 "run_to_run_gap": rel_gap(free[0], free[1]), "rerun_spread": spread,
                 "to_deterministic": [rel_gap(f, port[-1]) for f in free]}
    say(f"[5/6] (m1) controlled seq_modeling, 64 x 4, batch 8, 30 epochs on {card}: epoch 0 "
        f"is {gaps[0]:.3e} from the golden run (band {M_STEP_BAND}), the worst of epochs "
        f"0-{early - 1} (the JAX record's {M_JAX_CONTROLLED_STEPS} steps) epoch {early_worst} "
        f"{gaps[early_worst]:.3e} (band {M_JAX_CONTROLLED_BAND}), the worst epoch {worst} "
        f"{gaps[worst]:.3e} (band {M_LAST5_BAND}); {within} of {len(gaps)} epochs within the JAX "
        f"record's {M_JAX_CONTROLLED_BAND}; final {port[-1]:.2f} vs {gold_h[-1]:.2f}; with the "
        f"default cuDNN algorithms twice: epoch 30 at {free[0]:.2f} / {free[1]:.2f}, run to run "
        f"{out['m1']['run_to_run_gap']:.3e}, to the deterministic run "
        + " / ".join(f"{g:.3e}" for g in out["m1"]["to_deterministic"])
        + f"; the three runs' widest gap at any epoch {spread:.3e}")

    # (m2): the recorded conditional run; last-5 means within 1% of the golden
    # run and of the JAX package's record
    record = json.loads(M_JAX_RECORD.read_text())["jax_elbo"]
    with deterministic_cudnn():
        report, port, gold_h = run("m2", M_SYNTH + ["--problem", "seq_modeling",
                                                    "--conditional"], 30 * 8)
    m2 = {"port_last5": last5(port), "golden_last5": last5(gold_h),
          "jax_record_last5": last5(record), "final_gap_pct": report["final_gap_pct"]}
    m2["to_golden"] = rel_gap(m2["port_last5"], m2["golden_last5"])
    m2["to_jax_record"] = rel_gap(m2["port_last5"], m2["jax_record_last5"])
    out["m2"] = m2
    say(f"[5/6] (m2) conditional seq_modeling, 64 x 4, batch 8, 30 epochs, free noise and "
        f"dropout: last-5 mean {m2['port_last5']:.2f}, golden {m2['golden_last5']:.2f} "
        f"({m2['to_golden']:.3%} apart), the JAX record {m2['jax_record_last5']:.2f} "
        f"({m2['to_jax_record']:.3%} apart); final_gap_pct {report['final_gap_pct']} (the "
        f"record's 0.253)")
    if m2["to_golden"] > M_LAST5_BAND or m2["to_jax_record"] > M_LAST5_BAND:
        raise AssertionError(f"(m2): last-5 means over {M_LAST5_BAND:.0%}: {m2}; port {port}")

    # (m3): dyn_modeling, 32 rows a step
    with deterministic_cudnn():
        report, port, gold_h = run("m3", ["--problem", "dyn_modeling", "--n-seq", "32",
                                          "--batch", "8", "--epochs", "15"], 15 * 4)
    out["m3"] = {"port_last5": last5(port), "golden_last5": last5(gold_h),
                 "to_golden": rel_gap(last5(port), last5(gold_h)),
                 "final_gap_pct": report["final_gap_pct"]}
    say(f"[5/6] (m3) dyn_modeling, 32 x 4, batch 8 (32 rows), 15 epochs: last-5 mean "
        f"{out['m3']['port_last5']:.2f}, golden {out['m3']['golden_last5']:.2f} "
        f"({out['m3']['to_golden']:.3%} apart); final_gap_pct {report['final_gap_pct']}")
    if out["m3"]["to_golden"] > M_LAST5_BAND:
        raise AssertionError(f"(m3): last-5 means over {M_LAST5_BAND:.0%}: {out['m3']}")

    # (m4): regression, controlled (gated, through the harness's run
    # functions), then four seeds through main (a reading)
    m4_argv = ["--problem", "regression", "--epochs", "3"] + M_CONTROLLED
    with deterministic_cudnn():
        port, gold_h = timed("m4", lambda: regression_controlled(m4_argv, torch.device("cuda")),
                             3 * 2, mvae=False)
    gaps = [rel_gap(a, b) for a, b in zip(port, gold_h)]
    if not all(math.isfinite(x) for x in port + gold_h) or max(gaps) > M_REGRESSION_BAND:
        raise AssertionError(f"(m4): controlled regression {gaps} over {M_REGRESSION_BAND}: "
                             f"port {port} golden {gold_h}")
    report, _, gold_h = run("m4 seeds", ["--problem", "regression", "--seeds", "0,1,2,3",
                                         "--epochs", "30"], 4 * 30 * 2, mvae=False)
    out["m4"] = {"controlled_worst_gap": max(gaps),
                 "seed_finals": [h[-1] for h in report["port_elbo_by_seed"].values()],
                 "golden_final": gold_h[-1]}
    say(f"[5/6] (m4) regression, 32 sequences, batch 16: controlled 3 epochs, worst "
        f"{max(gaps):.3e} (band {M_REGRESSION_BAND}); seeds 0-3, 30 epochs: the port "
        f"{report['port_final_min']} - {report['port_final_max']} "
        f"({rel_gap(report['port_final_max'], report['port_final_min']):.1%} spread), the "
        f"golden anchor {gold_h[-1]} (the JAX record's band on real data: 5.87 - 7.35)")

    # (m5): bfloat16_full at (m2)'s unconditional configuration
    with deterministic_cudnn():
        report, port, gold_h = run("m5", M_SYNTH + ["--dtype", "bfloat16_full"], 30 * 8,
                                   bf16=True)
    out["m5"] = {"port_first": port[0], "port_final": port[-1], "golden_final": gold_h[-1],
                 "drift_pct": report["final_gap_pct"]}
    say(f"[5/6] (m5) seq_modeling under bfloat16_full, 64 x 4, batch 8, 30 epochs: "
        f"{port[0]:.2f} -> {port[-1]:.2f}; float32 golden {gold_h[-1]:.2f}, drift "
        f"{report['final_gap_pct']}% (the JAX record's 1.687%)")
    if not port[-1] < port[0] or not last5(port) < sum(port[:5]) / 5:
        raise AssertionError(f"(m5): the bfloat16_full ELBO does not fall: {port}")

    # (m6): (j2)'s compiled exp_1 corpus, latent 256
    from mmdyn_tpu_torch.data.compile import load_packed

    corpus = tmp / "gen" / "compiled.npz"
    shape = load_packed(corpus)["visual"].shape
    n_seq = min(32, shape[0])
    with deterministic_cudnn():
        report, port, gold_h = run("m6", ["--dataset", str(corpus), "--latent", "256",
                                          "--batch", "4", "--epochs", "30", "--anneal", "15"],
                                   30 * (n_seq // 4))
    out["m6"] = {"sequences": shape[0], "frames": shape[1], "port_last5": last5(port),
                 "golden_last5": last5(gold_h), "to_golden": rel_gap(last5(port), last5(gold_h)),
                 "final_gap_pct": report["final_gap_pct"]}
    say(f"[5/6] (m6) (j2)'s corpus, {shape[0]} sequences x {shape[1]} frames read ({n_seq} "
        f"used), seq_modeling, latent 256, batch 4, 30 epochs, anneal 15: last-5 mean "
        f"{out['m6']['port_last5']:.2f}, golden {out['m6']['golden_last5']:.2f} "
        f"({out['m6']['to_golden']:.3%} apart); final_gap_pct {report['final_gap_pct']}")
    if out["m6"]["to_golden"] > M_LAST5_BAND:
        raise AssertionError(f"(m6): last-5 means over {M_LAST5_BAND:.0%}: {out['m6']}")

    out["launches"] = total
    out["port_steps"] = steps
    out["total_s"] = time.perf_counter() - t0
    say(f"[5/6] (m) took {out['total_s']:.1f} s on {card} ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in out["seconds"].items())
        + f"); launches {total}")
    return out


# (l): data parallelism (mmdyn_tpu_torch/parallel) on the one card
DDP_STEPS = 4
DDP_TIMEOUT = 300
DDP_LAUNCHES = {"poe_reparam": DDP_STEPS, "bce_sum": 2 * DDP_STEPS, "bce_sum_bf16": 0}


def ddp_cli_one_rank(kernels, card, tmp, det_params):
    """(l1), part 1: ``cli.main --num-devices 1`` (a one-rank NCCL group) on
    (f)'s corpus and flags: its parameters must equal those of (f)'s plain
    run bit for bit (both loops' steps run cuDNN's deterministic
    algorithms; an all-reduce over one rank and a division by 1 are
    exact)."""
    from mmdyn_tpu_torch.cli import main as cli_main

    reset_counters(kernels)
    t0 = time.perf_counter()
    run = cli_main.main(cli_argv(tmp) + ["--num-epochs", "2", "--log-dir",
                                         str(tmp / "dp1"), "--num-devices", "1"])
    wall_s = time.perf_counter() - t0
    launches = read_counters(kernels)
    got = run.state.model.state_dict()
    differ = sorted(k for k, v in det_params.items() if not torch.equal(got[k].cpu(), v))
    if (run.mesh is None or run.mesh.size != 1 or run.device.type != "cuda" or differ
            or launches != {"poe_reparam": 10, "bce_sum": 20, "bce_sum_bf16": 0}):
        raise AssertionError(f"(l1) cli.main --num-devices 1: {len(differ)} tensors differ "
                             f"from the plain run ({differ[:5]}), launches {launches}")
    fps = run._logger_dict["Perf/frames_per_sec"]
    say(f"[5/6] (l1) cli.main --num-devices 1 (one-rank NCCL group) "
        f"on {card}: {wall_s:.2f} s, loop frames/s by epoch {fps}; all {len(det_params)} "
        f"parameter tensors equal (f)'s plain run's bit for bit; launches {launches}")
    del run
    torch.cuda.empty_cache()
    return {"frames_per_s": fps, "tensors_equal": len(det_params), "launches": launches}


def ddp_bare_step(kernels, card, flag, bare_step_ms):
    """(l1), part 2: the flagship's bare step at batch 512 in a one-rank
    NCCL group against the same step without a group, in turns on one
    state, with torch's default cuDNN algorithms as in (a) (a session of (g)
    selected the deterministic ones for the process): ms/step of each and
    (a)'s, the collectives per step and their bytes, the NCCL kernels'
    device time and the device time the group adds, from profiles of 3
    steps of each. NCCL runs no kernel for an all-reduce in place over one
    rank, so what the group adds is the flat gradient buffer's copies."""
    from mmdyn_tpu_torch.parallel import make_mesh
    from mmdyn_tpu_torch.train import make_train_step

    mesh = make_mesh(1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False       # (a)'s algorithms, not (g)'s
    try:
        state, plain = train_state(flag, mesh.device)
        steps = {"group": make_train_step(flag, mesh=mesh), "plain": plain}
        batch = {k: torch.as_tensor(v, device=mesh.device)
                 for k, v in synthetic_batch(flag.batchsize).items()}
        gen = torch.Generator(device=mesh.device).manual_seed(0)

        def run(name, n):
            for _ in range(n):
                steps[name](state, batch, gen, 1.0)

        run("group", 1)                                   # warm-up
        torch.cuda.synchronize()
        step_ms, launches = {}, {}
        for name in ("group", "plain", "plain", "group"):
            before = mesh.collectives
            reset_counters(kernels)
            t0 = time.perf_counter()
            run(name, DDP_STEPS)
            torch.cuda.synchronize()
            step_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / DDP_STEPS)
            launches[name] = read_counters(kernels)
            if name == "group":
                per_step = (mesh.collectives - before) / DDP_STEPS
        if any(v != DDP_LAUNCHES for v in launches.values()):
            raise AssertionError(f"(l1) bare step: launches {launches} over {DDP_STEPS} steps")
        grad_bytes = 4 * sum(p.numel() for p in state.model.parameters())
        prof, events = device_profile(lambda: run("group", 3), "(l1) 3 one-rank NCCL steps",
                                      calls=3, top=6)
        plain_prof, _ = device_profile(lambda: run("plain", 3), "(l1) the same 3 steps "
                                       "without a group", calls=3, top=0)
        nccl = [e for e in events if "nccl" in e.key.lower()]
        nccl_ms = sum(dev_us(e) for e in nccl) / 1e3 / 3
        added_ms = (prof["busy_ms"] - plain_prof["busy_ms"]) / 3
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh.close()
    say(f"[5/6] (l1) the seq flagship's bare step at batch 512 on {card}: in a one-rank "
        f"NCCL group {[round(t, 3) for t in step_ms['group']]} ms/step, without a group "
        f"{[round(t, 3) for t in step_ms['plain']]} (in turns on one state), (a) "
        f"{bare_step_ms:.3f}; {per_step:g} collectives per step (the gradients' "
        f"{grad_bytes / 2**20:.1f} MiB all-reduce and the metrics'); NCCL kernels "
        f"{nccl_ms:.4f} ms of device time per step ({len(nccl)} kinds"
        + "".join(f"; {e.key[:50]} {dev_us(e) / e.count:.1f} us x{e.count // 3}"
                  for e in nccl)
        + f"); device busy per step {prof['busy_ms'] / 3:.3f} ms in the group, "
        f"{plain_prof['busy_ms'] / 3:.3f} without: the group adds {added_ms:.4f} ms")
    del state, batch
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "bare_step_ms": bare_step_ms, "collectives_per_step": per_step,
            "grad_bytes": grad_bytes, "nccl_ms_per_step": nccl_ms,
            "added_device_ms_per_step": added_ms, "busy_share": prof["busy_share"]}


def _collective_ms(step, state, batch, gen, device):
    """One more step with every all-reduce timed on the host between two
    synchronisations of the card: (step ms, ms inside the all-reduces). The
    time inside holds gloo's copies through the host, its exchange with the
    other rank, and the wait for that rank to arrive."""
    import torch.distributed as dist

    real, spent = dist.all_reduce, [0.0]

    def timed(t, *args, **kwargs):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        torch.cuda.synchronize(device)
        spent[0] += time.perf_counter() - t0
        return out

    dist.all_reduce = timed
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(state, batch, gen, 1.0)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3, spent[0] * 1e3
    finally:
        dist.all_reduce = real


def ddp_gaps(losses, grads, params, ref):
    """A run's gaps to the reference run ``ref`` (same state, batch and
    steps): every step's loss (max relative), the first step's gradients
    (max gap over the tensor's max |g|, worst tensor; and relative L2 over
    all), the parameters after the steps (largest gap over the largest
    |param|; relative L2)."""
    def l2(a, b):
        return math.sqrt(sum(float(((a[n] - v).double() ** 2).sum()) for n, v in b.items())
                         / sum(float((v.double() ** 2).sum()) for v in b.values()))

    worst = max((float((grads[n] - g).abs().max() / g.abs().max()), n)
                for n, g in ref["grads"].items())
    want = ref["params"]
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
            "grad_rel": worst[0], "grad_worst": worst[1],
            "grad_l2_rel": l2(grads, ref["grads"]),
            "param_gap_over_max": (max(float((params[n] - v).abs().max())
                                       for n, v in want.items())
                                   / max(float(v.abs().max()) for v in want.values())),
            "param_l2_rel": l2(params, want)}


def _ddp_rank(path):
    """One of (l2)'s two ranks, both on ``cuda:0``, joined by gloo: the seq
    flagship's 4 steps on this rank's 256 rows of the reference's global
    batch from the reference's state, held against the one-process run;
    then (l3), predict of the whole serving batch."""
    from mmdyn_tpu_torch.models import model_kwargs, setup_model
    from mmdyn_tpu_torch.ops import kernels
    from mmdyn_tpu_torch.parallel import make_mesh, shard_batch
    from mmdyn_tpu_torch.problems import make_optimizer
    from mmdyn_tpu_torch.serve import InferenceSession
    from mmdyn_tpu_torch.train import create_train_state, make_train_step
    from mmdyn_tpu_torch.utils.device import set_reference_precision

    set_reference_precision()
    torch.backends.cudnn.deterministic = True     # as in the reference's process
    ref = torch.load(path, weights_only=False)
    cfg = ref["cfg"]
    mesh = make_mesh(2, devices=["cuda:0", "cuda:0"], backend="gloo", timeout=DDP_TIMEOUT)
    dev = mesh.device
    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device=dev,
                        **model_kwargs(cfg))
    model.load_state_dict(ref["init"])
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg, mesh=mesh)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in shard_batch(mesh, ref["batch"]).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters(kernels)
    before = mesh.collectives
    losses, step_s, grads, signs = [], [], None, {}
    with pinned_draws(), relu_signs(model, signs):
        for _ in range(DDP_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen, 1.0)
            losses.append(float(metrics["loss"]))       # the read syncs
            step_s.append(time.perf_counter() - t0)
            if grads is None:
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    launches = read_counters(kernels)
    per_step = (mesh.collectives - before) / DDP_STEPS
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out = {
        "rank": mesh.rank, "launches": launches, "collectives_per_step": per_step,
        "losses": losses, **ddp_gaps(losses, grads, params, ref),
        "params_sum": float(sum(p.double().sum() for p in params.values())),
        "step_ms": [t * 1e3 for t in step_s],
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "_grads": grads if mesh.is_chief else None,    # for (l7)'s float64 probe
        "_signs": signs,
    }
    out["instrumented_step_ms"], out["allreduce_ms"] = _collective_ms(step, state, batch,
                                                                      gen, dev)
    session = InferenceSession(cfg, ref["init"], device=dev, mesh=mesh)
    pred = session.predict(**ref["serve_x"])
    out["serve_gap"] = max(float((pred[k].cpu() - v).abs().max())
                           for k, v in ref["serve"].items())
    out["serve_rows"] = int(pred["visual"].shape[0])
    return out


def ddp_two_ranks(card, flag, tmp):
    """(l2) and (l3): the one-process reference on the card (the seq flagship
    at full width, batch 512, 4 steps from one state, cuDNN's deterministic
    algorithms, the draws pinned by ``pinned_draws``; predict at batch 64),
    then two gloo ranks sharing ``cuda:0``
    (``_ddp_rank``) held against it: every step's loss within rel 1e-4, the
    first step's gradients within 1e-4 in relative L2 norm (a gradient
    summed wrong, which Adam's scale-free update would hide, shows here),
    the parameters after the 4 steps within 1e-3 in relative L2 norm,
    predict within atol 1e-5, and 1 PoE and 2 BCE launches per step on each
    rank. The parameters' largest single gap is printed, beside the same
    readings of the reference rerun with cuDNN's default algorithms (the
    floor): Adam divides each gradient element by its own magnitude plus
    1e-8, so an element whose gradient sits at float32's rounding floor
    moves by up to the learning rate whatever its sign, in any two runs
    that sum in different orders."""
    from mmdyn_tpu_torch.parallel import spawn
    from mmdyn_tpu_torch.serve import InferenceSession

    batch_np = synthetic_batch(flag.batchsize)

    def one_process(init=None):
        """4 steps of one process on the global batch: (the first state's
        weights, losses, first-step gradients, parameters, the first step's
        ReLU signs)."""
        state, step = train_state(flag, None)
        if init is not None:
            state.model.load_state_dict(init)
        dev = next(state.model.parameters()).device
        first = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        losses, grads, signs = [], None, {}
        with pinned_draws(), relu_signs(state.model, signs):
            for _ in range(DDP_STEPS):
                state, metrics = step(state, batch, gen, 1.0)
                losses.append(float(metrics["loss"]))
                if grads is None:
                    grads = {n: p.grad.detach().cpu()
                             for n, p in state.model.named_parameters()}
        params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
        return first, losses, grads, params, signs

    init, losses, grads, params, signs = one_process()
    ref = {"losses": losses, "grads": grads, "params": params}
    # the floor: the same run with cuDNN's default algorithms, which sum in
    # other orders (as (f)'s rerun shows, they also differ run to run)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        floor = one_process(init)[1:]
        control = ddp_gaps(*floor[:3], ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # for (l7): one process without cuDNN (PyTorch's own convolutions), which
    # sums in still other orders
    torch.backends.cudnn.enabled = False
    try:
        no_cudnn = one_process(init)[1:]
    finally:
        torch.backends.cudnn.enabled = True
    x = serving_inputs(64)
    serve = {k: v.cpu() for k, v in InferenceSession(flag, init).predict(**x).items()}
    torch.cuda.empty_cache()
    path = tmp / "ddp_reference.pt"
    torch.save({"cfg": flag, "init": init, "batch": batch_np, **ref, "serve_x": x,
                "serve": serve}, path)
    t0 = time.perf_counter()
    ranks = spawn(_ddp_rank, 2, (str(path),), backend="gloo", timeout=DDP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    # the first step's gradients and ReLU signs of the four float32 runs, for (l7)
    probe = tmp / "float64_probe.pt"
    rank_signs = [r.pop("_signs") for r in ranks]     # the rows' axis is -2
    torch.save({"cfg": flag, "init": init, "batch": batch_np, "grads": {
        "one_process": grads, "two_ranks": ranks[0].pop("_grads"), "floor": floor[1],
        "no_cudnn": no_cudnn[1]},
        "signs": {"one_process": signs, "floor": floor[3], "no_cudnn": no_cudnn[3],
                  "two_ranks": {
            n: torch.cat([r[n] for r in rank_signs], dim=-2) for n in signs}}}, probe)
    ranks[1].pop("_grads")
    say(f"[5/6] (l2) the floor: one process with cuDNN's default algorithms against the "
        f"reference (deterministic ones): {json.dumps(control)}")
    for r in ranks:
        share = r["allreduce_ms"] / r["instrumented_step_ms"]
        say(f"[5/6] (l2) rank {r['rank']} of 2 (gloo, both on cuda:0) on {card}: seq "
            f"flagship latent {flag.latent_size} {flag.compute_dtype}, "
            f"{flag.batchsize // 2} of {flag.batchsize} rows, {DDP_STEPS} steps "
            f"{[round(t, 3) for t in r['step_ms']]} ms (the first warms up); losses "
            f"{r['losses']}, max rel gap to one process {r['loss_rel']:.3e}; first-step "
            f"gradients {r['grad_rel']:.3e} (max gap over max |g|, {r['grad_worst']}), "
            f"{r['grad_l2_rel']:.3e} in L2; parameters L2 {r['param_l2_rel']:.3e}, largest "
            f"gap over max |param| {r['param_gap_over_max']:.3e}; "
            f"{r['collectives_per_step']:g} collectives per "
            f"step; launches {r['launches']}; peak {r['peak_gib']:.2f} GiB; one "
            f"instrumented step {r['instrumented_step_ms']:.1f} ms, {r['allreduce_ms']:.1f} "
            f"ms ({share:.1%}) inside gloo's all-reduces (copies through the host, the "
            f"exchange, the wait for the other rank)")
        say(f"[5/6] (l3) rank {r['rank']}: predict of the 64-row batch, 32 rows each, "
            f"BatchNorm over both: max gap to one process {r['serve_gap']!r} (atol 1e-5)")
    say(f"[5/6] (l2)+(l3): two spawned ranks took {wall_s:.1f} s, start-up included; two "
        f"ranks on one card share its SMs and memory: no evidence of scaling")
    for r in ranks:
        if (r["launches"] != DDP_LAUNCHES or r["loss_rel"] > 1e-4 or r["grad_l2_rel"] > 1e-4
                or r["param_l2_rel"] > 1e-3 or r["serve_gap"] > 1e-5
                or r["serve_rows"] != 64):
            raise AssertionError(f"(l2)/(l3) rank {r['rank']}: "
                                 f"{ {k: v for k, v in r.items() if k != 'losses'} }")
    if ranks[0]["params_sum"] != ranks[1]["params_sum"]:
        raise AssertionError("(l2): the two ranks hold different parameters")
    for r in ranks:
        r["gloo_share"] = r["allreduce_ms"] / r["instrumented_step_ms"]
    return {"ranks": ranks, "floor": control, "wall_s": wall_s,
            "launches": ranks[0]["launches"], "_probe": probe}


def ddp_refusal(card):
    """(l4): ``cli.main --num-devices N`` for one card more than the machine
    has exits non-zero with an error naming both counts, before any rank or
    run directory exists."""
    count = torch.cuda.device_count()
    n = count + 1
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-m", "mmdyn_tpu_torch.cli.main",
                              "--num-devices", str(n), "--logs-root", tmp],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        left = list(Path(tmp).iterdir())
    want = (f"--num-devices {n} asks for {n} CUDA devices, but {count} "
            f"{'is' if count == 1 else 'are'} visible")
    if out.returncode == 0 or want not in out.stderr or left:
        raise AssertionError(f"(l4): exit {out.returncode}, {out.stderr[-500:]}, left {left}")
    say(f"[5/6] (l4) cli.main --num-devices {n} on {card}: exit {out.returncode}, "
        f"'{want}'")
    return {"exit": out.returncode, "message": want}


SERVE_BATCH, EXPORT_BATCH = 64, 8        # (l5)'s server, (l6)'s artifact
SMOKE_TIMEOUT, PROBE_TIMEOUT = 300, 900


def serve_requests(x):
    """(l5)'s requests, in order: (name, path, npz body); uint8 images, as
    (g)'s clients send them."""
    def wire(b):
        return {"visual": (x["visual"][:b] * 255).astype(np.uint8),
                "tactile": (x["tactile"][:b] * 255).astype(np.uint8), "pose": x["pose"][:b]}

    return [("predict_1", "/predict", wire(1)), ("predict_64", "/predict", wire(64)),
            ("predict_sample", "/predict?sample=1", wire(64)),
            ("rollout", "/rollout?steps=4", wire(8)), ("prior", "/sample?n=8&seed=3", None)]


def serve_and_time(server, requests):
    """The replies to ``requests`` from ``server`` (serving from a thread,
    closed after), then the /predict round trip at 1 and 64 rows (median of
    10 after 2, host ms)."""
    with running(server) as port:
        replies = {name: dict(http_post(port, path, body)[1]) for name, path, body in requests}
        bodies = {name: body for name, _, body in requests}
        round_trip = {b: float(np.median([http_post(port, "/predict", bodies[f"predict_{b}"])[0]
                                          for _ in range(12)][2:])) for b in (1, 64)}
    return replies, round_trip


def _serve_rank(run, tmp):
    """(l5) and (l6) in one of two ranks sharing ``cuda:0``, joined by gloo:
    rank 0 serves (f)'s run over HTTP at batch 64 and posts
    ``serve_requests`` to itself while rank 1 follows; then both export at
    batch 8 (rank 0 writes a one-device artifact) and ask for the graph
    predictor, which must refuse."""
    from mmdyn_tpu_torch.ops import kernels
    from mmdyn_tpu_torch.parallel import make_mesh
    from mmdyn_tpu_torch.serve import InferenceSession, export_session
    from mmdyn_tpu_torch.serve.server import follow, make_server
    from mmdyn_tpu_torch.utils.device import set_reference_precision

    set_reference_precision()
    mesh = make_mesh(2, devices=["cuda:0", "cuda:0"], backend="gloo", timeout=DDP_TIMEOUT)
    session = InferenceSession.from_run(run, mesh=mesh)
    reset_counters(kernels)
    out = {"rank": mesh.rank}
    if mesh.is_chief:
        server = make_server(session, port=0, batch_size=SERVE_BATCH)
        out["replies"], out["round_trip_ms"] = serve_and_time(
            server, serve_requests(serving_inputs(SERVE_BATCH)))
    else:
        out["calls"] = follow(session)
    t0 = time.perf_counter()
    out["manifest"] = export_session(session, Path(tmp, "l6_ranks"), batch_size=EXPORT_BATCH)
    out["export_s"] = time.perf_counter() - t0
    try:
        session.aot_predict(EXPORT_BATCH, tuple(out["manifest"]["modalities"]))
        out["aot_error"] = None
    except RuntimeError as e:
        out["aot_error"] = str(e)
    out["launches"] = read_counters(kernels)
    return out


def reply_gaps(got, want):
    """Per reply: the largest uint8 gap in levels and float gap."""
    gaps = {}
    for name, w in want.items():
        g = got[name]
        if set(g) != set(w) or any(g[k].shape != w[k].shape for k in w):
            raise AssertionError(f"(l5) {name}: {sorted(g)} vs {sorted(w)}")
        gaps[name] = {k: (int(np.abs(g[k].astype(np.int16) - w[k].astype(np.int16)).max())
                          if w[k].dtype == np.uint8 else float(np.abs(g[k] - w[k]).max()))
                      for k in w}
    return gaps


def rollout_gaps(got, want):
    """A rollout reply's largest float gap at each step, and over the whole
    trajectory its largest gap over the largest |value|."""
    keys = [k for k, w in want.items() if w.dtype != np.uint8]
    steps = [max(float(np.abs(got[k][t] - want[k][t]).max()) for k in keys)
             for t in range(len(want[keys[0]]))]
    return steps, max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                      for k in keys)


def ddp_serving(kernels, card, tmp):
    """(l5) and (l6): (f)'s run served by one process on the card and then
    by two gloo ranks sharing ``cuda:0`` (``_serve_rank``), the same
    requests in the same order from a fresh session: uint8 images within 1
    level, mu / logvar / pose within atol 1e-5, /sample equal. The 4-step
    rollout feeds each step's images back, which amplifies the BatchNorm
    sums' other order: its first step (a predict) is held at atol 1e-5, the
    trajectory at (g)'s card-vs-CPU bound, 1e-4 of its largest value. The /predict
    round trip of both at 1 and 64 rows (a cost, no claim). The two-rank
    artifact at batch 8 equals the one-process card artifact bit for bit on
    the same inputs, and the graph predictor of the card group refuses,
    naming predict. No kernel of the port launches."""
    from mmdyn_tpu_torch.serve import InferenceSession, export_session, load_exported
    from mmdyn_tpu_torch.serve.server import make_server
    from mmdyn_tpu_torch.parallel import spawn

    run = tmp / "run"
    torch.cuda.empty_cache()
    reset_counters(kernels)
    one = InferenceSession.from_run(run)
    want, one_ms = serve_and_time(make_server(one, port=0, batch_size=SERVE_BATCH),
                                  serve_requests(serving_inputs(SERVE_BATCH)))
    export_session(one, tmp / "l6_one", batch_size=EXPORT_BATCH)
    launches = read_counters(kernels)
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank0, rank1 = spawn(_serve_rank, 2, (str(run), str(tmp)), backend="gloo",
                         timeout=DDP_TIMEOUT)
    wall_s = time.perf_counter() - t0
    gaps = reply_gaps(rank0["replies"], want)
    worst_u8 = max(v for g in gaps.values() for k, v in g.items() if isinstance(v, int))
    worst_f = max(v for name, g in gaps.items() if name not in ("prior", "rollout")
                  for v in g.values() if isinstance(v, float))
    roll_steps, roll_rel = rollout_gaps(rank0["replies"]["rollout"], want["rollout"])
    prior_equal = all(np.array_equal(rank0["replies"]["prior"][k], v)
                      for k, v in want["prior"].items())
    say(f"[5/6] (l5) HTTP server of two gloo ranks on cuda:0 ({card}), batch {SERVE_BATCH}: "
        f"/predict at 1 and 64 rows, /predict?sample=1, /rollout?steps=4 (8 rows), "
        f"/sample?n=8 against one process's server: worst uint8 gap {worst_u8} levels, "
        f"worst float gap of the predicts {worst_f!r} (atol 1e-5), /sample equal: "
        f"{prior_equal}; the rollout's float gap by step {roll_steps} (the first atol "
        f"1e-5), over its largest value {roll_rel!r} (1e-4); "
        f"by reply {json.dumps(gaps)}; rank 1 made {rank1['calls']} calls (2 warm-up, 4 "
        f"requests, 24 timed)")
    say(f"[5/6] (l5) /predict round trip (uint8 npz, median of 10) on {card}: two ranks "
        f"{rank0['round_trip_ms'][1]:.3f} ms at 1 row, {rank0['round_trip_ms'][64]:.3f} ms at "
        f"64; one process {one_ms[1]:.3f} / {one_ms[64]:.3f} ms (a cost, no claim)")
    x = serving_inputs(EXPORT_BATCH, seed=9)
    a, b = load_exported(tmp / "l6_one")(**x), load_exported(tmp / "l6_ranks")(**x)
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    say(f"[5/6] (l6) export_session of the two-rank session at batch {EXPORT_BATCH} on "
        f"{card}: rank 0 wrote a {rank0['manifest']['platforms']} artifact in "
        f"{rank0['export_s']:.2f} s, both ranks returned its manifest; its outputs "
        f"{sorted(a)} equal the one-process card artifact's bit for bit: {not differ}; "
        f"aot_predict on the card group raised: {rank0['aot_error']!r}")
    say(f"[5/6] (l5)+(l6): two spawned ranks took {wall_s:.1f} s, start-up included; "
        f"launches: one process {launches}, ranks {rank0['launches']}, {rank1['launches']}")
    if (worst_u8 > 1 or worst_f > 1e-5 or roll_steps[0] > 1e-5 or roll_rel > 1e-4
            or not prior_equal or differ
            or rank0["manifest"] != rank1["manifest"] or rank1["calls"] != 2 + 4 + 2 * 12
            or rank0["manifest"]["batch_size"] != EXPORT_BATCH
            or any(r["aot_error"] is None or "call predict" not in r["aot_error"]
                   for r in (rank0, rank1))
            or any(any(v.values()) for v in (launches, rank0["launches"], rank1["launches"]))):
        raise AssertionError(f"(l5)/(l6): gaps {gaps}, prior equal {prior_equal}, artifact "
                             f"differs in {differ}, rank 1 calls {rank1['calls']}, aot "
                             f"{rank0['aot_error']!r}, launches {launches}, "
                             f"{rank0['launches']}, {rank1['launches']}")
    return {"gaps": gaps, "rollout_by_step": roll_steps, "rollout_rel": roll_rel,
            "round_trip_ms": {"two_ranks": rank0["round_trip_ms"],
                                            "one_process": one_ms},
            "export_s": rank0["export_s"], "aot_error": rank0["aot_error"], "wall_s": wall_s}


def _rel_l2(got, want, names):
    num = sum(float(((got[n].double() - want[n]) ** 2).sum()) for n in names)
    return math.sqrt(num / sum(float((want[n] ** 2).sum()) for n in names))


class _KinkedRelu(torch.autograd.Function):
    """ReLU whose backward takes ``given[name]`` as its derivative's mask
    when it is set, else ``x > 0``."""

    @staticmethod
    def forward(ctx, x, name, given):
        ctx.save_for_backward(x)
        ctx.name, ctx.given = name, given
        return torch.clamp_min(x, 0.0)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        mask = ctx.given.get(ctx.name)
        return grad * (x > 0 if mask is None else mask), None, None


def _float64_probe(path):
    """(l7), in a child process on the host CPU: the first step of (l2)'s
    reference (same weights, batch and pinned draws) in float64, and each
    float32 run's first-step gradients' relative L2 distance to it, over all
    tensors and per tensor. ``Tensor.float()`` keeps a float64 tensor and
    the subset mask is made float64, so no part of the step rounds to
    float32; on the CPU the kernels' plain versions run.

    ReLU is not differentiable at 0: an element whose input rounds to the
    other side of 0 in a float32 run passes (or stops) its whole gradient.
    So the ReLU inputs' signs of each float32 run are compared with
    float64's (the flips), and the backward is taken a second time, from the
    same forward, with the two-rank run's signs as the ReLU derivative: the
    float64 gradient of the function that run took."""
    torch.set_default_dtype(torch.float64)
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_float(t, *a, **k)
    from mmdyn_tpu_torch.models import model_kwargs, setup_model
    from mmdyn_tpu_torch.problems import reconstruction
    from mmdyn_tpu_torch.train.steps import _loss_fn

    tables = reconstruction._tables
    reconstruction._tables = lambda use_pose, device: (
        (tables(use_pose, device)[0].double(),) + tables(use_pose, device)[1:])
    ref = torch.load(path, weights_only=False)
    cfg = ref["cfg"]
    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device="cpu",
                        **model_kwargs(cfg)).double()
    model.load_state_dict(ref["init"])
    given, own = {}, {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.ReLU):
            m.forward = lambda x, name=name: _KinkedRelu.apply(x, name, given)
    batch = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in ref["batch"].items()}
    params = dict(model.named_parameters())
    t0 = time.perf_counter()
    with pinned_draws(), relu_signs(model, own):
        loss, _ = _loss_fn(model, cfg, batch, torch.Generator().manual_seed(0), 1.0, True)
    want = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                retain_graph=True)))
    given.update(ref["signs"]["two_ranks"])
    kinked = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    seconds = time.perf_counter() - t0
    names = sorted(want)
    return {"seconds": seconds, "loss": float(loss.detach()), "rows": cfg.batchsize,
            "latent": cfg.latent_size,
            "all": {run: _rel_l2(g, want, names) for run, g in ref["grads"].items()},
            "by_tensor": {n: {run: _rel_l2(g, want, [n]) for run, g in ref["grads"].items()}
                          for n in names},
            "flips": {run: sum(int((s[n] != own[n]).sum()) for n in own)
                      for run, s in ref["signs"].items()},
            "relu_elements": sum(v.numel() for v in own.values()),
            "two_ranks_to_its_kinks": _rel_l2(ref["grads"]["two_ranks"], kinked, names),
            "kinks_to_float64": _rel_l2(kinked, want, names)}


def ddp_float64(card, probe, tmp):
    """(l7): ``multihost_smoke --spawn 2`` on the card in a subprocess
    (its 1e-5 gate) while the float64 probe (``_float64_probe``, one spawned
    process) runs on the host CPU."""
    with open(tmp / "smoke.out", "w") as out, open(tmp / "smoke.err", "w") as err:
        # its own process group: a failure here stops the ranks it spawns too
        smoke = subprocess.Popen(
            [sys.executable, "-m", "mmdyn_tpu_torch.tools.multihost_smoke", "--spawn", "2",
             "--timeout", str(SMOKE_TIMEOUT)], cwd=REPO, stdout=out, stderr=err,
            start_new_session=True)
    try:
        return _float64_and_smoke(card, probe, smoke, tmp)
    finally:
        if smoke.poll() is None:
            os.killpg(smoke.pid, signal.SIGKILL)
            smoke.wait()


def _float64_and_smoke(card, probe, smoke, tmp):
    from mmdyn_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    (report,) = spawn(_float64_probe, 1, (str(probe),), timeout=PROBE_TIMEOUT)
    probe_s = time.perf_counter() - t0
    runs = ("one_process", "two_ranks", "floor", "no_cudnn")
    worst = sorted(report["by_tensor"], key=lambda n: -report["by_tensor"][n]["two_ranks"])[:5]
    shown = worst + [n for n in ("pose_decoder.deconv_net.2.weight",) if n not in worst]
    ratio = report["all"]["two_ranks"] / report["all"]["one_process"]
    flips = report["flips"]
    say(f"[5/6] (l7) float64 probe, ReLU kinks (the pose encoder's and decoder's "
        f"{report['relu_elements']} ReLU inputs of the step): elements on the other side of "
        f"0 from float64 in each float32 run " + ", ".join(f"{r} {flips[r]}" for r in runs)
        + f"; the two-rank gradients' distance to the float64 backward taken with their "
        f"ReLU signs {report['two_ranks_to_its_kinks']:.3e} (that backward's distance to "
        f"float64's own {report['kinks_to_float64']:.3e})")
    say(f"[5/6] (l7) float64 probe: the first step of (l2)'s reference (seq flagship, batch "
        f"{report['rows']}, latent {report['latent']}, pinned draws) in float64 on the host CPU in "
        f"{report['seconds']:.1f} s (loss {report['loss']!r}); first-step gradients' "
        f"relative L2 distance to it: " + ", ".join(f"{r} {report['all'][r]:.3e}" for r in runs)
        + f" (float32 on {card}: the one-process reference, rank 0 of (l2)'s two ranks, the "
        f"one process under cuDNN's default algorithms, and without cuDNN); two ranks / one "
        f"process "
        f"{ratio:.2f}; by tensor (5 farthest for two ranks): " + "; ".join(
            f"{n} " + " / ".join(f"{report['by_tensor'][n][r]:.3e}" for r in runs)
            for n in shown))
    smoke.wait(timeout=SMOKE_TIMEOUT)
    lines = (tmp / "smoke.out").read_text().strip().splitlines()
    result = json.loads(lines[-1]) if lines else {}
    gaps = {k: v for k, v in result.items() if k.endswith("max_rel_gap")}
    say(f"[5/6] (l7) multihost_smoke --spawn 2 on {card} (both ranks on cuda:0, gloo, full "
        f"float32): exit {smoke.returncode}, ok {result.get('ok')}, max relative loss gaps "
        f"to the golden run {gaps} (gate 1e-5)")
    if smoke.returncode != 0 or not result.get("ok") or len(gaps) != 2:
        raise AssertionError(f"(l7) multihost_smoke: exit {smoke.returncode}, {result}, "
                             f"{(tmp / 'smoke.err').read_text()[-2000:]}")
    # the two-rank gradients are as close to float64 as rounding puts one
    # process's (within 2x) once the ReLU kinks match: a kink passes or
    # stops a whole gradient, so a distance across one measures no rounding
    if not (all(math.isfinite(v) for v in report["all"].values())
            and report["two_ranks_to_its_kinks"] <= 2 * report["all"]["one_process"]):
        raise AssertionError(f"(l7) float64 probe: {report['all']}, with the two-rank "
                             f"kinks {report['two_ranks_to_its_kinks']!r}")
    return {"float64": {"all": report["all"], "ratio": ratio, "seconds": report["seconds"],
                        "flips": flips, "relu_elements": report["relu_elements"],
                        "two_ranks_to_its_kinks": report["two_ranks_to_its_kinks"],
                        "kinks_to_float64": report["kinks_to_float64"],
                        "wall_s": probe_s, "by_tensor": {n: report["by_tensor"][n]
                                                         for n in shown}},
            "multihost_smoke": {"exit": smoke.returncode, "gaps": gaps}}


def ddp_path(kernels, card, flag, bare_step_ms, det_params, tmp):
    """(l), in (f)'s temporary directory: (l1) one rank bit for bit and its
    bare step, (l2) and (l3) two gloo ranks on one card, (l4) the refusal,
    (l5) and (l6) serving and export across two ranks, (l7) multihost_smoke
    and the float64 probe of (l2)'s gradients."""
    t0 = time.perf_counter()
    out = {"cli_one_rank": ddp_cli_one_rank(kernels, card, tmp, det_params),
           "bare_one_rank": ddp_bare_step(kernels, card, flag, bare_step_ms)}
    out.update(ddp_two_ranks(card, flag, tmp))
    probe = out.pop("_probe")
    out["refusal"] = ddp_refusal(card)
    out["serving"] = ddp_serving(kernels, card, tmp)
    out.update(ddp_float64(card, probe, tmp))
    out["seconds"] = time.perf_counter() - t0
    say(f"[5/6] (l) took {out['seconds']:.1f} s")
    return out


# (n): the reference configuration on the card (docs/PARITY.md:673-730): exp_1
# at the record's scale, cli.main at the reference defaults, cli.evaluate and
# plot_run, each a fresh process of the normal entry point, so that no setting
# of this process (the deterministic algorithms (g) selected, (j2)'s trace)
# reaches them
REFCFG = REPO / "docs" / "convergence"
# (n1): docs/PARITY.md:684-686 on the device path. The record's corpus is "16
# objects x 10 trials + top-up" (165 sequences); the device path keeps every
# trial, and 160 dumps compile (strict parity) to 159 sequences, 127 of them
# train: no step at batch 128. The top-up is a 17th catalog object (the first
# 16 are those of --n_objects 16): 170 dumps, 169 sequences, 135 train, 33 test
N_GEN_ARGV = ["--engine", "analytic", "--headless", "--fast-shading", "--n_objects", "17",
              "--trial_per_obj", "10", "--n_timesteps", "300", "--interval", "15",
              "--device-physics"]
N_SNAPSHOTS = 20
N_MIN_SEQUENCES = 161    # (n1): compiled to 160, 128 of them train: one step an epoch
# (n2): docs/PARITY.md:687-691 and :703-705
N_TRAIN_ARGV = ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae",
                "--input-type", "visuotactile", "--use-pose", "--latent-size", "256",
                "--batchsize", "128", "--num-epochs", "100", "--annealing-epochs", "50",
                "--bf16-full", "--image-interval", "10", "--ckpt-interval", "10"]
N_EPOCHS = 100
# Bounds against the JAX record, whose run had another initialisation and
# another random corpus: a miss prints NOT MET beside its bound and is
# recorded with the run's readings; the script raises on what the port's own
# runs must hold (launches, finite values, monotone curves, (n4), (n5))
N_EPOCH0_BAND = 0.02     # (n2) epoch 0 against the record's
N_LAST5_BAND = 0.01      # (n2) last-5 mean against the record's (BASELINE.md's 1%)
N_TEST_BAND = 0.01       # (n3) test loss per batch against the record's
N_SEEDS = (1, 2)         # (n2) the same run at these seeds too (readings)
# (n3): the record's 2 test batches over 32 held-out sequences are batch 16
N_EVAL_BATCH = 16
N_PREEMPT_EPOCHS = 20    # (n4): --num-epochs cut from 100
N_KILL_AFTER = 8         # (n4): SIGTERM once the run has logged this many steps
N_RERUN_ROWS = 512       # (n5): (d)'s batch
N_RERUN_SEQUENCES = 700  # (n5): 560 train sequences, one batch of 512
N_TIMEOUT = 600          # seconds for any one process of (n)


def entry_command(module, argv):
    """``python -c``: ``module``'s ``main(argv)`` in a fresh process, then the
    port's kernel counters of that process on a last line ``LAUNCHES {...}``."""
    code = (f"import json, sys; sys.path.insert(0, {str(REPO)!r}); "
            f"from {module} import main; main({[str(a) for a in argv]!r}); "
            "import chip_smoke; from mmdyn_tpu_torch.ops import kernels; "
            "print('LAUNCHES ' + json.dumps(chip_smoke.read_counters(kernels)))")
    return [sys.executable, "-c", code]


def start_process(cmd, log, trace=False):
    """``cmd`` from the repository root, its output (stdout and stderr) to
    ``log``; ``MMDYN_GEN_TRACE`` set only when ``trace``."""
    env = {k: v for k, v in os.environ.items() if k != "MMDYN_GEN_TRACE"}
    if trace:
        env["MMDYN_GEN_TRACE"] = "1"
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT, env=env)


def finish_process(label, proc, log, marker="LAUNCHES "):
    """Wait for ``proc`` (killing it past ``N_TIMEOUT``): its output and the
    JSON of its last line that starts with ``marker``; a non-zero exit or no
    such line raises with the output's tail."""
    try:
        rc = proc.wait(timeout=N_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = Path(log).read_text()
    found = [ln for ln in text.splitlines() if ln.startswith(marker)]
    if rc != 0 or not found:
        raise AssertionError(f"{label}: exit {rc}; output ends:\n{text[-4000:]}")
    return text, json.loads(found[-1][len(marker):])


def run_entry(label, module, argv, log, trace=False):
    """``entry_command`` to its end: (output, kernel counters, wall s)."""
    t0 = time.perf_counter()
    text, launches = finish_process(
        label, start_process(entry_command(module, argv), log, trace), log)
    return text, launches, time.perf_counter() - t0


def jsonl_series(run, tag):
    """{step: value} of ``tag``'s records in a run's metrics."""
    path = Path(run) / "tensorboard" / "metrics.jsonl"
    if not path.exists():
        return {}
    recs = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    return {r["step"]: r["value"] for r in recs if r.get("tag") == tag}


def refcfg_generate(card, tmp):
    """(n1): exp_1 on the device path at the record's scale: wall seconds,
    the stage split, every sequence 20 snapshots of each stream."""
    ds = tmp / "refcfg"
    text, launches, wall_s = run_entry(
        "(n1) exp_1_flat_plane", "mmdyn_tpu_torch.cli.exp_1_flat_plane",
        N_GEN_ARGV + ["--logdir", ds / "dataset"], tmp / "n1.log", trace=True)
    stages = {}
    for ln in text.splitlines():
        if ln.startswith("# gen-trace"):
            for part in ln.split(": ", 1)[1].split()[1:]:
                key, val = part.split("=")
                stages[key] = stages.get(key, 0.0) + float(val.rstrip("s"))
    seqs = sorted((ds / "dataset").glob("*/*/sequence_*"))
    for seq in seqs:
        data = json.loads((seq / "data.json").read_text())
        counts = [len(list(seq.glob(f"{stem}_*.png")))
                  for stem in ("visual", "tactile", "seg", "depth")]
        if len(data["time_step"]) != N_SNAPSHOTS or counts != [N_SNAPSHOTS] * 4:
            raise AssertionError(f"(n1): {seq}: {len(data['time_step'])} snapshots, "
                                 f"PNGs {counts}")
    trials = math.prod(int(N_GEN_ARGV[N_GEN_ARGV.index(f) + 1])
                       for f in ("--n_objects", "--trial_per_obj"))
    say(f"[5/6] (n1) exp_1_flat_plane {' '.join(N_GEN_ARGV)} on {card}: {trials} trials "
        f"in {wall_s:.2f} s ({trials / wall_s:.2f} trials/s), {len(seqs)} sequences x "
        f"{N_SNAPSHOTS} snapshots x 4 PNGs ({len(seqs) * N_SNAPSHOTS / wall_s:.1f} "
        f"snapshots written/s); stages summed: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; launches {launches}")
    if launches != ZERO_LAUNCHES or len(seqs) < N_MIN_SEQUENCES:
        raise AssertionError(f"(n1): {len(seqs)} sequences ({N_MIN_SEQUENCES} give one step "
                             f"at batch 128), launches {launches}")
    return ds, {"wall_s": wall_s, "sequences": len(seqs), "stages_s": stages}


def record_series(tag):
    """The JAX record's ``tag`` by epoch (refcfg_exp1_metrics.jsonl)."""
    recs = [json.loads(ln) for ln in
            (REFCFG / "refcfg_exp1_metrics.jsonl").read_text().splitlines() if ln.strip()]
    by_step = {r["step"]: r["value"] for r in recs if r.get("tag") == tag}
    return [by_step[k] for k in sorted(by_step)]


def verdict(gap, band):
    return f"gap {gap:.3%}, bound {band:.0%}: {'met' if gap <= band else 'NOT MET'}"


def train_curve(run):
    """A run's ``Loss/train_epoch`` by epoch and its last-5 mean."""
    train = jsonl_series(run, "Loss/train_epoch")
    train = [train[k] for k in sorted(train)]
    return train, sum(train[-5:]) / 5


def refcfg_train(card, ds, tmp):
    """(n2): cli.main at the reference defaults on (n1)'s dumps (compiled by
    the CLI), 100 epochs of one step; then plot_run on the run; then the
    same run at ``--seed`` 1 and 2 (readings: the spread of epoch 0 and of
    the last-5 mean over initialisations and shuffles). Raised: 1 PoE and 2
    bf16 BCE launches a step, every loss finite, the summary's
    monotone_after_warmup. Against the JAX record (another initialisation
    and another random corpus): epoch 0 and the last-5 mean, each printed
    beside its bound as met or NOT MET."""
    run = tmp / "refcfg_run"
    text, launches, wall_s = run_entry("(n2) cli.main", "mmdyn_tpu_torch.cli.main",
                                       N_TRAIN_ARGV + ["--dataset-path", ds, "--log-dir", run],
                                       tmp / "n2.log")
    split = next((ln for ln in text.splitlines() if ln.startswith("dataset: ")), "")
    _, _, plot_s = run_entry("(n2) plot_run", "mmdyn_tpu_torch.tools.plot_run",
                             ["--run", run, "--out", tmp / "refcfg_exp1.png"], tmp / "plot.log")
    summary = json.loads((tmp / "refcfg_exp1.json").read_text())
    chart = ("drawn" if (tmp / "refcfg_exp1.png").exists()
             else "not drawn (matplotlib is not installed here)")
    record = json.loads((REFCFG / "refcfg_exp1.json").read_text())
    train, last5 = train_curve(run)
    fps = list(jsonl_series(run, "Perf/frames_per_sec").values())
    rec_last5 = sum(record_series("Loss/train_epoch")[-5:]) / 5
    gaps = {"epoch0": rel_gap(train[0], record["train_first"]),
            "last5": rel_gap(last5, rec_last5)}
    want = {"poe_reparam": N_EPOCHS, "bce_sum": 2 * N_EPOCHS, "bce_sum_bf16": 2 * N_EPOCHS}
    say(f"[5/6] (n2) cli.main {' '.join(N_TRAIN_ARGV)} on {card}: {wall_s:.2f} s "
        f"(the dumps' compile included; {split}); train ELBO epoch 0 {train[0]!r} "
        f"(record {record['train_first']}, {verdict(gaps['epoch0'], N_EPOCH0_BAND)}), "
        f"last {train[-1]!r} (record {record['train_last']}), last-5 mean {last5!r} "
        f"(record {rec_last5!r}, {verdict(gaps['last5'], N_LAST5_BAND)}; the port's corpus "
        f"is the device path's, within (j)'s bounds of the record's host path, its trials' "
        f"drops drawn anew, and its initialisation another); plot_run ({plot_s:.2f} s, the "
        f"chart {chart}): {json.dumps(summary)}; the loop's frames/s median "
        f"{summary.get('median_frames_per_sec')} on the card (the record's "
        f"{record['median_frames_per_sec']} is a TPU's), epochs 1-{N_EPOCHS - 1} "
        f"{min(fps[1:]):.1f}-{max(fps[1:]):.1f}; launches {launches} (want {want})")
    if (launches != want or len(train) != N_EPOCHS
            or not all(math.isfinite(v) for v in train) or not summary["monotone_after_warmup"]):
        raise AssertionError(f"(n2): {len(train)} epochs, launches {launches} (want {want}), "
                             f"monotone_after_warmup {summary['monotone_after_warmup']}")
    seeds = {0: (train[0], last5)}
    for seed in N_SEEDS:
        other = tmp / f"refcfg_seed{seed}"
        run_entry(f"(n2) --seed {seed}", "mmdyn_tpu_torch.cli.main",
                  N_TRAIN_ARGV + ["--dataset-path", ds, "--log-dir", other, "--seed", seed],
                  tmp / f"n2_seed{seed}.log")
        curve, seed_last5 = train_curve(other)
        seeds[seed] = (curve[0], seed_last5)
    lo, hi = (min(v[1] for v in seeds.values()), max(v[1] for v in seeds.values()))
    say(f"[5/6] (n2) the same run at seeds {sorted(seeds)} (initialisation and shuffle): "
        f"epoch 0 {[round(v[0], 2) for v in seeds.values()]}, last-5 means "
        f"{[round(v[1], 2) for v in seeds.values()]} (spread {hi / lo - 1:.3%}; the record's "
        f"{rec_last5:.2f} {'inside' if lo <= rec_last5 <= hi else 'outside'} it)")
    return run, {"wall_s": wall_s, "split": split, "summary": summary, "gaps": gaps,
                 "met": {k: gaps[k] <= b for k, b in (("epoch0", N_EPOCH0_BAND),
                                                      ("last5", N_LAST5_BAND))},
                 "last5": last5, "record_last5": rec_last5, "seeds": seeds,
                 "launches": launches}


def refcfg_evaluate(card, run, tmp):
    """(n3): cli.evaluate on (n2)'s run at the record's 2 test batches: the
    launches raised on; the test loss per batch beside the record's, printed
    as met or NOT MET against its 1% bound; the pose, tactile and visual
    measures beside the record's."""
    _, launches, wall_s = run_entry("(n3) cli.evaluate", "mmdyn_tpu_torch.cli.evaluate",
                                    ["--run", run, "--batchsize", N_EVAL_BATCH],
                                    tmp / "n3.log")
    got = json.loads((run / "plot" / "eval_metrics.json").read_text())
    want = json.loads((REFCFG / "refcfg_exp1_eval.json").read_text())
    gap = rel_gap(got["test_loss_per_batch"], want["test_loss_per_batch"])
    keys = [k for k in want if k.startswith("Perf_measure_validation")]
    say(f"[5/6] (n3) cli.evaluate --batchsize {N_EVAL_BATCH} on {card} ({wall_s:.2f} s): "
        f"{got['n_test_batches']} test batches (record {want['n_test_batches']}), test "
        f"loss per batch {got['test_loss_per_batch']!r} (record "
        f"{want['test_loss_per_batch']!r}, {verdict(gap, N_TEST_BAND)}); "
        + "; ".join(f"{k.split('_')[-1]} {got.get(k)!r} (record {want[k]!r})" for k in keys)
        + f"; launches {launches}")
    n = got["n_test_batches"]
    if (launches != {"poe_reparam": n, "bce_sum": 2 * n, "bce_sum_bf16": 2 * n} or n < 1
            or not all(math.isfinite(got[k]) for k in ["test_loss_per_batch"] + keys)):
        raise AssertionError(f"(n3): {n} test batches, launches {launches}, {got}")
    return {"wall_s": wall_s, "metrics": got, "gap": gap, "met": gap <= N_TEST_BAND,
            "launches": launches}


def _latest(run):
    return torch.load(Path(run) / "checkpoint" / "latest", weights_only=True)


def refcfg_preempt(card, ds, tmp):
    """(n4): (n2)'s flags cut to ``N_PREEMPT_EPOCHS`` epochs, uninterrupted and
    killed by SIGTERM once its metrics hold ``N_KILL_AFTER`` step losses,
    then ``--resume``d to the end: the final parameters, Adam's state and
    the generator bit for bit, every step's loss and the replayed epochs'
    validation losses equal."""
    argv = (N_TRAIN_ARGV[:N_TRAIN_ARGV.index("--num-epochs") + 1] + [N_PREEMPT_EPOCHS]
            + N_TRAIN_ARGV[N_TRAIN_ARGV.index("--num-epochs") + 2:] + ["--dataset-path", ds])
    full, pre = tmp / "n4_full", tmp / "n4_pre"
    _, _, full_s = run_entry("(n4) uninterrupted", "mmdyn_tpu_torch.cli.main",
                             argv + ["--log-dir", full], tmp / "n4_full.log")
    proc = start_process(entry_command("mmdyn_tpu_torch.cli.main", argv + ["--log-dir", pre]),
                         tmp / "n4_pre.log")
    deadline = time.monotonic() + N_TIMEOUT
    while len(jsonl_series(pre, "Loss/train_step")) < N_KILL_AFTER:
        if proc.poll() is not None or time.monotonic() > deadline:
            finish_process("(n4) the run to preempt", proc, tmp / "n4_pre.log")
            raise AssertionError("(n4): the run ended before it was sent SIGTERM")
        time.sleep(0.002)
    seen = len(jsonl_series(pre, "Loss/train_step"))
    proc.send_signal(signal.SIGTERM)
    text, _ = finish_process("(n4) the preempted run", proc, tmp / "n4_pre.log")
    stopped = next((ln for ln in text.splitlines() if ln.startswith("preempted:")), None)
    with open(pre / "results.pkl", "rb") as f:
        stopped_epochs = len(pickle.load(f)["Loss/validation_epoch"])
    text, _, resume_s = run_entry("(n4) --resume", "mmdyn_tpu_torch.cli.main",
                                  argv + ["--log-dir", pre, "--resume"], tmp / "n4_resume.log")
    resumed_from = next((ln for ln in text.splitlines() if ln.startswith("resumed from")), "")
    a, b = _latest(full), _latest(pre)
    tensors = {f"model.{k}": (v, b["model"][k]) for k, v in a["model"].items()}
    for i, st in a["optimizer"]["state"].items():
        tensors.update({f"adam.{i}.{k}": (torch.as_tensor(v), torch.as_tensor(
            b["optimizer"]["state"][i][k])) for k, v in st.items()})
    tensors["generator"] = (a["generator"], b["generator"])
    max_diff = max(float((x.double() - y.double()).abs().max()) if x.is_floating_point()
                   else float(not torch.equal(x, y)) for x, y in tensors.values())
    steps_full, steps_pre = (jsonl_series(r, "Loss/train_step") for r in (full, pre))
    with open(full / "results.pkl", "rb") as f:
        val_full = pickle.load(f)["Loss/validation_epoch"]
    with open(pre / "results.pkl", "rb") as f:
        val_resumed = pickle.load(f)["Loss/validation_epoch"]
    say(f"[5/6] (n4) preemption on {card}, {N_PREEMPT_EPOCHS} epochs (cut from "
        f"{N_EPOCHS}): uninterrupted {full_s:.2f} s; SIGTERM after {seen} logged steps "
        f"(>= {N_KILL_AFTER}): {stopped!r}, {stopped_epochs} epochs validated; "
        f"{resumed_from!r} in {resume_s:.2f} s; final state vs the uninterrupted run's: "
        f"max |diff| {max_diff!r} over {len(tensors)} tensors (parameters, Adam's moments "
        f"and step counts, the generator), step {a['step']} / {b['step']}, epoch "
        f"{a['epoch']} / {b['epoch']}; {len(steps_pre)} step losses equal: "
        f"{steps_pre == steps_full}; the {len(val_resumed)} replayed epochs' validation "
        f"losses equal: {val_resumed == val_full[-len(val_resumed):]}")
    ends = {(x["step"], x["epoch"]) for x in (a, b)}
    if (stopped is None or not resumed_from or max_diff != 0.0
            or ends != {(len(steps_full), N_PREEMPT_EPOCHS - 1)} or steps_pre != steps_full
            or len(steps_full) < N_PREEMPT_EPOCHS or not val_resumed
            or val_resumed != val_full[-len(val_resumed):]):
        raise AssertionError("(n4): the SIGTERM'd and resumed run is not the "
                             "uninterrupted one bit for bit")
    return {"killed_after_steps": seen, "stopped": stopped, "max_diff": max_diff,
            "tensors": len(tensors), "uninterrupted_s": full_s, "resume_s": resume_s}


def rerun_probe(ds, log_root):
    """(n5), run in a fresh process (``python -c``): for float32 and
    ``bfloat16_full``, ``cli.main`` trains the seq flagship one epoch at
    batch 512 on ``ds``; then its loop's step (cuDNN's deterministic
    algorithms) runs twice from one state, and so does the unwrapped step
    (torch's defaults, a reading), and both are timed in turns (repaired,
    default, default, repaired), 4 steps each. Prints ``RERUN {...}``."""
    from mmdyn_tpu_torch.cli import main as cli_main
    from mmdyn_tpu_torch.data.loader import to_device_batch

    out = {}
    for policy in ("float32", "bfloat16_full"):
        problem = cli_main.main(
            ["--problem-type", "seq_modeling", "--model-name", "cnn-mvae", "--input-type",
             "visuotactile", "--use-pose", "--batchsize", str(N_RERUN_ROWS), "--dtype",
             policy, "--num-epochs", "1", "--no-tensorboard", "--dataset-path", str(ds),
             "--log-dir", str(Path(log_root) / policy)])
        steps = {"repaired": problem.train_step, "default": problem.train_step.__wrapped__}
        diffs = {k: step_rerun_diff(problem, step) for k, step in steps.items()}
        batch = to_device_batch(next(iter(problem.train_loader)), problem.device)
        ms = {"repaired": [], "default": []}
        for name in ("repaired", "default", "default", "repaired"):
            steps[name](problem.state, batch, problem.generator, 1.0)     # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                steps[name](problem.state, batch, problem.generator, 1.0)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / 4)
        out[policy] = {"rerun_diff": diffs["repaired"][0],
                       "default_rerun_diff": diffs["default"][0],
                       "default_differing": len(diffs["default"][1]), "step_ms": ms,
                       "cudnn_deterministic_after": torch.backends.cudnn.deterministic}
        del problem
        torch.cuda.empty_cache()
    print("RERUN " + json.dumps(out))


def refcfg_rerun(card, tmp):
    """(n5): ``rerun_probe`` in a fresh process on a 700 x 2 corpus (one
    batch of 512 train sequences): the repaired step reruns to 0.0 under
    both policies, with nothing set around it."""
    from mmdyn_tpu_torch.data.compile import COMPILED_NAME
    from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays

    ds = tmp / "n5_ds"
    make_compiled_arrays(ds / COMPILED_NAME, n_sequences=N_RERUN_SEQUENCES, seq_length=2,
                         seed=0, packed_dir=True)
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
            f"chip_smoke.rerun_probe({str(ds)!r}, {str(tmp / 'n5_runs')!r})")
    t0 = time.perf_counter()
    _, out = finish_process("(n5)", start_process([sys.executable, "-c", code], tmp / "n5.log"),
                            tmp / "n5.log", marker="RERUN ")
    for policy, r in out.items():
        mean = {k: sum(v) / len(v) for k, v in r["step_ms"].items()}
        say(f"[5/6] (n5) {policy} at batch {N_RERUN_ROWS} on {card}, a fresh process "
            f"through cli.main's training setup: the loop's step run twice from one state "
            f"differs by {r['rerun_diff']!r} (bound 0.0); unwrapped, with torch's default "
            f"cuDNN algorithms, by {r['default_rerun_diff']!r} ({r['default_differing']} "
            f"parameters); ms/step in turns {r['step_ms']} "
            f"({mean['repaired'] / mean['default'] - 1:+.1%}); the process's cuDNN setting "
            f"after the steps: deterministic={r['cudnn_deterministic_after']}")
    if any(r["rerun_diff"] != 0.0 for r in out.values()):
        raise AssertionError(f"(n5): the repaired step does not rerun bit for bit: {out}")
    return {**out, "wall_s": time.perf_counter() - t0}


def refcfg_path(card, tmp):
    """(n): the reference configuration, (n1)-(n5)."""
    t0 = time.perf_counter()
    ds, gen = refcfg_generate(card, tmp)
    run, train = refcfg_train(card, ds, tmp)
    evaluate = refcfg_evaluate(card, run, tmp)
    preempt = refcfg_preempt(card, ds, tmp)
    rerun = refcfg_rerun(card, tmp)
    wall_s = time.perf_counter() - t0
    say(f"[5/6] (n) the reference configuration on {card}: {wall_s:.1f} s")
    return {"generate": gen, "train": train, "evaluate": evaluate, "preempt": preempt,
            "rerun": rerun, "wall_s": wall_s, "launches": train["launches"]}


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
                                 profile_steps=3, determinism_rows=(512, 128)),
        "dyn_modeling": run_path("(b) dyn_modeling", dyn, kernels, card, mvae_per_step,
                                 seq_len=8, profile_steps=2, top=25),
        "cnn-vae": run_path("(c) cnn-vae", vae, kernels, card,
                            {"poe_reparam": 0, "bce_sum": 0}),
        "seq_bf16_full": run_path("(d) seq flagship", dataclasses.replace(
            flag, compute_dtype="bfloat16_full"), kernels, card, mvae_per_step,
            profile_steps=3, determinism_rows=(512, 128)),
        "dyn_bf16_full": run_path("(e) dyn_modeling", dataclasses.replace(
            dyn, compute_dtype="bfloat16_full"), kernels, card, mvae_per_step, seq_len=8,
            profile_steps=2, top=25),
    }
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_path(kernels, card, paths["seq_modeling"]["frames_per_s"], Path(tmp))
        serve = serve_path(kernels, card, Path(tmp))
        tools = tools_path(kernels, card, Path(tmp))
        corpus = corpus_path(kernels, card, Path(tmp))
        ddp = ddp_path(kernels, card, flag, paths["seq_modeling"]["step_ms"],
                       cli.pop("_det_params"), Path(tmp))
    datagen = datagen_path(kernels, card)
    with tempfile.TemporaryDirectory() as tmp:
        simcli = simcli_path(kernels, card, datagen.pop("_chunk"), Path(tmp))
        tools["dumps"] = tools_dump_path(kernels, card, Path(tmp))
        convergence = convergence_path(kernels, card, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        refcfg = refcfg_path(card, Path(tmp))

    for e in entries:
        # the bf16 kernel's main path is (d), the others' (a)
        main = "seq_bf16_full" if e["name"] == "bce_sum_bf16" else "seq_modeling"
        e["launches"] = paths[main]["launches"][e["name"]]
        e["launches_by_path"] = {name: p["launches"][e["name"]] for name, p in paths.items()}
        e["launches_by_path"]["cli"] = cli["launches"][e["name"]]
        e["launches_by_path"]["serve"] = serve["launches"][e["name"]]
        e["launches_by_path"]["corpus"] = corpus["launches"][e["name"]]
        e["launches_by_path"]["datagen"] = datagen["launches"][e["name"]]
        e["launches_by_path"]["simcli"] = simcli["launches"][e["name"]]
        e["launches_by_path"]["tools"] = (tools["launches"][e["name"]]
                                          + tools["dumps"]["launches"][e["name"]])
        e["launches_by_path"]["ddp"] = ddp["launches"][e["name"]]
        e["launches_by_path"]["parity"] = convergence["launches"][e["name"]]
        e["launches_by_path"]["refcfg"] = refcfg["launches"][e["name"]]
    if any(m.split(".")[0] in ("jax", "mmdyn_tpu") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")
    say("[6/6] " + json.dumps({**{name: {k: p[k] for k in (
        "step_ms", "frames_per_s", "peak_gib", "busy_share", "conv_share") if k in p}
        for name, p in paths.items()}, "cli": cli, "serve": serve, "corpus": corpus,
        "datagen": datagen, "simcli": simcli, "tools": tools, "ddp": ddp,
        "convergence": convergence, "refcfg": refcfg}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
