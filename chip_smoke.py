#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``mmdyn_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py              # from the repository root

Phases, one line each, any failure raises and exits non-zero:

1. torch version; TF32 off for cuDNN convolutions and for matmuls, so that
   float32 means float32 in every comparison below.
2. Build the CUDA kernels from ``mmdyn_tpu_torch/ops/csrc`` with nvcc.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (batch 512) and at a ragged small shape: PoE with both
   subset tables (rtol 1e-5, atol 1e-6), BCE with and without mask (rel
   1e-5, and bit-identical across two launches). Kernel, plain-version and
   library-call times (CUDA events, L2 flushed before every launch) beside
   the byte / operation bound of the H100 SXM (3.35 TB/s, 67 TFLOP/s f32).
4. One flagship train step (cnn-mvae, visuotactile + pose, seq_modeling,
   latent 256, float32) at batch 32 on the card against the same step on
   the CPU (same weights, noise-free, no dropout): loss rel 1e-4 over two
   steps. Then the main path: 5 steps at batch 512 through ``setup_model``
   / ``make_optimizer`` / ``make_train_step`` on one repeated synthetic
   batch; the losses are finite and fall, and every step launched the PoE
   kernel once and the BCE kernel twice. Three more steps under
   torch.profiler give the device time by kernel and the device's busy
   share (the top 40 kernels printed).
5. A ``kernels`` JSON line, the card's name and power limit from nvidia-smi,
   and last the result line.

Without a CUDA device the script prints no result and exits 1.
"""

import dataclasses
import json
import math
import subprocess
import sys
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


def synthetic_batch(b, seed=0, seq_len=2):
    """The bench.py synthetic batch: uniform images and pose, NHWC."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return {
        "visual": f(b, seq_len, 64, 64, 3), "tactile": f(b, seq_len, 64, 64, 3),
        "pose": f(b, seq_len, 7), "avail": np.ones((b, seq_len, 2), np.float32),
        "final_visual": f(b, 64, 64, 3), "final_tactile": f(b, 64, 64, 3),
        "final_pose": f(b, 7), "seg": np.ones((b, seq_len, 64, 64, 3), np.float32),
    }


def check_poe(kernels, recon, timer, dev, b=512, d=256):
    g = torch.Generator(device=dev).manual_seed(1)
    worst, entry = 0.0, None
    cases = [("no_pose", recon.SUBSETS_NO_POSE, b, d), ("pose", recon.SUBSETS_POSE, b, d),
             ("ragged", recon.SUBSETS_POSE[3:5], 3, 5)]
    for name, rows, bb, dd in cases:
        mask = torch.tensor(rows, dtype=torch.float32, device=dev)
        if name == "ragged":
            mask = mask[:, 1:3].contiguous()          # K=2, M=2
        k, m = mask.shape
        mu, lv = (torch.randn((m, bb, dd), generator=g, device=dev) for _ in range(2))
        noise = torch.randn((k, bb, dd), generator=g, device=dev)
        got = kernels._poe_reparam_cuda(mu, lv, mask, noise)
        want = kernels.poe_reparam_plain(mu, lv, mask, noise)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            worst = max(worst, float((x - y).abs().max()))
        if name == "pose":
            n = bb * dd
            ms = timer(lambda: kernels._poe_reparam_cuda(mu, lv, mask, noise))
            plain_ms = timer(lambda: kernels.poe_reparam_plain(mu, lv, mask, noise))
            bytes_moved = (2 * m + k) * n * 4 + 3 * k * n * 4 + mask.numel() * 4
            # per element: M x (exp, 2 add, div, mul); per subset: 2M fma,
            # div, div, add, log, mul, exp, fma
            bound_ms, bound_by = bound(bytes_moved, n * (5 * m + k * (4 * m + 8)))
            entry = {"name": "poe_reparam", "route": "cuda",
                     "source": "mmdyn_tpu_torch/ops/csrc/poe_reparam.cu",
                     "replaces": POE_REPLACES, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "shape": f"M={m} K={k} B={bb} D={dd}", "bytes": bytes_moved}
    entry["max_abs_err"] = worst
    say(f"[3/6] poe_reparam ok (no_pose, pose, ragged): max |kernel - plain| "
        f"{worst:.3g}; {entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f} ms, "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bytes'] / 1e6:.2f} MB)")
    return entry


def check_bce(kernels, timer, dev, k=4, b=512, p=64 * 64 * 3):
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(2)
    worst_rel, entry = 0.0, None
    for name, kk, bb, pp in (("main", k, b, p), ("ragged", 3, 3, 7)):
        x = torch.randn((kk, bb, pp), generator=g, device=dev) * 3
        z = torch.rand((bb, pp), generator=g, device=dev)
        mask = (torch.rand((bb, pp), generator=g, device=dev) > 0.3).float()
        for m in (None, mask):
            got = kernels._bce_sum_cuda(x, z, m)
            again = kernels._bce_sum_cuda(x, z, m)
            if not torch.equal(got, again):
                raise AssertionError(f"bce_sum differs between two launches: "
                                     f"{float(got)!r} vs {float(again)!r}")
            want = kernels.bce_sum_plain(x, z, m)
            rel = abs(float(got) - float(want)) / abs(float(want))
            if rel > 1e-5:
                raise AssertionError(f"bce_sum {name} mask={m is not None}: "
                                     f"{float(got)!r} vs plain {float(want)!r}")
            worst_rel = max(worst_rel, rel)
            if name == "main" and m is None:
                err = abs(float(got) - float(want))
                ms = timer(lambda: kernels._bce_sum_cuda(x, z, None))
                plain_ms = timer(lambda: kernels.bce_sum_plain(x, z, None))
                library_ms = timer(lambda: F.binary_cross_entropy_with_logits(
                    x, z.expand_as(x), reduction="sum"))
                bytes_moved = (x.numel() + z.numel()) * 4 + 4
                # per logit: max, mul, sub, abs, exp, log1p, 2 add
                bound_ms, bound_by = bound(bytes_moved, 8 * x.numel())
                entry = {"name": "bce_sum", "route": "cuda",
                         "source": "mmdyn_tpu_torch/ops/csrc/bce_sum.cu",
                         "replaces": BCE_REPLACES, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms,
                         "shape": f"K={kk} B={bb} P={pp}", "bytes": bytes_moved}
        if name == "main":
            masked_ms = timer(lambda: kernels._bce_sum_cuda(x, z, mask))
    entry["masked_ms"] = masked_ms
    say(f"[3/6] bce_sum ok (main, ragged; mask and none; bit-identical reruns): "
        f"max rel err {worst_rel:.3g}; {entry['ms']:.4f} ms (masked {masked_ms:.4f}) "
        f"vs plain {entry['plain_ms']:.4f} ms, library {entry['library_ms']:.4f} ms, "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bytes'] / 1e6:.1f} MB)")
    return entry


def flagship(cfg, device, seed=0, **model_kwargs):
    from mmdyn_tpu_torch.models import setup_model
    from mmdyn_tpu_torch.problems import make_optimizer
    from mmdyn_tpu_torch.train import create_train_state, make_train_step

    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device=device,
                        seed=seed, latent_size=cfg.latent_size, use_pose=cfg.use_pose,
                        **model_kwargs)
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    return state, make_train_step(cfg, device=device)


def check_card_vs_cpu(cfg, b=32, steps=2):
    cfg = dataclasses.replace(cfg, batchsize=b, noise_free=True)
    batch = synthetic_batch(b, seed=3)
    losses = {}
    for dev in ("cuda", "cpu"):
        state, step = flagship(cfg, dev, dropout_rate=0.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        losses[dev] = [float(step(state, batch, gen, 1.0)[1]["loss"])
                       for _ in range(steps)]
    for i, (a, c) in enumerate(zip(losses["cuda"], losses["cpu"])):
        if not math.isclose(a, c, rel_tol=1e-4):
            raise AssertionError(f"step {i}: card loss {a!r} vs cpu {c!r}")
    say(f"[4/6] batch {b}: card matches cpu over {steps} steps (rel 1e-4): "
        f"card {losses['cuda']} cpu {losses['cpu']}")


def main_path(cfg, kernels, steps=5, device=None):
    state, step = flagship(cfg, device)               # the card, by default
    dev = next(state.model.parameters()).device
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg.batchsize).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    kl = torch.tensor(1.0, device=dev)
    kernels.fused_poe_reparam.launches = 0
    kernels.fused_masked_bce_sum.launches = 0
    losses = []
    _, metrics = step(state, batch, gen, kl)          # step 1 also warms up
    losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        _, metrics = step(state, batch, gen, kl)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    launches = {"poe_reparam": kernels.fused_poe_reparam.launches,
                "bce_sum": kernels.fused_masked_bce_sum.launches}
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if launches != {"poe_reparam": steps, "bce_sum": 2 * steps}:
        raise AssertionError(f"kernel launches {launches} over {steps} steps")
    return state, step, batch, gen, kl, losses, launches, step_s


def profile(step, state, batch, gen, kl, steps=3, top=40):
    """torch.profiler over a few steps: device time by kernel and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, gen, kl)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    say(f"[profile] {steps} steps, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); top kernels per step:")
    for e in events[:top]:
        say(f"  {dev_us(e) / 1e3 / steps:10.4f} ms/step {e.count // steps:5d}x  "
            f"{e.key[:140]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mmdyn_tpu_torch.ops import build, kernels
    from mmdyn_tpu_torch.problems import ProblemConfig
    from mmdyn_tpu_torch.problems import reconstruction as recon

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    say(f"[1/6] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card}); TF32 off (cuDNN and matmul)")

    secs = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    say(f"[2/6] built {', '.join(build.SOURCES)} for sm_90a in {secs:.1f} s")

    dev = torch.device("cuda")
    timer = Timer(dev)
    entries = [check_poe(kernels, recon, timer, dev), check_bce(kernels, timer, dev)]

    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=256,
                        batchsize=512, compute_dtype="float32")
    check_card_vs_cpu(cfg)
    state, step, batch, gen, kl, losses, launches, step_s = main_path(cfg, kernels)
    say(f"[4/6] main path: cnn-mvae visuotactile+pose seq_modeling latent 256 f32, "
        f"batch {cfg.batchsize}: {step_s * 1e3:.3f} ms/step, "
        f"{cfg.batchsize / step_s:.1f} frames/s on {card}; losses {losses}; "
        f"launches {launches}")
    profile(step, state, batch, gen, kl)

    for e in entries:
        e["launches"] = launches[e["name"]]
    if any(m.split(".")[0] in ("jax", "mmdyn_tpu") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")
    say("[5/6] " + json.dumps({"step_ms": step_s * 1e3,
                               "frames_per_s": cfg.batchsize / step_s}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
