#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``mmdyn_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py              # from the repository root

Phases, any failure raises and exits non-zero:

1. torch version; TF32 off for cuDNN convolutions and for matmuls, so that
   float32 means float32 in every comparison below.
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
   and the timer's floor: one launch of a one-float ``zero_()``.
4. Train steps on the card against the same steps on the CPU (same weights,
   no dropout, loss rel 1e-4 over two steps): the seq flagship at batch 32;
   dyn_modeling at 8 x 4 with ``mask_loss`` (the masked BCE kernel inside a
   step); the conditional MVAE with a 3-wide shock; cnn-vae seq_modeling
   visual; mlp-vae reconstruction tactile; the conditional regressor. The
   MVAEs run noise-free; the VAEs' reparameterisation noise is pinned to one
   CPU-drawn tensor on both devices for the check's duration.
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
       launch (its loss has no kernel in the JAX package either).
   ms/step and frames/s of each (frames: B rows per step, B * T for dyn).
6. A ``kernels`` JSON line, the card's name and power limit from nvidia-smi,
   and last the result line.

Without a CUDA device the script prints no result and exits 1.
"""

import contextlib
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
PORT_KERNELS = ("poe_reparam", "bce_partial", "bce_final")   # device kernel names


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


def check_card_vs_cpu(kernels, cfg, b, seq_len=2, shock=0, launches=(0, 0), steps=2):
    """Two train steps on the card and on the CPU from the same weights and
    batch, no dropout: the losses agree to rel 1e-4, and each card step
    launched (PoE, BCE) = ``launches`` kernels."""
    cfg = dataclasses.replace(cfg, batchsize=b, noise_free=cfg.is_mvae)
    batch = synthetic_batch(b, seed=3, seq_len=seq_len, shock=shock,
                            random_seg=cfg.mask_loss)
    losses = {}
    with pinned_vae_noise():
        for dev in ("cuda", "cpu"):
            state, step = train_state(cfg, dev, dropout_rate=0.0)
            gen = torch.Generator(device=dev).manual_seed(0)
            kernels.fused_poe_reparam.launches = kernels.fused_masked_bce_sum.launches = 0
            losses[dev] = [float(step(state, batch, gen, 1.0)[1]["loss"])
                           for _ in range(steps)]
            if dev == "cuda":
                got = (kernels.fused_poe_reparam.launches,
                       kernels.fused_masked_bce_sum.launches)
                if got != tuple(steps * n for n in launches):
                    raise AssertionError(f"{cfg.model_name} {cfg.problem_type}: "
                                         f"(PoE, BCE) launches {got} over {steps} steps")
    for i, (a, c) in enumerate(zip(losses["cuda"], losses["cpu"])):
        if not math.isclose(a, c, rel_tol=1e-4):
            raise AssertionError(f"{cfg.model_name} {cfg.problem_type} step {i}: "
                                 f"card loss {a!r} vs cpu {c!r}")
    rows = b * seq_len if cfg.problem_type == "dyn_modeling" else b
    say(f"[4/6] {cfg.model_name} {cfg.problem_type} {cfg.input_type}"
        f"{' +pose' if cfg.use_pose and cfg.is_mvae else ''}"
        f"{f' cond S={shock}' if cfg.conditional else ''}"
        f"{' mask' if cfg.mask_loss else ''}, {rows} rows: card matches cpu over "
        f"{steps} steps (rel 1e-4), (PoE, BCE) launches per step {launches}: "
        f"card {losses['cuda']} cpu {losses['cpu']}")


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
    kernels.fused_poe_reparam.launches = 0
    kernels.fused_masked_bce_sum.launches = 0
    losses = [step(state, batch, gen, kl)[1]["loss"]]  # step 1 also warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(step(state, batch, gen, kl)[1]["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    launches = {"poe_reparam": kernels.fused_poe_reparam.launches,
                "bce_sum": kernels.fused_masked_bce_sum.launches}
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite and falling: {losses}")
    want = {name: n * steps for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} over {steps} "
                             f"steps, expected {want}")
    dyn = cfg.problem_type == "dyn_modeling"
    frames = cfg.batchsize * (seq_len if dyn else 1)
    say(f"[5/6] {label}: {cfg.model_name} {cfg.input_type}"
        f"{'+pose' if cfg.use_pose and cfg.is_mvae else ''} {cfg.problem_type} "
        f"latent {cfg.latent_size} f32, batch {cfg.batchsize}"
        f"{f' x {seq_len}' if dyn else ''}: {step_s * 1e3:.3f} ms/step, "
        f"{frames / step_s:.1f} frames/s on {card}; losses {losses}; launches "
        f"{launches} over {steps} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile_steps:
        profile(step, state, batch, gen, kl, steps=profile_steps, top=top)
    del state, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"step_ms": step_s * 1e3, "frames_per_s": frames / step_s,
            "launches": launches, "launches_per_step": per_step}


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
    # the port's own kernels, whatever their rank (L2 as the step leaves it)
    ours = [e for e in events if any(k in e.key for k in PORT_KERNELS)]
    if not ours:
        raise AssertionError(f"the profile shows none of {PORT_KERNELS}")
    say("[profile] the port's kernels per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / steps:.4f} ms in {e.count // steps}x "
        f"({dev_us(e) / e.count:.2f} us each)" for e in ours))


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

    mvae_per_step = {"poe_reparam": 1, "bce_sum": 2}
    torch.cuda.reset_peak_memory_stats()
    paths = {
        "seq_modeling": run_path("(a) seq flagship", flag, kernels, card, mvae_per_step,
                                 profile_steps=3),
        "dyn_modeling": run_path("(b) dyn_modeling", dyn, kernels, card, mvae_per_step,
                                 seq_len=8, profile_steps=2, top=25),
        "cnn-vae": run_path("(c) cnn-vae", vae, kernels, card,
                            {"poe_reparam": 0, "bce_sum": 0}),
    }

    for e in entries:
        e["launches"] = paths["seq_modeling"]["launches"][e["name"]]
        e["launches_by_path"] = {name: p["launches"][e["name"]] for name, p in paths.items()}
        e["launches_per_step"] = {name: p["launches_per_step"][e["name"]]
                                  for name, p in paths.items()}
    if any(m.split(".")[0] in ("jax", "mmdyn_tpu") for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")
    say("[6/6] " + json.dumps({name: {"step_ms": p["step_ms"],
                                      "frames_per_s": p["frames_per_s"]}
                               for name, p in paths.items()}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
