"""Training cells: the program's training loop, epoch after epoch.

Set-up builds ``mmdyn_tpu_torch.train.loop.Problem`` on a corpus that the
benchmark writes, the way ``cli.main`` builds it (``set_reference_precision``,
no TensorBoard, logs under ``TMPDIR``), loads the benchmark's weights into
its model, seeds its training generator, and warms it up with whole epochs
of ``Problem._train_epoch``: the loader, ``device_prefetch``, the step
under cuDNN's deterministic algorithms and the per-epoch read-back. The
first three of those steps are recorded (the batch each saw, the loss,
Adam's first moment after one step, the parameters after three) and the
plain reference follows them once the window has closed.

The window trains on from there, calling ``_train_epoch`` with the next
epoch and its KL weight, as ``Problem.train`` does, until ``--seconds``
have passed, and ends with a ``synchronize``: ``train_frames_per_s`` is
every frame trained in it (B rows a step; B x T for dyn_modeling) over its
wall seconds. Test epochs, checkpoints and images stay outside it.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from bench_port import checks, core, devtrace
from bench_port.counts import model as counts
from bench_port.counts import peaks

TRAIN_FRAC = 0.8            # the program's split (data/dataset.py), first 80% train
WEIGHTS, NOISE, CORPUS, LOADER = range(4)   # seed streams
RECORDED_STEPS = 3
FAULTS = ("unchanged", "half_batch", "altered_loss")


def corpus_size(mix):
    """Sequences so that the train split holds exactly ``steps_per_epoch``
    batches (the test split, which no step reads, takes the rest)."""
    return math.ceil(mix["batch"] * mix["steps_per_epoch"] / TRAIN_FRAC)


def make_corpus(torch, root, mix, seed, device):
    """A compiled corpus of seeded frames in the packed layout that the
    program's ``data/compile.py::load_packed`` reads: one ``.npy`` per key
    under ``root/compiled_dataset_v2.npz/``. Each sequence has a brightness
    level and a noise amplitude of its own, so rows differ as real frames
    do. Made on the device in a few calls, written once."""
    n, t = corpus_size(mix), mix["seq_length"]
    g = torch.Generator(device).manual_seed(core.seed_words(seed, CORPUS))

    def frames(*shape):
        lead = (n,) + (1,) * (len(shape))
        level = torch.rand(lead, generator=g, device=device)
        amp = torch.rand(lead, generator=g, device=device)
        u = torch.rand((n,) + shape, generator=g, device=device)
        x = (level + amp * (u - 0.5)).clamp_(0.0, 1.0).mul_(255.0).round_()
        return x.to(torch.uint8).cpu().numpy()

    packed = {
        "visual": frames(t, 64, 64, 3), "tactile": frames(t, 64, 64, 3),
        "final_visual": frames(64, 64, 3), "final_tactile": frames(64, 64, 3),
        "pose": torch.rand((n, t, 7), generator=g, device=device).cpu().numpy(),
        "final_pose": torch.rand((n, 7), generator=g, device=device).cpu().numpy(),
        "avail": np.ones((n, t, 2), np.float32),
        "seq_length": np.int64(t), "has_shock": np.bool_(False), "crop": np.bool_(True),
        "pose_min": np.zeros(7, np.float32), "pose_max": np.ones(7, np.float32),
    }
    out = Path(root) / "compiled_dataset_v2.npz"
    out.mkdir(parents=True)
    for k, v in packed.items():
        np.save(out / f"{k}.npy", v)
    return packed


def make_weights(torch, model, seed, device):
    """The weights of ``model``'s parameters (the reference's names, which
    the program's model shares), made on the device from ``seed`` in one
    draw: torch's default init, U(-1, 1) / sqrt(fan_in) for every conv and
    linear weight and bias (fan_in as torch counts it), BatchNorm's scale 1
    and shift 0."""
    from bench_port.reference.model import BatchNorm

    params = list(model.named_parameters())
    by_name = dict(params)
    g = torch.Generator(device).manual_seed(core.seed_words(seed, WEIGHTS))
    u = torch.rand(sum(p.numel() for _, p in params), generator=g, device=device)
    u = u.mul_(2.0).sub_(1.0)
    bn = {f"{name}.{leaf}" for name, m in model.named_modules() if isinstance(m, BatchNorm)
          for leaf in ("weight", "bias")}
    out, at = {}, 0
    for name, p in params:
        if name in bn:
            out[name] = torch.full_like(p, 1.0 if name.endswith("weight") else 0.0,
                                        device=device)
            continue
        owner = by_name[name.rsplit(".", 1)[0] + ".weight"]
        fan_in = owner.shape[1] * math.prod(owner.shape[2:])
        out[name] = (u[at:at + p.numel()].view(p.shape) / math.sqrt(fan_in)).clone()
        at += p.numel()
    return out


def problem_config(config, mix):
    from mmdyn_tpu_torch.problems.base import ProblemConfig

    m = config["model"]
    return ProblemConfig(problem_type=m["problem_type"], model_name=m["model_name"],
                         input_type=m["input_type"], use_pose=m["use_pose"],
                         latent_size=m["latent_size"], compute_dtype=m["compute_dtype"],
                         lr=m["lr"], optimizer=m["optimizer"],
                         pose_multiplier=m["pose_multiplier"],
                         annealing_epochs=m["annealing_epochs"], mask_loss=m["mask_loss"],
                         batchsize=mix["batch"], num_epochs=1 << 20)


def kl_weight(epoch, annealing_epochs):
    """The KL annealing schedule (problems.py:212-216)."""
    return (epoch + 1) / annealing_epochs if epoch < annealing_epochs else 1.0


class StepRecorder:
    """Stands in for ``problem.train_step`` and calls it: counts the steps,
    and for the first ``RECORDED_STEPS`` keeps the batch (on the host), the
    loss, Adam's first moment after step 1 and the parameters after the
    last. ``fault`` breaks the step underneath, for the fault tests."""

    def __init__(self, problem, fault=None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
        self.inner = problem.train_step
        self.fault = fault
        self.calls = 0
        self.batches, self.losses = [], []
        self.first_moment = self.params = None

    def __call__(self, state, batch, generator, kl_weight):
        i = self.calls
        self.calls += 1
        if i < RECORDED_STEPS:
            self.batches.append({k: v.detach().cpu() for k, v in batch.items()})
        state, metrics = self._step(state, batch, generator, kl_weight)
        if i < RECORDED_STEPS:
            self.losses.append(metrics["loss"].detach().clone())
            named = list(state.model.named_parameters())
            if i == 0:
                opt = state.optimizer
                self.first_moment = {
                    n: opt.state[p]["exp_avg"].detach().clone() / (1 - opt.defaults["betas"][0])
                    for n, p in named if "exp_avg" in opt.state.get(p, {})}
            if i == RECORDED_STEPS - 1:
                self.params = {n: p.detach().clone() for n, p in named}
        return state, metrics

    def _step(self, state, batch, generator, kl_weight):
        if self.fault == "half_batch":
            half = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if self.fault == "unchanged":
            real = state.optimizer.step
            state.optimizer.step = lambda *a, **k: None
            try:
                return self.inner(state, batch, generator, kl_weight)
            finally:
                state.optimizer.step = real
        state, metrics = self.inner(state, batch, generator, kl_weight)
        if self.fault == "altered_loss":
            metrics = dict(metrics, loss=metrics["loss"] * 1.01)
        return state, metrics


def match_rows(corpus, batches):
    """The corpus rows of each recorded batch, found by their pose, and the
    number of rows that are not distinct train rows equal, key by key, to
    what the benchmark wrote."""
    import torch

    n_train = int(TRAIN_FRAC * corpus["pose"].shape[0])
    index = {corpus["pose"][i, 0].tobytes(): i for i in range(n_train)}
    rows, bad = [], 0
    for batch in batches:
        t = batch["pose"].shape[1]
        idx = [index.get(batch["pose"][b, 0].numpy().tobytes(), -1)
               for b in range(batch["pose"].shape[0])]
        bad += sum(i < 0 for i in idx) + len(idx) - len(set(idx))
        ok = np.array([i for i in idx if i >= 0], dtype=np.int64)
        keep = [j for j, i in enumerate(idx) if i >= 0]
        for k, v in batch.items():
            want = corpus[k][ok]
            if want.ndim == v.ndim and k in ("visual", "tactile", "pose", "avail"):
                want = want[:, :t]
            want = torch.from_numpy(np.ascontiguousarray(want))
            got = v[keep]
            if want.dtype == torch.uint8:
                # the frames as the benchmark wrote them: x / 255 on the
                # device may round in its last bit, so compare the bytes
                got = torch.round(got * 255.0).to(torch.uint8)
            same = (got == want).reshape(len(keep), -1).all(dim=1)
            bad += int((~same).sum())
        rows.append(idx)
    return rows, bad


def reference_batch(torch, corpus, idx, problem_type, device):
    """The reference's own inputs and targets of the rows ``idx``, worked
    out from the corpus: frame 0 against the resting frames
    (seq_modeling); every frame against the next, a sequence's last against
    its resting frame, and the pose against the next row's, wrapping over
    the batch (dyn_modeling, problems.py:765-803)."""
    def img(key, sl=slice(None)):
        return torch.from_numpy(np.ascontiguousarray(corpus[key][idx][:, sl])).to(
            device).to(torch.float32) / 255.0

    def vec(key):
        return torch.from_numpy(np.ascontiguousarray(corpus[key][idx])).to(device)

    if problem_type == "seq_modeling":
        return {"visual": img("visual", 0), "tactile": img("tactile", 0),
                "pose": vec("pose")[:, 0], "t_visual": img("final_visual"),
                "t_tactile": img("final_tactile"), "t_pose": vec("final_pose")}
    out = {}
    for m in ("visual", "tactile"):
        x = img(m)                                      # (B, T, 64, 64, 3)
        nxt = torch.cat([x[:, 1:], img(f"final_{m}")[:, None]], dim=1)
        out[m] = x.reshape(-1, 64, 64, 3)
        out[f"t_{m}"] = nxt.reshape(-1, 64, 64, 3)
    pose = vec("pose").reshape(-1, 7)
    out["pose"], out["t_pose"] = pose, torch.roll(pose, -1, dims=0)
    return out


def follow_reference(torch, config, mix, corpus, rows, weights, seed, device, precision):
    """The reference's three steps on the rows the program's steps saw:
    (losses, first gradients, parameters after the last step)."""
    from bench_port.reference.model import MVAE, strict_float32, train_steps

    m = config["model"]
    with strict_float32():
        ref = MVAE(m["latent_size"]).to(device).set_precision(precision)
        ref.load_state_dict(weights, strict=True)
        gen = torch.Generator(device).manual_seed(core.seed_words(seed, NOISE))
        batches = [reference_batch(torch, corpus, np.asarray(r), m["problem_type"], device)
                   for r in rows]
        return train_steps(ref, batches, gen, kl_weight(0, m["annealing_epochs"]), m["lr"],
                           m["pose_multiplier"])


def readings(rec):
    """The program's (losses, first gradients, parameters after the last
    recorded step), as ``follow_reference`` returns the reference's."""
    return ([float(x) for x in rec.losses], rec.first_moment or {}, rec.params or {})


def compare(torch, prog, ref, weights):
    """The gaps of two sets of readings: (values, details), the details each
    step's loss gap and the leaf gaps' median and worst leaves."""
    leaves = checks.counted_leaves(ref[1])
    cpu = {n: w.detach().to("cpu", torch.float64) for n, w in weights.items()}

    def delta(params):
        return {n: p.to("cpu", torch.float64) - cpu[n] for n, p in params.items()}

    steps = checks.step_loss_gaps(prog[0], ref[0])
    grad = checks.leaf_gaps({n: g.cpu() for n, g in prog[1].items()},
                            {n: g.cpu() for n, g in ref[1].items()}, leaves)
    update = checks.leaf_gaps(delta(prog[2]), delta(ref[2]), leaves)
    values = {"loss_gap_step1": steps[0], "grad_gap": max(grad.values()),
              "grad_median_gap": checks.summary(grad)["median"],
              "update_gap": max(update.values())}
    details = {"step_loss_gaps": steps, "grad": checks.summary(grad),
               "update": checks.summary(update), "leaves": len(leaves),
               "leaves_left_out": len(ref[1]) - len(leaves)}
    return values, details


def run(args, cell, config, mix, limits, metrics, t_start, device="cuda", fault=None,
        control=None):
    """One run of a training cell; returns (result, checks)."""
    import torch

    from mmdyn_tpu_torch.train.loop import Problem
    from mmdyn_tpu_torch.utils.device import set_reference_precision

    from bench_port.reference.model import MVAE

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    m = config["model"]
    if mix["steps_per_epoch"] < RECORDED_STEPS:
        raise ValueError(f"the first epoch must hold the {RECORDED_STEPS} recorded steps")
    set_reference_precision()
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        corpus = make_corpus(torch, Path(tmp) / "data", mix, args.seed, device)
        cfg = problem_config(config, mix)
        problem = Problem(cfg, Path(tmp) / "data", log_dir=Path(tmp) / "run",
                          seed=core.seed_words(args.seed, LOADER), device=device,
                          tensorboard=False)
        with torch.device("meta"):
            shapes = MVAE(m["latent_size"])
        weights = make_weights(torch, shapes, args.seed, device)
        problem.model.load_state_dict(weights, strict=True)
        problem.generator.manual_seed(core.seed_words(args.seed, NOISE))
        rec = StepRecorder(problem, fault)
        problem.train_step = rec

        epochs = itertools.count()

        def train_epoch():
            epoch = next(epochs)
            return math.isfinite(problem._train_epoch(
                epoch, kl_weight(epoch, m["annealing_epochs"])))

        for _ in range(mix["warm_epochs"]):
            train_epoch()
        finite = True
        sync()
        setup_s = time.monotonic() - t_start

        rows = mix["batch"] * (mix["seq_length"] if m["problem_type"] == "dyn_modeling" else 1)
        # the window: whole epochs until --seconds have passed; a traced run
        # then profiles the device alone over ``trace_epochs`` more, and the
        # host too over one more (the profiler's cost to a host-bound loop
        # makes those epochs slower: the step period is the untraced one's)
        steps0 = rec.calls
        t0 = time.monotonic()
        ends = [t0]
        while ends[-1] - t0 < args.seconds:
            finite &= train_epoch()
            ends.append(time.monotonic())
        sync()
        window_s = time.monotonic() - t0
        steps = rec.calls - steps0
        epoch_ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
        print(f"reading epochs {len(epoch_ms)}: ms min {epoch_ms[0]:.1f} median "
              f"{core.median(epoch_ms):.1f} max {epoch_ms[-1]:.1f}", file=sys.stderr)
        traced, hosted = {}, {}
        if args.trace:
            traced_from = rec.calls
            with devtrace.traced(torch, traced, cuda):
                for _ in range(mix["trace_epochs"]):
                    finite &= train_epoch()
            traced_steps = rec.calls - traced_from
            with devtrace.traced(torch, hosted, cuda, host=True):
                finite &= train_epoch()
        device_out = core.device_info(torch) if cuda else {
            "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

        # the program's state goes before the reference runs on the device
        rec.inner = problem = train_epoch = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        rows_idx, rows_bad = match_rows(corpus, rec.batches)
        ref = follow_reference(torch, config, mix, corpus, rows_idx, weights, args.seed,
                               device, "float32")
        values, details = compare(torch, readings(rec), ref, weights)
        record = {"program": dict(values, **details)}
        if control is not None:
            # the control: the reference at a lower precision in the program's place
            values, details = compare(torch, follow_reference(
                torch, config, mix, corpus, rows_idx, weights, args.seed, device, control),
                ref, weights)
            record["control"] = dict(values, **details)
        for side, r in record.items():
            print(f"reading {side} {json.dumps(r)}", file=sys.stderr)
        values["rows_bad"] = float(rows_bad)
        values["window_losses_nonfinite"] = 0.0 if finite else 1.0

    limits = dict(limits, rows_bad=0.0, window_losses_nonfinite=0.0)
    checks_out, ok = checks.judge(values, limits)
    result = {"correct": ok, "attempted": steps, "failed": 0 if finite else steps,
              "metrics": {}, "device": device_out, "readings": record}
    if args.trace:
        tr = traced["trace"]
        ctx = SimpleNamespace(trace=tr, steps=traced_steps, rows=rows,
                              window_steps=steps, window_s=window_s,
                              latent=m["latent_size"], policy=m["compute_dtype"],
                              peak_flops=peaks.peak_flops(config["precision"]),
                              counts=counts)
        result["metrics"] = core.read_metrics(metrics["per_layer"], ctx)
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": hosted["trace"].idle_gaps()}
    else:
        result["metrics"] = {
            "train_frames_per_s": {"value": steps * rows / window_s, "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    return result, checks_out
