"""Training-trajectory parity harness on the port: train the port's
production step and the reference-semantics golden model (``tools/gold.py``)
side by side on the SAME data and compare their ELBO trajectories.

The port's side (``run_port``) is the step ``cli.main`` runs:
``setup_model`` -> ``make_optimizer`` -> ``make_train_step``, with the KL
schedule of ``problems/base.py::anneal_kl``; on an MVAE every step launches
the fused PoE kernel once and the BCE kernel twice. The golden side
(``run_torch``) evaluates the reference's sequential subset passes in
float32, whatever ``--dtype`` says. Both use Adam(lr), the same KL schedule
and the same batches in the same order, on the same device. Problems:

  * ``seq_modeling``  input = frame 0 per sequence, target = resting frame
                      (problems.py:634-673).
  * ``dyn_modeling``  input = every frame (B*T flattened), target =
                      roll(-1) with the resting-frame patch at sequence
                      ends; pose targets rolled WITHOUT the patch
                      (problems.py:765-803).
  * ``regression``    visual frame 0 -> final 7-D pose, MSE-sum
                      (problems.py:263-359).

Stochasticity controls (docs/PARITY.md):
  --noise-free    z = posterior mean on BOTH sides (no reparam noise)
  --no-dropout    Dropout(0.1) disabled on BOTH sides
  --shared-init   load the port's initial weights into the golden model

    python -m mmdyn_tpu_torch.tools.elbo_parity --problem seq_modeling \\
        --conditional --n-seq 64 --batch 8 --epochs 30 [--platform cpu]

Runs on the CUDA card; ``--platform cpu`` selects the CPU. Prints one JSON
line, ``{"problem": ..., "final_gap_pct": ..., "port_elbo": [...],
"torch_elbo": [...]}``, and ``main(argv)`` returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mmdyn_tpu_torch.data.compile import COMPILED_NAME, load_packed
from mmdyn_tpu_torch.models import setup_model
from mmdyn_tpu_torch.problems.base import ProblemConfig, anneal_kl, make_optimizer
from mmdyn_tpu_torch.tools import gold
from mmdyn_tpu_torch.train import create_train_state
from mmdyn_tpu_torch.train.steps import make_train_step
from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_synthetic_sequences(n_seq, seq_len=4, seed=0, shock_dim=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    seqs = {
        "visual": f(n_seq, seq_len, 64, 64, 3),
        "tactile": f(n_seq, seq_len, 64, 64, 3),
        "pose": f(n_seq, seq_len, 7),
        "final_visual": f(n_seq, 64, 64, 3),
        "final_tactile": f(n_seq, 64, 64, 3),
        "final_pose": f(n_seq, 7),
    }
    if shock_dim:
        # a per-sequence shock, constant over frames (exp_3 logs one shock
        # per trial, exp_3_force_pert.py:125-140)
        seqs["shock"] = np.repeat(f(n_seq, 1, shock_dim), seq_len, axis=1)
    return seqs


def load_compiled_sequences(path, n_seq=None):
    """Full (n, T, ...) sequence arrays from a compiled dataset."""
    p = Path(path)
    if p.is_dir() and not (p / "visual.npy").exists():
        p = p / COMPILED_NAME
    d = load_packed(p)
    n = d["visual"].shape[0] if n_seq is None else min(n_seq, d["visual"].shape[0])
    to_f = lambda a: (np.asarray(a, np.float32) / 255.0  # noqa: E731
                      if a.dtype == np.uint8 else np.asarray(a, np.float32))
    seqs = {
        "visual": to_f(d["visual"][:n]),
        "tactile": to_f(d["tactile"][:n]),
        "pose": np.asarray(d["pose"][:n], np.float32),
        "final_visual": to_f(d["final_visual"][:n]),
        "final_tactile": to_f(d["final_tactile"][:n]),
        "final_pose": np.asarray(d["final_pose"][:n], np.float32),
    }
    if "shock" in d and np.ndim(d["shock"]) == 3:
        seqs["shock"] = np.asarray(d["shock"][:n], np.float32)
    return seqs


def dyn_flatten_roll(x_bt, final):
    """The reference dyn_modeling target construction on a (B, T, ...) block
    (problems.py:765-803): flatten to (B*T, ...), roll -1 along the flattened
    axis, patch each sequence's last step with the resting frame."""
    b, t = x_bt.shape[:2]
    flat = x_bt.reshape((b * t,) + x_bt.shape[2:])
    tgt = np.roll(flat, -1, axis=0).copy()
    tgt[t - 1::t] = final
    return flat, tgt


def condition_dim(seqs, args):
    return seqs["shock"].shape[-1] if args.conditional else 0


def _epochs(args, n_seq, step, label):
    """Run ``step(epoch, batch_slice)`` over the epochs; each epoch's mean
    loss. The losses stay on the device until the epoch ends."""
    nb = n_seq // args.batch
    history = []
    for epoch in range(args.epochs):
        losses = [step(epoch, slice(b * args.batch, (b + 1) * args.batch))
                  for b in range(nb)]
        history.append(float(np.mean(torch.stack(losses).tolist())))
        print(f"# {label} epoch {epoch}: {history[-1]:.2f}", file=sys.stderr)
    return history


# ---------------------------------------------------------------------------
# the port's side: the production train step
# ---------------------------------------------------------------------------

def problem_config(args, cond_dim):
    is_reg = args.problem == "regression"
    return ProblemConfig(
        problem_type=args.problem,
        model_name="regressor" if is_reg else "cnn-mvae",
        input_type="visual" if is_reg else "visuotactile",
        use_pose=not is_reg, latent_size=args.latent, batchsize=args.batch,
        lr=args.lr, annealing_epochs=args.anneal, compute_dtype=args.dtype,
        conditional=cond_dim > 0, condition_dim=cond_dim,
        noise_free=args.noise_free)


def port_model(args, cond_dim, device, seed=0):
    """The port's model for ``args``, initialised from ``seed`` on ``device``."""
    drop = 0.0 if args.no_dropout else gold.DROPOUT_RATE
    if args.problem == "regression":
        return setup_model("regressor", out_dim=7, dropout_rate=drop,
                           compute_dtype=args.dtype, device=device, seed=seed)
    return setup_model("cnn-mvae", cross_modal=True, latent_size=args.latent,
                       use_pose=True, conditional=cond_dim > 0,
                       condition_dim=cond_dim, dropout_rate=drop,
                       compute_dtype=args.dtype, device=device, seed=seed)


def run_port(seqs, args, model, device, seed=0):
    """Train ``model`` (``port_model``'s) through ``make_train_step``;
    returns the mean loss of every epoch. Dropout and noise come from one
    generator on the device, seeded with ``seed + 1``."""
    cfg = problem_config(args, condition_dim(seqs, args))
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    train_step = make_train_step(cfg, device=device)
    generator = torch.Generator(device).manual_seed(seed + 1)
    data = {k: torch.tensor(v, device=device) for k, v in seqs.items()}

    def step(epoch, sl):
        _, metrics = train_step(state, {k: v[sl] for k, v in data.items()}, generator,
                                anneal_kl(epoch, args.anneal))
        return metrics["loss"]

    return _epochs(args, seqs["visual"].shape[0], step, "port")


# ---------------------------------------------------------------------------
# the golden side: reference-semantics sequential passes
# ---------------------------------------------------------------------------

def gold_model(args, cond_dim, device, seed=0):
    """The golden model for ``args``, torch's default init under ``seed``."""
    return gold.make_gold(args.problem == "regression", args.latent, cond_dim,
                          0.0 if args.no_dropout else gold.DROPOUT_RATE, seed, device)


def run_torch(seqs, args, model, device, seed=0):
    """Train the golden ``model`` with Adam(lr) on the reference's
    evaluation; returns the mean loss of every epoch. Dropout and noise
    come from one generator on the device, seeded with ``seed``."""
    cond_dim = condition_dim(seqs, args)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    generator = torch.Generator(device).manual_seed(seed)
    tensor = lambda a: torch.tensor(a, device=device)  # noqa: E731
    to_img = lambda a: tensor(a.transpose(0, 3, 1, 2))  # noqa: E731

    def batch_views(sl):
        """Per-problem (inputs, targets, condition) for one batch."""
        cond = None
        if args.problem == "seq_modeling":
            if cond_dim:
                # condition strided like the input (problems.py:664-667)
                cond = seqs["shock"][sl, 0]
            return ((seqs["visual"][sl, 0], seqs["tactile"][sl, 0],
                     seqs["pose"][sl, 0]),
                    (seqs["final_visual"][sl], seqs["final_tactile"][sl],
                     seqs["final_pose"][sl]), cond)
        if args.problem == "dyn_modeling":
            bv, gv = dyn_flatten_roll(seqs["visual"][sl], seqs["final_visual"][sl])
            bt_, gt = dyn_flatten_roll(seqs["tactile"][sl], seqs["final_tactile"][sl])
            bp = seqs["pose"][sl].reshape(-1, 7)
            # reference rolls pose targets WITHOUT the resting patch
            # (problems.py:798)
            gp = np.roll(bp, -1, axis=0)
            if cond_dim:
                cond = seqs["shock"][sl].reshape(-1, cond_dim)
            return (bv, bt_, bp), (gv, gt, gp), cond
        # regression: visual frame 0 -> final pose
        return ((seqs["visual"][sl, 0],), (seqs["final_pose"][sl],), cond)

    def step(epoch, sl):
        klw = anneal_kl(epoch, args.anneal)
        ins, tgts, cond = batch_views(sl)
        opt.zero_grad()
        if args.problem == "regression":
            out = model(to_img(ins[0]), generator)
            loss = torch.nn.functional.mse_loss(out, tensor(tgts[0]), reduction="sum")
        else:
            loss = gold.mvae_eval(model, to_img(ins[0]), to_img(ins[1]), tensor(ins[2]),
                                  to_img(tgts[0]), to_img(tgts[1]), tensor(tgts[2]), klw,
                                  cond=None if cond is None else tensor(cond),
                                  generator=generator, noise_free=args.noise_free)
        loss.backward()
        opt.step()
        return loss.detach()

    return _epochs(args, seqs["visual"].shape[0], step, "torch")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", default="seq_modeling",
                    choices=["seq_modeling", "dyn_modeling", "regression"])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16,
                    help="sequences per step (dyn flattens to batch*T rows)")
    ap.add_argument("--n-seq", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=4,
                    help="frames per synthetic sequence (ignored with --dataset)")
    ap.add_argument("--latent", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--anneal", type=int, default=3)
    ap.add_argument("--platform", default=None,
                    help="cpu: run on the CPU; otherwise the CUDA card (raises "
                    "without one)")
    ap.add_argument("--dataset", default=None,
                    help="compiled dataset path (real exp data) instead of "
                    "synthetic frames")
    ap.add_argument("--skip-torch", action="store_true",
                    help="only run the port's side")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "bfloat16_full"],
                    help="the port's activation policy (the golden side is "
                    "always f32; use to bound the accelerated policies' drift)")
    ap.add_argument("--conditional", action="store_true",
                    help="CVAE pathway: the shock condition concatenates "
                    "into the visual/tactile encoders (after the FC trunk) "
                    "and decoders (onto z); pose stays unconditional "
                    "(problems.py:286-289, vae.py:118-123). Requires a "
                    "shock stream (exp_3 corpora, or synthetic)")
    ap.add_argument("--shock-dim", type=int, default=3,
                    help="synthetic shock width (ignored with --dataset)")
    ap.add_argument("--noise-free", action="store_true",
                    help="z = posterior mean on both sides")
    ap.add_argument("--no-dropout", action="store_true",
                    help="disable Dropout(0.1) on both sides")
    ap.add_argument("--shared-init", action="store_true",
                    help="load the port's initial weights into the golden model")
    ap.add_argument("--seed", type=int, default=0,
                    help="init + noise seed for both sides")
    ap.add_argument("--seeds", default=None,
                    help="comma list: run the port's side once per seed "
                    "(independent init + noise draws) and emit per-seed "
                    "trajectories; combine with --skip-torch or let the "
                    "single golden run (at --seed) serve as the comparison point")
    return ap.parse_args(argv)


def _emit(result, args):
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return result


def main(argv=None):
    args = parse_args(argv)
    device = device_for_platform(args.platform)
    set_reference_precision()

    if args.dataset:
        seqs = load_compiled_sequences(args.dataset, args.n_seq)
        print(f"# real dataset: {seqs['visual'].shape[0]} sequences x "
              f"{seqs['visual'].shape[1]} frames from {args.dataset}",
              file=sys.stderr)
    else:
        seqs = make_synthetic_sequences(
            args.n_seq, args.seq_len,
            shock_dim=args.shock_dim if args.conditional else 0)
    if args.conditional and "shock" not in seqs:
        raise SystemExit("--conditional needs a shock stream; this dataset "
                         "has none (use an exp_3 corpus)")
    cond_dim = condition_dim(seqs, args)

    def golden(init=None):
        t0 = time.time()
        model = gold_model(args, cond_dim, device, seed=args.seed)
        if init is not None:
            model.load_state_dict(init)
        th = run_torch(seqs, args, model, device, seed=args.seed)
        print(f"# torch done in {time.time()-t0:.1f}s", file=sys.stderr)
        return th

    if args.seeds is not None:
        # multi-seed spread: the port per seed, optional single golden anchor
        per_seed = {}
        for s in [int(s) for s in args.seeds.split(",")]:
            t0 = time.time()
            per_seed[s] = run_port(seqs, args, port_model(args, cond_dim, device, s),
                                   device, seed=s)
            print(f"# port seed {s} done in {time.time()-t0:.1f}s "
                  f"(final {per_seed[s][-1]:.2f})", file=sys.stderr)
        finals = [h[-1] for h in per_seed.values()]
        result = {"problem": args.problem,
                  "port_elbo_by_seed": {str(s): [round(x, 2) for x in h]
                                        for s, h in per_seed.items()},
                  "port_final_min": round(min(finals), 2),
                  "port_final_max": round(max(finals), 2)}
        if not args.skip_torch:
            result["torch_elbo"] = [round(x, 2) for x in golden()]
        return _emit(result, args)

    t0 = time.time()
    model = port_model(args, cond_dim, device, seed=args.seed)
    init = ({k: v.detach().clone() for k, v in model.state_dict().items()}
            if args.shared_init else None)
    px = run_port(seqs, args, model, device, seed=args.seed)
    print(f"# port done in {time.time()-t0:.1f}s", file=sys.stderr)
    result = {"problem": args.problem, "port_elbo": [round(x, 2) for x in px]}
    if not args.skip_torch:
        th = golden(init)
        gap = abs(px[-1] - th[-1]) / abs(th[-1]) * 100
        result = {"problem": args.problem, "final_gap_pct": round(gap, 3),
                  "port_elbo": [round(x, 2) for x in px],
                  "torch_elbo": [round(x, 2) for x in th]}
    return _emit(result, args)


if __name__ == "__main__":
    main()
