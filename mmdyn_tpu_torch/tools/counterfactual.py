"""Counterfactual sweep for conditional (CVAE) models: one observation, many
shock conditions (port of ``tools/counterfactual.py``).

The exp_3 pathway trains resting-state prediction conditioned on the shock
force (mmdyn/pytorch/problems/problems.py:664-667, models/vae.py:231-237);
the reference never exposes a way to ask the model "what if the push were
different?". This sweeps the condition over a grid for a fixed input frame
and reports how the predicted resting state moves.

    python -m mmdyn_tpu_torch.tools.counterfactual --run logs/cvae_run/ \
        --frames ds/dataset/.../sequence_0 --sweep 0,0.25,0.5,0.75,1 \
        --strip counterfactual.png [--platform cpu]

Outputs one JSON line: per-condition L1 of the prediction vs the first
sweep value's prediction (sensitivity), plus an optional PNG strip (one row
per condition value; Pillow).
"""

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description="Conditional counterfactual sweep")
    p.add_argument("--run", required=True, type=str)
    p.add_argument("--frames", required=True, type=str,
                   help="sequence dump dir; frame --index is the observation")
    p.add_argument("--index", default=0, type=int)
    p.add_argument("--sweep", default="0,0.25,0.5,0.75,1", type=str,
                   help="normalized condition values (applied to every dim)")
    p.add_argument("--strip", default=None, type=str)
    p.add_argument("--out", default=None, type=str)
    p.add_argument("--calibrate", default=None, type=str)
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' runs on the CPU; otherwise the CUDA card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from mmdyn_tpu_torch.cli.infer import _load_frames
    from mmdyn_tpu_torch.serve import InferenceSession
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = device_for_platform(args.platform)
    set_reference_precision()
    session = InferenceSession.from_run(args.run, device=device)
    cfg = session.cfg
    if not cfg.conditional:
        raise SystemExit("--run must be a conditional (CVAE) model")
    modalities = (("visual", "tactile") if cfg.cross_modal
                  else (cfg.input_type,))
    if args.calibrate:
        cal = _load_frames(args.calibrate, modalities)
        n_cal = len(next(iter(cal.values())))
        session = session.freeze_bn(
            **cal, condition=np.zeros((n_cal, cfg.condition_dim), np.float32))

    frames = _load_frames(args.frames, modalities)
    obs = {m: v[args.index:args.index + 1] for m, v in frames.items()}
    values = [float(x) for x in args.sweep.split(",")]

    preds = {}
    for val in values:
        cond = np.full((1, cfg.condition_dim), val, np.float32)
        out = session.predict(**obs, condition=cond)
        preds[val] = {k: out[k][0].cpu().numpy() for k in (*modalities, "mu")}

    base = preds[values[0]]
    report = {"run": str(args.run), "frames": str(args.frames),
              "index": args.index, "condition_dim": cfg.condition_dim,
              "sweep": values, "vs": values[0]}
    for m in modalities:
        report[f"{m}_l1_vs_base"] = [
            round(float(np.abs(preds[v][m] - base[m]).mean()), 5)
            for v in values]
    report["mu_l2_vs_base"] = [
        round(float(np.linalg.norm(preds[v]["mu"] - base["mu"])), 4)
        for v in values]
    # the conditional pathway is live iff non-base conditions move the output
    deltas = [x for v in values[1:]
              for x in [report[f"{modalities[0]}_l1_vs_base"][values.index(v)]]]
    report["condition_sensitivity"] = round(float(np.mean(deltas)), 5)

    if args.strip:
        from PIL import Image

        rows = []
        for v in values:
            rows.append(np.concatenate([preds[v][m] for m in modalities],
                                       axis=1))
        strip = np.concatenate(rows, axis=0)
        Image.fromarray((np.clip(strip, 0, 1) * 255).astype(np.uint8)).save(
            args.strip)
        report["strip"] = str(args.strip)

    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
