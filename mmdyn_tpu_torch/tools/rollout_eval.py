"""Closed-loop rollout evaluation: dynamics predictions vs ground truth
(port of ``tools/rollout_eval.py``).

The dyn_modeling problem trains one-step transitions
(mmdyn/pytorch/problems/problems.py:760-803) but the reference never
measures what happens when the model is iterated. This tool rolls the
trained model forward from a sequence's first frame and scores the
trajectory against the actual dump frames:

* closed-loop:  pred[t+1] = model(pred[t]) — errors compound;
* teacher-forced: pred[t+1] = model(gt[t]) — the training objective;
* persistence baseline: pred[t] = gt[0] — the bar any dynamics model must
  clear.

Per-step L1 and BCE per modality, whole-image AND segment-masked (the
object occupies a small fraction of the frame, so whole-image L1 is
dominated by static background; the masked metric scores only pixels the
object's segmentation touches in the target or initial frame). Written as
one JSON line + an optional side-by-side PNG strip (ground truth over
prediction; Pillow).

    python -m mmdyn_tpu_torch.tools.rollout_eval --run logs/dyn_run/ \
        --frames ds/dataset/synset0/obj0/sequence_0 [--strip out.png] \
        [--platform cpu]
"""

import argparse
import json
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description="Rollout-vs-ground-truth scoring")
    p.add_argument("--run", required=True, type=str)
    p.add_argument("--frames", required=True, type=str,
                   help="one sequence dump dir (visual_*.png ...)")
    p.add_argument("--out", default=None, type=str,
                   help="write the JSON report here (default: stdout only)")
    p.add_argument("--strip", default=None, type=str,
                   help="write a GT-vs-prediction PNG strip here")
    p.add_argument("--calibrate", default=None, type=str,
                   help="freeze BN statistics on this dump dir first")
    p.add_argument("--max-steps", default=0, type=int,
                   help="cap the horizon (0 = full sequence)")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' runs on the CPU; otherwise the CUDA card")
    return p


def _metrics(pred, gt, mask=None):
    """Per-step L1 and BCE of (T, H, W, C) [0, 1] arrays; ``mask``
    (T, H, W) restricts the means to object pixels."""
    import numpy as np

    eps = 1e-6
    p = np.clip(np.asarray(pred, np.float64), eps, 1 - eps)
    g = np.asarray(gt, np.float64)
    l1_px = np.abs(p - g).mean(axis=-1)                      # (T, H, W)
    bce_px = -(g * np.log(p) + (1 - g) * np.log(1 - p)).mean(axis=-1)
    if mask is not None:
        w = np.asarray(mask, np.float64)
        denom = np.maximum(w.sum(axis=(1, 2)), 1.0)
        l1 = (l1_px * w).sum(axis=(1, 2)) / denom
        bce = (bce_px * w).sum(axis=(1, 2)) / denom
    else:
        l1 = l1_px.mean(axis=(1, 2))
        bce = bce_px.mean(axis=(1, 2))
    return [round(float(x), 5) for x in l1], [round(float(x), 5) for x in bce]


def _load_seg_masks(frames_dir):
    """Object masks with the training compile's exact seg prep
    (data/compile.py): per-frame seg-bbox crop -> 256 -> 64, background
    value 1 zeroed; mask = any nonzero channel."""
    import glob as _glob

    import numpy as np

    from mmdyn_tpu_torch.data.compile import _bounding_box, _load_image, _to_train_res

    seg_paths = sorted(_glob.glob(str(Path(frames_dir) / "seg_*.png")))
    if not seg_paths:
        return None
    masks = []
    for sp in seg_paths:
        seg_full = _load_image(sp, resize=False)
        bbox = _bounding_box(seg_full)
        seg = _load_image(sp, bounding_box=bbox)
        seg = np.where(seg == 1, 0, seg)
        seg64 = _to_train_res(seg.astype(np.uint8))
        masks.append((seg64 > 0).any(axis=-1))
    return np.stack(masks)  # (T, 64, 64) bool


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
    if cfg.problem_type == "regression":
        raise SystemExit("rollout evaluation needs a generative model")
    modalities = (("visual", "tactile") if cfg.cross_modal
                  else (cfg.input_type,))
    if args.calibrate:
        session = session.freeze_bn(**_load_frames(args.calibrate, modalities))

    input_mods = (tuple(modalities) + ("pose",) if cfg.use_pose
                  else tuple(modalities))
    frames = _load_frames(args.frames, input_mods,
                          norms=session.norms)  # images (T, 64, 64, 3)
    t_total = len(next(iter(frames.values())))
    horizon = t_total - 1
    if args.max_steps:
        horizon = min(horizon, args.max_steps)
    if horizon < 1:
        raise SystemExit(f"sequence too short ({t_total} frames)")

    report = {"run": str(args.run), "frames": str(args.frames),
              "problem_type": cfg.problem_type, "horizon": horizon,
              "modalities": list(modalities)}

    def host(out):
        return {k: v.cpu().numpy() for k, v in out.items()}

    # --- closed-loop rollout from frame 0 -------------------------------
    init = {m: v[:1] for m, v in frames.items()}
    traj = host(session.rollout(horizon, **init))

    # --- teacher-forced one-step predictions ----------------------------
    teacher = host(session.predict(**{m: v[:horizon] for m, v in frames.items()}))

    # dyn targets: the next frame; seq/reconstruction targets: the resting
    # (final) frame of the sequence
    dyn = cfg.problem_type == "dyn_modeling"
    segs = _load_seg_masks(args.frames)
    mask = None
    if segs is not None:
        tgt = segs[1:horizon + 1] if dyn else np.repeat(segs[-1:], horizon, 0)
        # union with the initial mask: score where the object IS or WAS
        mask = np.logical_or(tgt, segs[:1]).astype(np.float64)
        report["masked"] = True
    for m in modalities:
        gt_next = (frames[m][1:horizon + 1] if dyn
                   else np.repeat(frames[m][-1:], horizon, axis=0))
        roll = traj[m][:, 0]
        base = np.repeat(frames[m][:1], horizon, axis=0)
        entry = {}
        for tag, msk in (("", None), ("masked_", mask)):
            if msk is None and tag:
                continue
            l1, bce = _metrics(roll, gt_next, msk)
            tf_l1, tf_bce = _metrics(teacher[m], gt_next, msk)
            b_l1, b_bce = _metrics(base, gt_next, msk)
            entry[f"{tag}rollout_l1"] = l1
            entry[f"{tag}rollout_bce"] = bce
            entry[f"{tag}teacher_l1"] = tf_l1
            entry[f"{tag}teacher_bce"] = tf_bce
            entry[f"{tag}persistence_l1"] = b_l1
            entry[f"{tag}persistence_bce"] = b_bce
            entry[f"{tag}rollout_l1_mean"] = round(float(np.mean(l1)), 5)
            entry[f"{tag}teacher_l1_mean"] = round(float(np.mean(tf_l1)), 5)
            entry[f"{tag}persistence_l1_mean"] = round(float(np.mean(b_l1)), 5)
            entry[f"{tag}beats_persistence"] = (
                entry[f"{tag}rollout_l1_mean"]
                < entry[f"{tag}persistence_l1_mean"])
        report[m] = entry

    if args.strip:
        from PIL import Image

        m = modalities[0]
        gt_next = (frames[m][1:horizon + 1] if dyn
                   else np.repeat(frames[m][-1:], horizon, axis=0))
        top = np.concatenate(list(gt_next), axis=1)
        bot = np.concatenate(list(traj[m][:, 0]), axis=1)
        strip = np.concatenate([top, bot], axis=0)
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
