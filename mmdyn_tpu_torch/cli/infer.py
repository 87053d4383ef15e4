"""Batch inference / deployment CLI for trained runs (port of
``mmdyn_tpu/cli/infer.py``). It runs on the card; ``--platform cpu`` selects
the CPU.

    # predict resting states for every frame of a sim dump sequence
    python -m mmdyn_tpu_torch.cli.infer --run logs/run_... --frames dump/sequence_0

    # closed-loop dynamics rollout from the first frame (dyn models)
    python -m mmdyn_tpu_torch.cli.infer --run logs/run_... --frames dump/sequence_0 \
        --rollout 20

    # write a self-contained deployment artifact (torch.export program)
    python -m mmdyn_tpu_torch.cli.infer --run logs/run_... --export artifact_dir

Frames are prepared exactly as the training compile does (seg-bbox square
crop -> 256 -> 64, datasets.py:159-345) so serving inputs match the training
distribution. Reading PNGs needs Pillow.

``--num-devices N`` > 1 spawns N ranks, one per card (or CPU processes with
``--platform cpu``), as ``cli/main.py`` does: every rank reads the frames
and predicts each batch, computing its row block with BatchNorm statistics
over the whole batch (``InferenceSession``'s ``mesh``); the batch is
rounded up to a multiple of N (the tail padded as before), a rollout
starts from its frame once per rank; rank 0 writes the outputs.
``--export`` needs one rank.
"""

import argparse
import glob
import json
import sys
import time
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description="Inference on a trained run")
    p.add_argument("--run", default=None, type=str,
                   help="run directory (or use --torch-ckpt)")
    p.add_argument("--torch-ckpt", default=None, type=str,
                   help="serve a reference-trained torch .ckpt directly")
    p.add_argument("--model-name", default="cnn-mvae", type=str,
                   help="(with --torch-ckpt) reference model name")
    p.add_argument("--input-type", default="visuotactile", type=str,
                   help="(with --torch-ckpt) training input type")
    p.add_argument("--problem-type", default="seq_modeling", type=str,
                   help="(with --torch-ckpt) problem the ckpt was trained on")
    p.add_argument("--conditional", action="store_true", default=False,
                   help="(with --torch-ckpt) conditional (CVAE) checkpoint")
    p.add_argument("--frames", default=None, type=str,
                   help="sequence dump dir (visual_*.png [tactile_*, seg_*])")
    p.add_argument("--out", default=None, type=str,
                   help="output dir (default: <run>/plot/infer)")
    p.add_argument("--batchsize", default=64, type=int)
    p.add_argument("--rollout", default=0, type=int,
                   help="closed-loop steps from the first frame")
    p.add_argument("--sample", action="store_true", default=False,
                   help="stochastic z (default: posterior mean)")
    p.add_argument("--no-pose", action="store_true", default=False,
                   help="predict from images only even for a use_pose model "
                        "(otherwise an unloadable pose modality is an error)")
    p.add_argument("--parity", action="store_true", default=False,
                   help="train-mode dropout (reference eval semantics)")
    p.add_argument("--export", default=None, type=str,
                   help="write a torch.export deployment artifact here")
    p.add_argument("--checkpoint", default=None, type=str,
                   help="checkpoint name under <run>/checkpoint (default: latest)")
    p.add_argument("--calibrate", default=None, type=str,
                   help="sequence dump dir; freeze BatchNorm statistics on "
                        "these frames before predicting")
    p.add_argument("--num-devices", default=0, type=int,
                   help="data-parallel over this many devices, one process each "
                        "(0 = one device, no process group)")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' serves on the CPU; otherwise the CUDA card")
    return p


def _load_frames(frames_dir, modalities, norms=None):
    """Sim-dump PNGs -> dict of (N, 64, 64, 3) float32 in [0, 1].

    When "pose" is requested and ``norms`` carries the run's min-max
    constants (norms.json), per-frame poses are read from the dump's
    data.json (position + orientation, data/compile.py:160-162) and
    normalised the way training did."""
    import numpy as np

    from mmdyn_tpu_torch.data.compile import (_bounding_box, _load_image,
                                              _to_train_res)

    frames_dir = Path(frames_dir)

    def sorted_glob(prefix):
        return sorted(glob.glob(str(frames_dir / f"{prefix}_*.png")))

    seg_paths = sorted_glob("seg")
    out = {}
    for m in modalities:
        if m == "pose":
            data_json = frames_dir / "data.json"
            if norms and "pose_min" in norms and data_json.exists():
                with open(data_json) as f:
                    info = json.load(f)
                pose = np.concatenate(
                    [np.asarray(info["position"], np.float32),
                     np.asarray(info["orientation"], np.float32)], axis=1)
                lo = np.asarray(norms["pose_min"], np.float32)
                hi = np.asarray(norms["pose_max"], np.float32)
                rng = np.where(hi - lo == 0, 1.0, hi - lo)
                out[m] = ((pose - lo) / rng).astype(np.float32)
            else:
                # a use_pose model fed images only forms a DIFFERENT PoE
                # posterior — never degrade silently (pass --no-pose to
                # predict from images alone on purpose)
                missing = ("no data.json in the dump" if norms
                           and "pose_min" in norms else
                           "run has no pose normalisation constants "
                           "(norms.json predates pose recording)")
                raise ValueError(
                    f"pose modality requested but unavailable: {missing}. "
                    f"Use --no-pose to run on images only.")
            continue
        paths = sorted_glob(m)
        if not paths:
            raise FileNotFoundError(f"no {m}_*.png under {frames_dir}")
        # runs trained on a --no-crop compile must be served the full frame
        # (norms.json records the compile's crop setting; default True)
        use_crop = bool((norms or {}).get("crop", True))
        imgs = []
        for i, path in enumerate(paths):
            bbox = None
            if use_crop and i < len(seg_paths):
                bbox = _bounding_box(_load_image(seg_paths[i], resize=False))
            img = _load_image(path, bounding_box=bbox)       # 256x256 uint8
            imgs.append(_to_train_res(img))                  # 64x64 uint8
        out[m] = np.stack(imgs).astype(np.float32) / 255.0
    lens = {m: len(v) for m, v in out.items()}
    if len(set(lens.values())) > 1:
        raise ValueError(f"modality frame counts differ: {lens}")
    return out


def _save_images(out_dir, name, arr):
    import numpy as np
    from PIL import Image

    for i, img in enumerate(np.asarray(arr)):
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(Path(out_dir) / f"{name}_{i:04d}.png")


def check_source(args):
    """Exactly one of --run / --torch-ckpt (``cli/serve.py`` too)."""
    if bool(args.run) == bool(args.torch_ckpt):
        raise SystemExit("exactly one of --run / --torch-ckpt is required")


def load_session(args, mesh=None):
    """The session of the CLIs' shared flags (``cli/serve.py`` too), on the
    device --platform selects, or one rank of ``mesh``."""
    check_source(args)
    from mmdyn_tpu_torch.serve import InferenceSession
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = mesh.device if mesh is not None else device_for_platform(args.platform)
    set_reference_precision()
    if args.torch_ckpt:
        return InferenceSession.from_torch_ckpt(
            args.torch_ckpt, problem_type=args.problem_type,
            model_name=args.model_name, input_type=args.input_type,
            conditional=args.conditional, parity=args.parity, device=device, mesh=mesh)
    return InferenceSession.from_run(args.run, parity=args.parity,
                                     checkpoint=args.checkpoint, device=device, mesh=mesh)


def main(argv=None):
    """Predicts (or exports); returns the report (or the manifest). With
    ``--num-devices`` > 1, rank 0's report."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    check_source(args)
    from mmdyn_tpu_torch.parallel import cli_mesh, launched, spawn_cli

    if args.num_devices > 1 and not launched():
        return spawn_cli(main, argv, args.num_devices, args.platform)
    mesh = cli_mesh(args.num_devices, args.platform)
    try:
        return _infer(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _infer(args, mesh):
    import numpy as np

    from mmdyn_tpu_torch.serve import export_session

    chief = mesh is None or mesh.is_chief
    session = load_session(args, mesh)
    cfg = session.cfg
    modalities = (("visual", "tactile") if cfg.cross_modal
                  else (cfg.input_type,))
    if args.calibrate:
        session = session.freeze_bn(**_load_frames(args.calibrate,
                                                   modalities,
                                                   norms=session.norms))

    if args.export:
        manifest = export_session(session, args.export,
                                  batch_size=args.batchsize,
                                  modalities=modalities, sample=args.sample,
                                  conditional=cfg.conditional)
        print(json.dumps({"export": args.export,
                          "platforms": manifest["platforms"],
                          "modalities": manifest["modalities"],
                          "batch_size": manifest["batch_size"]}))
        return manifest

    if not args.frames:
        raise SystemExit("--frames or --export is required")
    if args.out is None and args.run is None:
        raise SystemExit("--out is required with --torch-ckpt")
    out_dir = Path(args.out or Path(args.run) / "plot" / "infer")
    if chief:
        out_dir.mkdir(parents=True, exist_ok=True)

    input_mods = (tuple(modalities) + ("pose",)
                  if cfg.use_pose and not args.no_pose else tuple(modalities))
    frames = _load_frames(args.frames, input_mods, norms=session.norms)
    n = len(next(iter(frames.values())))
    report = {"run": args.run or args.torch_ckpt, "frames": args.frames,
              "n_frames": n,
              "modalities": list(modalities), "batchsize": args.batchsize}

    if args.rollout:
        # the first frame, once per rank: identical rows leave batch
        # statistics as one row's; row 0's trajectory is kept
        rows = 1 if mesh is None else mesh.size
        init = {m: np.repeat(v[:1], rows, 0) for m, v in frames.items()}
        t0 = time.perf_counter()
        traj = session.rollout(args.rollout, **init, sample=args.sample)
        traj = {k: v.cpu().numpy() for k, v in traj.items()}   # the readback syncs
        dt = time.perf_counter() - t0
        for m in modalities if chief else ():
            _save_images(out_dir, f"rollout_{m}", traj[m][:, 0])
        report["rollout_steps"] = args.rollout
        report["rollout_s"] = round(dt, 4)
    else:
        bs = min(args.batchsize, n)
        if mesh is not None:
            bs = -(-bs // mesh.size) * mesh.size    # every rank takes equal rows
        regression = cfg.problem_type == "regression"
        out_keys = ("pose",) if regression else modalities
        preds, lat, rows = {k: [] for k in out_keys}, [], []
        for s in range(0, n, bs):
            batch = {m: v[s:s + bs] for m, v in frames.items()}
            rows.append(len(next(iter(batch.values()))))
            pad = bs - rows[-1]
            if pad > 0:  # static batch shape: pad the ragged tail
                batch = {m: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                         for m, v in batch.items()}
            t0 = time.perf_counter()
            # uint8 image payloads, quantized on the device: a 4x smaller
            # readback, which is also the sync
            out = session.predict(**batch, sample=args.sample,
                                  uint8_images=not regression)
            arrs = {k: out[k].cpu().numpy() for k in out_keys}
            lat.append(time.perf_counter() - t0)
            for k in out_keys:
                arr = arrs[k]
                preds[k].append(arr[:len(arr) - pad] if pad else arr)
        if regression:
            poses = np.concatenate(preds["pose"])
            report["pose_mean"] = [round(float(x), 5) for x in poses.mean(0)]
            if chief:
                np.save(out_dir / "pred_pose.npy", poses)
            if "pose_min" in session.norms:   # runs carry norms.json now
                denorm = session.denormalize_pose(poses)
                report["pose_mean_denorm"] = [round(float(x), 5)
                                              for x in denorm.mean(0)]
                if chief:
                    np.save(out_dir / "pred_pose_denorm.npy", denorm)
        elif chief:
            for m in out_keys:
                _save_images(out_dir, f"pred_{m}", np.concatenate(preds[m]))
        # the first batch includes lazy initialisation; the steady state excludes it
        report["latency_ms_first"] = round(lat[0] * 1e3, 2)
        if len(lat) > 1:
            steady = lat[1:]
            report["latency_ms_steady"] = round(
                sum(steady) / len(steady) * 1e3, 2)
            # real (unpadded) rows only: the padded tail of the final batch
            # is serving overhead, not delivered frames
            report["frames_per_s"] = round(sum(rows[1:]) / sum(steady), 1)

    if chief:
        with open(out_dir / "infer_report.json", "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
