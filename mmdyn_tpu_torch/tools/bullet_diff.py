"""Cross-engine dump diff harness (port of ``tools/bullet_diff.py``).

Runs one of the port's data-collection CLIs twice with the SAME seed on two
physics engines and diffs the dumps: pose trajectories, image statistics
per stream, segmentation coverage, and logged contact forces. On a machine
with PyBullet:

    python -m mmdyn_tpu_torch.tools.bullet_diff --script demo \
        --engines pybullet,analytic --seed 3 --workdir /tmp/bullet_diff

and compare the report against the expected tolerances (README
"Cross-engine validation"). The CLIs' device paths are reached through
``--extra`` (``--extra=--device-physics``), on the card, or on the CPU with
``--platform cpu``, which is forwarded to the CLI.

Matches the reference protocol: mmdyn/tact_sim/utils/pybullet.py:8-155
(engine setup), experiments/exp_1_flat_plane.py:119-157 (dump layout).

Prints one JSON report and returns it; exit code 1 if any metric exceeds
its tolerance. Needs cv2.
"""

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np


def run_script(script, engine, seed, out_dir, n_timesteps, interval, extra):
    """Run one of the port's sim CLIs in process into out_dir."""
    argv = ["--engine", engine, "--headless", "--seed", str(seed),
            "--n_timesteps", str(n_timesteps), "--interval", str(interval),
            "--logdir", str(out_dir)] + list(extra or [])
    if script == "demo":
        from mmdyn_tpu_torch.cli import demo as mod
    elif script == "exp_1_flat_plane":
        from mmdyn_tpu_torch.cli import exp_1_flat_plane as mod
        argv += ["--n_objects", "2", "--trial_per_obj", "1"]
    elif script == "exp_2_inclined_plane":
        from mmdyn_tpu_torch.cli import exp_2_inclined_plane as mod
        argv += ["--n_objects", "2", "--trial_per_obj", "1"]
    elif script == "exp_3_force_pert":
        from mmdyn_tpu_torch.cli import exp_3_force_pert as mod
        argv += ["--n_objects", "2", "--trial_per_obj", "1"]
    else:
        raise ValueError(script)
    mod.main(argv)


def quat_angle_deg(q1, q2):
    """Geodesic angle between two quaternions (q and -q identified)."""
    d = abs(float(np.clip(np.dot(q1, q2)
                          / (np.linalg.norm(q1) * np.linalg.norm(q2) + 1e-12),
                          -1.0, 1.0)))
    return math.degrees(2.0 * math.acos(min(d, 1.0)))


def sequence_dirs(root):
    """Every directory containing a data.json, sorted by relative path."""
    return sorted(p.parent for p in Path(root).glob("**/data.json"))


def diff_sequences(dir_a, dir_b):
    """Diff one sequence directory pair -> metric dict."""
    import cv2

    with open(dir_a / "data.json") as f:
        da = json.load(f)
    with open(dir_b / "data.json") as f:
        db = json.load(f)

    n = min(len(da["position"]), len(db["position"]))
    pos_a = np.asarray(da["position"][:n], np.float64)
    pos_b = np.asarray(db["position"][:n], np.float64)
    pos_l2 = np.linalg.norm(pos_a - pos_b, axis=1)
    orn_deg = [quat_angle_deg(np.asarray(da["orientation"][i]),
                              np.asarray(db["orientation"][i]))
               for i in range(n)]

    out = {
        "frames": n,
        "frames_a": len(da["position"]), "frames_b": len(db["position"]),
        "pos_l2_mean": round(float(pos_l2.mean()), 6),
        "pos_l2_max": round(float(pos_l2.max()), 6),
        "pos_l2_final": round(float(pos_l2[-1]), 6),
        "orn_deg_mean": round(float(np.mean(orn_deg)), 4),
        "orn_deg_final": round(float(orn_deg[-1]), 4),
    }
    for key in ("force", "shock"):
        if key in da and key in db:
            fa = np.asarray(da[key][:n], np.float64).reshape(n, -1)
            fb = np.asarray(db[key][:n], np.float64).reshape(n, -1)
            out[f"{key}_mad"] = round(
                float(np.mean(np.abs(fa - fb))), 6)

    for stream in ("visual", "tactile", "seg", "depth"):
        mads, cov_a, cov_b = [], [], []
        for i in range(n):
            pa = dir_a / f"{stream}_{i:04d}.png"
            pb = dir_b / f"{stream}_{i:04d}.png"
            if not (pa.exists() and pb.exists()):
                continue
            ia = cv2.imread(str(pa), cv2.IMREAD_UNCHANGED).astype(np.float64)
            ib = cv2.imread(str(pb), cv2.IMREAD_UNCHANGED).astype(np.float64)
            mads.append(float(np.mean(np.abs(ia - ib))))
            if stream == "seg":
                # coverage: fraction of pixels with any object id. save_image
                # writes seg as (value * 255).astype(uint8), so the no-object
                # value -1 lands on (-255) % 256 = 1
                cov_a.append(float((ia != 1).mean()))
                cov_b.append(float((ib != 1).mean()))
        if mads:
            out[f"{stream}_mad_mean"] = round(float(np.mean(mads)), 4)
            out[f"{stream}_mad_max"] = round(float(np.max(mads)), 4)
        if cov_a:
            out["seg_coverage_a"] = round(float(np.mean(cov_a)), 4)
            out["seg_coverage_b"] = round(float(np.mean(cov_b)), 4)
    return out


def build_parser():
    ap = argparse.ArgumentParser(description="Cross-engine dump diff")
    ap.add_argument("--script", default="demo",
                    choices=["demo", "exp_1_flat_plane",
                             "exp_2_inclined_plane", "exp_3_force_pert"])
    ap.add_argument("--engines", default="pybullet,analytic",
                    help="comma-separated pair to compare")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--n_timesteps", type=int, default=200)
    ap.add_argument("--interval", type=int, default=20)
    ap.add_argument("--workdir", default="/tmp/bullet_diff")
    ap.add_argument("--extra", default=None,
                    help="comma-separated extra args forwarded to the CLI, "
                    "use the = form: --extra=--fast-shading,--object,bowl")
    ap.add_argument("--skip-run", action="store_true",
                    help="diff existing workdir dumps without re-running")
    # Tolerances. Same-engine same-seed runs are bit-identical (all zeros).
    # For Bullet-vs-analytic the analytic integrator and box-approximated
    # contacts legitimately diverge: bound the FINAL resting pose, not the
    # transient.
    ap.add_argument("--tol-pos-final", type=float, default=0.15,
                    help="max final-pose position L2 [m]")
    ap.add_argument("--tol-orn-final", type=float, default=45.0,
                    help="max final-pose orientation angle [deg]")
    ap.add_argument("--tol-seg-coverage", type=float, default=0.1,
                    help="max |seg coverage difference|")
    ap.add_argument("--tol-img-mad", type=float, default=40.0,
                    help="max per-stream mean-abs-diff (uint8 counts)")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the CLIs' device paths on the CPU (forwarded "
                         "to the CLI); otherwise the CUDA card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mmdyn_tpu_torch.utils.device import device_for_platform

    device = device_for_platform(args.platform)
    eng_a, eng_b = args.engines.split(",")
    extra = args.extra.split(",") if args.extra else []
    if device.type == "cpu":
        extra += ["--platform", "cpu"]
    work = Path(args.workdir)
    dir_a, dir_b = work / eng_a, work / eng_b
    if not args.skip_run:
        for eng, d in ((eng_a, dir_a), (eng_b, dir_b)):
            if d.exists():
                import shutil
                shutil.rmtree(d)
            run_script(args.script, eng, args.seed, d, args.n_timesteps,
                       args.interval, extra)

    seqs_a = sequence_dirs(dir_a)
    seqs_b = sequence_dirs(dir_b)
    if not seqs_a or not seqs_b:
        sys.exit(f"no sequences under {dir_a} / {dir_b}")
    pairs = min(len(seqs_a), len(seqs_b))
    reports = []
    failures = []
    for sa, sb in zip(seqs_a[:pairs], seqs_b[:pairs]):
        r = diff_sequences(sa, sb)
        r["sequence"] = str(sa.relative_to(dir_a))
        reports.append(r)
        if r["pos_l2_final"] > args.tol_pos_final:
            failures.append(f"{r['sequence']}: pos_l2_final "
                            f"{r['pos_l2_final']} > {args.tol_pos_final}")
        if r["orn_deg_final"] > args.tol_orn_final:
            failures.append(f"{r['sequence']}: orn_deg_final "
                            f"{r['orn_deg_final']} > {args.tol_orn_final}")
        if "seg_coverage_a" in r and abs(
                r["seg_coverage_a"] - r["seg_coverage_b"]) > args.tol_seg_coverage:
            failures.append(f"{r['sequence']}: seg coverage diff")
        for stream in ("visual", "tactile"):
            if r.get(f"{stream}_mad_mean", 0) > args.tol_img_mad:
                failures.append(f"{r['sequence']}: {stream} MAD "
                                f"{r[f'{stream}_mad_mean']}")

    report = {"script": args.script, "engines": [eng_a, eng_b],
              "seed": args.seed, "sequences": reports,
              "failures": failures, "ok": not failures}
    print(json.dumps(report))
    if failures:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
