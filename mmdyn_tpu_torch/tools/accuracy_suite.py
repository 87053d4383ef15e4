"""Reference-scale accuracy suite: do the trained models learn real physics?
(port of ``tools/accuracy_suite.py``)

Evaluates runs of all three problem families on the HELD-OUT test split of a
compiled corpus (ideally an ``exp_1 --apply-sampled-position`` corpus, whose
resting positions are non-degenerate, docs/PARITY.md "Pose regression in
world units"), against the baselines any learner must beat:

* regression — mean resting-POSITION error (metres, denormalised via the
  run's norms.json) and orientation geodesic angle, vs the train-split
  mean predictor;
* seq_modeling (MVAE frame-0 -> final state) — final-pose position error vs
  the mean predictor, final-image L1 vs persistence (copy frame 0);
* dyn_modeling — teacher-forced one-step image L1 / world pose error vs
  persistence (copy frame t), plus closed-loop rollout drift at the full
  horizon vs persistence from frame 0;
* conditional — whether a CVAE's counterfactual response to the shock moves
  the way the ground-truth outcomes do.

Two measurement hazards are handled explicitly (docs/PARITY.md):

* pixel persistence is degenerate on this representation — frames are
  bbox-re-cropped around the object (a reference quirk, datasets.py), so
  consecutive images are nearly identical. Image metrics therefore also
  report the model's own AUTOENCODING FLOOR (reconstruction of the target
  frame).
* most frames of a drop sequence are at rest, where persistence is exact by
  definition. One-step metrics are therefore split into MOVING (gt per-step
  displacement > 1 cm) and RESTING rows.

    python -m mmdyn_tpu_torch.tools.accuracy_suite --dataset <corpus> \
        --reg-run <dir> --seq-run <dir> --dyn-run <dir> [--cond-run <dir>] \
        [--out report.json] [--platform cpu]

The data come from the port's ``data/dataset.py::VisuoTactileArrays``; each
``eval_*`` takes the split arrays, so the JAX package's functions can be
held against these on the same arrays.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.serve import InferenceSession


def _f32img(x):
    return np.asarray(x, np.float32) / 255.0


def _pos_err(pred_pose_denorm, gt_pose_denorm):
    return np.linalg.norm(pred_pose_denorm[:, :3] - gt_pose_denorm[:, :3],
                          axis=1)


def _pos_err_split(pred_pose_denorm, gt_pose_denorm):
    """(xy, z) error split. Frames are bbox-re-cropped around the object (a
    reference quirk, utils/datasets.py), so world x/y is UNOBSERVABLE from
    images by construction — the mean predictor is the information-theoretic
    optimum there. Resting HEIGHT is a function of object shape, so z is the
    axis where image->pose learning can actually show up."""
    d = pred_pose_denorm[:, :3] - gt_pose_denorm[:, :3]
    return np.linalg.norm(d[:, :2], axis=1), np.abs(d[:, 2])


def _quat_angle(pred_pose_denorm, gt_pose_denorm):
    q = pred_pose_denorm[:, 3:]
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    g = gt_pose_denorm[:, 3:]
    g = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-9)
    dot = np.clip(np.abs(np.sum(q * g, axis=1)), 0.0, 1.0)
    return 2.0 * np.arccos(dot)


def _upvec(pose_denorm):
    """World-frame direction of the body z-axis, R(q) @ e_z, xyzw quats.

    The geodesic angle conflates resting ATTITUDE (which face is down —
    observable from the crop) with spin about symmetry axes the corpus
    cannot identify (a sphere's orientation is pure gauge; a box looks
    identical under its 180-degree symmetries). The body-up direction is
    invariant to spin about the body z-axis and is the component of
    orientation a resting-state predictor could actually learn."""
    q = pose_denorm[:, 3:]
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                     1 - 2 * (x * x + y * y)], axis=1)


def _upvec_angle(pred_pose_denorm, gt_pose_denorm):
    dot = np.clip(np.sum(_upvec(pred_pose_denorm) * _upvec(gt_pose_denorm),
                         axis=1), -1.0, 1.0)
    return np.arccos(dot)


def _orient_rows(entry, prefix, pred, gt, base=None, pers=None, floor=None):
    """Orientation metric rows: geodesic + up-vector, each vs the supplied
    baselines (mean predictor / persistence) and the autoencode floor."""
    for name, fn in (("orient_err_rad", _quat_angle),
                     ("upvec_err_rad", _upvec_angle)):
        entry[f"{prefix}{name}"] = round(float(fn(pred, gt).mean()), 5)
        if base is not None:
            entry[f"{prefix}{name}_mean_predictor"] = round(
                float(fn(base, gt).mean()), 5)
        if pers is not None:
            entry[f"{prefix}{name}_persistence"] = round(
                float(fn(pers, gt).mean()), 5)
        if floor is not None:
            entry[f"{prefix}{name}_autoencode_floor"] = round(
                float(fn(floor, gt).mean()), 5)


def _host(out):
    """A prediction's tensors on the host, as numpy."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def _chunked_predict(session, chunk=256, **arrays):
    """predict() over a large batch in fixed-size chunks: every call has one
    batch shape (the tail is padded by repeating its last row, and the
    padding's outputs are dropped), as the JAX package's tool calls it."""
    n = len(next(v for v in arrays.values() if v is not None))
    outs = []
    for i in range(0, n, chunk):
        part = {k: (None if v is None else v[i:i + chunk])
                for k, v in arrays.items()}
        m = len(next(v for v in part.values() if v is not None))
        if m < chunk:
            part = {k: (None if v is None else np.concatenate(
                [v, np.repeat(v[-1:], chunk - m, axis=0)]))
                for k, v in part.items()}
        outs.append({k: v[:m] for k, v in _host(session.predict(**part)).items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def eval_regression(run, train, test, results, device=None):
    s = InferenceSession.from_run(run, device=device)
    gt = s.denormalize_pose(test["final_pose"])
    pred = _chunked_predict(s, visual=_f32img(test["visual"][:, 0]))
    pose = s.denormalize_pose(np.asarray(pred["pose"]))
    base = s.denormalize_pose(train["final_pose"]).mean(axis=0,
                                                        keepdims=True)
    base = np.repeat(base, len(gt), axis=0)
    xy, z = _pos_err_split(pose, gt)
    bxy, bz = _pos_err_split(base, gt)
    results["regression"] = {
        "n_test": int(len(gt)),
        "pos_err_m": round(float(_pos_err(pose, gt).mean()), 5),
        "pos_err_mean_predictor_m":
            round(float(_pos_err(base, gt).mean()), 5),
        # xy is unobservable from the cropped frames (see _pos_err_split);
        # z (resting height from shape) is the learnable axis
        "pos_err_xy_m": round(float(xy.mean()), 5),
        "pos_err_xy_mean_predictor_m": round(float(bxy.mean()), 5),
        "pos_err_z_m": round(float(z.mean()), 5),
        "pos_err_z_mean_predictor_m": round(float(bz.mean()), 5),
    }
    pers = s.denormalize_pose(test["pose"][:, 0])
    _orient_rows(results["regression"], "", pose, gt, base=base, pers=pers)
    r = results["regression"]
    r["beats_mean_predictor"] = bool(
        r["pos_err_m"] < r["pos_err_mean_predictor_m"])
    r["beats_mean_predictor_z"] = bool(
        r["pos_err_z_m"] < r["pos_err_z_mean_predictor_m"])


def eval_seq(run, train, test, results, device=None):
    s = InferenceSession.from_run(run, device=device)
    gt = s.denormalize_pose(test["final_pose"])
    pred = _chunked_predict(
        s, visual=_f32img(test["visual"][:, 0]),
        tactile=_f32img(test["tactile"][:, 0]),
        pose=test["pose"][:, 0] if s.cfg.use_pose else None)
    base = s.denormalize_pose(train["final_pose"]).mean(axis=0,
                                                        keepdims=True)
    base = np.repeat(base, len(gt), axis=0)
    entry = {"n_test": int(len(gt))}
    if "pose" in pred:
        pose = s.denormalize_pose(np.asarray(pred["pose"]))
        entry["final_pos_err_m"] = round(float(_pos_err(pose, gt).mean()), 5)
        entry["final_pos_err_mean_predictor_m"] = round(
            float(_pos_err(base, gt).mean()), 5)
        entry["beats_mean_predictor"] = bool(
            entry["final_pos_err_m"] < entry["final_pos_err_mean_predictor_m"])
        xy, z = _pos_err_split(pose, gt)
        bxy, bz = _pos_err_split(base, gt)
        entry["final_pos_err_xy_m"] = round(float(xy.mean()), 5)
        entry["final_pos_err_xy_mean_predictor_m"] = round(float(bxy.mean()), 5)
        entry["final_pos_err_z_m"] = round(float(z.mean()), 5)
        entry["final_pos_err_z_mean_predictor_m"] = round(float(bz.mean()), 5)
        entry["beats_mean_predictor_z"] = bool(
            entry["final_pos_err_z_m"] < entry["final_pos_err_z_mean_predictor_m"])
    # autoencoding floor: the same model fed the TARGET (resting) frame —
    # for a resting-state predictor input == target there, so this is the
    # decoder's reconstruction ceiling on these images
    floor = _chunked_predict(
        s, visual=_f32img(test["final_visual"]),
        tactile=_f32img(test["final_tactile"]),
        pose=test["final_pose"] if s.cfg.use_pose else None)
    for mod in ("visual", "tactile"):
        gt_img = _f32img(test[f"final_{mod}"])
        l1 = float(np.abs(np.asarray(pred[mod]) - gt_img).mean())
        pers = float(np.abs(_f32img(test[mod][:, 0]) - gt_img).mean())
        fl = float(np.abs(np.asarray(floor[mod]) - gt_img).mean())
        entry[f"{mod}_l1"] = round(l1, 5)
        entry[f"{mod}_l1_persistence"] = round(pers, 5)
        entry[f"{mod}_l1_autoencode_floor"] = round(fl, 5)
        entry[f"{mod}_beats_persistence"] = bool(l1 < pers)
        entry[f"{mod}_within_2x_floor"] = bool(l1 < 2.0 * max(fl, 1e-9))
    if "pose" in floor:
        # pose reconstruction ceiling: the model fed the TARGET state — the
        # distance the joint-latent pose decode loses before any dynamics
        fp = s.denormalize_pose(np.asarray(floor["pose"]))
        entry["final_pos_err_autoencode_floor_m"] = round(
            float(_pos_err(fp, gt).mean()), 5)
        if "pose" in pred:
            _orient_rows(entry, "final_",
                         s.denormalize_pose(np.asarray(pred["pose"])), gt,
                         base=base, pers=s.denormalize_pose(test["pose"][:, 0]),
                         floor=fp)
    results["seq_modeling"] = entry


def eval_dyn(run, train, test, results, chunk=256, device=None):
    s = InferenceSession.from_run(run, device=device)
    n, t = test["visual"].shape[:2]
    # teacher-forced one-step: rows = all (seq, t) pairs with a successor
    vis = _f32img(test["visual"][:, :-1].reshape(-1, 64, 64, 3))
    tac = _f32img(test["tactile"][:, :-1].reshape(-1, 64, 64, 3))
    pose = test["pose"][:, :-1].reshape(-1, 7)
    nxt_vis = _f32img(test["visual"][:, 1:].reshape(-1, 64, 64, 3))
    nxt_pose = test["pose"][:, 1:].reshape(-1, 7)
    pred = _chunked_predict(
        s, chunk=chunk, visual=vis, tactile=tac,
        pose=pose if s.cfg.use_pose else None)
    entry = {"n_test": int(n), "seq_length": int(t)}
    # split transitions by ground-truth world motion: persistence is exact
    # on resting rows by definition, so the physics question is the moving
    # split (the resting split doubles as the autoencoding floor)
    perr = np.abs(np.asarray(pred["visual"]) - nxt_vis).mean(axis=(1, 2, 3))
    perr_pers = np.abs(vis - nxt_vis).mean(axis=(1, 2, 3))
    if s.cfg.use_pose:
        step_motion = _pos_err(s.denormalize_pose(nxt_pose),
                               s.denormalize_pose(pose))
    else:                       # no pose stream: motion from image change
        step_motion = perr_pers
    moving = step_motion > (0.01 if s.cfg.use_pose else 1e-3)
    entry["n_transitions"] = int(len(perr))
    entry["n_moving"] = int(moving.sum())
    entry["onestep_visual_l1"] = round(float(perr.mean()), 6)
    entry["onestep_visual_l1_persistence"] = round(float(perr_pers.mean()), 6)
    entry["onestep_beats_persistence"] = bool(perr.mean() < perr_pers.mean())
    if moving.any():
        entry["onestep_visual_l1_moving"] = round(
            float(perr[moving].mean()), 6)
        entry["onestep_visual_l1_persistence_moving"] = round(
            float(perr_pers[moving].mean()), 6)
        entry["onestep_beats_persistence_moving"] = bool(
            perr[moving].mean() < perr_pers[moving].mean())
    if (~moving).any():
        entry["onestep_visual_l1_autoencode_floor"] = round(
            float(perr[~moving].mean()), 6)
    if "pose" in pred:
        gt = s.denormalize_pose(nxt_pose)
        pe = _pos_err(s.denormalize_pose(np.asarray(pred["pose"])), gt)
        pp = _pos_err(s.denormalize_pose(pose), gt)
        entry["onestep_pos_err_m"] = round(float(pe.mean()), 6)
        entry["onestep_pos_err_persistence_m"] = round(float(pp.mean()), 6)
        entry["onestep_pose_beats_persistence"] = bool(
            pe.mean() < pp.mean())
        if moving.any():
            entry["onestep_pos_err_moving_m"] = round(
                float(pe[moving].mean()), 6)
            entry["onestep_pos_err_persistence_moving_m"] = round(
                float(pp[moving].mean()), 6)
            entry["onestep_pose_beats_persistence_moving"] = bool(
                pe[moving].mean() < pp[moving].mean())
        if (~moving).any():
            # resting rows: pose_{t+1} == pose_t, so predicting the next
            # pose IS reconstructing the input pose — the joint-latent pose
            # decode ceiling, the analogue of the image autoencoding floor
            fl = float(pe[~moving].mean())
            entry["onestep_pos_err_pose_floor_m"] = round(fl, 6)
            if moving.any():
                entry["pose_dynamics_within_2x_floor"] = bool(
                    pe[moving].mean() < 2.0 * max(fl, 1e-9))
        # orientation: one-step geodesic + up-vector vs persistence; the
        # resting split is the quaternion decode floor (same argument as
        # the position floor above)
        pd = s.denormalize_pose(np.asarray(pred["pose"]))
        cur = s.denormalize_pose(pose)
        _orient_rows(entry, "onestep_", pd, gt, pers=cur)
        if (~moving).any():
            entry["onestep_orient_err_rad_floor"] = round(
                float(_quat_angle(pd[~moving], gt[~moving]).mean()), 5)
            entry["onestep_upvec_err_rad_floor"] = round(
                float(_upvec_angle(pd[~moving], gt[~moving]).mean()), 5)
        if moving.any():
            entry["onestep_upvec_err_rad_moving"] = round(
                float(_upvec_angle(pd[moving], gt[moving]).mean()), 5)
            entry["onestep_upvec_err_rad_persistence_moving"] = round(
                float(_upvec_angle(cur[moving], gt[moving]).mean()), 5)
        # WHY the pose floor is where it is: PoE ablation over input
        # modalities. pose-only >> 0 means the pose expert itself is the
        # bottleneck (7 pose dims x pose_multiplier vs a 24,576-pixel
        # BCE-sum — the ELBO spends the latent on pixels; reference loss
        # weighting, main.py:37/problems.py)
        if s.cfg.use_pose:
            po = _chunked_predict(s, chunk=chunk, pose=pose)
            io = _chunked_predict(s, chunk=chunk, visual=vis, tactile=tac)
            entry["onestep_pos_err_pose_only_m"] = round(float(_pos_err(
                s.denormalize_pose(np.asarray(po["pose"])), gt).mean()), 6)
            entry["onestep_pos_err_images_only_m"] = round(float(_pos_err(
                s.denormalize_pose(np.asarray(io["pose"])), gt).mean()), 6)
    # closed-loop rollout from frame 0 over the full horizon: here the
    # persistence bar is the WHOLE fall (frame 0 is 1.5 m up in the air)
    roll = _host(s.rollout(t - 1, visual=_f32img(test["visual"][:, 0]),
                           tactile=_f32img(test["tactile"][:, 0]),
                           pose=test["pose"][:, 0] if s.cfg.use_pose else None))
    final = np.asarray(roll["visual"])[-1]
    gt_final = _f32img(test["visual"][:, -1])
    l1r = float(np.abs(final - gt_final).mean())
    persr = float(np.abs(_f32img(test["visual"][:, 0]) - gt_final).mean())
    entry["rollout_final_visual_l1"] = round(l1r, 6)
    entry["rollout_final_visual_l1_persistence"] = round(persr, 6)
    entry["rollout_beats_persistence"] = bool(l1r < persr)
    if s.cfg.use_pose and "pose" in roll:
        gt_fp = s.denormalize_pose(test["pose"][:, -1])
        rp = _pos_err(s.denormalize_pose(np.asarray(roll["pose"])[-1]), gt_fp)
        rpp = _pos_err(s.denormalize_pose(test["pose"][:, 0]), gt_fp)
        entry["rollout_final_pos_err_m"] = round(float(rp.mean()), 6)
        entry["rollout_final_pos_err_persistence_m"] = round(
            float(rpp.mean()), 6)
        entry["rollout_pose_beats_persistence"] = bool(
            rp.mean() < rpp.mean())
    results["dyn_modeling"] = entry


def eval_conditional(run, train, test, results, device=None):
    """CVAE counterfactual CONSISTENCY on an exp_3 corpus: does the
    conditional prediction move the way the ground-truth shock outcomes do?

    The round-3 counterfactual harness (``tools/counterfactual.py``) showed
    the prediction responds monotonically to the condition; this check compares
    the DIRECTION and MAGNITUDE of that response against physics. Both the
    data and the model are reduced to a linear map shock -> final position
    (least squares over sequences); consistency = cosine similarity between
    the two coefficient matrices plus the per-axis sign agreement. The gt
    map comes from the train split (what the model could have learned), the
    model map from its own test-split counterfactuals (true shock vs zero
    shock), so the comparison never touches test-split outcomes.
    """
    s = InferenceSession.from_run(run, device=device)
    if not s.cfg.conditional or "shock" not in test:
        raise SystemExit("--cond-run needs a conditional run + shock corpus")

    def lstsq_map(shock, pos):
        """pos ~ shock @ W + b; returns W (S, 3)."""
        a = np.concatenate([shock, np.ones((len(shock), 1))], axis=1)
        w, *_ = np.linalg.lstsq(a, pos, rcond=None)
        return w[:-1]

    sh = test["shock"][:, 0]
    lo = np.asarray(s.norms.get("shock_min", np.zeros(sh.shape[-1])),
                    np.float32)
    hi = np.asarray(s.norms.get("shock_max", np.ones(sh.shape[-1])),
                    np.float32)
    rng = np.where(hi - lo == 0, 1.0, hi - lo)

    # ground truth: RAW shock -> final position over the TRAIN split (the
    # same raw-unit basis as the model map below)
    gt_w = lstsq_map(train["shock"][:, 0] * rng + lo, s.denormalize_pose(
        train["final_pose"])[:, :3])
    zero_norm = np.repeat(((0.0 - lo) / rng)[None], len(sh), axis=0)
    kw = dict(visual=_f32img(test["visual"][:, 0]),
              tactile=_f32img(test["tactile"][:, 0]),
              pose=test["pose"][:, 0] if s.cfg.use_pose else None)
    p_true = _chunked_predict(s, condition=sh.astype(np.float32), **kw)
    p_zero = _chunked_predict(s, condition=zero_norm.astype(np.float32), **kw)
    pos_true = s.denormalize_pose(np.asarray(p_true["pose"]))[:, :3]
    pos_zero = s.denormalize_pose(np.asarray(p_zero["pose"]))[:, :3]
    # model map in RAW shock units (same basis as gt_w): displacement per
    # unit raw shock, via least squares of (pos_true - pos_zero) on raw shock
    raw = sh * rng + lo
    a = np.concatenate([raw, np.ones((len(raw), 1))], axis=1)
    w, *_ = np.linalg.lstsq(a, pos_true - pos_zero, rcond=None)
    md_w = w[:-1]

    cos = float(np.sum(gt_w * md_w) /
                max(np.linalg.norm(gt_w) * np.linalg.norm(md_w), 1e-12))
    # the physically-driven axes: gt slopes with meaningful magnitude
    strong = np.abs(gt_w) > 0.1 * np.abs(gt_w).max()
    sign_agree = float((np.sign(gt_w) == np.sign(md_w))[strong].mean())
    results["conditional"] = {
        "n_test": int(len(sh)),
        "gt_shock_to_pos_map": [[round(float(x), 5) for x in r]
                                for r in gt_w],
        "model_shock_to_pos_map": [[round(float(x), 5) for x in r]
                                   for r in md_w],
        "map_cosine": round(cos, 4),
        "sign_agreement_strong_axes": round(sign_agree, 3),
        "mean_cf_displacement_m": round(
            float(np.linalg.norm(pos_true - pos_zero, axis=1).mean()), 5),
        "moves_the_right_way": bool(cos > 0.5),
    }


def build_parser():
    ap = argparse.ArgumentParser(description="Held-out accuracy against baselines")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--reg-run", default=None)
    ap.add_argument("--seq-run", default=None)
    ap.add_argument("--dyn-run", default=None)
    ap.add_argument("--cond-run", default=None,
                    help="conditional (CVAE) seq run for the counterfactual-"
                    "consistency check (exp_3 corpora)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; otherwise the CUDA card")
    ap.add_argument("--no-crop", action="store_true", default=False,
                    help="evaluate against the --no-crop compile variant "
                    "(runs trained with cli.main --no-crop)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mmdyn_tpu_torch.data.dataset import VisuoTactileArrays
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = device_for_platform(args.platform)
    set_reference_precision()
    crop = not args.no_crop
    train = VisuoTactileArrays(args.dataset, train=True, crop=crop).arrays
    test = VisuoTactileArrays(args.dataset, train=False, crop=crop).arrays
    results = {"dataset": str(args.dataset),
               "crop": crop,
               "n_train": int(len(train["final_pose"])),
               "n_test": int(len(test["final_pose"]))}
    if args.reg_run:
        eval_regression(args.reg_run, train, test, results, device=device)
    if args.seq_run:
        eval_seq(args.seq_run, train, test, results, device=device)
    if args.dyn_run:
        eval_dyn(args.dyn_run, train, test, results, device=device)
    if args.cond_run:
        eval_conditional(args.cond_run, train, test, results, device=device)

    print(json.dumps(results, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
