"""Experiment 3: force perturbation of initially stable objects (port of
``mmdyn_tpu/cli/exp_3_force_pert.py``, itself a port of
mmdyn/tact_sim/experiments/exp_3_force_pert.py).

The object settles on a movable (mass 100) sensor; during t in [130, 160] a
random lateral shock force is applied to the sensor every step. Snapshots
are taken from t >= 100 and the shock vector is logged per frame, feeding
the conditional (CVAE) training pathway downstream. ``--device-physics``
runs on the card (``--platform cpu``: the CPU):

    python -m mmdyn_tpu_torch.cli.exp_3_force_pert --headless --force 1 \\
        --n_objects 2 --trial_per_obj 1 --n_timesteps 300 --logdir sim_logs
"""

import argparse
import json
import random
from collections import defaultdict
from pathlib import Path

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--n_timesteps", type=int, default=500)
parser.add_argument("--dataset_dir", type=str, default="~/datasets/ShapeNetSem")
parser.add_argument("--logdir", type=str, default="sim_logs")
parser.add_argument("--category",
                    type=lambda s: [i.replace(" ", "") for i in s.split(",")],
                    default="")
parser.add_argument("--show_image", default=False, action="store_true")
parser.add_argument("--interval", type=int, default=10)
parser.add_argument("--fast-shading", action="store_true", default=False,
                    help="float32 Phong (faster snapshots)")
parser.add_argument("--device-render", action="store_true", default=False,
                    help="render the snapshots in batches on the device at the end "
                    "of each rollout (sim/raycast_torch.py, sim/tactile_torch.py)")
parser.add_argument("--device-physics", action="store_true", default=False,
                    help="step all of an object's trials on the device in one "
                    "batched rollout (sim/physics_torch.py) and render them with "
                    "the packed device pipeline; analytic engine only")
parser.add_argument("--headless", action="store_true", default=False)
parser.add_argument("--force", type=float, default=1)
parser.add_argument("--debug", action="store_true", default=False)
parser.add_argument("--trial_per_obj", type=int, default=10)
parser.add_argument("--engine", type=str, default="auto",
                    choices=["auto", "pybullet", "analytic"])
parser.add_argument("--n_objects", type=int, default=8)
parser.add_argument("--seed", type=int, default=None)
parser.add_argument("--apply-sampled-position", action="store_true", default=False,
                    help="actually drop from the sampled Gaussian position "
                         "(the reference discards it; the parity default keeps "
                         "that quirk)")
parser.add_argument("--drop-std", type=float, default=0.05,
                    help="Gaussian std (m) of the sampled drop position")
parser.add_argument("--workers", type=int, default=1,
                    help="Parallel trial processes (trials are independent; "
                    "each uses its own engine instance)")
parser.add_argument("--snapshot_from", type=int, default=100,
                    help="First timestep eligible for snapshots (exp_3:128).")
parser.add_argument("--platform", default=None, type=str,
                    help="'cpu' runs the device paths on the CPU; otherwise the CUDA card")

SHOCK_FIRST, SHOCK_LAST = 130, 160      # the shocked steps (exp_3:113-114)


def _no_snapshots(args):
    print(f"WARNING: no snapshots taken (n_timesteps {args.n_timesteps} <= "
          f"snapshot_from {args.snapshot_from}); skipping trial")


def run_trial(args, info, k, engine, force_amp):
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.physics import setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.sample import sample_pose
    from mmdyn_tpu_torch.sim.assets import spawn_object
    from mmdyn_tpu_torch.cli._simrun import make_deferred, snapshot
    from mmdyn_tpu_torch.cli.exp_1_flat_plane import device_of

    backend = setup_backend(time_step=config.TIME_STEP, renders=not args.headless,
                            gravity=True, engine=engine)
    # movable sensor, mass 100 (exp_3:64-65)
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.005, use_force=False,
                         constrained=False, mass=100, fast_shading=args.fast_shading)

    if not info["textured_material"]:
        color = list(random.choice(info["colors"]))
        color[-1] = 1.0
    else:
        color = []

    init_pos = np.array([0.0, 0.0, 1.3])
    COM_shift = info["center_mass"] - np.array([0, 0, info["mesh_height"] / 4])
    position, orientation = sample_pose(init_pos, random_chance=0.8, random_orn=False,
                                        gaussian_mean=0, gaussian_std=args.drop_std)
    obj_id = spawn_object(backend, info, position=init_pos - info["center_mass"],
                          orientation=[0, 0, 0, 1], mass=1, color=color, COM_shift=COM_shift)
    if args.apply_sampled_position:
        backend.set_pose(obj_id, position - info["center_mass"], orientation)
    else:
        # reference quirk: the sampled position discarded, the orientation applied
        pos, _ = backend.get_pose(obj_id)
        backend.set_pose(obj_id, pos, orientation)

    _, _, _, seg_img, _ = sensor.get_sensor_image()
    if sensor.is_blank(seg_img):
        backend.reset()
        backend.disconnect()
        return False

    data = defaultdict(list)
    shock = [force_amp * np.random.normal(), force_amp * np.random.normal(), 0]
    img_counter = 0
    deferred = make_deferred(sensor, device=device_of(args)) if args.device_render else None
    path = Path(args.logdir).joinpath(info["synset"], info["obj_name"], str(int(force_amp)),
                                      "sequence_" + str(k).zfill(4))
    for t in range(args.n_timesteps):
        if SHOCK_FIRST <= t <= SHOCK_LAST:
            backend.apply_external_force(sensor.sensor_id, shock)

        if (t + 1) % args.interval == 0 and t >= args.snapshot_from:
            pose, force = snapshot(sensor, obj_id, path, img_counter, mask_seg_to_obj=False,
                                   show_image=args.show_image, deferred=deferred)
            data["time_step"].append(t)
            data["time"].append(t * config.TIME_STEP)
            data["position"].append(list(pose[0]))
            data["orientation"].append(list(pose[1]))
            data["force"].append(force)
            data["shock"].append(shock)
            img_counter += 1
        backend.step()
    if deferred is not None:
        deferred.flush()

    if img_counter == 0:
        # n_timesteps never reached snapshot_from: no frames and no dump
        # directory, a skipped trial
        _no_snapshots(args)
        backend.reset()
        backend.disconnect()
        return False

    with open(path.joinpath("data.json"), "w") as f:
        json.dump(data, f)
    backend.reset()
    backend.disconnect()
    return True


def run_trials_device(args, info, trial_seeds, force_amp):
    """All of one object's trials in one batched device rollout
    (--device-physics): the same per-trial RNG draws as run_trial (the
    colour, sample_pose, then the shock), with the per-step shock on the
    movable sensor shipped as the rollout's external-force series."""
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.physics import setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.sample import sample_pose
    from mmdyn_tpu_torch.sim.assets import spawn_object
    from mmdyn_tpu_torch.cli._simrun import run_trials_device_physics
    from mmdyn_tpu_torch.cli.exp_1_flat_plane import device_of

    backend = setup_backend(time_step=config.TIME_STEP, renders=False, gravity=True,
                            engine="analytic")
    # movable sensor, mass 100 (exp_3:64-65)
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.005, use_force=False,
                         constrained=False, mass=100, fast_shading=args.fast_shading)

    init_pos = np.array([0.0, 0.0, 1.3])
    COM_shift = info["center_mass"] - np.array([0, 0, info["mesh_height"] / 4])
    trial_states, paths, colors, shocks = [], [], [], []
    for k, seed in trial_seeds:
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
        # the same RNG draws, in the same order, as run_trial
        if not info["textured_material"]:
            color = list(random.choice(info["colors"]))
            color[-1] = 1.0
        else:
            color = []
        colors.append(tuple(color))
        position, orientation = sample_pose(init_pos, random_chance=0.8, random_orn=False,
                                            gaussian_mean=0, gaussian_std=args.drop_std)
        shocks.append([force_amp * np.random.normal(), force_amp * np.random.normal(), 0])
        p0 = (position if args.apply_sampled_position else init_pos) - info["center_mass"]
        trial_states.append((p0, orientation))
        paths.append(Path(args.logdir).joinpath(info["synset"], info["obj_name"],
                                                str(int(force_amp)),
                                                "sequence_" + str(k).zfill(4)))
    if len(set(colors)) != 1:
        raise ValueError("--device-physics requires a single color per object")
    obj_id = spawn_object(backend, info, position=init_pos - info["center_mass"],
                          orientation=[0, 0, 0, 1], mass=1, color=list(colors[0]),
                          COM_shift=COM_shift)

    # the per-step world-frame shock on the sensor
    ids = sorted(backend.bodies)
    row = {bid: r for r, bid in enumerate(ids)}
    n_steps = int(args.n_timesteps)
    ext = np.zeros((len(trial_states), n_steps, len(ids), 3), np.float32)
    if SHOCK_FIRST < n_steps:
        last = min(SHOCK_LAST, n_steps - 1)
        for k in range(len(trial_states)):
            ext[k, SHOCK_FIRST:last + 1, row[sensor.sensor_id]] = shocks[k]

    results = run_trials_device_physics(backend, sensor, obj_id,
                                        [{obj_id: st} for st in trial_states],
                                        args.n_timesteps, args.interval, paths,
                                        snapshot_from=args.snapshot_from, ext_forces=ext,
                                        mask_seg_to_obj=False, device=device_of(args))
    n_ok = 0
    for path, res, shock in zip(paths, results, shocks):
        if res is None:
            continue
        if not res["time_step"]:
            _no_snapshots(args)
            continue
        data = {"time_step": res["time_step"], "time": res["time"],
                "position": res["position"], "orientation": res["orientation"],
                "force": res["force"], "shock": [shock] * len(res["time_step"])}
        path.mkdir(parents=True, exist_ok=True)
        with open(path.joinpath("data.json"), "w") as f:
            json.dump(data, f)
        n_ok += 1
    backend.reset()
    backend.disconnect()
    return n_ok


def _run_trial_star(job):
    args, info, k, engine, force_amp, seed = job
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
    print(f"trial: {info['obj_name']} #{k} ({info['category']}), force_amp={force_amp}")
    return run_trial(args, info, k, engine, force_amp)


def main(argv=None):
    from mmdyn_tpu_torch.cli.exp_1_flat_plane import (device_of, iter_objects,
                                                      resolve_engine, run_jobs)

    args = parser.parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    force_amp = 1000 * args.force
    engine = resolve_engine(args)
    if args.device_physics or args.device_render:
        device_of(args)                 # no card and no --platform cpu: raise now

    jobs, total = [], 0
    for info in iter_objects(args, engine):
        total += 1
        if args.device_physics:
            trial_seeds = [(k, None if args.seed is None else args.seed + 7919 * total + k)
                           for k in range(args.trial_per_obj)]
            print(f"device trials: {info['obj_name']} x{len(trial_seeds)} "
                  f"({info['category']}), force_amp={force_amp}")
            run_trials_device(args, info, trial_seeds, force_amp)
            continue
        for k in range(args.trial_per_obj):
            seed = None if args.seed is None else args.seed + 7919 * total + k
            jobs.append((args, info, k, engine, force_amp, seed))
    if not args.device_physics:
        run_jobs(args, engine, jobs, _run_trial_star)
    print(f"done: {total} objects x {args.trial_per_obj} trials")


if __name__ == "__main__":
    main()
