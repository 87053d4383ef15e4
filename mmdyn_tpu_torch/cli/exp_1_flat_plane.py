"""Experiment 1: objects freefalling on a flat sensor (port of
``mmdyn_tpu/cli/exp_1_flat_plane.py``, itself a port of
mmdyn/tact_sim/experiments/exp_1_flat_plane.py).

With PyBullet and a local ShapeNetSem download this replays the reference
protocol (metadata join, COM / texture filtering, a fresh engine per trial).
On the analytic engine it draws from a synthetic primitive catalog instead.
``--device-physics`` steps all of an object's trials in one batched rollout
on the card and renders them there (``--platform cpu``: on the CPU):

    python -m mmdyn_tpu_torch.cli.exp_1_flat_plane --headless --n_objects 4 \\
        --trial_per_obj 10 --device-physics --logdir sim_logs
"""

import argparse
import json
import random
from collections import defaultdict
from pathlib import Path

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--n_timesteps", type=int, default=500,
                    help="Number of timesteps in each trial.")
parser.add_argument("--dataset_dir", type=str, default="~/datasets/ShapeNetSem",
                    help="Absolute path to the ShapeNetSem directory (PyBullet engine).")
parser.add_argument("--logdir", type=str, default="sim_logs")
parser.add_argument("--category",
                    type=lambda s: [i.replace(" ", "") for i in s.split(",")],
                    default="", help="ShapeNetSem category filter.")
parser.add_argument("--show_image", default=False, action="store_true")
parser.add_argument("--interval", type=int, default=10,
                    help="Timesteps between snapshots.")
parser.add_argument("--fast-shading", action="store_true", default=False,
                    help="float32 Phong (faster snapshots)")
parser.add_argument("--device-render", action="store_true", default=False,
                    help="render the snapshots in batches on the device at the end "
                    "of each rollout (sim/raycast_torch.py, sim/tactile_torch.py)")
parser.add_argument("--device-physics", action="store_true", default=False,
                    help="step all of an object's trials on the device in one "
                    "batched rollout (sim/physics_torch.py) and render them with "
                    "the packed device pipeline; analytic engine only, implies "
                    "--device-render")
parser.add_argument("--headless", action="store_true", default=False)
parser.add_argument("--debug", action="store_true", default=False)
parser.add_argument("--trial_per_obj", type=int, default=10)
parser.add_argument("--engine", type=str, default="auto",
                    choices=["auto", "pybullet", "analytic"])
parser.add_argument("--n_objects", type=int, default=8,
                    help="Synthetic catalog size (analytic engine).")
parser.add_argument("--seed", type=int, default=None)
parser.add_argument("--apply-sampled-position", action="store_true", default=False,
                    help="actually drop from the sampled Gaussian position "
                         "(the reference samples one and discards it, "
                         "exp_1_flat_plane.py:83-108: every object falls "
                         "from exactly (0,0,1.5); the default replicates that "
                         "quirk). Use --drop-std to widen the scatter.")
parser.add_argument("--drop-std", type=float, default=0.05,
                    help="Gaussian std (m) of the sampled drop position")
parser.add_argument("--workers", type=int, default=1,
                    help="Parallel trial processes (trials are independent; "
                    "each uses its own engine instance)")
parser.add_argument("--platform", default=None, type=str,
                    help="'cpu' runs the device paths on the CPU; otherwise the CUDA card")


def resolve_engine(args):
    """``--engine auto``: PyBullet where it imports, else the analytic engine;
    ``--device-physics`` needs the analytic one."""
    engine = args.engine
    if engine == "auto":
        try:
            import pybullet  # noqa: F401
            engine = "pybullet"
        except ImportError:
            engine = "analytic"
    if args.device_physics and engine != "analytic":
        raise SystemExit("--device-physics requires the analytic engine")
    return engine


def device_of(args):
    """The device of the ``--device-*`` paths (None for the host path)."""
    from mmdyn_tpu_torch.utils.device import device_for_platform

    if args.device_physics or args.device_render:
        return device_for_platform(args.platform)
    return None


def iter_objects(args, engine):
    """Yield parsed object records for the configured engine."""
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.assets import (parse_shapenet_sem, preload_shapenet_sem,
                                            synthetic_object_catalog)

    if engine == "pybullet":
        meta_df, root = preload_shapenet_sem(path=args.dataset_dir,
                                             category=args.category or [""])
        print(f"Total number of available objects (before filtering out): {meta_df.shape}")
        for _, row in meta_df.iterrows():
            info = parse_shapenet_sem(row, root)
            if (info["colors"] or info["textured_material"]) and \
                    np.linalg.norm(info["center_mass"]) < config.COM_THRESHOLD:
                yield info
    else:
        yield from synthetic_object_catalog(args.n_objects, seed=args.seed or 0)


def run_trial(args, info, k, engine):
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.physics import setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.sample import sample_pose
    from mmdyn_tpu_torch.sim.assets import spawn_object
    from mmdyn_tpu_torch.cli._simrun import make_deferred, snapshot

    backend = setup_backend(time_step=config.TIME_STEP, renders=not args.headless,
                            gravity=True, engine=engine)
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.005, use_force=False,
                         constrained=False, fast_shading=args.fast_shading)

    if not info["textured_material"]:
        color = list(random.choice(info["colors"]))
        color[-1] = 1.0
    else:
        color = []

    init_pos = np.array([0.0, 0.0, 1.5])
    COM_shift = info["center_mass"] - np.array([0, 0, info["mesh_height"] / 4])
    position, orientation = sample_pose(init_pos, random_chance=0.8, random_orn=True,
                                        gaussian_mean=0, gaussian_std=args.drop_std)

    obj_id = spawn_object(backend, info, position=init_pos - info["center_mass"],
                          orientation=[0, 0, 0, 1], mass=1, color=color, COM_shift=COM_shift)
    backend.set_pose(obj_id, *backend.get_pose(obj_id))
    if args.apply_sampled_position:
        # non-parity: the sampled drop position is actually used
        backend.set_pose(obj_id, position - info["center_mass"], orientation)
    else:
        # reference quirk: the sampled position discarded, the orientation applied
        pos, _ = backend.get_pose(obj_id)
        backend.set_pose(obj_id, pos, orientation)

    # blank-image guard (exp_1:111-115)
    _, _, _, seg_img, _ = sensor.get_sensor_image()
    if sensor.is_blank(seg_img):
        backend.reset()
        backend.disconnect()
        return False

    data = defaultdict(list)
    img_counter = 0
    deferred = make_deferred(sensor, device=device_of(args)) if args.device_render else None
    path = Path(args.logdir).joinpath(info["synset"], info["obj_name"],
                                      "sequence_" + str(k).zfill(4))
    for t in range(args.n_timesteps):
        if (t + 1) % args.interval == 0:
            pose, _ = snapshot(sensor, obj_id, path, img_counter, show_image=args.show_image,
                               deferred=deferred)
            data["time_step"].append(t)
            data["time"].append(t * config.TIME_STEP)
            data["position"].append(list(pose[0]))
            data["orientation"].append(list(pose[1]))
            img_counter += 1
        backend.step()
    if deferred is not None:
        deferred.flush()

    with open(path.joinpath("data.json"), "w") as f:
        json.dump(data, f)
    backend.reset()
    backend.disconnect()
    return True


def run_trials_device(args, info, trial_seeds):
    """All of one object's trials in one batched device rollout
    (--device-physics): the same per-trial RNG draws as run_trial (the
    colour, then sample_pose), then physics and rendering on the device via
    _simrun.run_trials_device_physics."""
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.physics import setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.sample import sample_pose
    from mmdyn_tpu_torch.sim.assets import spawn_object
    from mmdyn_tpu_torch.cli._simrun import run_trials_device_physics

    backend = setup_backend(time_step=config.TIME_STEP, renders=False, gravity=True,
                            engine="analytic")
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.005, use_force=False,
                         constrained=False, fast_shading=args.fast_shading)

    init_pos = np.array([0.0, 0.0, 1.5])
    COM_shift = info["center_mass"] - np.array([0, 0, info["mesh_height"] / 4])
    trial_states, paths, colors = [], [], []
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
        position, orientation = sample_pose(init_pos, random_chance=0.8, random_orn=True,
                                            gaussian_mean=0, gaussian_std=args.drop_std)
        p0 = (position if args.apply_sampled_position else init_pos) - info["center_mass"]
        trial_states.append((p0, orientation))
        paths.append(Path(args.logdir).joinpath(info["synset"], info["obj_name"],
                                                "sequence_" + str(k).zfill(4)))
    # the synthetic catalog gives each object one colour, so all trials share
    # the spawn colour (the batched scene has one object body)
    if len(set(colors)) != 1:
        raise ValueError("--device-physics requires a single color per object")
    obj_id = spawn_object(backend, info, position=init_pos - info["center_mass"],
                          orientation=[0, 0, 0, 1], mass=1, color=list(colors[0]),
                          COM_shift=COM_shift)

    results = run_trials_device_physics(backend, sensor, obj_id,
                                        [{obj_id: st} for st in trial_states],
                                        args.n_timesteps, args.interval, paths,
                                        device=device_of(args))
    n_ok = 0
    for path, res in zip(paths, results):
        if res is None:
            continue    # blank-image guard (exp_1:111-115)
        data = {"time_step": res["time_step"], "time": res["time"],
                "position": res["position"], "orientation": res["orientation"]}
        path.mkdir(parents=True, exist_ok=True)
        with open(path.joinpath("data.json"), "w") as f:
            json.dump(data, f)
        n_ok += 1
    backend.reset()
    backend.disconnect()
    return n_ok


def _run_trial_star(job):
    args, info, k, engine, seed = job
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
    print(f"trial: {info['obj_name']} #{k} ({info['category']})")
    return run_trial(args, info, k, engine)


def run_jobs(args, engine, jobs, run):
    """The host path's trials, in a spawn pool of ``--workers`` processes on
    the analytic engine (PyBullet connections are per-process globals)."""
    if args.workers > 1 and engine == "analytic":
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.workers) as pool:
            pool.map(run, jobs)
    else:
        for job in jobs:
            run(job)


def main(argv=None):
    args = parser.parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    engine = resolve_engine(args)
    if args.device_physics or args.device_render:
        device_of(args)                 # no card and no --platform cpu: raise now

    jobs = []
    total = 0
    for info in iter_objects(args, engine):
        total += 1
        if args.device_physics:
            trial_seeds = [(k, None if args.seed is None else args.seed + 7919 * total + k)
                           for k in range(args.trial_per_obj)]
            print(f"device trials: {info['obj_name']} x{len(trial_seeds)} "
                  f"({info['category']})")
            run_trials_device(args, info, trial_seeds)
            continue
        for k in range(args.trial_per_obj):
            seed = None if args.seed is None else args.seed + 7919 * total + k
            jobs.append((args, info, k, engine, seed))
    if not args.device_physics:
        run_jobs(args, engine, jobs, _run_trial_star)
    print(f"done: {total} objects x {args.trial_per_obj} trials")


if __name__ == "__main__":
    main()
