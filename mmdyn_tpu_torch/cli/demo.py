"""Single-object imprint collection (port of ``mmdyn_tpu/cli/demo.py``, itself
a port of mmdyn/tact_sim/examples/demo.py).

Drops one object onto the sensor and dumps visual / tactile / seg / depth
sequences plus data.json. With PyBullet installed the bundled winebottle /
bowl meshes are used; otherwise the analytic engine drops an equivalent
primitive. ``--device-render`` and ``--device-physics`` run on the card;
``--platform cpu`` runs them on the CPU.

    python -m mmdyn_tpu_torch.cli.demo --headless --n_timesteps 200 --logdir sim_logs
"""

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--object", type=str, default="winebottle")
parser.add_argument("--logdir", type=str, default="sim_logs")
parser.add_argument("--n_timesteps", type=int, default=200,
                    help="Number of timesteps in simulation.")
parser.add_argument("--show_image", default=False, action="store_true",
                    help="If true, shows the sensor images.")
parser.add_argument("--interval", type=int, default=10,
                    help="Number of timesteps between each snapshot.")
parser.add_argument("--fast-shading", action="store_true", default=False,
                    help="float32 Phong (faster snapshots)")
parser.add_argument("--device-render", action="store_true", default=False,
                    help="render the snapshots in batches on the device at the end "
                    "of the rollout (sim/raycast_torch.py, sim/tactile_torch.py)")
parser.add_argument("--device-physics", action="store_true", default=False,
                    help="step the whole rollout on the device (sim/physics_torch.py) "
                    "and render it with the packed device pipeline; analytic engine "
                    "only, implies --device-render")
parser.add_argument("--headless", action="store_true", default=False,
                    help="If true, uses headless rendering.")
parser.add_argument("--engine", type=str, default="auto",
                    choices=["auto", "pybullet", "analytic"])
parser.add_argument("--seed", type=int, default=None)
parser.add_argument("--debug", action="store_true", default=False)
parser.add_argument("--platform", default=None, type=str,
                    help="'cpu' runs the device paths on the CPU; otherwise the CUDA card")


def main(argv=None):
    from mmdyn_tpu_torch.sim import config
    from mmdyn_tpu_torch.sim.physics import PyBulletBackend, setup_backend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.assets import preload_object, spawn_object
    from mmdyn_tpu_torch.sim import geometry
    from mmdyn_tpu_torch.cli._simrun import (make_deferred, run_trials_device_physics,
                                             snapshot)
    from mmdyn_tpu_torch.utils.device import device_for_platform

    args = parser.parse_args(argv)
    if args.seed is not None:
        np.random.seed(args.seed)

    engine = args.engine
    if args.device_physics:
        if engine == "pybullet":
            raise SystemExit("--device-physics requires the analytic engine")
        engine = "analytic"
    device = (device_for_platform(args.platform)
              if args.device_physics or args.device_render else None)

    backend = setup_backend(time_step=config.TIME_STEP, renders=not args.headless,
                            gravity=True, engine=engine)
    sensor = make_sensor(backend, size=[1.5, 1.5, 1], position=[0, 0, 0.5],
                         sensor_vector=[0, 0, 1], thickness=0.01, use_force=False,
                         constrained=False, fast_shading=args.fast_shading)

    # initial object pose via the pose-algebra pipeline (demo.py:56-62)
    position = np.array([0.0, 0.0, 1.3])
    orientation = np.array([0, 0, 0, 1])
    base_pose = geometry.list2pose_stamped(list(position) + list(orientation))
    t_mat = np.eye(4)
    pose_transform = geometry.pose_from_matrix(t_mat, frame_id="body")
    object_pose = geometry.transform_body(base_pose, pose_transform)
    object_pose_list = geometry.pose_stamped2list(object_pose)

    if isinstance(backend, PyBulletBackend):
        info = preload_object(args.object)
    else:
        info = {"shape": "sphere" if args.object == "bowl" else "box",
                "size": 0.15 if args.object == "bowl" else [0.06, 0.06, 0.25],
                "colors": [[1, 0, 0, 1]], "scale": 1.0}
    obj_id = spawn_object(backend, info, position=object_pose_list[0:3],
                          orientation=object_pose_list[3:7], mass=0.5, color=[1, 0, 0, 1],
                          mesh_scale=info.get("scale"))
    print("Preloaded the object.")

    data = defaultdict(list)
    img_counter = 0
    deferred = make_deferred(sensor, device=device) if args.device_render else None
    path = Path(args.logdir).joinpath("dataset")

    if args.device_physics:
        # the whole rollout as one device trial (physics + packed rendering +
        # the run-length wire)
        pose0 = backend.get_pose(obj_id)
        res = run_trials_device_physics(backend, sensor, obj_id, [{obj_id: pose0}],
                                        args.n_timesteps, args.interval, [path],
                                        device=device)[0]
        if res is None:
            raise SystemExit("initial frame is blank: nothing to record")
        data = {"time_step": res["time_step"], "time": res["time"],
                "position": res["position"], "orientation": res["orientation"]}
        path.mkdir(parents=True, exist_ok=True)
        with open(path.joinpath("data.json"), "w") as f:
            json.dump(data, f)
        backend.reset()
        print(f"wrote {len(data['time_step'])} snapshots to {path}")
        return

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
    print(f"wrote {img_counter} snapshots to {path}")


if __name__ == "__main__":
    main()
