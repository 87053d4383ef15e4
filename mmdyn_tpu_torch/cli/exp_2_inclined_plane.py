"""Experiment 2: objects on an inclined sensor (port of
``mmdyn_tpu/cli/exp_2_inclined_plane.py``, itself a port of
mmdyn/tact_sim/experiments/exp_2_inclined_plane.py).

The sensor is tilted by --slope radians about the y-axis and (on PyBullet)
held by a fixed constraint re-pinned every step; the contact force is
logged. ``--device-physics`` runs on the card (``--platform cpu``: the CPU):

    python -m mmdyn_tpu_torch.cli.exp_2_inclined_plane --headless --slope 0.15 \\
        --n_objects 2 --trial_per_obj 1 --n_timesteps 300 --logdir sim_logs
"""

import argparse

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
                    "the packed device pipeline; analytic engine only, incompatible "
                    "with --use-force (the equilibrium buffer is sequential host "
                    "state)")
parser.add_argument("--headless", action="store_true", default=False)
parser.add_argument("--slope", type=float, default=0.15,
                    help="Sensor tilt angle (radians).")
parser.add_argument("--use-force", action="store_true", default=False,
                    help="Equilibrium sensor mode: tactile frames come from "
                    "the image-buffer spring/contact-force binary search "
                    "(sensor.py::compute_equilibrium) instead of the "
                    "instantaneous clip. The reference ships this sensor "
                    "capability but never exercises it in an experiment "
                    "(tact_sim/tactile/sensor.py:265,274); off by default "
                    "for dump parity.")
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
parser.add_argument("--platform", default=None, type=str,
                    help="'cpu' runs the device paths on the CPU; otherwise the CUDA card")


def main(argv=None):
    from mmdyn_tpu_torch.cli._simrun import Scene, run_experiment
    from mmdyn_tpu_torch.sim.transforms import quat_from_euler

    args = parser.parse_args(argv)
    tilt = quat_from_euler([0.0, args.slope, 0.0])
    run_experiment(args, Scene(drop=(0.3, 0.0, 1.5), sensor_orientation=tuple(tilt),
                               use_force=args.use_force, pinned=True, log_force=True,
                               note=f", slope={args.slope}"))


if __name__ == "__main__":
    main()
