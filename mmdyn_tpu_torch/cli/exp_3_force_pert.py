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


def main(argv=None):
    from mmdyn_tpu_torch.cli._simrun import Scene, run_experiment

    args = parser.parse_args(argv)
    force_amp = 1000 * args.force
    # the object settles on a movable sensor, mass 100 (exp_3:64-65); the
    # segmentation dumps keep every body, not only the object
    run_experiment(args, Scene(drop=(0.0, 0.0, 1.3), random_orn=False, sensor_mass=100,
                               mask_seg_to_obj=False, log_force=True,
                               shock=(SHOCK_FIRST, SHOCK_LAST, force_amp),
                               snapshot_from=args.snapshot_from, skip_empty=True,
                               note=f", force_amp={force_amp}"))


if __name__ == "__main__":
    main()
