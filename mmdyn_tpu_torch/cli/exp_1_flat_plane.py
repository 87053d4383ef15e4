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


def main(argv=None):
    from mmdyn_tpu_torch.cli._simrun import Scene, run_experiment

    run_experiment(parser.parse_args(argv), Scene(reset_spawn_pose=True))


if __name__ == "__main__":
    main()
