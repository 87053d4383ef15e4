"""Training CLI of the port, flag-compatible with ``mmdyn_tpu/cli/main.py``
(and so with the reference, mmdyn/pytorch/main.py).

    python -m mmdyn_tpu_torch.cli.main --problem-type seq_modeling \\
        --model-name cnn-mvae --input-type visuotactile --use-pose \\
        --dataset-path ~/dataset --batchsize 128 --num-epochs 100

It trains on the card; ``--platform cpu`` selects the CPU. A dataset
directory without a compiled corpus is compiled from its simulator dumps
first (``data/compile.py``; ``--no-strict-parity`` keeps the last sequence
that the reference drops).

Data parallelism: ``--num-devices N`` > 1 spawns N processes, one per card
(``cuda:0``..``cuda:N-1``, NCCL), or N CPU processes (gloo) with
``--platform cpu``, and trains on the global batch as one process would
(``parallel/mesh.py``); more cards than are visible is an error. Under
``torchrun`` the CLI joins the group it finds (``--num-devices`` 0 or its
size), and ``--num-devices 1`` trains in a one-rank group.
"""

import argparse
import pickle
import sys


def build_parser():
    parser = argparse.ArgumentParser(description="Training (PyTorch + CUDA)")

    # Problem (reference flags, main.py:10-54)
    parser.add_argument("--problem-type", default="seq_modeling", type=str,
                        help="Problem type (default: seq_modeling)")
    parser.add_argument("--model-name", default="cnn-mvae", type=str,
                        help="Model architecture name")
    parser.add_argument("--input-type", default="visual", type=str,
                        help="Input modality (valid: visual, tactile, visuotactile)")
    parser.add_argument("--use-pose", action="store_true", default=False,
                        help="Use pose as additional modality (MVAE only)")
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--dataset-path", default="~/dataset", type=str)
    parser.add_argument("--batchsize", default=128, type=int)
    parser.add_argument("--criterion", default="crossentropy", type=str)
    parser.add_argument("--optimizer", default="Adam", type=str)
    parser.add_argument("--num-epochs", default=100, type=int)
    parser.add_argument("--mask-loss", action="store_true", default=False,
                        help="Mask the reconstruction loss to the object segment")
    parser.add_argument("--vis-pose", action="store_true", default=False)
    parser.add_argument("--pose-multiplier", default=1000, type=float)

    # Misc
    parser.add_argument("--save-name", default="run", type=str)
    parser.add_argument("--no-cuda", action="store_true", default=False,
                        help="(accepted for compatibility; the device is chosen "
                             "with --platform)")

    # VAE specific
    parser.add_argument("--kl-weight", type=float, default=1.0)
    parser.add_argument("--latent-size", type=int, default=256)
    parser.add_argument("--annealing-epochs", type=int, default=50)
    parser.add_argument("--conditional", action="store_true", default=False)

    # framework additions
    parser.add_argument("--num-devices", type=int, default=0,
                        help="Data-parallel over this many devices, one process "
                             "each (0 = one device, no process group)")
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--log-dir", default=None, type=str,
                        help="Reuse an existing run directory (for --resume)")
    parser.add_argument("--logs-root", default="./logs", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-strict-parity", action="store_true", default=False,
                        help="Compile without the reference's quirks (keep the "
                             "final sequence)")
    parser.add_argument("--no-crop", action="store_true", default=False,
                        help="Train on the corpus compiled WITHOUT the reference's "
                             "seg-bbox re-crop (datasets.py:347-366)")
    parser.add_argument("--no-tensorboard", action="store_true", default=False)
    parser.add_argument("--platform", default=None, type=str,
                        help="'cpu' trains on the CPU; otherwise the CUDA card")
    parser.add_argument("--dtype", default="auto", type=str,
                        choices=("auto", "float32", "bfloat16", "bfloat16_full"),
                        help="Activation policy. 'auto' (default) applies the JAX "
                             "package's rule, which picks bf16 on a TPU only: "
                             "float32 here")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 matmul/conv inputs (f32 accumulate); "
                             "overrides --dtype")
    parser.add_argument("--bf16-full", action="store_true", default=False,
                        help="bfloat16 activations end-to-end (statistics, latent "
                             "and loss math stay f32); overrides --dtype")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="Write a torch.profiler trace of epoch 1 here")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="Recompute activations in the backward pass")
    parser.add_argument("--augment", action="store_true", default=False,
                        help="On-device train-time augmentation (flip/shift/"
                             "brightness; image-only problems)")
    parser.add_argument("--augment-shift", type=int, default=4,
                        help="Max translation in pixels for --augment")
    parser.add_argument("--augment-brightness", type=float, default=0.1,
                        help="Max relative brightness jitter for --augment")
    parser.add_argument("--image-interval", type=int, default=1,
                        help="Log sample/recon image grids every N epochs "
                             "(1 = reference behaviour)")
    parser.add_argument("--ckpt-interval", type=int, default=1,
                        help="Write the 'latest' resume checkpoint every N epochs "
                             "(best-val saves are unaffected)")
    return parser


def _rank_main(argv):
    """One spawned rank of ``--num-devices``: the run directory."""
    return main(argv).log_dir


def main(argv=None):
    """Trains; returns the ``Problem``, or, when ``--num-devices`` spawned
    the ranks, the run directory."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    from mmdyn_tpu_torch.parallel import cli_mesh, launched, spawn_cli

    if args.num_devices > 1 and not launched():
        return spawn_cli(_rank_main, argv, args.num_devices, args.platform)

    from mmdyn_tpu_torch import config

    if args.problem_type not in config.PROBLEM_TYPES:
        raise ValueError(f"Invalid problem type {args.problem_type!r}")
    mesh = cli_mesh(args.num_devices, args.platform)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, mesh):
    from mmdyn_tpu_torch.problems.base import ProblemConfig
    from mmdyn_tpu_torch.train.loop import Problem
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = mesh.device if mesh is not None else device_for_platform(args.platform)
    set_reference_precision()
    cfg = ProblemConfig(
        problem_type=args.problem_type,
        model_name=args.model_name,
        input_type=args.input_type,
        use_pose=args.use_pose,
        conditional=args.conditional,
        mask_loss=args.mask_loss,
        kl_weight=args.kl_weight,
        pose_multiplier=args.pose_multiplier,
        latent_size=args.latent_size,
        annealing_epochs=args.annealing_epochs,
        lr=args.lr,
        optimizer=args.optimizer,
        batchsize=args.batchsize,
        num_epochs=args.num_epochs,
        compute_dtype=("bfloat16_full" if args.bf16_full
                       else "bfloat16" if args.bf16 else args.dtype),
        remat=args.remat,
        augment=args.augment,
        augment_shift=args.augment_shift,
        augment_brightness=args.augment_brightness,
    )
    problem = Problem(cfg, args.dataset_path, save_name=args.save_name,
                      logs_root=args.logs_root, log_dir=args.log_dir, seed=args.seed,
                      device=device, tensorboard=not args.no_tensorboard,
                      strict_parity=not args.no_strict_parity,
                      no_crop=args.no_crop, resume=args.resume,
                      profile_dir=args.profile_dir, image_interval=args.image_interval,
                      ckpt_interval=args.ckpt_interval, vis_pose=args.vis_pose, mesh=mesh)

    # the reference saves the argparse namespace next to the run (main.py:69)
    if problem.chief:
        with open(problem.log_dir / "problem.pkl", "wb") as f:
            pickle.dump(vars(args), f)

    problem.train()
    return problem


if __name__ == "__main__":
    main()
