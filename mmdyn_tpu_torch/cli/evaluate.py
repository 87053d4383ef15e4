"""Offline evaluation of a trained run (port of ``mmdyn_tpu/cli/evaluate.py``):
test-set metrics, reconstruction grids and prior-sample panels in the run's
``plot/`` directory. The grids are PNGs written with Pillow.

    python -m mmdyn_tpu_torch.cli.evaluate --run logs/run_.../ --dataset-path ds
"""

import argparse
import json
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate a trained run")
    p.add_argument("--run", required=True, type=str,
                   help="run directory (contains checkpoint/ and problem.pkl)")
    p.add_argument("--dataset-path", default=None, type=str,
                   help="dataset to evaluate on (default: the training one)")
    p.add_argument("--batchsize", default=None, type=int)
    p.add_argument("--n-samples", default=50, type=int)
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' evaluates on the CPU; otherwise the CUDA card")
    p.add_argument("--seed", default=0, type=int)
    return p


def _save_grid(path, images, nrow=8):
    """Write (N, H, W, 3) float images in [0, 1] as one PNG panel."""
    import numpy as np

    from mmdyn_tpu_torch.train.metrics import make_grid

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing the evaluation grids needs Pillow (PIL)") from e
    grid = make_grid(np.clip(np.asarray(images), 0, 1), nrow=nrow)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from mmdyn_tpu_torch.train.loop import Problem, stream_seed
    from mmdyn_tpu_torch.train.steps import make_sample_fn
    from mmdyn_tpu_torch.utils.device import (cudnn_deterministic, device_for_platform,
                                              set_reference_precision)
    from mmdyn_tpu_torch.utils.runs import config_from_args, load_run_args, trained_policy

    device = device_for_platform(args.platform)
    set_reference_precision()
    run_dir = Path(args.run)
    saved = load_run_args(run_dir)
    cfg = config_from_args(saved, trained_policy(run_dir), batchsize=args.batchsize)
    dataset_path = args.dataset_path or saved["dataset_path"]

    problem = Problem(cfg, dataset_path, log_dir=str(run_dir), seed=args.seed,
                      device=device, tensorboard=False, resume=True,
                      no_crop=bool(saved.get("no_crop", False)))
    if problem._start_epoch == 0:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}")

    # --- test metrics --------------------------------------------------------
    val_loss, aux = problem._test_epoch(epoch=0, kl_weight=1.0)
    metrics = {"test_loss_total": val_loss,
               "test_loss_per_batch": val_loss / max(len(problem.test_loader), 1),
               "n_test_batches": len(problem.test_loader),
               "epoch": problem._start_epoch - 1}
    for k, v in problem._logger_dict.items():
        if v:
            metrics[k.replace("/", "_")] = float(v[-1])
    plot_dir = problem.plot_dir
    with open(plot_dir / "eval_metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)

    # --- reconstruction grids --------------------------------------------------
    if aux is not None and "recon_x" in aux:
        recon = aux["recon_x"]
        named = recon.items() if isinstance(recon, dict) else [(None, recon)]
        for k, v in named:
            if v.dim() == 4:
                _save_grid(plot_dir / ("recon.png" if k is None else f"recon_{k}.png"),
                           torch.sigmoid(v[:64].float()).cpu().numpy())

    # --- prior samples ---------------------------------------------------------
    sample_fn = make_sample_fn(problem.cfg, n=args.n_samples, device=device)
    if sample_fn is not None:
        sample_fn = cudnn_deterministic(sample_fn, device)
        cond = None
        if cfg.conditional:
            cond = torch.rand((args.n_samples, problem.cfg.condition_dim),
                              generator=torch.Generator(device).manual_seed(
                                  stream_seed(args.seed, 1)), device=device)
        gen = torch.Generator(device).manual_seed(stream_seed(args.seed, 0))
        for k, v in sample_fn(problem.state.model, gen, cond).items():
            if v.dim() == 4:
                _save_grid(plot_dir / f"samples_{k}.png", v.float().cpu().numpy())

    print(json.dumps(metrics))
    print(f"wrote evaluation artifacts to {plot_dir}")
    return metrics


if __name__ == "__main__":
    main()
