"""Multi-process data-parallel smoke test of the port (port of
``tools/multihost_smoke.py``).

The loader's row blocks and the data-parallel step are held against a
one-process golden run: the parent trains in one process, then spawns N
ranks that form a gloo group (``parallel.spawn``), each taking its
``BatchLoader`` row block of every global batch through the data-parallel
step (``make_train_step(..., mesh=)``: BatchNorm statistics, noise and
dropout over the global batch, gradients summed across ranks). Every rank's
per-step losses must equal the golden ones within 1e-5 relative.

    python -m mmdyn_tpu_torch.tools.multihost_smoke --spawn 2 [--platform cpu]

The parent prints one JSON line ``{"ok": ..., "process_i_max_rel_gap": ...}``
and exits 0 when every rank agrees. Without ``--spawn`` each process runs as
one rank and prints its losses: launched by hand, as the JAX tool's children
are, each joins the group at ``--coordinator`` (``parallel.make_mesh`` over
``tcp://HOST:PORT``) as rank ``--process-id`` of ``--num-processes``:

    python -m mmdyn_tpu_torch.tools.multihost_smoke --coordinator 127.0.0.1:29500 \
        --num-processes 2 --process-id 0 [--platform cpu]    # and --process-id 1

or, without ``--coordinator``, under ``torchrun``. The model is the
flagship's at a tiny size (cnn-mvae, visuotactile + pose, seq_modeling,
latent 8, global batch 8, 24 sequences, 2 epochs of 3 steps): the point is
the loader, group and collective plumbing. With ``--platform cpu``
the ranks run on the CPU; otherwise rank i runs on card ``i % count``, gloo
carrying its CUDA tensors (so two ranks may share one card), every process
in full float32 (``set_reference_precision``).
"""

import argparse
import json
import sys

import numpy as np

GLOBAL_BATCH = 8
N_SEQ = 24
EPOCHS = 2          # 2 epochs x 3 batches


def make_data():
    """A deterministic corpus (uint8 frames, uniform poses), identical in
    every process."""
    rng = np.random.default_rng(1234)
    img = lambda *s: rng.integers(0, 256, size=s, dtype=np.uint8)  # noqa: E731
    return {"visual": img(N_SEQ, 2, 64, 64, 3), "tactile": img(N_SEQ, 2, 64, 64, 3),
            "pose": rng.uniform(size=(N_SEQ, 2, 7)).astype(np.float32),
            "final_visual": img(N_SEQ, 64, 64, 3), "final_tactile": img(N_SEQ, 64, 64, 3),
            "final_pose": rng.uniform(size=(N_SEQ, 7)).astype(np.float32)}


def _device(platform, rank):
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def run_training(platform, mesh=None):
    """The shared computation: seeded-shuffle loader row blocks -> the
    (data-parallel) train step. Returns the per-step losses."""
    import torch

    from mmdyn_tpu_torch.data.loader import BatchLoader, to_device_batch
    from mmdyn_tpu_torch.models import model_kwargs, setup_model
    from mmdyn_tpu_torch.problems import ProblemConfig, make_optimizer
    from mmdyn_tpu_torch.train import create_train_state, make_train_step
    from mmdyn_tpu_torch.utils.device import set_reference_precision

    # full float32 on the card: torch's default TF32 convolutions would hold
    # the golden run and the ranks, at other batch shapes, to 3 digits only
    set_reference_precision()
    device = mesh.device if mesh is not None else _device(platform, 0)
    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True, latent_size=8,
                        batchsize=GLOBAL_BATCH)
    model = setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device=device,
                        seed=0, **model_kwargs(cfg))
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg, device=device, mesh=mesh)
    generator = torch.Generator(device).manual_seed(0)
    proc = {} if mesh is None else {"process_index": mesh.rank, "process_count": mesh.size}
    losses = []
    for epoch in range(EPOCHS):
        loader = BatchLoader(make_data(), GLOBAL_BATCH, shuffle=True, seed=epoch,
                             frames=1, **proc)
        for host_batch in loader:
            state, metrics = step(state, to_device_batch(host_batch, device), generator, 1.0)
            losses.append(float(metrics["loss"]))
    return losses


def rank_main(platform, coordinator=None, num_processes=None, process_id=None,
              timeout=None):
    """One rank: join the group (the initialised one, or the one at
    ``coordinator``), train, return (rank, losses)."""
    import torch.distributed as dist

    from mmdyn_tpu_torch.parallel import make_mesh

    if coordinator is None:
        world, kw = dist.get_world_size(), {}
    else:
        world = num_processes
        kw = {"init_method": f"tcp://{coordinator}", "rank": process_id,
              "timeout": timeout}
    devices = [_device(platform, r) for r in range(world)]
    mesh = make_mesh(world, devices=devices, backend="gloo", **kw)
    try:
        return mesh.rank, run_training(platform, mesh)
    finally:
        mesh.close()


def parent_main(args):
    from mmdyn_tpu_torch.parallel import spawn

    golden = run_training(args.platform)
    report = {"num_processes": args.spawn, "golden": golden}
    ok = True
    try:
        results = spawn(rank_main, args.spawn, (args.platform,), backend="gloo",
                        timeout=args.timeout)
    except (RuntimeError, TimeoutError) as e:
        report["error"] = str(e).strip().splitlines()[-3:]
        results, ok = [], False
    for rank, losses in results:
        report[f"process_{rank}"] = losses
        rel = max(abs(a - b) / max(abs(b), 1e-9) for a, b in zip(losses, golden))
        report[f"process_{rank}_max_rel_gap"] = rel
        if len(losses) != len(golden) or rel > 1e-5:
            ok = False
    report["ok"] = ok
    print(json.dumps(report))
    return report


def build_parser():
    ap = argparse.ArgumentParser(description="Multi-process data-parallel smoke test")
    ap.add_argument("--spawn", type=int, default=0,
                    help="parent mode: run the golden run, then spawn N ranks")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in the group at --coordinator")
    ap.add_argument("--num-processes", type=int, default=2,
                    help="the number of processes in the group at --coordinator")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT where the processes launched by hand rendezvous")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the spawned ranks may take in all (with "
                         "--coordinator, the bound on each collective)")
    ap.add_argument("--platform", default=None, type=str,
                    help="'cpu' runs the ranks on the CPU; otherwise the CUDA cards")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.spawn:
        return parent_main(args)
    import torch.distributed as dist

    from mmdyn_tpu_torch.parallel import launched

    if args.coordinator is not None:
        if args.process_id is None:
            raise SystemExit("--coordinator needs --process-id")
        rank, losses = rank_main(args.platform, args.coordinator, args.num_processes,
                                 args.process_id, args.timeout)
    else:
        if not launched():
            raise SystemExit("without --spawn this runs as one rank at --coordinator "
                             "or under torchrun")
        if not dist.is_initialized():
            dist.init_process_group("gloo")
        rank, losses = rank_main(args.platform)
    print(json.dumps({"process": rank, "losses": losses}))
    return {"process": rank, "losses": losses}


if __name__ == "__main__":
    sys.exit(0 if main().get("ok", True) else 1)
