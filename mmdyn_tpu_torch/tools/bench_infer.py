"""Serving latency / throughput benchmark for a trained run or a fresh
flagship model (port of ``tools/bench_infer.py``).

Measures the session's fixed-batch predictor (``InferenceSession.
aot_predict``: a CUDA graph on the card) across batch sizes:

* round-trip latency: a call on device-resident inputs plus the readback of
  every prediction to the host, what one serving request experiences;
* pipelined: ``--iters`` calls, then one ``torch.cuda.synchronize()``: the
  device runs the launches in order, so this bounds all of them with one
  sync, and the host's launch cost hides behind the device's work;
* rollout: closed-loop dynamics steps/s at batch 1.

    python -m mmdyn_tpu_torch.tools.bench_infer [--run logs/run_...] \
        [--batch-sizes 1,8,64,256] [--platform cpu]
    (no --run: a randomly initialised flagship cnn-mvae + pose)

Prints one JSON line per configuration; ``main`` returns the rows.
"""

import argparse
import json
import statistics
import time


def build_parser():
    p = argparse.ArgumentParser(description="Serving latency benchmark")
    p.add_argument("--run", default=None, type=str,
                   help="run dir (default: fresh-init flagship model)")
    p.add_argument("--batch-sizes", default="1,8,64,256", type=str)
    p.add_argument("--iters", default=30, type=int)
    p.add_argument("--warmup", default=3, type=int)
    p.add_argument("--rollout", default=50, type=int,
                   help="rollout horizon for the rollout benchmark (0 = skip)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "bfloat16_full"],
                   help="serving compute dtype (parameters stay float32)")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' runs on the CPU; otherwise the CUDA card")
    return p


def fresh_session(dtype="float32", device=None):
    """The flagship configuration (cnn-mvae, visuotactile + pose, latent 256)
    with random weights, torch's default init from a CPU generator seeded
    with 0, on ``device`` (the card unless told otherwise)."""
    from mmdyn_tpu_torch.models import model_kwargs, setup_model
    from mmdyn_tpu_torch.problems.base import ProblemConfig
    from mmdyn_tpu_torch.serve import InferenceSession

    cfg = ProblemConfig(problem_type="seq_modeling", model_name="cnn-mvae",
                        input_type="visuotactile", use_pose=True,
                        compute_dtype=dtype)
    model = setup_model(cfg.model_name, cross_modal=True, device="cpu", seed=0,
                        **model_kwargs(cfg))
    return InferenceSession(cfg, model.state_dict(), device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from mmdyn_tpu_torch.serve import InferenceSession
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = device_for_platform(args.platform)
    set_reference_precision()
    session = (InferenceSession.from_run(args.run, compute_dtype=args.dtype,
                                         device=device)
               if args.run else fresh_session(args.dtype, device=device))
    cfg = session.cfg
    modalities = ["visual", "tactile"] if cfg.cross_modal else [cfg.input_type]
    if cfg.use_pose:
        modalities.append("pose")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def measure(predictor, inputs):
        run = lambda: predictor(inputs)  # noqa: E731
        for _ in range(args.warmup):
            run()
        sync()
        lat = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            readback = [v.cpu() for v in run().values()]   # every prediction
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        p50 = statistics.median(lat)
        p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]

        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        sync()                      # in-order execution: syncs all iters
        pipelined = (time.perf_counter() - t0) / args.iters
        return p50, p95, pipelined

    rows = []
    for bs in [int(b) for b in args.batch_sizes.split(",")]:
        inputs = {m: torch.rand((bs, 7) if m == "pose" else (bs, 64, 64, 3),
                                generator=torch.Generator(device).manual_seed(i),
                                device=device)
                  for i, m in enumerate(modalities)}
        row = {"metric": "serving latency", "batch": bs}
        for tag, u8 in (("f32", False), ("uint8", True)):
            predictor = session.aot_predict(bs, tuple(modalities), uint8_images=u8)
            p50, p95, pipelined = measure(predictor, inputs)
            row[f"p50_ms_{tag}"] = round(p50, 3)
            row[f"p95_ms_{tag}"] = round(p95, 3)
            if u8:
                row["pipelined_ms"] = round(pipelined * 1e3, 3)
                row["frames_per_s"] = round(bs / pipelined, 1)
        print(json.dumps(row))
        rows.append(row)

    if args.rollout and cfg.problem_type != "regression":
        init = {m: v[:1] for m, v in inputs.items()}
        traj = session.rollout(args.rollout, **init)   # warm-up
        float(traj["mu"][-1, 0, 0])
        t0 = time.perf_counter()
        for _ in range(5):
            traj = session.rollout(args.rollout, **init)
            float(traj["mu"][-1, 0, 0])                 # the readback syncs
        dt = (time.perf_counter() - t0) / 5
        row = {"metric": "rollout", "horizon": args.rollout, "batch": 1,
               "total_ms": round(dt * 1e3, 3),
               "steps_per_s": round(args.rollout / dt, 1)}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
