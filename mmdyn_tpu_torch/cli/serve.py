"""Serve a trained run over HTTP (stdlib-only serving loop; port of
``mmdyn_tpu/cli/serve.py``). It serves from the card; ``--platform cpu``
selects the CPU.

    python -m mmdyn_tpu_torch.cli.serve --run logs/run_.../ --port 8471

Endpoints (.npz request/response bodies; see serve/server.py):
    GET  /healthz
    POST /predict[?sample=1]
    POST /rollout?steps=N
    POST /sample?n=N[&seed=S]

Client example:

    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, visual=frames)   # (B, 64, 64, 3)
    req = urllib.request.Request("http://HOST:8471/predict",
                                 data=buf.getvalue(), method="POST")
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
    resting = out["visual"]                            # uint8 predictions
"""

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="HTTP serving for a trained run")
    p.add_argument("--run", default=None, type=str,
                   help="run directory (or use --torch-ckpt)")
    p.add_argument("--torch-ckpt", default=None, type=str,
                   help="serve a reference-trained torch .ckpt directly")
    p.add_argument("--model-name", default="cnn-mvae", type=str)
    p.add_argument("--input-type", default="visuotactile", type=str)
    p.add_argument("--problem-type", default="seq_modeling", type=str)
    p.add_argument("--conditional", action="store_true", default=False)
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8471, type=int)
    p.add_argument("--batchsize", default=64, type=int,
                   help="fixed serving batch (requests pad up to it)")
    p.add_argument("--parity", action="store_true", default=False)
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--num-devices", default=0, type=int,
                   help="0 or 1 = one card; several cards are not ported yet")
    p.add_argument("--microbatch-wait-ms", default=0.0, type=float,
                   help="coalesce concurrent predict requests for up to this "
                        "long into one device batch (use with --calibrate: "
                        "batch-stat BN would mix requests' statistics)")
    p.add_argument("--calibrate", default=None, type=str,
                   help="sequence dump dir; freezes BatchNorm statistics on "
                        "these frames (per-example deterministic serving)")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' serves on the CPU; otherwise the CUDA card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mmdyn_tpu_torch.cli.infer import _load_frames, check_source, load_session
    from mmdyn_tpu_torch.serve.server import make_server

    check_source(args)
    if args.num_devices > 1:
        raise NotImplementedError(
            "serving on several cards is not ported yet (ROADMAP.md, queue 1 item 5): "
            "rank 0 would have to broadcast every coalesced batch to the other ranks")
    session = load_session(args)
    if args.calibrate:
        mods = (("visual", "tactile") if session.cfg.cross_modal
                else (session.cfg.input_type,))
        frames = _load_frames(args.calibrate, mods)
        session = session.freeze_bn(**frames)
        print(f"froze BatchNorm statistics on "
              f"{len(next(iter(frames.values())))} calibration frames")
    if args.microbatch_wait_ms > 0 and session.bn_stats is None:
        print("WARNING: micro-batching with batch-statistics BatchNorm mixes "
              "concurrent requests' normalisation statistics; use "
              "--calibrate for per-example-deterministic serving")
    server = make_server(session, host=args.host, port=args.port,
                         batch_size=args.batchsize,
                         microbatch_wait_ms=args.microbatch_wait_ms)
    print(f"serving {args.run or args.torch_ckpt} on "
          f"http://{args.host}:{server.server_port} "
          f"(batch {args.batchsize}, model {session.cfg.model_name})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
