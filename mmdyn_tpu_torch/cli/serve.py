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

``--num-devices N`` > 1 spawns N ranks, one per card (or CPU processes with
``--platform cpu``), as ``cli/infer.py`` does, or joins a group launched by
``torchrun``: every rank loads the session (``--calibrate`` calibrates on
every rank, the statistics over all of them); rank 0 serves, and the other
ranks compute their rows of each batch it sends them (``serve/server.py``).
The serving batch must be a multiple of N. SIGINT or SIGTERM (to the
spawning process, which passes it on, or to rank 0) stops the server, then
every rank; each leaves the group and exits 0.
"""

import argparse
import signal
import sys
import threading


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
                   help="data-parallel over this many devices, one process each "
                        "(0 = one device, no process group)")
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


def _on_signals(handler):
    """SIGINT's and SIGTERM's handlers set to ``handler`` (in the main
    thread; elsewhere none is set); returns the previous ones."""
    if threading.current_thread() is not threading.main_thread():
        return {}
    return {sig: signal.signal(sig, handler) for sig in (signal.SIGINT, signal.SIGTERM)}


def _interrupt(signum, frame):
    """SIGINT and SIGTERM end ``serve_forever``, once: a second signal
    during the shutdown is ignored."""
    _on_signals(signal.SIG_IGN)
    raise KeyboardInterrupt


def main(argv=None):
    """Serves until interrupted; returns rank 0's ``/healthz`` record (with
    ``--num-devices`` > 1 from the spawning process too)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    from mmdyn_tpu_torch.cli.infer import check_source
    from mmdyn_tpu_torch.parallel import cli_mesh, launched, spawn_cli

    check_source(args)
    if args.num_devices > 1 and not launched():
        return spawn_cli(main, argv, args.num_devices, args.platform)
    mesh = cli_mesh(args.num_devices, args.platform)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _serve(args, mesh):
    from mmdyn_tpu_torch.cli.infer import _load_frames, load_session
    from mmdyn_tpu_torch.serve.server import check_serving_batch, follow, make_server

    if mesh is not None:    # on every rank, before any waits on another
        check_serving_batch(args.batchsize, mesh.size)
    session = load_session(args, mesh)
    if args.calibrate:
        mods = (("visual", "tactile") if session.cfg.cross_modal
                else (session.cfg.input_type,))
        frames = _load_frames(args.calibrate, mods)
        session = session.freeze_bn(**frames)
        if mesh is None or mesh.is_chief:
            print(f"froze BatchNorm statistics on "
                  f"{len(next(iter(frames.values())))} calibration frames")
    if mesh is not None and not mesh.is_chief:
        previous = _on_signals(signal.SIG_IGN)    # the stop comes from rank 0
        try:
            follow(session)
        finally:
            _restore(previous)
        return None
    if args.microbatch_wait_ms > 0 and session.bn_stats is None:
        print("WARNING: micro-batching with batch-statistics BatchNorm mixes "
              "concurrent requests' normalisation statistics; use "
              "--calibrate for per-example-deterministic serving")
    server = make_server(session, host=args.host, port=args.port,
                         batch_size=args.batchsize,
                         microbatch_wait_ms=args.microbatch_wait_ms)
    ranks = "" if mesh is None else f", {mesh.size} ranks"
    print(f"serving {args.run or args.torch_ckpt} on "
          f"http://{args.host}:{server.server_port} "
          f"(batch {args.batchsize}, model {session.cfg.model_name}{ranks})", flush=True)
    previous = _on_signals(_interrupt)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        _restore(previous)
    return server.RequestHandlerClass.app.health()


def _restore(handlers):
    for sig, handler in handlers.items():
        signal.signal(sig, handler)


if __name__ == "__main__":
    main()
