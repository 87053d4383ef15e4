"""HTTP serving capacity benchmark: concurrent clients vs micro-batching
(port of ``tools/bench_http.py``).

Starts the stdlib serving loop in process (``serve/server.py``) on an
OS-assigned port, drives POST /predict with concurrent batch-1 clients, and
reports requests/s and client-side latency percentiles: once without
request coalescing and once with ``--wait-ms``. Runs a run dir (``--run``)
or a fresh flagship model (``bench_infer.fresh_session``).

    python -m mmdyn_tpu_torch.tools.bench_http [--run logs/run_...] \
        [--clients 8] [--requests 40] [--batchsize 16] [--wait-ms 5] \
        [--platform cpu]

Prints one JSON line per configuration; ``main`` returns the rows.
"""

import argparse
import io
import json
import statistics
import threading
import time
import urllib.request


def build_parser():
    p = argparse.ArgumentParser(description="HTTP serving load benchmark")
    p.add_argument("--run", default=None, type=str)
    p.add_argument("--clients", default=8, type=int)
    p.add_argument("--requests", default=40, type=int,
                   help="requests per client")
    p.add_argument("--batchsize", default=16, type=int,
                   help="server-side batch (requests are batch-1)")
    p.add_argument("--wait-ms", default=5.0, type=float,
                   help="micro-batch gather window for the coalescing pass")
    p.add_argument("--calibrate-frames", default=8, type=int,
                   help="random calibration batch for frozen BN (0 = batch BN)")
    p.add_argument("--platform", default=None, type=str,
                   help="'cpu' serves on the CPU; otherwise the CUDA card")
    return p


def _drive(port, clients, requests, payload):
    lat = []
    lock = threading.Lock()
    errs = []

    def client():
        for _ in range(requests):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=payload,
                method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    resp.read()
            except Exception as e:   # pragma: no cover - diagnostics only
                with lock:
                    errs.append(str(e))
                return
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise RuntimeError(f"{len(errs)} client errors, first: {errs[0]}")
    lat.sort()
    return {
        "requests": len(lat),
        "wall_s": round(wall, 3),
        "req_per_s": round(len(lat) / wall, 1),
        "p50_ms": round(statistics.median(lat), 1),
        "p95_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 1),
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from mmdyn_tpu_torch.serve import InferenceSession
    from mmdyn_tpu_torch.serve.server import make_server
    from mmdyn_tpu_torch.tools.bench_infer import fresh_session
    from mmdyn_tpu_torch.utils.device import device_for_platform, set_reference_precision

    device = device_for_platform(args.platform)
    set_reference_precision()
    session = (InferenceSession.from_run(args.run, device=device) if args.run
               else fresh_session(device=device))
    if args.calibrate_frames:
        # frozen BN: coalescing is then semantically clean (docs/PARITY.md)
        n = args.calibrate_frames
        rng = np.random.default_rng(0)
        cal = {"visual": rng.random((n, 64, 64, 3), dtype=np.float32),
               "tactile": rng.random((n, 64, 64, 3), dtype=np.float32)}
        if session.cfg.use_pose:
            cal["pose"] = rng.random((n, 7), dtype=np.float32)
        session = session.freeze_bn(**cal)

    mods = (["visual", "tactile"] if session.cfg.cross_modal
            else [session.cfg.input_type])
    arrays = {m: np.random.default_rng(1).random((1, 64, 64, 3),
                                                 dtype=np.float32)
              for m in mods}
    if session.cfg.use_pose:
        arrays["pose"] = np.zeros((1, 7), np.float32)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()

    rows = []
    for wait_ms in (0.0, args.wait_ms):
        server = make_server(session, port=0, batch_size=args.batchsize,
                             microbatch_wait_ms=wait_ms)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            _drive(server.server_port, 2, 2, payload)   # warm the serving path
            stats = _drive(server.server_port, args.clients, args.requests,
                           payload)
            app = server.RequestHandlerClass.app
            stats.update({
                "metric": "http serving", "clients": args.clients,
                "microbatch_wait_ms": wait_ms,
                "device_batches": app._batches,
                "coalescing": round(app._requests / max(app._batches, 1), 2),
            })
            print(json.dumps(stats))
            rows.append(stats)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    return rows


if __name__ == "__main__":
    main()
