"""Minimal production serving loop: HTTP endpoints over an InferenceSession
(port of ``mmdyn_tpu/serve/server.py``).

Stdlib-only (http.server); the model runs at a fixed batch size: requests
are padded up to it and truncated on the way out, and both the sample=0 and
sample=1 variants are warmed at that batch in __init__, so the first client
request pays no lazy initialisation. /rollout's step count and /sample's n
are quantized to power-of-two buckets (run at the bucket, truncated to the
request), so the shapes a client can make the device run are bounded.

Endpoints (wire format: .npz bodies — `np.savez` on the client,
`np.load` here; metadata via query string):

    GET  /healthz             -> JSON: model/problem/batch configuration
    POST /predict[?sample=1]  -> npz in  (visual/tactile/pose [, condition])
                                 npz out (predictions + mu/logvar)
    POST /rollout?steps=N     -> npz in (initial states, batch B)
                                 npz out ((N, B, ...) trajectories)
    POST /sample?n=N[&seed=S] -> npz in (empty or {condition})
                                 npz out (N prior-sample decodes)

Images travel as uint8 in both directions (quantized on the device on the
way out: a 4x smaller readback).

The reference has no serving story at all; this is the smallest honest one:
single worker (one card, in-order execution), fixed shapes, zero deps.
/sample?seed=S draws from a generator on the session's device seeded with S.
The device work runs on one long-lived thread of the app, not on the
request threads: torch builds cuDNN's execution plans once per thread.

A session of a group of ranks (``InferenceSession(mesh=)``, more than one
rank) serves as the JAX package's meshed session does, each rank computing
its rows of every batch: rank 0 runs the server, and the other ranks run
``follow``. From the device thread, each predict or rollout first sends
rank 0's call to them as one header (the method, the padded inputs, the
condition, ``sample``, ``uint8_images``, ``steps``) through
``parallel.mesh.broadcast_object``, and every rank then makes the call
together. A request is checked on rank 0 before its header goes out: a rank
that raised between two collectives would leave the others waiting.
/sample runs on rank 0 alone (``sample_prior`` has no collective). The
serving batch must split evenly over the ranks; a rollout's rows are padded
up to a multiple of the group size (the last row repeated) and truncated
back. ``server_close`` sends the ``stop`` header that ends the loops, and
a ``ping`` header goes out every ``KEEPALIVE_S`` seconds, so an idle
server's ranks never wait for the next header as long as the group's
timeout.
"""

from __future__ import annotations

import io
import json
import queue
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from mmdyn_tpu_torch.parallel.mesh import broadcast_object

KEEPALIVE_S = 10.0      # at most this long between two headers to the ranks


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _bucket(n: int) -> int:
    """Next power of two >= n: the shape a request runs at.

    Running /rollout's step count and /sample's n at the bucket and
    truncating bounds the distinct shapes at ~log2(limit) instead of one per
    distinct client value.
    """
    return 1 << max(0, (n - 1).bit_length())


def check_serving_batch(batch_size: int, ranks: int):
    """A group serves a batch only when it splits evenly over the ranks."""
    if batch_size % ranks:
        raise ValueError(f"a serving batch of {batch_size} rows does not split over "
                         f"{ranks} ranks: pass a multiple of {ranks}")


def _call(session, header):
    """The session call a header names (rank 0's and its followers')."""
    kwargs = dict(header["inputs"], condition=header["condition"], sample=header["sample"],
                  uint8_images=header["uint8_images"])
    if header["method"] == "rollout":
        return session.rollout(header["steps"], **kwargs)
    return session.predict(**kwargs)


def follow(session) -> int:
    """The loop of ranks 1.. of a serving group while rank 0 serves
    (module doc): receive each header, make the same session call and drop
    its result, until the ``stop`` header. A call that raises is logged and
    the loop goes on; the group's timeout (``make_mesh(timeout=)``) bounds
    any wait. Returns the number of calls made."""
    calls = 0
    while True:
        header = broadcast_object(session.mesh, None)
        if header["method"] == "stop":
            return calls
        if header["method"] == "ping":
            continue
        calls += 1
        try:
            _call(session, header)
        except Exception:   # rank 0 raised the same, or will time out
            print(f"rank {session.mesh.rank}: {header['method']} failed", file=sys.stderr)
            traceback.print_exc()


class ServingApp:
    """Request -> prediction glue; separable from HTTP for testing.

    ``microbatch_wait_ms > 0`` enables request coalescing: concurrent
    predict requests with the same signature (modalities, conditionality,
    sample flag) merge into one device batch, amortising the dispatch
    round-trip. NOTE: under default batch-statistics BatchNorm, coalescing
    mixes requests into each other's normalisation statistics — enable it
    together with a frozen-BN session (InferenceSession.freeze_bn /
    --calibrate), whose predictions are per-example deterministic.
    """

    def __init__(self, session, batch_size: int = 64,
                 microbatch_wait_ms: float = 0.0):
        self.session = session
        self.batch_size = int(batch_size)
        self.cfg = session.cfg
        self._mesh = session.mesh if session.grouped else None
        if self._mesh is not None:
            check_serving_batch(self.batch_size, self._mesh.size)
        self._stopped = False       # the device thread sent ``stop``
        self._closed = threading.Event()
        self.modalities = (["visual", "tactile"] if self.cfg.cross_modal
                           else [self.cfg.input_type])
        if self.cfg.use_pose:
            self.modalities.append("pose")
        self._lock = threading.Lock()   # one card: serialize compute
        # ... and run it on one long-lived thread: torch keeps cuDNN's
        # execution plans per thread, and a thread's first forward builds
        # them, while the stdlib server answers each request on a new thread
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="mmdyn-device")
        self._requests = 0
        self._batches = 0
        # warm the actual serving path (session.predict) at the padded batch
        # shape, both sample variants, so no client request pays the lazy
        # initialisation (cuDNN handles, kernel loading) inside the lock
        warm = {m: (np.zeros((self.batch_size, 7), np.float32) if m == "pose"
                    else np.zeros((self.batch_size, 64, 64, 3), np.float32))
                for m in self.modalities}
        cond = (np.zeros((self.batch_size, self.cfg.condition_dim),
                         np.float32) if self.cfg.conditional else None)
        self._run_batch(warm, cond, sample=False, n=1)
        if self.cfg.problem_type != "regression":
            self._run_batch(warm, cond, sample=True, n=1)
        self._batches = 0
        self._batcher = (_MicroBatcher(self, microbatch_wait_ms / 1e3)
                         if microbatch_wait_ms > 0 else None)
        if self._mesh is not None:
            threading.Thread(target=self._keepalive, daemon=True,
                             name="mmdyn-keepalive").start()

    # -- helpers ---------------------------------------------------------
    def health(self) -> dict:
        import dataclasses

        return {
            "status": "ok",
            "model": self.cfg.model_name,
            "problem_type": self.cfg.problem_type,
            "modalities": self.modalities,
            "batch_size": self.batch_size,
            "conditional": self.cfg.conditional,
            "requests_served": self._requests,
            "batches_executed": self._batches,
            "microbatching": self._batcher is not None,
            "frozen_bn": self.session.bn_stats is not None,
            "ranks": 1 if self._mesh is None else self._mesh.size,
            "config": dataclasses.asdict(self.cfg),
        }

    def _parse_inputs(self, npz) -> tuple[dict, np.ndarray | None, int]:
        inputs = {}
        n = None
        for m in self.modalities:
            if m not in npz:
                continue
            arr = np.asarray(npz[m])
            want = (7,) if m == "pose" else (64, 64, 3)
            if arr.ndim != 1 + len(want) or arr.shape[1:] != want:
                # validate BEFORE grouping: a malformed request must not
                # poison a coalesced microbatch or reach the device
                raise ValueError(f"{m} must be (B,{','.join(map(str, want))});"
                                 f" got {arr.shape}")
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            else:
                arr = arr.astype(np.float32)
            inputs[m] = arr
            n = arr.shape[0] if n is None else n
            if arr.shape[0] != n:
                raise ValueError("modalities disagree on batch size")
        if not inputs:
            raise ValueError(f"need at least one of {self.modalities}")
        if n == 0:
            raise ValueError("empty batch")
        cond = None
        if "condition" in npz:
            if not self.cfg.conditional:
                raise ValueError("model is not conditional")
            cond = np.asarray(npz["condition"], np.float32)
            if cond.shape[0] != n:
                raise ValueError(f"condition batch {cond.shape[0]} != "
                                 f"input batch {n}")
        return inputs, cond, n

    def _on_device(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on the device thread, its dict of tensors
        read back to numpy there (the readback is the sync)."""
        return self._device.submit(
            lambda: {k: v.cpu().numpy() for k, v in fn(*args, **kwargs).items()}
        ).result()

    def _send(self, header):
        """On the device thread: ``header`` to the other ranks of a group."""
        if self._stopped:
            raise RuntimeError("the serving group has stopped")
        broadcast_object(self._mesh, header)
        self._stopped = header["method"] == "stop"

    def _collective(self, header):
        """The call ``header`` names, made on the device thread by every rank
        (module doc): read back to numpy as ``_on_device`` does."""
        def job():
            if self._mesh is not None:
                self._send(header)
            return {k: v.cpu().numpy() for k, v in _call(self.session, header).items()}

        return self._device.submit(job).result()

    def _keepalive(self):
        while not self._closed.wait(KEEPALIVE_S):
            with self._lock:
                if not self._closed.is_set():
                    self._device.submit(self._send, {"method": "ping"}).result()

    def close(self):
        """End the other ranks' ``follow`` loops (one ``stop`` header) and
        the device thread; later calls do nothing."""
        with self._lock:
            if self._closed.is_set():
                return
            self._closed.set()
            if self._mesh is not None:
                self._device.submit(self._send, {"method": "stop"}).result()
        self._device.shutdown()

    def _pad(self, arr: np.ndarray, to: int) -> np.ndarray:
        n = arr.shape[0]
        if n == to:
            return arr
        return np.concatenate([arr, np.repeat(arr[-1:], to - n, axis=0)])

    def _run_batch(self, inputs, cond, sample, n):
        """Pad to the serving batch, predict, read back, truncate to n."""
        inputs = {m: self._pad(a, self.batch_size) for m, a in inputs.items()}
        if cond is not None:
            cond = self._pad(cond, self.batch_size)
        header = {"method": "predict", "inputs": inputs, "condition": cond,
                  "sample": sample, "uint8_images": self.cfg.problem_type != "regression"}
        with self._lock:
            out = self._collective(header)
            self._batches += 1
        return {k: v[:n] for k, v in out.items()}

    # -- endpoints -------------------------------------------------------
    def predict(self, body: bytes, sample: bool = False) -> bytes:
        npz = np.load(io.BytesIO(body), allow_pickle=False)
        inputs, cond, n = self._parse_inputs(npz)
        if n > self.batch_size:
            raise ValueError(f"batch {n} exceeds serving batch size "
                             f"{self.batch_size}")
        self.session.check_inputs(**inputs, condition=cond)
        if self._batcher is not None:
            out = self._batcher.submit(inputs, cond, sample, n)
        else:
            out = self._run_batch(inputs, cond, sample, n)
        with self._lock:   # counter only; compute lock already released
            self._requests += 1
        return _npz_bytes(out)

    def sample(self, body: bytes, n: int, seed: int = 0) -> bytes:
        cond = None
        if body:
            npz = np.load(io.BytesIO(body), allow_pickle=False)
            if "condition" in npz:
                if not self.cfg.conditional:
                    raise ValueError("model is not conditional")
                cond = np.asarray(npz["condition"], np.float32)
                if cond.shape[0] != n:
                    raise ValueError(f"condition batch {cond.shape[0]} != n={n}")
        if self.cfg.problem_type == "regression":
            raise ValueError("regression models have no latent space")
        if not 0 < n <= max(256, self.batch_size):
            # bound n so clients cannot grow device memory without limit
            raise ValueError(f"n must be in (0, {max(256, self.batch_size)}]")
        # quantize the shape: run at the next power-of-two bucket and return
        # the first n draws (the same draws for every n of a bucket and seed)
        run_n = _bucket(int(n))
        if cond is not None and run_n != n:
            cond = self._pad(cond, run_n)
        with self._lock:
            gen = torch.Generator(self.session.device).manual_seed(int(seed))
            out = self._on_device(self.session.sample_prior, run_n, gen,
                                  condition=cond, uint8_images=True)
            self._requests += 1
            self._batches += 1
        return _npz_bytes({k: v[:n] for k, v in out.items()})

    def rollout(self, body: bytes, steps: int, sample: bool = False) -> bytes:
        npz = np.load(io.BytesIO(body), allow_pickle=False)
        inputs, cond, n = self._parse_inputs(npz)
        if n > self.batch_size:
            raise ValueError(f"rollout batch {n} exceeds serving batch size "
                             f"{self.batch_size}")
        if not 0 < steps <= 1000:
            # bound the loop (and the trajectory held on the device)
            raise ValueError("steps must be in (0, 1000]")
        self.session.check_inputs(**inputs, condition=cond)
        # quantize the step count the same way as /sample: run the rollout
        # at the next bucket and truncate the trajectory
        run_steps = _bucket(int(steps))
        if self._mesh is not None:      # every rank takes equal rows
            rows = -(-n // self._mesh.size) * self._mesh.size
            inputs = {m: self._pad(a, rows) for m, a in inputs.items()}
            cond = None if cond is None else self._pad(cond, rows)
        header = {"method": "rollout", "inputs": inputs, "condition": cond,
                  "sample": sample, "uint8_images": True, "steps": run_steps}
        with self._lock:
            traj = self._collective(header)
            self._requests += 1
        return _npz_bytes({k: v[:steps, :n] for k, v in traj.items()})


class _MicroBatcher:
    """Coalesce concurrent predict requests into one device batch.

    A single worker thread drains the arrival queue into per-signature
    pending lists, then serves the signature whose OLDEST request has
    waited longest (FIFO across signatures — a sustained stream of one
    signature cannot starve another). A group closes when its rows fill
    the serving batch or ``wait_s`` has elapsed since its oldest arrival;
    one padded predict serves the group and each caller gets its row
    slice back.
    """

    def __init__(self, app: "ServingApp", wait_s: float):
        self.app = app
        self.wait_s = wait_s
        self.q = queue.Queue()
        self._pending = {}          # key -> list of request tuples
        threading.Thread(target=self._loop, daemon=True,
                         name="mmdyn-microbatcher").start()

    def submit(self, inputs, cond, sample, n):
        key = (tuple(sorted(inputs)), cond is not None, bool(sample))
        done = threading.Event()
        slot = {}
        self.q.put((key, inputs, cond, n, done, slot, time.monotonic()))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def _drain(self, timeout):
        """Move arrivals into the per-key pending lists; block up to
        ``timeout`` for the first one when nothing is pending."""
        try:
            item = self.q.get(timeout=timeout)
        except queue.Empty:
            return
        self._pending.setdefault(item[0], []).append(item)
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                return
            self._pending.setdefault(item[0], []).append(item)

    def _group(self):
        while not self._pending:
            self._drain(timeout=3600.0)
        # serve the signature with the oldest waiting request
        key = min(self._pending, key=lambda k: self._pending[k][0][6])
        deadline = self._pending[key][0][6] + self.wait_s
        rows = sum(it[3] for it in self._pending[key])
        while rows < self.app.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            self._drain(timeout=timeout)
            rows = sum(it[3] for it in self._pending[key])
        group, rows = [], 0
        stay = []
        for it in self._pending.pop(key):
            if rows + it[3] <= self.app.batch_size:
                group.append(it)
                rows += it[3]
            else:
                stay.append(it)     # overflow: next group, keeps its age
        if stay:
            self._pending[key] = stay
        return group

    def _loop(self):
        while True:
            group = self._group()
            try:
                inputs = {m: np.concatenate([g[1][m] for g in group])
                          for m in group[0][1]}
                cond = (np.concatenate([g[2] for g in group])
                        if group[0][2] is not None else None)
                total = sum(g[3] for g in group)
                out = self.app._run_batch(inputs, cond, group[0][0][2], total)
                off = 0
                for _, _, _, n, done, slot, _ in group:
                    slot["out"] = {k: v[off:off + n] for k, v in out.items()}
                    off += n
                    done.set()
            except Exception as e:   # propagate to every waiter
                for item in group:
                    item[5]["err"] = e
                    item[4].set()


class _Handler(BaseHTTPRequestHandler):
    app: ServingApp = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: dict):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if urlparse(self.path).path == "/healthz":
            self._reply_json(200, self.app.health())
        else:
            self._reply_json(404, {"error": "unknown path"})

    def do_POST(self):
        url = urlparse(self.path)
        try:
            q = parse_qs(url.query)
            sample = q.get("sample", ["0"])[0] == "1"
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self._reply_json(400, {
                    "error": "Content-Length header must be an integer"})
            # bound the in-memory buffer BEFORE reading: the largest honest
            # request is one serving batch of f32 visual+tactile+pose plus
            # npz framing — anything far beyond that is malformed or abusive
            cap = max(1 << 20,
                      4 * self.app.batch_size * (2 * 64 * 64 * 3 + 7) * 2)
            if not 0 <= length <= cap:
                return self._reply_json(400, {
                    "error": f"Content-Length {length} outside [0, {cap}]"})
            body = self.rfile.read(length)
            if url.path == "/predict":
                out = self.app.predict(body, sample=sample)
            elif url.path == "/rollout":
                steps = int(q.get("steps", ["10"])[0])
                out = self.app.rollout(body, steps, sample=sample)
            elif url.path == "/sample":
                out = self.app.sample(body, int(q.get("n", ["16"])[0]),
                                      seed=int(q.get("seed", ["0"])[0]))
            else:
                return self._reply_json(404, {"error": "unknown path"})
        except ValueError as e:
            return self._reply_json(400, {"error": str(e)})
        except Exception as e:   # corrupt npz, device errors, OOM: reply,
            return self._reply_json(500, {  # don't drop the connection
                "error": f"{type(e).__name__}: {e}"})
        self._reply(200, out, "application/x-npz")


class _Server(ThreadingHTTPServer):
    def server_close(self):
        """Close the socket, then the app (a group's ``stop`` header)."""
        super().server_close()
        self.RequestHandlerClass.app.close()


def make_server(session, host: str = "127.0.0.1", port: int = 8471,
                batch_size: int = 64,
                microbatch_wait_ms: float = 0.0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; .serve_forever() to run,
    .server_close() to close. For a session of a group, on rank 0 while the
    other ranks ``follow`` (module doc)."""
    app = ServingApp(session, batch_size=batch_size,
                     microbatch_wait_ms=microbatch_wait_ms)
    handler = type("Handler", (_Handler,), {"app": app})
    return _Server((host, port), handler)
