"""Data parallelism over processes (port of ``mmdyn_tpu/parallel/mesh.py``).

The JAX package scales by SPMD over a device mesh: the jitted step computes
what the one-device step computes on the global batch, with XLA inserting
the gradient ``psum`` and reducing BatchNorm over the global batch. Here one
process drives one device, the processes form a ``torch.distributed`` group,
and the same result is reached by hand:

* each rank takes its contiguous row block of every global batch
  (``shard_batch``; ``BatchLoader``'s process blocks);
* parameters start equal (``replicate`` broadcasts rank 0's) and stay
  equal: the gradients are summed across ranks by one flat all-reduce after
  the backward (``all_reduce_grads``), and every loss is normalised by the
  global batch (``global_rows``);
* inside ``sharded(mesh)`` the model's cross-row operations are global.
  Train-mode BatchNorm takes each statistic over every rank's rows
  (``var_mean``, differentiable through ``all_reduce_sum``). Every random
  draw is taken at the global shape and each rank keeps its rows
  (``global_draw``), so every rank's generator stays in step with the one
  process's. The dyn pose targets roll across rank boundaries
  (``roll_rows``). At one rank all three are the one-process code.

The device collectives are ``all_reduce`` and ``broadcast`` only, at every
group size (a one-rank group on the card still goes through NCCL): gloo
carries those two on CUDA tensors, which lets two ranks share one card, as
NCCL does not. A gather is an all-reduce of a zero-filled global buffer.
Host values (the stop flag, the run's name, barriers) go through a gloo
group on CPU tensors, so reading them never waits for the device.

Processes: ``spawn`` starts N ranks in fresh processes around a file
rendezvous; processes launched by hand give ``make_mesh`` a ``tcp://``
address, their count and their rank; under ``torchrun`` (``WORLD_SIZE``
set) ``make_mesh`` joins the group from the environment; without any of
these, a one-rank group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import multiprocessing
import os
import pickle
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_ACTIVE = contextvars.ContextVar("mmdyn_sharded_mesh", default=None)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One process's place in the data-parallel group.

    ``group`` carries the collectives on ``device``'s tensors; ``host_group``
    is a gloo group for CPU tensors (the same group when ``group`` is gloo).
    ``shape`` is the ``mesh_shape`` asked for: a flat group of
    ``prod(shape)`` ranks in row-major order, as the JAX package's
    multi-axis meshes stay pure data parallelism. ``collectives`` counts the
    device collectives this process has issued."""

    rank: int
    size: int
    device: torch.device
    group: object
    host_group: object
    shape: tuple
    owns_group: bool = False
    collectives: int = 0

    @property
    def is_chief(self) -> bool:
        """Rank 0: the one that writes files and logs."""
        return self.rank == 0

    def close(self):
        """Destroy the process group if ``make_mesh`` created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def _rank_device(devices, rank, world):
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n "
                               "to run the ranks on the CPU")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices given for {world} ranks")
    device = torch.device(devices[rank])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              mesh_shape: Optional[Sequence[int]] = None, backend: Optional[str] = None,
              timeout: Optional[float] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None) -> Mesh:
    """This process's ``Mesh``: rank ``r`` of the group drives ``devices[r]``
    (by default ``cuda:LOCAL_RANK``).

    The group is the one already initialised (by ``spawn``), else, with
    ``init_method`` (``tcp://HOST:PORT``), the group of ``num_devices``
    processes that rendezvous there, this one at ``rank`` (launched by hand,
    as the JAX package's ``jax.distributed.initialize`` is given its
    coordinator); else the one ``torchrun``'s environment names, else a
    one-rank group of this process.
    ``num_devices`` and ``mesh_shape``, when given, must match its size.
    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU; a
    backend other than the initialised group's gets a group of its own over
    the same ranks. ``timeout`` (seconds) bounds every collective of a group
    made here."""
    if mesh_shape is not None:
        n = math.prod(mesh_shape)
        if num_devices is not None and num_devices != n:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs {n} ranks, "
                             f"num_devices={num_devices}")
        num_devices = n
    owns = not dist.is_initialized()
    if owns and init_method is not None:
        if num_devices is None or rank is None or not 0 <= rank < num_devices:
            raise ValueError(f"init_method {init_method!r} needs num_devices and a rank "
                             f"in [0, num_devices): {num_devices}, {rank}")
        world = num_devices
    elif owns:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"a mesh of {num_devices} ranks needs {num_devices} processes, one per "
            f"device, but this process group has {world}: launch them with "
            f"torchrun, parallel.spawn or the CLIs' --num-devices")
    device = _rank_device(devices, rank, world)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world, **kw)
        elif "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    group = (dist.group.WORLD if dist.get_backend() == backend
             else dist.new_group(backend=backend, **kw))
    host = group if backend == "gloo" else dist.new_group(backend="gloo", **kw)
    return Mesh(rank, world, device, group, host, tuple(mesh_shape or (world,)), owns)


# ----------------------------------------------------------------------
# collectives

def _all_reduce(mesh: Mesh, t, op=dist.ReduceOp.SUM):
    mesh.collectives += 1
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


class _SumAcrossRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks; its backward sums the incoming
    gradient over the ranks, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(ctx.mesh, grad.clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x, mesh: Mesh):
    """Differentiable sum of ``x`` across the ranks."""
    return _SumAcrossRanks.apply(x, mesh)


def var_mean(x, dim, mesh: Mesh, keepdim=True):
    """The biased variance and the mean of ``x`` over ``dim`` and over every
    rank's ``x``, in two passes: the summed sum gives the mean, then the
    summed squared deviations the variance, so the result equals the one
    process's ``torch.var_mean`` up to the order of the sums. Both
    reductions carry gradients."""
    count = math.prod(x.shape[d] for d in dim) * mesh.size
    mean = all_reduce_sum(x.sum(dim, keepdim=True), mesh) / count
    var = all_reduce_sum(torch.square(x - mean).sum(dim, keepdim=True), mesh) / count
    if not keepdim:
        var, mean = var.squeeze(dim), mean.squeeze(dim)
    return var, mean


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params):
    """Sum every parameter's gradient across the ranks: one flat all-reduce
    of all of them, copied back in place."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def reduce_metrics(mesh: Mesh, metrics: dict) -> dict:
    """Scalar metrics of every rank's rows -> the global batch's, in one
    all-reduce: ``loss`` summed (each rank's is its part of the global
    batch's loss), the others (means over equal row blocks) averaged."""
    keys = list(metrics)
    vals = _all_reduce(mesh, torch.stack([metrics[k].detach().float() for k in keys]))
    return {k: v if k == "loss" else v / mesh.size for k, v in zip(keys, vals.unbind())}


def gather_rows(mesh: Mesh, x, n: Optional[int] = None):
    """On every rank, the first ``n`` rows (all by default) of the global
    batch whose row blocks the ranks hold as ``x``: an all-reduce of a
    zero-filled buffer, floating point summed in float32 (exact: one rank
    writes each row)."""
    b = x.shape[0]
    total = b * mesh.size
    n = total if n is None else min(n, total)
    dtype = torch.float32 if x.is_floating_point() else x.dtype
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=dtype, device=x.device)
    lo = mesh.rank * b
    if lo < n:
        out[lo:min(lo + b, n)] = x[:n - lo]
    return _all_reduce(mesh, out).to(x.dtype)


@torch.no_grad()
def replicate(mesh: Mesh, obj):
    """Broadcast rank 0's values of a module's parameters and buffers (or of
    a sequence of tensors) to every rank, in place; one broadcast per
    dtype. Returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = list(obj)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        same = by_dtype[dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        mesh.collectives += 1
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return obj


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous row block of ``batch`` (an array or tensor, or
    a dict of them), as ``BatchLoader``'s process blocks; the rows must
    split evenly."""
    def block(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} rows does not split evenly over "
                             f"{mesh.size} ranks")
        b = n // mesh.size
        return x[mesh.rank * b:(mesh.rank + 1) * b]

    if isinstance(batch, dict):
        return {k: None if v is None else block(v) for k, v in batch.items()}
    return block(batch)


def agree(mesh: Mesh, flag: bool) -> bool:
    """True on every rank if ``flag`` is true on any (a host all-reduce)."""
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


def barrier(mesh: Mesh):
    dist.barrier(group=mesh.host_group)


# ----------------------------------------------------------------------
# the global batch inside a step

@contextlib.contextmanager
def sharded(mesh: Optional[Mesh]):
    """Inside the block the model's cross-row operations span ``mesh``'s
    ranks (module doc); ``None`` leaves them local. Scoped to the calling
    thread's context."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The enclosing ``sharded`` block's mesh when it spans more than one
    rank, else None."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.size > 1 else None


def global_rows(n: int) -> int:
    """The global batch of a rank's ``n`` rows."""
    mesh = active_mesh()
    return n if mesh is None else n * mesh.size


def global_draw(draw, shape, dim=0):
    """``draw(shape)`` with ``shape[dim]`` this rank's rows: drawn at the
    global shape, this rank's block kept, so the draw equals the one
    process's rows and every rank's generator advances alike."""
    mesh = active_mesh()
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    n = shape[dim]
    full = shape[:dim] + (n * mesh.size,) + shape[dim + 1:]
    return draw(full).narrow(dim, mesh.rank * n, n).contiguous()


def roll_rows(x):
    """``torch.roll(x, -1, 0)`` of the global batch: a rank's last row takes
    the next rank's first (the last rank's, rank 0's)."""
    rolled = torch.roll(x, -1, 0)
    mesh = active_mesh()
    if mesh is None:
        return rolled
    heads = torch.zeros((mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    heads[mesh.rank] = x[0]
    heads = _all_reduce(mesh, heads)
    return torch.cat([rolled[:-1], heads[(mesh.rank + 1) % mesh.size][None]])


# ----------------------------------------------------------------------
# processes

def _rank_main(fn, args, rank, nprocs, backend, tmp, timeout):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=Path(tmp, "rendezvous").as_uri(),
                            rank=rank, world_size=nprocs, **kw)
    try:
        result = fn(*args)
    except BaseException:
        Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    with open(Path(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


SIGNAL_GRACE_S = 60.0   # the ranks' time to end after a signal passed on


def _wait(procs, deadline, tmp, signalled):
    while True:
        codes = [p.exitcode for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            errs = [Path(tmp, f"rank{r}.err") for r in range(len(procs))]
            detail = "\n".join(f"--- rank {r} ---\n{e.read_text()}"
                               for r, e in enumerate(errs) if e.exists())
            raise RuntimeError(f"rank {failed[0]} exited with code {codes[failed[0]]}"
                               f"\n{detail}")
        if all(c == 0 for c in codes):
            return
        running = [r for r, c in enumerate(codes) if c is None]
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"ranks {running} still running at the time limit")
        if signalled and time.monotonic() > signalled[0] + SIGNAL_GRACE_S:
            raise TimeoutError(f"ranks {running} still running {SIGNAL_GRACE_S:g} s "
                               f"after signal {signalled[1]} was passed on")
        procs[codes.index(None)].join(0.05)


@contextlib.contextmanager
def _passing_signals(procs, signalled):
    """Inside the block SIGINT and SIGTERM to this process go on to every
    rank still running (which ends its work as it would end it alone: the
    training loop's checkpointed stop, the server's shutdown), and
    ``signalled`` records the first: (time, signal). Only the main thread
    can set handlers; elsewhere nothing is passed on."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def pass_on(signum, frame):
        if not signalled:
            signalled.extend((time.monotonic(), signal.Signals(signum).name))
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    previous = {sig: signal.signal(sig, pass_on) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def spawn(fn, nprocs: int, args=(), backend: str = "gloo", timeout: Optional[float] = None):
    """Run ``fn(*args)`` in ``nprocs`` fresh processes that form one process
    group (rank i in process i) and return their results in rank order.

    The group is initialised before ``fn`` runs, with ``backend``, through
    a file in a temporary directory (no TCP port to race for); ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` are set as ``torchrun`` sets them, and
    ``make_mesh`` joins the group. ``fn`` must be importable (a module-level
    function) and return a picklable value. The ranks share the host's
    cores: each takes its share of torch's threads. If a rank fails, the
    others are stopped and the failure's traceback raised; ``timeout``
    (seconds) bounds the whole run and every collective. A SIGINT or
    SIGTERM to this process while the ranks run is passed on to them; ranks
    that have not ended ``SIGNAL_GRACE_S`` seconds later are stopped, and a
    ``TimeoutError`` raised."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mmdyn_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                             args=(fn, args, rank, nprocs, backend, tmp, timeout))
                 for rank in range(nprocs)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        signalled = []
        try:
            with _passing_signals(procs, signalled):
                _wait(procs, deadline, tmp, signalled)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for rank in range(nprocs):
            with open(Path(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def launched() -> bool:
    """Whether this process is one rank of a launched group: initialised by
    ``spawn``, or under ``torchrun`` (``WORLD_SIZE`` set)."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def cli_mesh(num_devices: int, platform) -> Optional[Mesh]:
    """The mesh a CLI's ``--num-devices`` and ``--platform`` give this
    process: the launched group's (``num_devices`` 0 or its size), a
    one-rank group for 1, else None (no group)."""
    if launched():
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ["WORLD_SIZE"]))
        if num_devices not in (0, world):
            raise ValueError(f"--num-devices {num_devices} in a launched group of "
                             f"{world} processes: pass 0 or {world}")
        n = world
    elif num_devices == 1:
        n = 1
    else:
        return None
    return make_mesh(n, devices=["cpu"] * n if platform == "cpu" else None)


def spawn_cli(fn, argv, num_devices: int, platform):
    """A CLI's ``--num-devices N`` > 1 outside a launched group: ``fn(argv)``
    in N spawned ranks, one per device (NCCL on ``cuda:0``..``cuda:N-1``;
    gloo CPU processes with ``--platform cpu``); returns rank 0's result.
    Asking for more cards than are visible is an error naming both counts:
    there is no fallback to fewer."""
    if platform != "cpu":
        count = torch.cuda.device_count()
        if num_devices > count:
            raise RuntimeError(f"--num-devices {num_devices} asks for {num_devices} CUDA "
                               f"devices, but {count} {'is' if count == 1 else 'are'} "
                               f"visible")
    return spawn(fn, num_devices, (argv,), backend="gloo" if platform == "cpu" else "nccl")[0]
