"""Training end to end: run directory, corpus, model, optimizer, epoch loop,
checkpoints and resume (port of ``mmdyn_tpu/train/loop.py``; reference
mmdyn/pytorch/problems/problems.py:23-216).

The loop keeps the JAX package's behaviour: batches prefetched to the
device, losses held there and read once per epoch, best-validation and
rolling checkpoints, a SIGTERM snapshot at the next step boundary and a
``resume`` that continues a stopped run as if it had never stopped, bit for
bit on the card too (``utils/device.py::cudnn_deterministic``). Every
draw of dropout, noise and augmentation comes from one training generator
on the device, whose state the checkpoints carry; prior samples for the
image log come from generators seeded apart from it, so logging less often
changes nothing else.

Data parallelism (``mesh``, one process per device): every rank runs the
loop on its row block of each global batch, through the data-parallel steps
(``train/steps.py``), so the losses, checkpoints and logs are the one
process's on the global batch. Rank 0 names the run directory and alone
writes files: checkpoints (``save_checkpoint`` waits for them on every
rank), metrics, images, prior samples, ``norms.json`` and the results. The
image panels take the global batch's first rows, gathered from the ranks.
Prior samples run on rank 0 alone, with its local BatchNorm statistics:
no collective runs there. A SIGTERM to any rank stops every rank at the
same step (``parallel.mesh.agree``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import pickle
import signal
from collections import defaultdict
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from mmdyn_tpu_torch.data.dataset import dataset_setup
from mmdyn_tpu_torch.data.loader import device_prefetch
from mmdyn_tpu_torch.models.factory import count_parameters, model_kwargs, setup_model
from mmdyn_tpu_torch.parallel.mesh import (agree, broadcast_object, gather_rows, replicate,
                                           sharded)
from mmdyn_tpu_torch.problems.base import (ProblemConfig, anneal_kl, make_optimizer,
                                           select_compute_dtype)
from mmdyn_tpu_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                              save_checkpoint)
from mmdyn_tpu_torch.train.metrics import MetricWriter, NullWriter
from mmdyn_tpu_torch.train.profiler import StepTimer, trace
from mmdyn_tpu_torch.train.state import create_train_state
from mmdyn_tpu_torch.train.steps import make_eval_step, make_sample_fn, make_train_step
from mmdyn_tpu_torch.utils.device import cudnn_deterministic, resolve_device

TRAIN_STREAM, SAMPLE_STREAM = 0, 1


def stream_seed(*words: int) -> int:
    """A generator seed for the stream named by ``words`` (the run's seed
    first), independent of every other stream's."""
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


class Problem:
    """Trains one problem configuration end to end, on the card
    unless ``device`` says otherwise; with ``mesh``, one rank of a
    data-parallel run on ``mesh.device`` (module doc)."""

    def __init__(self, cfg: ProblemConfig, dataset_path, save_name="run",
                 logs_root="./logs", log_dir=None, seed=0, device=None,
                 tensorboard=True, strict_parity=True, resume=False, profile_dir=None,
                 image_interval=1, ckpt_interval=1, vis_pose=False, no_crop=False,
                 mesh=None):
        self.mesh = mesh
        self.chief = mesh is None or mesh.is_chief
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.seed = seed
        self.profile_dir = profile_dir
        # the reference logs images and checkpoints every epoch
        # (problems.py:199-206); best-validation snapshots and the last epoch
        # are saved whatever the intervals
        self.image_interval = max(1, int(image_interval))
        self.ckpt_interval = max(1, int(ckpt_interval))
        self.vis_pose = vis_pose
        self._step_timer = StepTimer(self.device)
        self._best_loss = np.inf
        self._start_epoch = 0
        self._skip_batches = 0          # resume mid-epoch: steps already taken
        self._stop_requested = False    # set by the SIGTERM handler
        self._preempted = False         # set once the SIGTERM snapshot is saved
        self._last_eval_batch = None
        self._logger_dict = defaultdict(list)

        if log_dir:
            self.log_dir = Path(log_dir)
        else:
            name = save_name + datetime.now().strftime("_%Y_%m_%d_%H_%M_%S")
            if mesh is not None:
                name = broadcast_object(mesh, name)    # rank 0's clock names the run
            self.log_dir = Path(logs_root) / name
        self.checkpoint_dir = self.log_dir / "checkpoint"
        self.tensorboard_dir = self.log_dir / "tensorboard"
        self.plot_dir = self.log_dir / "plot"
        if self.chief:
            for d in (self.log_dir, self.checkpoint_dir, self.tensorboard_dir,
                      self.plot_dir):
                d.mkdir(parents=True, exist_ok=True)
            self.writer = MetricWriter(self.tensorboard_dir, tensorboard=tensorboard)
        else:
            self.writer = NullWriter()

        # --- corpus ---
        # a dataset directory without a corpus is compiled here, on the host
        dd = dataset_setup(dataset_path, cfg.problem_type, batchsize=cfg.batchsize,
                           seed=seed, strict_parity=strict_parity,
                           mask_loss=cfg.mask_loss, crop=not no_crop, mesh=mesh)
        self.train_dataset, self.test_dataset = dd["train_dataset"], dd["test_dataset"]
        self.train_loader, self.test_loader = dd["train_loader"], dd["test_loader"]
        self.seq_length = dd["seq_length"]
        self._log(f"dataset: {len(self.train_dataset)} train / {len(self.test_dataset)} "
                  f"test sequences  (seq_length {self.seq_length})")
        if len(self.train_loader) == 0 and cfg.num_epochs > 0:
            # an evaluation-only reattachment (num_epochs=0) takes no step
            raise ValueError(
                f"train split ({len(self.train_dataset)} sequences) is smaller than "
                f"the batch size ({cfg.batchsize}) with drop_last on: zero optimizer "
                f"steps per epoch. Use a smaller batch or more data. (The test split "
                f"drops its last element, datasets.py:107-108.)")
        if len(self.test_loader) == 0:
            msg = (f"test split ({len(self.test_dataset)} sequences) is smaller than "
                   f"the batch size ({cfg.batchsize}) and drop_last is on (reference "
                   f"semantics): validation loss will read 0. Use a smaller batch or "
                   f"more data.")
            self._log(f"WARNING: {msg}")
            self.writer.text("warnings/empty_test_split", msg)

        # --- the condition's width and the policy, known once the corpus is ---
        condition_dim = self.train_dataset.shock_dim
        self.cfg = dataclasses.replace(
            cfg, condition_dim=condition_dim,
            compute_dtype=select_compute_dtype(cfg, self.seq_length))
        # the run describes itself for serving: normalisation constants and
        # the train-time facts not readable from the parameters
        norms = dict(self.train_dataset.norms)
        norms["seq_length"] = self.seq_length
        norms["condition_dim"] = condition_dim
        norms["compute_dtype"] = self.cfg.compute_dtype
        norms["crop"] = self.train_dataset.crop
        if self.chief:
            with open(self.log_dir / "norms.json", "w") as f:
                json.dump(norms, f, indent=2)

        # --- model, optimizer, steps ---
        self.model = setup_model(self.cfg.model_name, cross_modal=self.cfg.cross_modal,
                                 device=self.device, seed=seed, **model_kwargs(self.cfg))
        if mesh is not None:
            replicate(mesh, self.model)
        self._log(f"model: {self.cfg.model_name}  params: "
                  f"{count_parameters(self.model):,}  compute_dtype: "
                  f"{self.cfg.compute_dtype}  device: {self.device}"
                  + ("" if mesh is None else f" x {mesh.size} ranks"))
        self.generator = torch.Generator(self.device).manual_seed(
            stream_seed(seed, TRAIN_STREAM))
        self.state = create_train_state(self.model,
                                        make_optimizer(self.cfg, self.model.parameters()))
        # on the card every step runs cuDNN's deterministic algorithms, so a
        # step reruns bit for bit and a resumed run is the uninterrupted one
        self.train_step = cudnn_deterministic(
            make_train_step(self.cfg, device=self.device, mesh=mesh), self.device)
        self.eval_step = cudnn_deterministic(
            make_eval_step(self.cfg, device=self.device, mesh=mesh), self.device)
        self.sample_fn = make_sample_fn(self.cfg, n=50, device=self.device)
        if self.sample_fn is not None:
            self.sample_fn = cudnn_deterministic(self.sample_fn, self.device)

        if resume:
            self._resume()

    def _log(self, msg):
        if self.chief:
            print(msg)

    def _stop_agreed(self):
        """Whether any rank asked for a stop (this process's flag alone
        without a mesh)."""
        if self.mesh is None:
            return self._stop_requested
        return agree(self.mesh, self._stop_requested)

    # ------------------------------------------------------------------
    def _resume(self):
        path = latest_checkpoint(self.checkpoint_dir)
        if path is None:
            self._log("resume requested but no checkpoint found; starting fresh")
            return
        epoch, self._best_loss, gen_state, batch_in_epoch = restore_checkpoint(
            path, self.state)
        if gen_state is not None:
            # the draws continue where they stopped
            self.generator.set_state(gen_state)
        if batch_in_epoch > 0:
            # a SIGTERM snapshot: replay epoch `epoch` (its order is a function
            # of (seed, epoch)) without the steps already taken
            self._start_epoch, self._skip_batches = epoch, batch_in_epoch
            self._log(f"resumed from {path} mid-epoch {epoch} (skipping {batch_in_epoch} "
                      f"completed steps, best val loss {self._best_loss:.4f})")
        else:
            self._start_epoch = epoch + 1
            self._log(f"resumed from {path} at epoch {epoch} "
                      f"(best val loss {self._best_loss:.4f})")
        for loader in (self.train_loader, self.test_loader):
            loader.set_epoch(self._start_epoch)

    def _batches(self, loader, skip=0):
        """The loader's batches on the device, prefetched, the first ``skip``
        dropped before they are copied; closed on leaving the ``with``, so an
        epoch left early stops its prefetch thread."""
        return contextlib.closing(device_prefetch(
            itertools.islice(iter(loader), skip, None), self.device, size=2))

    @staticmethod
    def _read(losses, perf_acc):
        """Device scalars -> floats with one wait for the device."""
        flat = losses + [v for vs in perf_acc.values() for v in vs]
        vals = torch.stack(flat).tolist() if flat else []
        out, i = {}, len(losses)
        for k, vs in perf_acc.items():
            out[k] = vals[i:i + len(vs)]
            i += len(vs)
        return vals[:len(losses)], out

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch, kl_weight):
        n_batches = len(self.train_loader)
        losses, perf_acc = [], defaultdict(list)
        skip, self._skip_batches = self._skip_batches, 0
        self._step_timer.reset()
        with self._batches(self.train_loader, skip) as batches:
            for b, batch in enumerate(batches, start=skip):
                self._step_timer.mark()
                self.state, metrics = self.train_step(self.state, batch, self.generator,
                                                      kl_weight)
                losses.append(metrics["loss"])
                for k, v in metrics.items():
                    if k != "loss":
                        perf_acc[k].append(v)
                if self._stop_agreed():
                    # SIGTERM: an exact snapshot of the state, the generator and
                    # the position, then unwind; train() stops the run
                    save_checkpoint(self.checkpoint_dir, self.state, epoch,
                                    self._best_loss, name="latest",
                                    generator=self.generator, batch_in_epoch=b + 1,
                                    mesh=self.mesh)
                    self._preempted = True
                    self._log(f"preempted: saved 'latest' at epoch {epoch} step "
                              f"{b + 1}/{n_batches}; resume with --resume")
                    break
        self._step_timer.mark()
        step_losses, perf = self._read(losses, perf_acc)
        for i, loss in enumerate(step_losses):
            self.writer.scalar("Loss/train_step", loss, epoch * n_batches + skip + i)
        train_loss = sum(step_losses)
        self._logger_dict["Loss/train_epoch"].append(train_loss / max(len(step_losses), 1))
        self._logger_dict["KL_annealing/train_epoch"].append(kl_weight)
        for k, vs in perf.items():
            self._logger_dict[f"Perf_measure_train/{k}"].append(sum(vs) / max(n_batches, 1))
        if self._step_timer.mean_step_time > 0:
            self._logger_dict["Perf/frames_per_sec"].append(
                self._step_timer.frames_per_sec(self.cfg.batchsize))
        return train_loss

    def _test_epoch(self, epoch, kl_weight):
        n_batches = len(self.test_loader)
        losses, perf_acc = [], defaultdict(list)
        last_aux = None
        # never render a stale batch when the test loader yields nothing
        self._last_eval_batch = None
        with self._batches(self.test_loader) as batches:
            for batch in batches:
                metrics, aux = self.eval_step(self.state.model, batch, self.generator,
                                              kl_weight)
                losses.append(metrics["loss"])
                for k, v in metrics.items():
                    if k != "loss":
                        perf_acc[k].append(v)
                last_aux, self._last_eval_batch = aux, batch
        losses, perf = self._read(losses, perf_acc)
        val_loss = sum(losses)
        self._logger_dict["Loss/validation_epoch"].append(val_loss / max(n_batches, 1))
        for k, vs in perf.items():
            self._logger_dict[f"Perf_measure_validation/{k}"].append(
                sum(vs) / max(n_batches, 1))
        return val_loss, last_aux

    def _rows(self, x, n):
        """The global batch's first ``n`` rows of ``x`` (this rank's rows)."""
        return x[:n] if self.mesh is None else gather_rows(self.mesh, x, n)

    def _write_images(self, epoch, aux, n_images=120):
        """Input / output / target panels (problems.py:588-614), to TensorBoard:
        nothing is copied off the device without it. Under a mesh every rank
        takes part in gathering the rows; rank 0 writes them."""
        # rank 0's writer decides; every rank then takes part in the gathers
        logs = (self.writer.tensorboard if self.mesh is None
                else agree(self.mesh, self.writer.tensorboard))
        if aux is None or "recon_x" not in aux or not logs:
            return
        nrow = self.seq_length if self.seq_length > 1 else int(np.sqrt(self.cfg.batchsize))
        recon = aux["recon_x"]

        def log(tag, logits):
            if logits.dim() == 4:
                logits = self._rows(logits, n_images)
                if self.writer.tensorboard:
                    images = torch.sigmoid(logits.float()).cpu().numpy()
                    self.writer.image_grid(tag, np.clip(images, 0, 1), epoch, nrow=nrow)

        if isinstance(recon, dict):
            log("Output_img/validation_visual", recon["visual"])
            log("Output_img/validation_tactile", recon["tactile"])
        else:
            log("Output_img/validation", recon)

        if (self.vis_pose and self.cfg.use_pose and isinstance(recon, dict)
                and recon.get("pose") is not None and self._last_eval_batch is not None):
            # 3-D triad figures (problems.py:605-614)
            from mmdyn_tpu_torch.problems.specs import parse_batch
            from mmdyn_tpu_torch.utils.plots import (plot_pose_tensorboard,
                                                     plot_single_pose_tensorboard)
            with sharded(self.mesh):
                ins, tgts = parse_batch(self.cfg, self._last_eval_batch)
            n = min(n_images, 16)   # host-side matplotlib figures: capped
            poses = [self._rows(x, n) for x in (ins["pose"], recon["pose"], tgts["pose"])]
            if not self.writer.tensorboard:
                return
            inp, out, tgt = (x.cpu().numpy() for x in poses)
            self.writer.figure("Pose_validation/input", plot_single_pose_tensorboard(
                inp, seq_length=self.seq_length), epoch)
            self.writer.figure("Pose_validation/output_vs_target", plot_pose_tensorboard(
                out, tgt, seq_length=self.seq_length), epoch)

    def _sample(self, epoch):
        """Prior samples to TensorBoard, drawn from the epoch's own sample
        generator (never from the training one); on rank 0 alone, outside
        ``sharded``: its BatchNorm statistics are its own, no collective."""
        if self.sample_fn is None or not self.writer.tensorboard:
            return
        gen = torch.Generator(self.device).manual_seed(
            stream_seed(self.seed, SAMPLE_STREAM, epoch))
        cond = None
        if self.cfg.conditional:
            cond = torch.rand((50, self.cfg.condition_dim), generator=gen, device=self.device)
        for k, v in self.sample_fn(self.state.model, gen, cond).items():
            if v.dim() == 4:
                self.writer.image_grid(f"Samples/latent_space_{k}",
                                       np.clip(v.float().cpu().numpy(), 0, 1), epoch)

    # ------------------------------------------------------------------
    def train(self):
        """The epoch loop (problems.py:193-210) with best-validation and
        rolling checkpoints.

        SIGTERM asks for a stop: the loop saves an exact snapshot as
        ``latest`` at the next step boundary and returns, and a ``resume``
        run continues it as the uninterrupted run would have gone on,
        bit-identical on the CPU and on the card (whose steps run cuDNN's
        deterministic algorithms). Under a mesh a SIGTERM to any rank stops
        them all at one step.
        """
        cfg = self.cfg

        def _request_stop(signum, frame):
            print("SIGTERM received: checkpointing at the next step boundary")
            self._stop_requested = True

        _no_handler = object()
        prev_handler = _no_handler
        try:
            prev_handler = signal.signal(signal.SIGTERM, _request_stop)
        except ValueError:
            pass    # not the main thread: no handler
        try:
            for epoch in range(self._start_epoch, cfg.num_epochs):
                self._log(f"Epoch: {epoch}")
                kl_weight = anneal_kl(epoch, cfg.annealing_epochs)
                # profile the second epoch (the first pays the warm-up), rank 0's
                do_profile = (self.profile_dir and epoch == self._start_epoch + 1
                              and self.chief)
                with trace(self.profile_dir if do_profile else None):
                    self._train_epoch(epoch, kl_weight)
                if self._preempted:
                    break
                val_loss, aux = self._test_epoch(epoch, kl_weight)
                last_epoch = epoch == cfg.num_epochs - 1
                if epoch % self.image_interval == 0 or last_epoch:
                    self._sample(epoch)
                    self._write_images(epoch, aux)
                for key, values in self._logger_dict.items():
                    self.writer.scalar(key, values[-1], epoch)
                self.writer.flush()

                # the validation loss is the global batch's, equal on every rank
                if val_loss < self._best_loss:
                    self._best_loss = val_loss
                    save_checkpoint(self.checkpoint_dir, self.state, epoch, self._best_loss,
                                    mesh=self.mesh)
                stop = self._stop_agreed()
                if epoch % self.ckpt_interval == 0 or last_epoch or stop:
                    save_checkpoint(self.checkpoint_dir, self.state, epoch, self._best_loss,
                                    name="latest", generator=self.generator,
                                    mesh=self.mesh)
                if stop:
                    self._log(f"preempted: saved 'latest' after epoch {epoch}; "
                              f"resume with --resume")
                    break
        finally:
            if prev_handler is not _no_handler:
                signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)

        perf = {k: v[-1] for k, v in self._logger_dict.items()
                if k.startswith("Perf_measure") and v}
        self.writer.hparams(dataclasses.asdict(self.cfg), perf)
        if self.chief:
            with open(self.log_dir / "results.pkl", "wb") as f:
                pickle.dump(dict(self._logger_dict), f)
        self.writer.close()
        return dict(self._logger_dict)
