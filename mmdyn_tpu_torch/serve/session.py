"""Inference / serving sessions (port of ``mmdyn_tpu/serve/session.py``):
load a trained run and predict without a dataset.

* ``from_run`` loads a run's own checkpoint (``train/checkpoint.py``) with
  neither the dataset nor the optimizer; ``from_torch_ckpt`` a
  reference-format torch checkpoint.
* Deterministic by default: dropout off (the model is built with
  ``dropout_rate=0``, which leaves the parameters unchanged) and z = the
  posterior mean. BatchNorm takes batch statistics, the reference's own
  serving semantics (problems.py:174), so predictions depend mildly on the
  composition of the served batch, until ``freeze_bn`` freezes them.
  ``parity=True`` keeps train-mode dropout, drawn from the session's
  generator. On the card a session selects cuDNN's deterministic
  algorithms for the process (``torch.backends.cudnn.deterministic``): with
  the default ones the same batch reruns to other last bits.
* Every forward runs under ``torch.inference_mode()``, entered inside the
  session's methods: it is thread-local, and the server calls from its
  handler and micro-batcher threads.
* ``aot_predict``: the predictor at one fixed batch, captured as a CUDA graph
  on the card.
* ``rollout``: the one-step predictor iterated closed-loop (a Python loop
  where the JAX package scans).

Modality subsets follow the MVAE's product-of-experts semantics
(vae.py:126-165): any non-None subset of (visual, tactile, pose) fuses with
the prior expert; absent modalities are not encoded.

Randomness: ``sample_prior``, ``predict(sample=True)`` and ``rollout`` draw
from a ``torch.Generator`` on the session's device (the session's own, or
one passed in). They cannot reproduce the JAX package's draws.

Data parallelism (``mesh``, ``parallel/mesh.py``), as the JAX package's
multi-controller mode: every rank calls ``predict``, ``rollout`` or
``freeze_bn`` with the whole batch; each computes its row block, with
BatchNorm statistics and noise draws taken over the global batch, and every
rank returns the whole result, gathered by an all-reduce of a zero-filled
buffer (gloo has no all-gather of CUDA tensors). ``sample_prior`` runs whole
on the rank that calls it, with no collective. Under a group of more than
one rank, ``aot_predict`` on the CPU returns the eager fixed-shape
predictor, which every rank calls together as it calls ``predict``; on the
card it raises (``aot_predict``). ``serve/export.py`` exports a one-device
program from rank 0.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mmdyn_tpu_torch.models import model_kwargs, setup_model
from mmdyn_tpu_torch.models.layers import bn_stats, load_bn_stats
from mmdyn_tpu_torch.ops.poe import product_of_experts
from mmdyn_tpu_torch.parallel.mesh import gather_rows, global_draw, shard_batch, sharded
from mmdyn_tpu_torch.problems.base import ProblemConfig
from mmdyn_tpu_torch.train.checkpoint import latest_checkpoint
from mmdyn_tpu_torch.utils.device import resolve_device
from mmdyn_tpu_torch.utils.runs import config_from_args, load_run_args
from mmdyn_tpu_torch.utils.weights import from_reference_state_dict

IMAGE_SHAPE = (64, 64, 3)
POSE_DIM = 7
_CNN_TRUNK = 512  # cnn encoder/regressor trunk width before condition concat
_MLP_TRUNK = 256  # mlp encoder last hidden width (models/vae.py layer_sizes)


def _is_mlp(cfg: ProblemConfig) -> bool:
    return cfg.model_name.split("-")[0] == "mlp"


def _infer_condition_dim(cfg: ProblemConfig, state_dict) -> Optional[int]:
    """Recover the shock-force width from the head's fan-in.

    condition_dim is probed from the dataset at train time and is not in
    problem.pkl; serving must not need the dataset. The condition joins
    between the trunk and the first head, so the head's fan-in exposes it:
    trunk width 512 for cnn, 256 for the mlp encoder's last hidden layer. A
    torch ``Linear.weight`` is (out, in): the fan-in is ``shape[1]``.
    """
    if not cfg.conditional:
        return None
    if cfg.problem_type == "regression":
        head, trunk = state_dict["out_net.0.weight"], _CNN_TRUNK
    else:
        enc = ("visual_encoder" if "visual_encoder.linear_means.weight" in state_dict
               else "encoder")
        head = state_dict[f"{enc}.linear_means.weight"]
        trunk = _MLP_TRUNK if _is_mlp(cfg) else _CNN_TRUNK
    return int(head.shape[1]) - trunk


def posterior_rows(model_name: str, batch: int) -> int:
    """Rows of the posterior (and of the sampling noise) for ``batch``
    inputs: the mlp VAE folds an image's three channel planes into rows."""
    mlp_fold = model_name.split("-")[0] == "mlp" and "mvae" not in model_name
    return 3 * batch if mlp_fold else batch


def _build_model(cfg: ProblemConfig, device, **overrides):
    return setup_model(cfg.model_name, cross_modal=cfg.cross_modal, device=device,
                       **model_kwargs(cfg), **overrides)


def _uint8(probs):
    """[0, 1] probabilities -> uint8 on the device; ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    return torch.round(probs * 255.0).to(torch.uint8)


class InferenceSession:
    """Deterministic (by default) forward-only access to a trained model.

    ``state_dict`` is the port's (``setup_model``'s names); ``bn_stats``
    ({BatchNorm module name: {"mean", "var"}}) builds a frozen-BatchNorm
    session. Without ``device`` the session runs on the card and raises
    when there is none; with ``mesh`` it is one rank of a data-parallel
    session on ``mesh.device`` (module doc).
    """

    def __init__(self, cfg: ProblemConfig, state_dict, parity: bool = False,
                 bn_stats=None, norms=None, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN's default algorithms are not all deterministic: the same
            # batch can rerun to other last bits. A serving session must
            # rerun bit for bit (and its graph equal its eager call), so on
            # the card it selects cuDNN's deterministic algorithms for the
            # convolutions cuDNN runs, for the process (the float32 ones are
            # ``ops.kernels.conv_fprop_f32`` and, transposed,
            # ``conv_dgrad_f32``, which sum in a fixed order).
            torch.backends.cudnn.deterministic = True
        self.cfg = cfg
        self.norms = norms or {}  # dataset min-max constants (norms.json)
        self.parity = parity
        kwargs = {} if parity else {"dropout_rate": 0.0}
        if bn_stats is not None:
            kwargs["bn_mode"] = "frozen"
        self.model = _build_model(cfg, self.device, **kwargs)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.requires_grad_(False)
        self.bn_stats = bn_stats
        if bn_stats is not None:
            load_bn_stats(self.model, bn_stats)
        self.generator = torch.Generator(self.device).manual_seed(0)
        self._aot_cache = {}

    @property
    def params(self):
        """The model's ``state_dict`` (the trained parameters only)."""
        return self.model.state_dict()

    # ------------------------------------------------------------------
    @classmethod
    def from_run(cls, run_dir, parity: bool = False, compute_dtype=None,
                 checkpoint: Optional[str] = None, device=None, mesh=None):
        """Load <run>/problem.pkl + the latest (or named) checkpoint of a run
        this package trained. The policy is the one ``norms.json`` records,
        unless ``compute_dtype`` overrides it. A run the JAX package trained
        holds orbax checkpoint directories, which this package cannot read:
        that raises, naming the conversion route."""
        run_dir = Path(run_dir)
        norms = None
        if (run_dir / "norms.json").exists():
            with open(run_dir / "norms.json") as f:
                norms = json.load(f)
        policy = compute_dtype or (norms or {}).get("compute_dtype", "float32")
        cfg = config_from_args(load_run_args(run_dir), policy)
        ckpt_dir = run_dir / "checkpoint"
        path = ckpt_dir / checkpoint if checkpoint else latest_checkpoint(ckpt_dir)
        if path is None or not Path(path).exists():
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        if Path(path).is_dir():
            raise ValueError(
                f"{path} is an orbax checkpoint directory (a run of the JAX package), "
                f"which this package cannot read. Convert it with `python "
                f"tools/export_torch_ckpt.py export --run {run_dir} --model-name "
                f"{cfg.model_name} --out <file>.ckpt`, then serve the file with "
                f"InferenceSession.from_torch_ckpt (the CLIs' --torch-ckpt)")
        state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        if norms is not None and "condition_dim" in norms:
            # recorded at train time: authoritative; the fan-in probe is the
            # fallback for runs without the field
            condition_dim = norms["condition_dim"]
        else:
            condition_dim = _infer_condition_dim(cfg, state_dict)
        cfg = dataclasses.replace(cfg, condition_dim=condition_dim)
        return cls(cfg, state_dict, parity=parity, norms=norms, device=device, mesh=mesh)

    @classmethod
    def from_torch_ckpt(cls, ckpt_path, problem_type="seq_modeling",
                        model_name="cnn-mvae", input_type="visuotactile",
                        conditional=False, parity=False, norms=None,
                        compute_dtype="float32", device=None, mesh=None):
        """Serve a reference-format torch checkpoint
        (``torch.save({'model': state_dict, ...})``, problems.py:580-586):
        the names are the port's, the BatchNorm running buffers are dropped.
        latent_size and use_pose come from the weights, condition_dim from
        the head's fan-in."""
        blob = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sd = from_reference_state_dict(
            blob["model"] if isinstance(blob, dict) and "model" in blob else blob)
        if problem_type == "regression":
            latent, use_pose = 256, False  # latent unused
        else:
            enc = ("visual_encoder" if "visual_encoder.linear_means.weight" in sd
                   else "encoder")
            latent = int(sd[f"{enc}.linear_means.weight"].shape[0])
            use_pose = any(k.startswith("pose_encoder.") for k in sd)
        cfg = ProblemConfig(problem_type=problem_type, model_name=model_name,
                            input_type=input_type, use_pose=use_pose,
                            conditional=conditional, latent_size=latent,
                            compute_dtype=compute_dtype)
        cfg = dataclasses.replace(cfg, condition_dim=_infer_condition_dim(cfg, sd))
        return cls(cfg, sd, parity=parity, norms=norms, device=device, mesh=mesh)

    # ------------------------------------------------------------------
    # prediction cores: tensors on the session's device in, tensors out

    def _noise(self, batch: int, generator):
        return global_draw(lambda s: torch.randn(s, generator=generator, device=self.device),
                           (posterior_rows(self.cfg.model_name, batch), self.cfg.latent_size))

    def _shard(self, inputs, condition):
        """This rank's rows of the inputs and the condition (all of them
        without a mesh)."""
        if self.mesh is None:
            return inputs, condition
        return (shard_batch(self.mesh, inputs),
                None if condition is None else shard_batch(self.mesh, condition))

    def _whole(self, out):
        """Every rank's rows of each output, on every rank."""
        if self.mesh is None:
            return out
        return {k: gather_rows(self.mesh, v) for k, v in out.items()}

    def _whole_traj(self, traj):
        """``_whole`` of (steps, B, ...) trajectories, batch on axis 1."""
        if self.mesh is None:
            return traj
        return {k: gather_rows(self.mesh, v.transpose(0, 1)).transpose(0, 1)
                for k, v in traj.items()}

    @property
    def grouped(self) -> bool:
        """Whether the session is one rank of a group of more than one."""
        return self.mesh is not None and self.mesh.size > 1

    def _posterior(self, inputs, condition, generator):
        """Joint PoE posterior over the present modalities (vae.py:126-165)."""
        model = self.model
        if not self.cfg.is_mvae:
            x = inputs["visual" if "visual" in inputs else "tactile"]
            if _is_mlp(self.cfg):
                # vae.py:82-83 view(-1, input_dim): channel planes fold into
                # the batch axis (see models/vae.py VAE.forward)
                x = x.permute(0, 3, 1, 2).reshape(-1, 64 * 64)
            return model.encoder(x, condition, generator)
        mus, lvs = [], []
        if "visual" in inputs:
            mu, lv = model.visual_encoder(inputs["visual"], condition, generator)
            mus.append(mu); lvs.append(lv)
        if "tactile" in inputs:
            mu, lv = model.tactile_encoder(inputs["tactile"], condition, generator)
            mus.append(mu); lvs.append(lv)
        if "pose" in inputs:
            mu, lv = model.pose_encoder(inputs["pose"])
            mus.append(mu); lvs.append(lv)
        mus = [torch.zeros_like(mus[0])] + mus       # prior expert N(0, I)
        lvs = [torch.zeros_like(lvs[0])] + lvs
        return product_of_experts(torch.stack(mus), torch.stack(lvs))

    def _decode(self, z, condition, uint8_images=False):
        """Decode z into every output modality; images sigmoided to [0, 1]
        (or quantised to uint8 on the device: a 4x smaller readback)."""
        model = self.model

        def img(logits):
            probs = torch.sigmoid(logits.float())
            return _uint8(probs) if uint8_images else probs

        if not self.cfg.is_mvae:
            out = model.decoder(z, condition)
            if _is_mlp(self.cfg):
                out = out.reshape(z.shape[0] // 3, 3, 64, 64).permute(0, 2, 3, 1)
            return {self.cfg.input_type: img(out)}
        preds = {"visual": img(model.visual_decoder(z, condition)),
                 "tactile": img(model.tactile_decoder(z, condition))}
        if self.cfg.use_pose:
            preds["pose"] = model.pose_decoder(z).float()
        return preds

    def _predict_core(self, inputs, condition, noise=None, uint8_images=False,
                      generator=None):
        """Predictions + posterior of ``inputs``; z = mu + noise * std when
        ``noise`` (the posterior's shape) is given, else mu. ``generator``
        feeds dropout when the session keeps it (``parity``)."""
        if self.cfg.problem_type == "regression":
            x = inputs["visual" if "visual" in inputs else "tactile"]
            return {"pose": self.model(x, condition, generator).float()}
        mu, lv = self._posterior(inputs, condition, generator)
        z = mu if noise is None else noise * torch.exp(0.5 * lv) + mu
        preds = self._decode(z, condition, uint8_images)
        if not self.cfg.is_mvae and _is_mlp(self.cfg):
            # the mlp fold put channel planes on the batch axis (row order
            # b*3 + c); group the per-plane posteriors back per input row so
            # every output's leading axis is the request batch
            b = next(iter(inputs.values())).shape[0]
            mu, lv = mu.reshape(b, 3, -1), lv.reshape(b, 3, -1)
        preds["mu"], preds["logvar"] = mu, lv
        return preds

    # ------------------------------------------------------------------
    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def check_inputs(self, visual=None, tactile=None, pose=None, condition=None):
        """Raise ``ValueError`` for inputs the model cannot take, before any
        device work (the server checks a request here before its other
        ranks see it)."""
        self._modalities(visual, tactile, pose)
        self._check_condition(condition)

    def _modalities(self, visual, tactile, pose):
        """The modalities the model encodes of the given ones."""
        names = [m for m, x in (("visual", visual), ("tactile", tactile), ("pose", pose))
                 if x is not None and (m != "pose" or self.cfg.use_pose)]
        if not names:
            raise ValueError("at least one input modality is required")
        if (not self.cfg.is_mvae and self.cfg.problem_type != "regression"
                and self.cfg.input_type not in names):
            # a single-modality VAE's encoder was trained on input_type;
            # feeding the other image stream would silently decode garbage
            raise ValueError(f"this {self.cfg.model_name} was trained on "
                             f"'{self.cfg.input_type}' input; got {names}")
        return names

    def _check_condition(self, condition):
        if self.cfg.conditional and condition is None:
            # fail with intent, not with a shape error inside the model: the
            # heads were trained on trunk+condition fan-in
            raise ValueError(
                f"this model is conditional (condition_dim={self.cfg.condition_dim}); "
                f"pass condition=(B, {self.cfg.condition_dim})")

    def _gather(self, visual, tactile, pose):
        given = {"visual": visual, "tactile": tactile, "pose": pose}
        return {m: self._tensor(given[m]) for m in self._modalities(visual, tactile, pose)}

    def _gather_condition(self, condition):
        if not self.cfg.conditional:
            return None
        self._check_condition(condition)
        return self._tensor(condition)

    def predict(self, visual=None, tactile=None, pose=None, condition=None,
                sample=False, uint8_images=False, generator=None):
        """One forward prediction from any present modality subset.

        For seq/dyn models this is the resting-state / next-state prediction
        the problem was trained on; for plain reconstruction the autoencoded
        input; for regression the 7-D pose estimate.

        Images are (B, 64, 64, 3) float in [0, 1] (uint8 0-255 out with
        ``uint8_images=True``, quantised on the device); pose is in the
        dataset's normalised pose space. Inputs are numpy arrays or tensors;
        the result is a dict of tensors on the session's device, the
        predictions plus the joint posterior (mu, logvar). ``sample`` draws z
        with noise from ``generator`` (default: the session's).
        """
        with torch.inference_mode(), sharded(self.mesh):
            inputs, cond = self._shard(self._gather(visual, tactile, pose),
                                       self._gather_condition(condition))
            gen = generator or self.generator
            noise = None
            if sample and self.cfg.problem_type != "regression":
                noise = self._noise(next(iter(inputs.values())).shape[0], gen)
            return self._whole(self._predict_core(inputs, cond, noise, bool(uint8_images),
                                                  gen))

    def denormalize_pose(self, pose):
        """Invert the dataset's min-max pose normalisation
        (datasets.py:244-253): x = lo + pose * (hi - lo). Needs the run's
        norms.json; raises otherwise."""
        if "pose_min" not in self.norms:
            raise ValueError(
                "no normalisation constants: the run has no norms.json "
                "(re-train, or pass norms= to InferenceSession)")
        lo = np.asarray(self.norms["pose_min"], np.float32)
        hi = np.asarray(self.norms["pose_max"], np.float32)
        return np.asarray(pose, np.float32) * (hi - lo) + lo

    def normalize_pose(self, pose):
        """Forward min-max normalisation for feeding raw poses in."""
        if "pose_min" not in self.norms:
            raise ValueError("no normalisation constants (see denormalize_pose)")
        lo = np.asarray(self.norms["pose_min"], np.float32)
        hi = np.asarray(self.norms["pose_max"], np.float32)
        rng = hi - lo
        rng[rng == 0] = 1.0
        return (np.asarray(pose, np.float32) - lo) / rng

    def encode(self, visual=None, tactile=None, pose=None, condition=None):
        """Joint posterior (mu, logvar) of the present modalities."""
        out = self.predict(visual, tactile, pose, condition)
        return out["mu"], out["logvar"]

    def sample_prior(self, n, generator=None, condition=None, uint8_images=False):
        """Decode n prior samples z ~ N(0, I) (problems.py:548-559), drawn
        from ``generator`` (default: the session's)."""
        if self.cfg.problem_type == "regression":
            raise ValueError("regression models have no latent space")
        with torch.inference_mode():
            cond = self._gather_condition(condition)
            z = torch.randn((int(n), self.cfg.latent_size),
                            generator=generator or self.generator, device=self.device)
            return self._decode(z, cond, bool(uint8_images))

    # ------------------------------------------------------------------
    def rollout(self, steps, visual=None, tactile=None, pose=None, condition=None,
                sample=False, uint8_images=False, generator=None):
        """Iterate the one-step predictor closed-loop for ``steps`` steps.

        Each step feeds the predicted modalities back as the next input
        (images as [0, 1] probabilities, the space the dyn targets live in);
        only the returned trajectory is quantised with ``uint8_images``.
        Returns a dict of (steps, B, ...) trajectories.
        """
        if self.cfg.problem_type == "regression":
            raise ValueError("rollout needs a generative model (the "
                             "regressor's pose output cannot be fed back)")
        with torch.inference_mode(), sharded(self.mesh):
            carry, cond = self._shard(self._gather(visual, tactile, pose),
                                      self._gather_condition(condition))
            gen = generator or self.generator
            keep = tuple(sorted(carry))
            ys = []
            for _ in range(int(steps)):
                noise = (self._noise(next(iter(carry.values())).shape[0], gen)
                         if sample else None)
                preds = self._predict_core(carry, cond, noise, False, gen)
                carry = {k: preds[k] for k in keep}
                ys.append({k: v for k, v in preds.items()
                           if k in keep or k in ("mu", "logvar")})
            traj = self._whole_traj({k: torch.stack([y[k] for y in ys]) for k in ys[0]})
            if uint8_images:
                traj = {k: (_uint8(v) if v.dim() == 5 else v) for k, v in traj.items()}
            return traj

    # ------------------------------------------------------------------
    def freeze_bn(self, visual=None, tactile=None, pose=None, condition=None,
                  generator=None) -> "InferenceSession":
        """Calibrate BatchNorm and return a frozen-statistics session.

        The models keep no running statistics (the reference always
        evaluates in train mode, problems.py:174), so batch-mode serving
        depends on the composition of the served batch: padding rows and,
        under request coalescing, other requests' data. This runs one
        calibration pass of the whole model in ``collect`` mode over the given
        batch (every encoder and decoder once; the decoders see a z sampled
        with noise from ``generator``, default the session's, so their
        statistics depend on it), and returns a new session whose predictions
        are per-example deterministic. Use a batch representative of the
        training data, e.g. a few hundred frames of the training dump.
        """
        collect = _build_model(self.cfg, self.device, dropout_rate=0.0, bn_mode="collect")
        collect.load_state_dict(self.model.state_dict(), strict=True)
        gen = generator or self.generator

        def rows(x):     # this rank's rows (under a mesh) as a device tensor
            return self._shard(self._tensor(x), None)[0]

        cond = rows(condition) if (condition is not None and self.cfg.conditional) else None
        with torch.inference_mode(), sharded(self.mesh):
            if self.cfg.is_mvae and self.cfg.problem_type != "regression":
                if visual is None or tactile is None:
                    raise ValueError("MVAE calibration needs visual AND tactile "
                                     "(every BN layer must execute)")
                p = rows(pose) if (pose is not None and self.cfg.use_pose) else None
                collect((rows(visual), rows(tactile)), p, cond, gen)
            else:
                collect(rows(visual if visual is not None else tactile), cond, gen)
        stats = bn_stats(collect)
        if not stats:
            # BN-free architectures (mlp stacks) have nothing to calibrate:
            # the session is already per-example deterministic
            warnings.warn("freeze_bn: model has no BatchNorm layers; "
                          "returning the session unchanged", stacklevel=2)
            return self
        return InferenceSession(self.cfg, self.model.state_dict(), parity=self.parity,
                                bn_stats=stats, norms=self.norms, device=self.device,
                                mesh=self.mesh)

    # ------------------------------------------------------------------
    def aot_predict(self, batch_size, modalities=("visual", "tactile"),
                    conditional=False, sample=False, uint8_images=False):
        """The predictor at a fixed batch size, built once per signature
        (cached): on the card a CUDA graph, replayed on static buffers; on a
        CPU session (asked for explicitly) the eager fixed-shape callable.
        Returns a ``FixedBatchPredictor``: ``fn(inputs, condition=None)``.

        Under a group of more than one rank (the JAX package compiles with
        the batch sharded), a CPU session's predictor takes the route of
        ``predict``: every rank calls it together with the whole batch. On
        the card that raises: a gloo collective cannot be captured in a CUDA
        graph, and a graph of NCCL ranks on separate cards cannot be checked
        on one card."""
        if self.grouped and self.device.type == "cuda":
            raise RuntimeError(
                f"aot_predict under a process group of {self.mesh.size} ranks on the "
                f"card: the gather of the ranks' rows is a collective, which a CUDA "
                f"graph of a gloo group cannot capture (and a graph of NCCL ranks on "
                f"separate cards cannot be checked on one card); call predict, "
                f"every rank together")
        key = (int(batch_size), tuple(sorted(modalities)), bool(conditional),
               bool(sample), bool(uint8_images))
        if key not in self._aot_cache:
            self._aot_cache[key] = FixedBatchPredictor(self, *key)
        return self._aot_cache[key]


class FixedBatchPredictor:
    """``predictor(inputs, condition=None) -> predictions`` at one batch
    size and modality set: ``inputs`` maps each modality to a (B, 64, 64, 3)
    or (B, 7) array; the result is a dict of tensors on the session's device.

    On the card ``_predict_core`` is captured once as a ``torch.cuda.CUDAGraph``
    on static input buffers (warmed up on a side stream first): a call copies
    the inputs in, replays, and clones the outputs out. With ``sample`` the
    noise is one more static input, filled from the session's generator
    before each replay, so the graph holds no random op; with ``parity``
    dropout the session's generator is registered with the graph, and a
    torch that cannot do that raises. A capture failure raises. One caller at
    a time: the buffers are shared.

    Under a group (a CPU session only) each call computes this rank's rows
    of the static buffers, BatchNorm over every rank's, and returns the whole
    batch's outputs, as ``predict`` does; the noise buffer is drawn whole and
    each rank keeps its rows, as ``parallel.mesh.global_draw`` draws.
    """

    def __init__(self, session, batch_size, modalities, conditional, sample, uint8_images):
        cfg = session.cfg
        self.session = session
        self.batch_size = batch_size
        self.modalities = modalities
        self.conditional = conditional and cfg.conditional
        self.sample = sample and cfg.problem_type != "regression"
        self.uint8_images = uint8_images
        dev = session.device
        with torch.inference_mode():
            self._inputs = {m: torch.zeros((batch_size, POSE_DIM) if m == "pose"
                                           else (batch_size,) + IMAGE_SHAPE, device=dev)
                            for m in modalities}
            self._condition = (torch.zeros((batch_size, cfg.condition_dim), device=dev)
                               if self.conditional else None)
            self._noise = (torch.zeros((posterior_rows(cfg.model_name, batch_size),
                                        cfg.latent_size), device=dev)
                           if self.sample else None)
        self._graph = self._capture() if dev.type == "cuda" else None

    def _run(self):
        s = self.session
        if not s.grouped:
            return s._predict_core(self._inputs, self._condition, self._noise,
                                   self.uint8_images, s.generator)
        inputs, cond = s._shard(self._inputs, self._condition)
        noise = None if self._noise is None else s._shard(self._noise, None)[0]
        with sharded(s.mesh):
            return s._whole(s._predict_core(inputs, cond, noise, self.uint8_images,
                                            s.generator))

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        if self.session.parity:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a generator with a CUDA "
                    f"graph, which parity dropout needs; call session.predict instead")
            graph.register_generator_state(self.session.generator)
        with torch.inference_mode():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._run()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                self._outputs = self._run()
        return graph

    def __call__(self, inputs, condition=None):
        with torch.inference_mode():
            if set(inputs) != set(self.modalities):
                raise ValueError(f"predictor takes modalities {list(self.modalities)}, "
                                 f"got {sorted(inputs)}")
            if (condition is not None) != self.conditional:
                raise ValueError(f"predictor was built with conditional={self.conditional}")
            pairs = [(self._inputs[m], inputs[m]) for m in self.modalities]
            if self.conditional:
                pairs.append((self._condition, condition))
            for buf, x in pairs:
                x = torch.as_tensor(x, dtype=torch.float32)
                if tuple(x.shape) != tuple(buf.shape):
                    raise ValueError(f"predictor takes {tuple(buf.shape)}, got {tuple(x.shape)}")
                buf.copy_(x)
            if self.sample:
                self._noise.normal_(generator=self.session.generator)
            if self._graph is None:
                return self._run()
            self._graph.replay()
            return {k: v.clone() for k, v in self._outputs.items()}
