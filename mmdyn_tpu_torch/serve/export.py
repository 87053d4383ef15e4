"""Portable serving artifacts via ``torch.export`` (port of
``mmdyn_tpu/serve/export.py``).

``export_session`` freezes an InferenceSession's predictor for a fixed batch
size into a self-contained directory:

    predict.pt2     ``torch.export.save`` of the ExportedProgram of
                    (inputs, condition, noise) -> predictions, the weights
                    (and frozen BatchNorm statistics) inside it
    manifest.json   shapes, modalities, the device type it was exported
                    on, config provenance

``load_exported`` runs it with no model code and no checkpoint machinery:
only torch, the serialized program and the port's custom operators
(``ops/kernels.py`` registers them: a model in BatchNorm mode ``batch``
exports each BatchNorm + swish as ``mmdyn::bn_swish``, and a float32 model
each convolution as ``mmdyn::conv_fprop`` and each transposed convolution as
``mmdyn::conv_dgrad``). A ``sample``
artifact takes its noise as an input (the posterior's shape), never a
generator. The program runs on the device type it was exported on
(``manifest["platforms"]``).

A session of a group of ranks exports a one-device program, as the JAX
package lowers its meshed session with unsharded specs: rank 0 exports a
session without a group from the same weights (and frozen statistics), the
other ranks wait, and every rank returns the manifest.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from mmdyn_tpu_torch.ops import kernels  # noqa: F401  (registers the mmdyn:: operators)
from mmdyn_tpu_torch.parallel.mesh import broadcast_object
from mmdyn_tpu_torch.serve.session import (IMAGE_SHAPE, POSE_DIM, InferenceSession,
                                           posterior_rows)

MANIFEST = "manifest.json"
MODULE = "predict.pt2"


class _Predictor(torch.nn.Module):
    """The session's ``_predict_core`` as a module whose parameters and
    buffers are the session model's, for ``torch.export``."""

    def __init__(self, session):
        super().__init__()
        self.model = session.model
        self.session = session     # not a Module: a plain attribute

    def forward(self, inputs, condition, noise):
        # generator None: dropout of a parity session draws from torch's
        # default generator, which the exported program can carry
        return self.session._predict_core(inputs, condition, noise)


def export_session(session, out_dir, batch_size=1, modalities=None,
                   conditional=False, sample=False):
    """Serialize the session's predictor for a fixed batch size on the
    session's device. ``modalities=None`` derives the input set from the
    session's config. Returns the manifest dict. Every rank of a group calls
    it (module doc); an error on rank 0 raises on every rank."""
    args = (out_dir, batch_size, modalities, conditional, sample)
    if not session.grouped:
        return _export(session, *args)
    manifest = error = None
    if session.mesh.is_chief:
        solo = InferenceSession(session.cfg, session.model.state_dict(),
                                parity=session.parity, bn_stats=session.bn_stats,
                                norms=session.norms, device=session.device)
        try:
            manifest = _export(solo, *args)
        except Exception as e:      # reported to every rank: none waits on
            error = e
    manifest, failed = broadcast_object(      # the other ranks wait here
        session.mesh, (manifest, None if error is None else f"{type(error).__name__}: {error}"))
    if error is not None:
        raise error
    if failed is not None:
        raise RuntimeError(f"the export on rank 0 failed: {failed}")
    return manifest


def _export(session, out_dir, batch_size, modalities, conditional, sample):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = session.cfg
    if modalities is None:
        modalities = (("visual", "tactile") if cfg.cross_modal else (cfg.input_type,))
        if cfg.use_pose:
            modalities = modalities + ("pose",)
    modalities = tuple(sorted(modalities))
    if (not cfg.is_mvae and cfg.problem_type != "regression"
            and tuple(m for m in modalities if m != "pose") != (cfg.input_type,)):
        # same guard as InferenceSession._gather: a single-modality VAE
        # artifact must take exactly the stream it was trained on
        raise ValueError(f"this {cfg.model_name} was trained on "
                         f"'{cfg.input_type}' input; got {modalities}")

    dev = session.device
    inputs = {m: torch.zeros((batch_size, POSE_DIM) if m == "pose"
                             else (batch_size,) + IMAGE_SHAPE, device=dev)
              for m in modalities}
    conditional = bool(conditional and cfg.conditional)
    cond = (torch.zeros((batch_size, cfg.condition_dim), device=dev)
            if conditional else None)
    sample = bool(sample and cfg.problem_type != "regression")
    noise = (torch.zeros((posterior_rows(cfg.model_name, batch_size), cfg.latent_size),
                         device=dev) if sample else None)
    with torch.no_grad():
        exported = torch.export.export(_Predictor(session), (inputs, cond, noise))
        outputs = sorted(exported.module()(inputs, cond, noise))
    torch.export.save(exported, out_dir / MODULE)

    manifest = {
        "batch_size": int(batch_size),
        "modalities": list(modalities),
        "conditional": conditional,
        "sample": sample,
        "platforms": [dev.type],
        "outputs": outputs,
        "frozen_bn": session.bn_stats is not None,
        "config": dataclasses.asdict(cfg),
        "torch_version": torch.__version__,
    }
    with open(out_dir / MANIFEST, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedPredictor:
    """A loaded artifact: ``preds = predictor(visual=..., tactile=...)``."""

    def __init__(self, exported, manifest):
        self._call = exported.module()
        self.manifest = manifest
        self.device = torch.device(manifest["platforms"][0])

    def __call__(self, condition=None, noise=None, **inputs):
        """Inputs as numpy arrays or tensors; uint8 images are 0-255 and
        scaled by 1/255, as the HTTP server does. A ``sample`` artifact
        draws its noise from a generator seeded with 0 unless ``noise`` is
        given."""
        man = self.manifest
        want = set(man["modalities"])
        got = {}
        for k, v in inputs.items():
            if v is None:
                continue
            arr = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            got[k] = torch.as_tensor(arr, dtype=torch.float32, device=self.device)
        if set(got) != want:
            raise ValueError(f"artifact expects modalities {sorted(want)}, got {sorted(got)}")
        cond = None
        if man["conditional"]:
            if condition is None:
                raise ValueError("artifact expects a condition")
            cond = torch.as_tensor(condition, dtype=torch.float32, device=self.device)
        if man["sample"]:
            cfg = man["config"]
            shape = (posterior_rows(cfg["model_name"], man["batch_size"]), cfg["latent_size"])
            noise = (torch.randn(shape, generator=torch.Generator(self.device).manual_seed(0),
                                 device=self.device) if noise is None
                     else torch.as_tensor(noise, dtype=torch.float32, device=self.device))
        else:
            noise = None
        with torch.inference_mode():
            return self._call({k: got[k] for k in sorted(got)}, cond, noise)


def load_exported(out_dir) -> ExportedPredictor:
    """Deserialize an exported artifact; needs only torch."""
    out_dir = Path(out_dir)
    with open(out_dir / MANIFEST) as f:
        manifest = json.load(f)
    return ExportedPredictor(torch.export.load(out_dir / MODULE), manifest)
