"""mmdyn_tpu_torch — the PyTorch + CUDA port of ``mmdyn_tpu`` for NVIDIA Hopper.

The module layout mirrors ``mmdyn_tpu`` so each counterpart is found at the
same path:

* ``mmdyn_tpu_torch.ops``      — PoE fusion, reparameterisation, ELBO losses,
  and the two hand-written CUDA kernels (``ops/kernels.py``, ``ops/csrc``).
* ``mmdyn_tpu_torch.models``   — layers, the VAE, the multimodal VAE, the
  regressor, the factory.
* ``mmdyn_tpu_torch.problems`` — problem config, batch parsing and
  augmentation, the losses of every family.
* ``mmdyn_tpu_torch.train``    — train state and the train / eval / sample steps.
* ``mmdyn_tpu_torch.data``     — compiling simulator dumps into a corpus, the
  corpus reader, the splits and the loader.
* ``mmdyn_tpu_torch.serve``    — the inference session, export, the HTTP server.
* ``mmdyn_tpu_torch.parallel`` — data parallelism over processes, one per
  device (``torch.distributed``).
* ``mmdyn_tpu_torch.sim``      — the simulator's host scene code and its batched
  device half (rollouts, raycast and tactile frames).
* ``mmdyn_tpu_torch.utils``    — device resolution, weights carried over from
  the JAX package's flax parameters, the run-length wire of the dumps.
* ``mmdyn_tpu_torch.cli``      — the training, evaluation, serving and data
  collection (simulator) entry points.

The port imports torch and numpy only. Its entry points place everything on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
