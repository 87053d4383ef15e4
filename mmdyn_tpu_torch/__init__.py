"""mmdyn_tpu_torch — the PyTorch + CUDA port of ``mmdyn_tpu`` for NVIDIA Hopper.

The module layout mirrors ``mmdyn_tpu`` so each counterpart is found at the
same path:

* ``mmdyn_tpu_torch.ops``      — PoE fusion, reparameterisation, ELBO losses,
  and the two hand-written CUDA kernels (``ops/kernels.py``, ``ops/csrc``).
* ``mmdyn_tpu_torch.models``   — layers, the multimodal VAE, the factory.
* ``mmdyn_tpu_torch.problems`` — problem config, batch parsing, subset-ELBO.
* ``mmdyn_tpu_torch.train``    — train state and the train / eval / sample steps.
* ``mmdyn_tpu_torch.utils``    — device resolution, weights carried over from
  the JAX package's flax parameters.

The port imports torch and numpy only. Its entry points place everything on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
