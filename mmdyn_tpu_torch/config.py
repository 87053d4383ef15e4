"""Flag registries and framework-wide constants (the port's copy of
``mmdyn_tpu/config.py``; reference mmdyn/pytorch/config.py:1-9)."""

# Training
OPTIMIZERS = ["SGD", "Adam"]
CRITERIONS = ["crossentropy"]
INPUT_TYPES = [None, "visual", "tactile", "pose", "visuotactile"]
PROBLEM_TYPES = ["regression", "reconstruction", "seq_modeling", "dyn_modeling"]

# Models
ARCHITECTURES = ["mlp", "cnn"]
MODELS = ["mlp-vae", "cnn-vae", "cnn-mvae", "regressor"]

# Numerics (reference parity constants)
POE_EPS = 1e-8          # mmdyn/pytorch/models/vae.py:311
BN_EPS = 1e-5           # torch.nn.BatchNorm2d default, used throughout vae.py
DROPOUT_RATE = 0.1      # mmdyn/pytorch/models/vae.py:213
IMAGE_SIZE = 64         # mmdyn/pytorch/problems/problems.py:111
COMPILE_SIZE = 256      # mmdyn/pytorch/utils/datasets.py:338
IMAGE_CHANNELS = 3
