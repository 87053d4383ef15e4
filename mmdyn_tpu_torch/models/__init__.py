"""Model families: so far the multimodal VAE (PoE)."""

from mmdyn_tpu_torch.models.factory import count_parameters, setup_model
from mmdyn_tpu_torch.models.vae import MVAE, Decoder, Encoder
