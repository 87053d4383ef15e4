"""Model families: the VAE, the multimodal VAE (PoE) and the regressor."""

from mmdyn_tpu_torch.models.factory import count_parameters, model_kwargs, setup_model
from mmdyn_tpu_torch.models.regressor import Regressor
from mmdyn_tpu_torch.models.vae import MVAE, VAE, Decoder, Encoder
