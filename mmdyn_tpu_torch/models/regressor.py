"""CNN pose regressor baseline (port of ``mmdyn_tpu/models/regressor.py``;
reference mmdyn/pytorch/models/models.py:28-77).

The encoders' DCGAN conv trunk, FC 6400 -> 512 + Swish + Dropout(0.1), an
optional condition concat, then an MLP head 512(+S) -> 256 -> 256 -> out_dim
(the 7-D pose by default). Parameters are named as the reference's torch
``state_dict``: ``conv_net.*`` and ``fc_net.0`` at the top, ``out_net.0/2/4``
for the head. ``compute_dtype`` is the activation policy of every conv and
Linear; the pose comes out float32 under every policy (regressor.py:61-63).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mmdyn_tpu_torch.config import DROPOUT_RATE
from mmdyn_tpu_torch.models.layers import Linear, Swish, dropout
from mmdyn_tpu_torch.models.vae import BOTTLENECK, condition_width, conv_trunk


class Regressor(nn.Module):
    def __init__(self, out_dim: int = 7, conditional: bool = False,
                 condition_dim: Optional[int] = None,
                 dropout_rate: float = DROPOUT_RATE, compute_dtype: str = "float32",
                 bn_mode: str = "batch"):
        super().__init__()
        self.conditional = conditional
        self.dropout_rate = dropout_rate
        dt = compute_dtype
        self.conv_net = conv_trunk(dt, bn_mode)
        self.fc_net = nn.Sequential(
            Linear(math.prod(BOTTLENECK), 512, compute_dtype=dt), Swish())
        fan_in = 512 + condition_width(conditional, condition_dim)
        self.out_net = nn.Sequential(
            Linear(fan_in, 256, compute_dtype=dt), nn.ReLU(),
            Linear(256, 256, compute_dtype=dt), nn.ReLU(),
            Linear(256, out_dim, compute_dtype=dt),
        )

    def forward(self, x, c=None, generator=None):
        """NHWC images (B, 64, 64, 3) and an optional (B, S) or (B,)
        condition -> (B, out_dim)."""
        h = self.conv_net(x.permute(0, 3, 1, 2).contiguous())  # NHWC -> NCHW
        h = dropout(self.fc_net(h.flatten(1)), self.dropout_rate, generator)
        # the condition joins only when given (regressor.py:52-55)
        if self.conditional and c is not None:
            if c.dim() == 1:
                c = c[:, None]
            h = torch.cat([h, c.to(h.dtype)], dim=-1)
        return self.out_net(h).float()
