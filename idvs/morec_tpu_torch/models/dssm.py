"""DSSM two-tower components (JAX twin: models/dssm.py; reference
bce_text/main-end2end(DSSM)/model/).

User tower = user-ID embedding + MLPEncoder (identity when dnn_layers == 0);
item tower = ID embedding + MLPEncoder, or the modality encoder
(model.py:16-29, encoders.py:21-41).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import MLPLayers


class MLPEncoder(nn.Module):
    """GELU MLP of dnn_layers equal-width layers (the Flax ``mlp``); the
    identity when dnn_layers is 0.

    Reference bce_text/main-end2end(DSSM)/model/encoders.py:21-41.
    """

    def __init__(self, embedding_dim: int, dnn_layers: int, drop_rate: float,
                 device=None):
        super().__init__()
        if dnn_layers > 0:
            self.mlp = MLPLayers([embedding_dim] * (dnn_layers + 1),
                                 drop_rate, device=device)
        else:
            self.mlp = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x if self.mlp is None else self.mlp(x, generator)
