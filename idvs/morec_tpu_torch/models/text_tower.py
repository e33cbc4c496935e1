"""Text item tower (JAX twin: models/text_tower.py).

A catalog row concatenates attributes, each packed ``[ids || attmask]``
side by side. Each attribute runs through the shared language model, is
pooled (CLS, or the masked mean), projected by ``fc`` and passed through an
exact GELU; several attributes are averaged. With ``project=False`` (the
two-stage towers' frozen encoder, reference bce_text/main-2stage(SASRec)/
model/encoders.py:79-95) the tower has no ``fc`` and returns the raw pooled
hidden, word_embedding_dim wide, averaged over the attributes. The
generator passed to ``forward`` feeds the language model's dropout in
training mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, xavier_normal_


class TextTower(nn.Module):
    def __init__(self, net: nn.Module, embedding_dim: int,
                 word_embedding_dim: int, pooling: str = "cls",
                 attr_lengths: Sequence[int] = (30,), project: bool = True,
                 device=None):
        super().__init__()
        if pooling not in ("cls", "mean"):
            raise ValueError(f"pooling must be 'cls' or 'mean', got "
                             f"{pooling!r}")
        self.net = net
        self.project = project
        if project:
            self.fc = Dense(word_embedding_dim, embedding_dim,
                            init=xavier_normal_, device=device)
        self.pooling = pooling
        self.attr_lengths = tuple(attr_lengths)

    def _pool(self, hidden: torch.Tensor,
              attmask: torch.Tensor) -> torch.Tensor:
        if self.pooling == "cls":
            return hidden[:, 0]
        m = attmask[:, :, None].to(hidden.dtype)
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)

    def _encode_attr(self, packed: torch.Tensor,
                     generator) -> torch.Tensor:
        num_words = packed.shape[1] // 2
        ids, attmask = packed[:, :num_words], packed[:, num_words:]
        pooled = self._pool(self.net(ids, attmask, generator), attmask)
        if not self.project:
            return pooled
        return F.gelu(self.fc(pooled), approximate="none")

    def forward(self, content: torch.Tensor,
                generator=None) -> torch.Tensor:
        """(N, sum(2 * attr_lengths)) token rows -> (N, embedding_dim), or
        (N, word_embedding_dim) with ``project=False``."""
        vecs, start = [], 0
        for n in self.attr_lengths:
            vecs.append(self._encode_attr(content[:, start:start + 2 * n],
                                          generator))
            start += 2 * n
        if len(vecs) == 1:
            return vecs[0]
        return torch.stack(vecs, dim=1).mean(dim=1)
