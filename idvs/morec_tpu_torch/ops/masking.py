"""Attention masks (JAX twin: idvs/morec_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def causal_additive_mask(log_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 0/1 validity mask -> (B, 1, L, L) float32 additive mask.

    mask[b, 0, q, k] = 0 iff k <= q and log_mask[b, k] != 0, else -1e9 (the
    reference's tril(expand(log_mask != 0))). The value is -1e9 and not -inf
    so that a left-padded row whose keys are all masked still softmaxes to
    finite uniform probabilities.
    """
    B, L = log_mask.shape
    key_valid = (log_mask != 0)[:, None, None, :]
    tri = torch.ones(L, L, dtype=torch.bool,
                     device=log_mask.device).tril()[None, None]
    keep = key_valid & tri
    zero = torch.zeros((), dtype=torch.float32, device=log_mask.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def label_columns(B: int, L: int, device=None) -> torch.Tensor:
    """(B, L) in-batch CE label column of row (i, j): i * (L + 1) + j + 1,
    the next item of user i in the flattened (B * (L + 1)) candidates."""
    rows = torch.arange(B, device=device)[:, None] * (L + 1)
    return rows + torch.arange(1, L + 1, device=device)[None, :]
