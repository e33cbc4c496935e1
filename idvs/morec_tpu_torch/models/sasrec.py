"""SASRec user encoder (JAX twin: models/sasrec.py).

Learned positions, an input LayerNorm (eps 1e-6) and dropout, then post-LN
blocks:
multi-head self-attention under the causal, key-validity additive mask with
no biases on Q/K/V/fc, and a ReLU FFN 4*d wide. The attention runs through
the ``fused_mha`` kernel with the (B, 1, L, L) mask shared by all heads;
both post-LN tails run through the epilogue kernels (the fc tail with a zero
bias, as the JAX package passes it). In training mode (``module.train()``)
the input, the attention probabilities and both tails drop at
``drop_rate``, each site with its own seed from the generator passed to
``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda.attention import fused_mha
from ..ops.cuda.mlp import fused_mlp_resln, fused_proj_resln
from ..ops.masking import causal_additive_mask
from .layers import (Dense, Dropout, Embed, LayerNorm, drop_call,
                     xavier_normal_)

EPS = 1e-6


class MultiHeadSelfAttention(nn.Module):
    """Returns the (B, L, d) context; the ``fc`` output projection is
    applied by the block's fused tail."""

    def __init__(self, d_model: int, n_heads: int, drop_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.drop_rate = drop_rate
        proj = lambda: Dense(d_model, d_model, bias=False,
                             init=xavier_normal_, device=device)
        self.w_Q, self.w_K, self.w_V, self.fc = proj(), proj(), proj(), proj()

    def forward(self, x: torch.Tensor, att_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        # one fused QKV matmul, as the JAX package runs it outside any kernel
        w = torch.cat([self.w_Q.weight, self.w_K.weight, self.w_V.weight],
                      dim=1).to(x.dtype)
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        return fused_mha(x @ w, bias=att_mask, n_heads=self.n_heads,
                         drop_rate=rate, seed=seed)


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, drop_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.mha = MultiHeadSelfAttention(d_model, n_heads, drop_rate,
                                          device=device)
        self.ln_attn = LayerNorm(d_model, EPS, device=device)
        self.ln_ffn = LayerNorm(d_model, EPS, device=device)
        self.w_1 = Dense(d_model, 4 * d_model, init=xavier_normal_,
                         device=device)
        self.w_2 = Dense(4 * d_model, d_model, init=xavier_normal_,
                         device=device)

    def forward(self, x: torch.Tensor, att_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        ctx = self.mha(x, att_mask, generator)
        fc = self.mha.fc.weight
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        x1 = fused_proj_resln(ctx, x, fc, torch.zeros_like(fc[0]),
                              ln=(self.ln_attn.weight, self.ln_attn.bias),
                              eps=EPS, drop_rate=rate, seed=seed)
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        return fused_mlp_resln(x1, self.w_1.weight, self.w_1.bias,
                               self.w_2.weight, self.w_2.bias,
                               ln=(self.ln_ffn.weight, self.ln_ffn.bias),
                               eps=EPS, act="relu", drop_rate=rate,
                               seed=seed)


class SASRecEncoder(nn.Module):
    """(B, L, d) item embeddings + (B, L) validity mask -> (B, L, d)
    per-position user states."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int,
                 max_seq_len: int, drop_rate: float = 0.0, device=None):
        super().__init__()
        self.position_embedding = Embed(max_seq_len, d_model,
                                        init=xavier_normal_, device=device)
        self.ln_in = LayerNorm(d_model, EPS, device=device)
        self.dropout = Dropout(drop_rate)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, drop_rate, device=device))

    def forward(self, input_embs: torch.Tensor, log_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        L = input_embs.shape[1]
        x = input_embs + self.position_embedding.weight[:L]
        x = self.dropout(self.ln_in(x), generator)
        att_mask = causal_additive_mask(log_mask)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, att_mask, generator)
        return x
