"""OPT decoder (JAX twin: models/opt.py), the reference's third text-encoder
family (inbatch_sasrec_e2e_text/run.py:41-47, pooled by masked mean).

The 125m-class geometry (pre-LN blocks, no word_embed_proj, a final
LayerNorm): the word table (``ScatterEmbed``: its gradient through the
``scatter_add_rows`` kernel) plus learned positions at offset 2, whose ids
follow the running count of the attention mask; pre-LN blocks whose
attention scales q by dh^-0.5 before the product (float32 scores plus the
padding and causal bias, a float32 softmax cast back, then the attention
dropout; plain PyTorch, as the JAX package runs no kernel there) and whose
ReLU FFN runs ``layers.pre_ln_mlp`` on ``ops/cuda/mlp.py``'s kernels:
``fused_mlp_res`` (the residual inside) in eval mode, ``fused_mlp`` with
``save_h`` then dropout and the residual in training mode (JAX
opt.py:142-152). Names follow the Flax tree.

``OPTConfig.from_dict`` reads HF's ``config.json`` and refuses the
geometries the JAX package's ``from_hf`` ignores and would build wrong
(ROADMAP C14): a post-LN block (``do_layer_norm_before`` false), a
projected word table (``word_embed_proj_dim`` != hidden), bias-free
projections, no final LayerNorm; OPT-350m is such a config.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from .bert import ScatterEmbed
from .layers import (Dense, Dropout, Embed, LayerNorm, attention, on_device,
                     pre_ln_mlp)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    """Defaults are OPT-125M's (and HF OPTConfig's)."""
    vocab_size: int = 50272
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 2048
    dropout: float = 0.1
    attention_dropout: float = 0.0
    pad_token_id: int = 1
    position_offset: int = 2

    @classmethod
    def from_dict(cls, hf: dict) -> "OPTConfig":
        """From HF's ``config.json`` as a dict; a key it lacks takes HF
        OPTConfig's default."""
        H = hf.get("hidden_size", cls.hidden_size)
        proj = hf.get("word_embed_proj_dim")
        refused = [
            ("do_layer_norm_before", not hf.get("do_layer_norm_before",
                                                True)),
            ("word_embed_proj_dim", proj is not None and proj != H),
            ("enable_bias", not hf.get("enable_bias", True)),
            ("_remove_final_layer_norm",
             hf.get("_remove_final_layer_norm", False))]
        bad = [k for k, refuse in refused if refuse]
        if bad:
            raise NotImplementedError(
                f"OPT config with {', '.join(f'{k}={hf.get(k)!r}' for k in bad)}"
                f": only the pre-LN 125m-class block is ported (a post-LN "
                f"block, a projected word table, bias-free projections or no "
                f"final LayerNorm, as OPT-350m, are not)")
        return cls(vocab_size=hf.get("vocab_size", cls.vocab_size),
                   hidden_size=H,
                   num_hidden_layers=hf.get("num_hidden_layers",
                                            cls.num_hidden_layers),
                   num_attention_heads=hf.get("num_attention_heads",
                                              cls.num_attention_heads),
                   ffn_dim=hf.get("ffn_dim", cls.ffn_dim),
                   max_position_embeddings=hf.get(
                       "max_position_embeddings",
                       cls.max_position_embeddings),
                   dropout=hf.get("dropout", cls.dropout),
                   attention_dropout=hf.get("attention_dropout",
                                            cls.attention_dropout),
                   pad_token_id=hf.get("pad_token_id", cls.pad_token_id))


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.q_proj = Dense(H, H, device=device)
        self.k_proj = Dense(H, H, device=device)
        self.v_proj = Dense(H, H, device=device)
        self.out_proj = Dense(H, H, device=device)
        self.drop = Dropout(cfg.attention_dropout)

    def forward(self, hidden: torch.Tensor, att_bias: torch.Tensor,
                generator=None) -> torch.Tensor:
        dh = hidden.shape[-1] // self.n_heads
        # HF scales the query before the product
        ctx = attention(self.q_proj(hidden) * (dh ** -0.5),
                        self.k_proj(hidden), self.v_proj(hidden),
                        self.n_heads, scaled=True, bias=att_bias,
                        drop=self.drop, generator=generator)
        return self.out_proj(ctx)


class OPTLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        H, F = cfg.hidden_size, cfg.ffn_dim
        self.self_attn_layer_norm = LayerNorm(H, 1e-5, device=device)
        self.self_attn = OPTAttention(cfg, device=device)
        self.final_layer_norm = LayerNorm(H, 1e-5, device=device)
        self.fc1 = Dense(H, F, device=device)
        self.fc2 = Dense(F, H, device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, hidden: torch.Tensor, att_bias: torch.Tensor,
                generator=None) -> torch.Tensor:
        h = self.self_attn(self.self_attn_layer_norm(hidden), att_bias,
                           generator)
        hidden = hidden + self.drop(h, generator)
        mlp = (self.final_layer_norm, self.fc1, self.fc2)
        if not self.training:
            return pre_ln_mlp(hidden, *mlp, act="relu", residual=True)
        return hidden + self.drop(pre_ln_mlp(hidden, *mlp, act="relu"),
                                  generator)


class OPTModel(nn.Module):
    """input_ids + attention_mask (B, T) -> last hidden state (B, T, H)."""

    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        device = on_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed_tokens = ScatterEmbed(cfg.vocab_size, H, device=device)
        self.embed_positions = Embed(
            cfg.max_position_embeddings + cfg.position_offset, H,
            device=device)
        self.drop = Dropout(cfg.dropout)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", OPTLayer(cfg, device=device))
        self.final_layer_norm = LayerNorm(H, 1e-5, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        c = self.cfg
        T = input_ids.shape[1]
        mask = attention_mask.long()
        # HF OPT's positions, JAX's rule at the pads (0 + offset)
        positions = ((torch.cumsum(mask, dim=1) * mask - 1).clamp_min(0)
                     + c.position_offset)
        h = self.embed_tokens(input_ids) + self.embed_positions(positions)
        h = self.drop(h, generator)
        pad_bias = ((1.0 - attention_mask.float())[:, None, None, :]
                    * -1e9)
        causal = torch.zeros(T, T, device=h.device).masked_fill(
            ~torch.ones(T, T, dtype=torch.bool, device=h.device).tril(),
            -1e9)
        att_bias = pad_bias + causal
        for i in range(c.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h, att_bias, generator)
        return self.final_layer_norm(h)


def opt_param_order(num_layers: int
                    ) -> List[Tuple[str, Optional[Tuple[str, ...]]]]:
    """[(HF name, Flax path)] in HF ``OPTModel.named_parameters()`` order
    (JAX opt.py ``opt_torch_param_order``): the decoder's embed_tokens,
    embed_positions, final_layer_norm, then each layer's k, v, q and out
    projections, self_attn_layer_norm, fc1, fc2, final_layer_norm."""
    order: List[Tuple[str, Optional[Tuple[str, ...]]]] = [
        ("decoder.embed_tokens.weight", ("embed_tokens", "embedding")),
        ("decoder.embed_positions.weight", ("embed_positions", "embedding")),
        ("decoder.final_layer_norm.weight", ("final_layer_norm", "scale")),
        ("decoder.final_layer_norm.bias", ("final_layer_norm", "bias")),
    ]
    leaves = (("self_attn.k_proj", ("self_attn", "k_proj"), "kernel"),
              ("self_attn.v_proj", ("self_attn", "v_proj"), "kernel"),
              ("self_attn.q_proj", ("self_attn", "q_proj"), "kernel"),
              ("self_attn.out_proj", ("self_attn", "out_proj"), "kernel"),
              ("self_attn_layer_norm", ("self_attn_layer_norm",), "scale"),
              ("fc1", ("fc1",), "kernel"), ("fc2", ("fc2",), "kernel"),
              ("final_layer_norm", ("final_layer_norm",), "scale"))
    for i in range(num_layers):
        t, L = f"decoder.layers.{i}.", f"layer_{i}"
        for hf, path, w in leaves:
            order += [(f"{t}{hf}.weight", (L, *path, w)),
                      (f"{t}{hf}.bias", (L, *path, "bias"))]
    return order
