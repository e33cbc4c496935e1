"""ViT-MAE encoder (JAX twin: models/vit_mae.py), the reference's MAE tower
(inbatch_sasrec_e2e_vision/model/encoders.py:7-21: the CLS row of the last
hidden state under a Dense and a GELU, ``VisionTower`` kind "mae").

As HF's ViTMAEModel, which the reference keeps, every forward masks
``mask_ratio`` of the patches at random: each image's patches are ordered
by uniform noise and the first ``len_keep`` kept (JAX :130-137; a stable
argsort). The noise is passed in, or drawn on the host from a
``torch.Generator``: the one handed down the forward calls in training
mode (the train step's), and in eval mode a fresh one seeded with
``EVAL_MASK_SEED`` a call, as the JAX encode seeds its ``masking`` key with
0 (train/evaluate.py:59), so two encodes of a catalog agree. The bits
cannot be JAX's (another generator): ROADMAP C, expected differences.

The fixed 2D sin-cos table is the initial value of the trainable
``position_embeddings`` (HF stores it in its checkpoints; JAX makes it a
param). Pre-LN blocks with plain attention (float32 logits and softmax)
and the pre-LN MLP on ``ops/cuda/mlp.py``'s kernels: ``fused_mlp_res``
in eval mode, ``fused_mlp`` with the residual added here in training mode
(JAX :93-99). Names follow the Flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import (Dense, Dropout, LayerNorm, attention, hf_config,
                     lecun_normal_, normal_, on_device, pre_ln_mlp)
from .swin import PatchProject

EVAL_MASK_SEED = 0
# HF ViTMAEConfig's defaults of the keys read (transformers 4.57)
HF_VIT_MAE = dict(image_size=224, patch_size=16, num_channels=3,
                  hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, intermediate_size=3072,
                  layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, mask_ratio=0.75,
                  qkv_bias=True, hidden_act="gelu")
# what HF's modeling_vit_mae.py builds from keys this model does not
# follow: bias-free q, k and v, another activation
HF_VIT_MAE_BUILT = dict(qkv_bias=True, hidden_act="gelu")


@dataclasses.dataclass(frozen=True)
class ViTMAEConfig:
    """Defaults are ViT-MAE-B/16."""
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    mask_ratio: float = 0.75

    @classmethod
    def from_dict(cls, hf: dict) -> "ViTMAEConfig":
        """From HF's ``config.json`` as a dict (JAX vit_mae.py
        ``from_hf``), a key it lacks at HF ViTMAEConfig's default."""
        return hf_config(cls, hf, HF_VIT_MAE, HF_VIT_MAE_BUILT)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def sincos_pos_embed(hidden: int, grid: int) -> np.ndarray:
    """(1, 1 + grid^2, hidden) float32 2D sin-cos table, the CLS row zero
    (HF ViTMAE's; JAX vit_mae.py:55-68)."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    emb = np.concatenate([_1d(hidden // 2, gx), _1d(hidden // 2, gy)], axis=1)
    emb = np.concatenate([np.zeros((1, hidden)), emb], axis=0)
    return emb[None].astype(np.float32)


def masking_noise(n: int, length: int, generator: torch.Generator,
                  device) -> torch.Tensor:
    """(n, length) uniform noise that orders each image's patches, drawn
    on the host from ``generator`` and moved to ``device``."""
    return torch.rand((n, length), generator=generator).to(device)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTMAEConfig, device=None):
        super().__init__()
        H, F, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        dense = lambda i, o: Dense(i, o, init=lecun_normal_, device=device)
        self.n_heads = cfg.num_attention_heads
        self.layernorm_before = LayerNorm(H, eps, device=device)
        self.query, self.key, self.value = (dense(H, H), dense(H, H),
                                            dense(H, H))
        self.attention_output = dense(H, H)
        self.layernorm_after = LayerNorm(H, eps, device=device)
        self.intermediate, self.output = dense(H, F), dense(F, H)
        self.attn_drop = Dropout(cfg.attention_probs_dropout_prob)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = self.layernorm_before(x)
        ctx = attention(self.query(h), self.key(h), self.value(h),
                        self.n_heads, drop=self.attn_drop,
                        generator=generator)
        x = x + self.dropout(self.attention_output(ctx), generator)
        mlp = (self.layernorm_after, self.intermediate, self.output)
        if not self.training:
            return pre_ln_mlp(x, *mlp, residual=True)
        return x + self.dropout(pre_ln_mlp(x, *mlp), generator)


class ViTMAEModel(nn.Module):
    """Normalised NHWC images -> the last hidden state (N, 1 + len_keep,
    H), CLS at row 0."""

    def __init__(self, cfg: ViTMAEConfig, device=None):
        super().__init__()
        device = on_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.patch_projection = PatchProject(cfg.patch_size,
                                             cfg.num_channels, H,
                                             device=device)
        self.position_embeddings = nn.Parameter(torch.empty(
            1, 1 + cfg.num_patches, H, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, H, device=device))
        self.n_layers = cfg.num_hidden_layers
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", ViTLayer(cfg, device=device))
        self.layernorm = LayerNorm(H, cfg.layer_norm_eps, device=device)

    def reset_parameters(self, generator) -> None:
        c = self.cfg
        table = sincos_pos_embed(c.hidden_size, c.image_size // c.patch_size)
        with torch.no_grad():
            self.position_embeddings.copy_(torch.from_numpy(table))
        normal_(0.02)(self.cls_token, generator)

    def forward(self, x: torch.Tensor, generator=None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        patches = self.patch_projection(x)
        B = patches.shape[0]
        patches = patches.reshape(B, -1, c.hidden_size)
        L = patches.shape[1]
        pos = self.position_embeddings.to(patches.dtype)
        patches = patches + pos[:, 1:]
        if c.mask_ratio > 0.0:
            if noise is None:
                if self.training and generator is None:
                    raise ValueError("ViT-MAE's masking in training mode "
                                     "needs a generator")
                gen = (generator if self.training else
                       torch.Generator().manual_seed(EVAL_MASK_SEED))
                noise = masking_noise(B, L, gen, patches.device)
            keep = torch.argsort(noise, dim=1, stable=True)
            keep = keep[:, :int(L * (1 - c.mask_ratio))]
            patches = torch.take_along_dim(patches, keep[:, :, None], dim=1)
        cls = (self.cls_token.to(patches.dtype) + pos[:, :1]).expand(
            B, 1, c.hidden_size)
        h = torch.cat([cls, patches], dim=1)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, generator)
        return self.layernorm(h)


def vit_mae_param_order(cfg: ViTMAEConfig) -> List[Tuple[str, tuple]]:
    """[(HF name, Flax path)] in HF ViTMAEModel's ``named_parameters()``
    order (JAX vit_mae.py ``vit_mae_torch_param_order``)."""
    order = [("embeddings.cls_token", ("cls_token",)),
             ("embeddings.position_embeddings", ("position_embeddings",)),
             ("embeddings.patch_embeddings.projection.weight",
              ("patch_projection", "kernel")),
             ("embeddings.patch_embeddings.projection.bias",
              ("patch_projection", "bias"))]
    leaves = (("attention.attention.query", "query"),
              ("attention.attention.key", "key"),
              ("attention.attention.value", "value"),
              ("attention.output.dense", "attention_output"),
              ("intermediate.dense", "intermediate"),
              ("output.dense", "output"))
    for i in range(cfg.num_hidden_layers):
        t, f = f"encoder.layer.{i}.", f"layer_{i}"
        for hf, port in leaves:
            order += [(f"{t}{hf}.weight", (f, port, "kernel")),
                      (f"{t}{hf}.bias", (f, port, "bias"))]
        for ln in ("layernorm_before", "layernorm_after"):
            order += [(f"{t}{ln}.weight", (f, ln, "scale")),
                      (f"{t}{ln}.bias", (f, ln, "bias"))]
    return order + [("layernorm.weight", ("layernorm", "scale")),
                    ("layernorm.bias", ("layernorm", "bias"))]


def vit_mae_frozen_paths(cfg: ViTMAEConfig, freeze_before: int,
                         prefix: tuple = ()) -> set:
    """Flax paths of the parameters with index < freeze_before in HF's
    order."""
    return {prefix + fpath for idx, (_, fpath)
            in enumerate(vit_mae_param_order(cfg)) if idx < freeze_before}
