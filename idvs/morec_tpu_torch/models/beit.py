"""BEiT encoder (JAX twin: models/beit.py), the fine-tuned-checkpoint
geometry the reference dispatches through its Vit_Encoder wrapper
(inbatch_sasrec_e2e_vision/run.py:6, model/model.py:24-29): a ``VisionTower``
of kind "swin", the pooled output under the ``classifier``.

Patch embedding and a CLS token (no absolute positions); pre-LN blocks
whose attention (key without bias; float32 logits plus the block's
relative position bias, a float32 softmax) and MLP (``ops/cuda/mlp.py``
``fused_mlp``, the residual added here) are scaled by the layer-scale
vectors ``lambda_1`` / ``lambda_2``; the pooler is the LayerNorm of the mean
of the patch tokens (BeitPooler, use_mean_pooling). Names follow the Flax
tree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .layers import (Dense, LayerNorm, attention, hf_config, lecun_normal_,
                     on_device, pre_ln_mlp)
from .swin import PatchProject

# HF BeitConfig's defaults of the keys read (transformers 4.57): note
# use_relative_position_bias False, where BEiT-B's fine-tuned config says
# true
HF_BEIT = dict(image_size=224, patch_size=16, num_channels=3,
               hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, layer_norm_eps=1e-12,
               use_relative_position_bias=False, layer_scale_init_value=0.1,
               use_mean_pooling=True, use_shared_relative_position_bias=False,
               use_absolute_position_embeddings=False, use_mask_token=False,
               hidden_act="gelu", hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
# what HF's modeling_beit.py builds from keys this model does not follow:
# one relative position bias shared by the layers, absolute positions, a
# mask token (a parameter, which shifts the freezing index), the CLS
# token's LayerNorm for a pooler, no layer scale, another activation,
# dropout. HF's drop_path_rate (0.1 in BEiT-B's config) is not followed
# either and is not refused: it acts in training only, and refusing it
# would refuse every published BEiT (C15)
HF_BEIT_BUILT = dict(use_shared_relative_position_bias=False,
                     use_absolute_position_embeddings=False,
                     use_mask_token=False, use_mean_pooling=True,
                     layer_scale_init_value=lambda v: v > 0,
                     hidden_act="gelu", hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)


@dataclasses.dataclass(frozen=True)
class BeitConfig:
    """Defaults are BEiT-B/16."""
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    use_relative_position_bias: bool = True
    layer_scale_init_value: float = 0.1
    use_mean_pooling: bool = True

    @classmethod
    def from_dict(cls, hf: dict) -> "BeitConfig":
        """From HF's ``config.json`` as a dict (JAX beit.py ``from_hf``), a
        key it lacks at HF BeitConfig's default."""
        return hf_config(cls, hf, HF_BEIT, HF_BEIT_BUILT)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def _beit_rel_pos_index(grid: int) -> np.ndarray:
    """(1 + g^2, 1 + g^2) rows of the ((2g - 1)^2 + 3, heads) bias table
    (HF BeitRelativePositionBias: three more rows for cls-to-token,
    token-to-cls and cls-to-cls; JAX beit.py:54-71)."""
    n = grid * grid
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += grid - 1
    rel[..., 1] += grid - 1
    rel[..., 0] *= 2 * grid - 1
    idx = np.zeros((n + 1, n + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    num_rel = (2 * grid - 1) ** 2
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


class BeitLayer(nn.Module):
    def __init__(self, cfg: BeitConfig, device=None):
        super().__init__()
        device = on_device(device)
        H, F, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        dense = lambda i, o, bias=True: Dense(i, o, bias, init=lecun_normal_,
                                              device=device)
        self.cfg, self.n_heads = cfg, cfg.num_attention_heads
        self.layernorm_before = LayerNorm(H, eps, device=device)
        self.query, self.key = dense(H, H), dense(H, H, bias=False)
        self.value, self.attention_output = dense(H, H), dense(H, H)
        if cfg.use_relative_position_bias:
            self.relative_position_bias_table = nn.Parameter(torch.empty(
                (2 * cfg.grid - 1) ** 2 + 3, self.n_heads, device=device))
            self.register_buffer("rel_index", torch.from_numpy(
                _beit_rel_pos_index(cfg.grid).reshape(-1)).to(device),
                persistent=False)
        self.lambda_1 = nn.Parameter(torch.empty(H, device=device))
        self.layernorm_after = LayerNorm(H, eps, device=device)
        self.intermediate, self.output = dense(H, F), dense(F, H)
        self.lambda_2 = nn.Parameter(torch.empty(H, device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            if self.cfg.use_relative_position_bias:
                self.relative_position_bias_table.zero_()
            self.lambda_1.fill_(self.cfg.layer_scale_init_value)
            self.lambda_2.fill_(self.cfg.layer_scale_init_value)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        T = x.shape[1]
        h = self.layernorm_before(x)
        bias = None
        if self.cfg.use_relative_position_bias:
            bias = self.relative_position_bias_table[self.rel_index]
            bias = bias.reshape(T, T, self.n_heads).permute(2, 0, 1)
        ctx = attention(self.query(h), self.key(h), self.value(h),
                        self.n_heads, bias=bias)
        x = x + self.lambda_1.to(x.dtype) * self.attention_output(ctx)
        h = pre_ln_mlp(x, self.layernorm_after, self.intermediate,
                       self.output)
        return x + self.lambda_2.to(x.dtype) * h


class BeitModel(nn.Module):
    """Normalised NHWC images -> pooled (N, H): the LayerNorm of the mean of
    the patch tokens."""

    def __init__(self, cfg: BeitConfig, device=None):
        super().__init__()
        device = on_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.patch_projection = PatchProject(cfg.patch_size,
                                             cfg.num_channels, H,
                                             device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, H, device=device))
        self.n_layers = cfg.num_hidden_layers
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", BeitLayer(cfg, device=device))
        self.pooler_ln = LayerNorm(H, cfg.layer_norm_eps, device=device)

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.cls_token.zero_()

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        H = self.cfg.hidden_size
        patches = self.patch_projection(x)
        B = patches.shape[0]
        patches = patches.reshape(B, -1, H)
        h = torch.cat([self.cls_token.to(patches.dtype).expand(B, 1, H),
                       patches], dim=1)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, generator)
        # the mean in float32, as XLA's
        return self.pooler_ln(h[:, 1:].float().mean(1).to(h.dtype))


def beit_param_order(cfg: BeitConfig) -> List[Tuple[str, tuple]]:
    """[(HF name, Flax path)] in HF BeitModel's ``named_parameters()``
    order (JAX beit.py ``beit_torch_param_order``)."""
    order = [("embeddings.cls_token", ("cls_token",)),
             ("embeddings.patch_embeddings.projection.weight",
              ("patch_projection", "kernel")),
             ("embeddings.patch_embeddings.projection.bias",
              ("patch_projection", "bias"))]
    for i in range(cfg.num_hidden_layers):
        t, f = f"encoder.layer.{i}.", f"layer_{i}"
        a = t + "attention.attention."
        order += [
            (t + "lambda_1", (f, "lambda_1")),
            (t + "lambda_2", (f, "lambda_2")),
            (a + "query.weight", (f, "query", "kernel")),
            (a + "query.bias", (f, "query", "bias")),
            (a + "key.weight", (f, "key", "kernel")),
            (a + "value.weight", (f, "value", "kernel")),
            (a + "value.bias", (f, "value", "bias")),
            (a + "relative_position_bias.relative_position_bias_table",
             (f, "relative_position_bias_table")),
            (t + "attention.output.dense.weight",
             (f, "attention_output", "kernel")),
            (t + "attention.output.dense.bias",
             (f, "attention_output", "bias")),
            (t + "intermediate.dense.weight", (f, "intermediate", "kernel")),
            (t + "intermediate.dense.bias", (f, "intermediate", "bias")),
            (t + "output.dense.weight", (f, "output", "kernel")),
            (t + "output.dense.bias", (f, "output", "bias")),
            (t + "layernorm_before.weight", (f, "layernorm_before", "scale")),
            (t + "layernorm_before.bias", (f, "layernorm_before", "bias")),
            (t + "layernorm_after.weight", (f, "layernorm_after", "scale")),
            (t + "layernorm_after.bias", (f, "layernorm_after", "bias")),
        ]
    return order + [("pooler.layernorm.weight", ("pooler_ln", "scale")),
                    ("pooler.layernorm.bias", ("pooler_ln", "bias"))]


def beit_frozen_paths(cfg: BeitConfig, freeze_before: int,
                      prefix: tuple = ()) -> set:
    """Flax paths of the parameters with index < freeze_before in HF's
    order."""
    return {prefix + fpath for idx, (_, fpath)
            in enumerate(beit_param_order(cfg)) if idx < freeze_before}
