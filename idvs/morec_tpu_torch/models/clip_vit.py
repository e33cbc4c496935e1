"""CLIP vision encoder (JAX twin: models/clip_vit.py), which the reference
imports (inbatch_sasrec_e2e_vision/run.py:6): a ``VisionTower`` of kind
"swin", the pooled output under the ``classifier``.

A bias-less patch convolution, the class embedding and learned positions,
``pre_layrnorm`` (sic, HF's name), pre-LN blocks whose attention scales q
before the product (float32 logits and softmax) and whose MLP takes
quick_gelu (x * sigmoid(1.702 x)) on ``ops/cuda/mlp.py``'s kernels:
``fused_mlp_res`` in eval mode, ``fused_mlp`` with the residual added here
in training mode (JAX :76-79); the pooled output is the post-LayerNorm of
the CLS row. Names follow the Flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from .layers import (Dense, Embed, LayerNorm, attention, hf_config,
                     lecun_normal_, normal_, on_device, pre_ln_mlp)
from .swin import PatchProject

# HF CLIPVisionConfig's defaults of the keys read (transformers 4.57)
HF_CLIP = dict(image_size=224, patch_size=32, num_channels=3,
               hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, layer_norm_eps=1e-5,
               hidden_act="quick_gelu", attention_dropout=0.0)
# what HF's modeling_clip.py builds from keys this model does not follow:
# another activation, dropout of the attention probabilities
HF_CLIP_BUILT = dict(hidden_act="quick_gelu", attention_dropout=0.0)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults are CLIP ViT-B/32's vision tower."""
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, hf: dict) -> "CLIPVisionConfig":
        """From HF's ``config.json`` as a dict (JAX clip_vit.py
        ``from_hf``): a ``CLIPModel``'s ``vision_config`` or a
        ``CLIPVisionModel``'s own keys, a key it lacks at HF
        CLIPVisionConfig's default."""
        return hf_config(cls, hf.get("vision_config", hf), HF_CLIP,
                         HF_CLIP_BUILT)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        H, F, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        dense = lambda i, o: Dense(i, o, init=lecun_normal_, device=device)
        self.n_heads = cfg.num_attention_heads
        self.layer_norm1 = LayerNorm(H, eps, device=device)
        self.q_proj, self.k_proj = dense(H, H), dense(H, H)
        self.v_proj, self.out_proj = dense(H, H), dense(H, H)
        self.layer_norm2 = LayerNorm(H, eps, device=device)
        self.fc1, self.fc2 = dense(H, F), dense(F, H)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = self.layer_norm1(x)
        dh = x.shape[-1] // self.n_heads
        ctx = attention(self.q_proj(h) * (dh ** -0.5), self.k_proj(h),
                        self.v_proj(h), self.n_heads, scaled=True)
        x = x + self.out_proj(ctx)
        mlp = (self.layer_norm2, self.fc1, self.fc2)
        if not self.training:
            return pre_ln_mlp(x, *mlp, act="quick_gelu", residual=True)
        return x + pre_ln_mlp(x, *mlp, act="quick_gelu")


class CLIPVisionModel(nn.Module):
    """Normalised NHWC images -> pooled (N, H): the post-LayerNorm of the
    CLS row."""

    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        device = on_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.patch_projection = PatchProject(cfg.patch_size,
                                             cfg.num_channels, H, bias=False,
                                             device=device)
        self.class_embedding = nn.Parameter(torch.empty(H, device=device))
        self.position_embedding = Embed(cfg.num_positions, H, device=device)
        self.pre_layrnorm = LayerNorm(H, cfg.layer_norm_eps, device=device)
        self.n_layers = cfg.num_hidden_layers
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg, device=device))
        self.post_layernorm = LayerNorm(H, cfg.layer_norm_eps, device=device)

    def reset_parameters(self, generator) -> None:
        normal_(0.02)(self.class_embedding, generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        H = self.cfg.hidden_size
        patches = self.patch_projection(x)
        B = patches.shape[0]
        patches = patches.reshape(B, -1, H)
        cls = self.class_embedding.to(patches.dtype).expand(B, 1, H)
        h = torch.cat([cls, patches], dim=1)
        h = h + self.position_embedding.weight[:h.shape[1]].to(h.dtype)
        h = self.pre_layrnorm(h)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, generator)
        return self.post_layernorm(h[:, 0])


def clip_param_order(cfg: CLIPVisionConfig) -> List[Tuple[str, tuple]]:
    """[(HF name, Flax path)] in HF CLIPVisionModel's
    ``named_parameters()`` order (JAX clip_vit.py
    ``clip_torch_param_order``)."""
    P = "vision_model."
    order = [(P + "embeddings.class_embedding", ("class_embedding",)),
             (P + "embeddings.patch_embedding.weight",
              ("patch_projection", "kernel")),
             (P + "embeddings.position_embedding.weight",
              ("position_embedding", "embedding")),
             (P + "pre_layrnorm.weight", ("pre_layrnorm", "scale")),
             (P + "pre_layrnorm.bias", ("pre_layrnorm", "bias"))]
    leaves = (("self_attn.k_proj", "k_proj"), ("self_attn.v_proj", "v_proj"),
              ("self_attn.q_proj", "q_proj"),
              ("self_attn.out_proj", "out_proj"),
              ("layer_norm1", "layer_norm1"), ("mlp.fc1", "fc1"),
              ("mlp.fc2", "fc2"), ("layer_norm2", "layer_norm2"))
    for i in range(cfg.num_hidden_layers):
        t, f = P + f"encoder.layers.{i}.", f"layer_{i}"
        for hf, port in leaves:
            w = "scale" if port.startswith("layer_norm") else "kernel"
            order += [(f"{t}{hf}.weight", (f, port, w)),
                      (f"{t}{hf}.bias", (f, port, "bias"))]
    return order + [(P + "post_layernorm.weight", ("post_layernorm", "scale")),
                    (P + "post_layernorm.bias", ("post_layernorm", "bias"))]


def clip_frozen_paths(cfg: CLIPVisionConfig, freeze_before: int,
                      prefix: tuple = ()) -> set:
    """Flax paths of the parameters with index < freeze_before in HF's
    order."""
    return {prefix + fpath for idx, (_, fpath)
            in enumerate(clip_param_order(cfg)) if idx < freeze_before}
