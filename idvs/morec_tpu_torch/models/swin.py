"""Swin Transformer (JAX twin: models/swin.py), weight-compatible with the
Flax tree and so with HF SwinModel checkpoints converted for it.

Patch embedding (space-to-depth and one matmul), pre-LN blocks of windowed
attention with a relative position bias, shifted windows on odd blocks,
patch merging between stages, a final LayerNorm and the mean pooler. Module
and parameter names follow the Flax tree (``stage_{s}_block_{b}``,
``query`` / ``key`` / ``value`` / ``attention_output``,
``layernorm_before`` / ``layernorm_after``, ``intermediate``, ``output``,
``stage_{s}_downsample.norm`` / ``.reduction``, ``patch_projection``,
``patch_norm``, ``layernorm``) and keep the Flax layouts, so
``convert.from_flax`` loads a Flax ``init`` tree as it is.

A block's attention and MLP run through the kernels of ``ops/cuda``. The
pad to a window multiple, the cyclic roll and the assembly of the score bias
(the table gather plus the shift mask) stay outside the kernels, as in the
JAX package. ``kernels`` selects the pair a block takes:

- ``"band"``: ``fused_mha_proj_band`` on the (N, Hp, Wp, C) map and
  ``fused_mlp_res`` (the residual inside the kernel);
- ``"windows"``: ``fused_mha_proj`` on partitioned windows and ``fused_mlp``
  with the residual added here. The JAX block falls back to this pair when
  a TPU kernel declines a geometry; here it is the caller's choice, with the
  same results.

In training mode DropPath draws one Bernoulli an image from the generator
handed down the forward calls: the "band" pair takes the attention's through
the ``DropPath`` module and the MLP's as the per-row scale of
``fused_mlp_res`` (the unit edition when DropPath is off), the "windows" pair
takes both through the module, as the JAX block. Two more paths run in
training mode only, as in the JAX block, where the config asks for them:

- dropout of the attention probabilities takes the window path whatever
  ``kernels`` says: the QKV product on the partitioned windows,
  ``fused_mha`` with the score bias (its relative-position table trains
  through the kernel's dbias) and the dropout inside, the output product
  (JAX swin.py:220-227);
- hidden dropout (``layers.Dropout``) drops the patch embedding after its
  LayerNorm, the attention's output and the MLP's; the MLP then runs
  ``fused_mlp`` and the ``DropPath`` module, not ``fused_mlp_res``, as the
  JAX block leaves its fused tails there.

In eval mode both rates are inert and the block runs its kernel pair. A
LayerNorm here returns its input's dtype
(`models/layers.py`), so a bf16 image stays bf16 through the tower; the
Flax tower's `nn.LayerNorm` promotes a bf16 input to its float32
parameters' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.attention import (fused_mha, fused_mha_proj,
                                  fused_mha_proj_band, window_partition,
                                  window_reverse)
from ..ops.cuda.mlp import fused_mlp, fused_mlp_res
from .layers import (Dense, DropPath, Dropout, LayerNorm, drop_call,
                     lecun_normal_, normal_, on_device)

KERNELS = ("band", "windows")


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Defaults are Swin-T; ``swin_base()`` is Swin-B."""
    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    drop_path_rate: float = 0.1
    use_absolute_embeddings: bool = False

    @classmethod
    def swin_base(cls) -> "SwinConfig":
        return cls(embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32))

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


def _rel_pos_index(w: int) -> np.ndarray:
    """(w*w, w*w) row of the bias table for each (query, key) pair."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += w - 1
    rel[..., 1] += w - 1
    rel[..., 0] *= 2 * w - 1
    return rel.sum(-1)


def _shift_mask(Hp: int, Wp: int, w: int, s: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask in {0, -100} for shifted windows."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, w * w)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_window_partition = window_partition
_window_reverse = window_reverse


def _check_kernels(kernels: str) -> None:
    if kernels not in KERNELS:
        raise ValueError(f"kernels must be one of {KERNELS}, got "
                         f"{kernels!r}")


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, n_heads: int,
                 resolution: Tuple[int, int], shift: bool, drop_path: float,
                 kernels: str = "band", device=None):
        super().__init__()
        _check_kernels(kernels)
        device = on_device(device)
        self.cfg, self.dim, self.n_heads = cfg, dim, n_heads
        self.resolution, self.kernels = tuple(resolution), kernels
        H, W = self.resolution
        self.window = min(cfg.window_size, H, W)
        self.shift = (self.window // 2
                      if shift and self.window < min(H, W) else 0)
        eps, F = cfg.layer_norm_eps, int(dim * cfg.mlp_ratio)
        dense = lambda i, o: Dense(i, o, init=lecun_normal_, device=device)
        self.layernorm_before = LayerNorm(dim, eps, device=device)
        self.query, self.key = dense(dim, dim), dense(dim, dim)
        self.value, self.attention_output = dense(dim, dim), dense(dim, dim)
        # a bare parameter, as the Flax block's self.param:
        # ((2w - 1)^2, heads)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * self.window - 1) ** 2, n_heads, device=device))
        self.layernorm_after = LayerNorm(dim, eps, device=device)
        self.intermediate, self.output = dense(dim, F), dense(F, dim)
        self.drop_path = DropPath(drop_path)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        # window bookkeeping, computed once with numpy: the table rows of
        # every (query, key) pair and, for a shifted block, the mask over
        # the padded map's windows
        w = self.window
        self.padded = (H + (w - H % w) % w, W + (w - W % w) % w)
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(w).reshape(-1)).to(device), persistent=False)
        self.register_buffer("shift_mask", torch.from_numpy(
            _shift_mask(*self.padded, w, self.shift)).to(device)
            if self.shift else None, persistent=False)

    def reset_parameters(self, generator) -> None:
        normal_(0.02)(self.relative_position_bias_table, generator)

    def rel_bias(self) -> torch.Tensor:
        """(1 or nW, heads, w*w, w*w) float score bias: the table gathered
        by relative position, plus the shift mask as a bias that is cyclic
        over an image's windows."""
        T = self.window ** 2
        bias = self.relative_position_bias_table[self.rel_index]
        bias = bias.reshape(T, T, self.n_heads).permute(2, 0, 1)[None].float()
        if self.shift:
            bias = bias + self.shift_mask[:, None]
        return bias

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self._forward(x, generator, window_path=self.training and bool(
            self.cfg.attention_probs_dropout_prob))

    def _forward(self, x: torch.Tensor, generator, window_path: bool
                 ) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        w, s = self.window, self.shift
        shortcut = x
        x = self.layernorm_before(x).reshape(B, H, W, C)
        Hp, Wp = self.padded
        pad_h, pad_w = Hp - H, Wp - W
        if pad_h or pad_w:
            x = nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        dt = x.dtype
        wqkv = torch.cat([self.query.weight, self.key.weight,
                          self.value.weight], dim=1).to(dt)
        bqkv = torch.cat([self.query.bias, self.key.bias,
                          self.value.bias]).to(dt)
        wo = self.attention_output.weight.to(dt)
        bo = self.attention_output.bias.to(dt)
        bias = self.rel_bias()
        if window_path:
            # the probabilities' dropout inside fused_mha; the products
            # around it stay plain matmuls, as in the JAX block
            rate, seed = drop_call(self.training,
                                   self.cfg.attention_probs_dropout_prob,
                                   generator)
            ctx = fused_mha(window_partition(x, w) @ wqkv + bqkv, bias=bias,
                            n_heads=self.n_heads, drop_rate=rate, seed=seed)
            x = window_reverse(ctx @ wo + bo, w, Hp, Wp)
        elif self.kernels == "band":
            x = fused_mha_proj_band(x, bias, wqkv, bqkv, wo, bo,
                                    n_heads=self.n_heads, window=w)
        else:
            wins = fused_mha_proj(window_partition(x, w), bias, wqkv, bqkv,
                                  wo, bo, n_heads=self.n_heads)
            x = window_reverse(wins, w, Hp, Wp)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        if pad_h or pad_w:
            x = x[:, :H, :W]
        x = self.dropout(x.reshape(B, L, C), generator)
        x = shortcut + self.drop_path(x, generator)

        ln = (self.layernorm_after.weight, self.layernorm_after.bias)
        mlp = (self.intermediate.weight.to(dt), self.intermediate.bias.to(dt),
               self.output.weight.to(dt), self.output.bias.to(dt))
        hidden_drop = self.training and self.cfg.hidden_dropout_prob > 0
        if self.kernels == "band" and not hidden_drop:
            # DropPath inside the kernel: its factor per image, broadcast
            # over the image's rows; the unit edition (no scale operand)
            # where DropPath is the identity
            sc = self.drop_path.scale(B, generator, x.device)
            if sc is not None:
                sc = sc[:, None].expand(B, L).reshape(-1)
            return fused_mlp_res(x, sc, *mlp, ln=ln,
                                 eps=self.cfg.layer_norm_eps)
        h = fused_mlp(x, *mlp, ln=ln, eps=self.cfg.layer_norm_eps)
        return x + self.drop_path(self.dropout(h, generator), generator)


class PatchProject(nn.Module):
    """Non-overlapping patch embedding as space-to-depth and one matmul
    over the (p, p, C, D) convolution kernel (the Flax HWIO layout, whose
    row-major (ph, pw, c) order is the space-to-depth order): the same
    linear map as the stride-p convolution. ``bias=False``: CLIP's
    bias-less patch convolution."""

    def __init__(self, patch: int, in_channels: int, features: int,
                 bias: bool = True, device=None):
        super().__init__()
        device = on_device(device)
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(patch, patch, in_channels,
                                               features, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if bias else None)

    def reset_parameters(self, generator) -> None:
        # flax lecun_normal on (p, p, C, D): fan_in = p * p * C
        p, _, c, d = self.weight.shape
        flat = torch.empty(p * p * c, d, device=self.weight.device)
        lecun_normal_(flat, generator)
        with torch.no_grad():
            self.weight.copy_(flat.reshape(self.weight.shape))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        B, H, W, C = x.shape
        x = x.reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, p * p * C)
        y = x @ self.weight.to(x.dtype).reshape(p * p * C, -1)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int,
                 resolution: Tuple[int, int], device=None):
        super().__init__()
        self.resolution = tuple(resolution)
        self.norm = LayerNorm(4 * dim, cfg.layer_norm_eps, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False,
                               init=lecun_normal_, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class SwinModel(nn.Module):
    """Normalised NHWC images -> pooled (B, num_features)."""

    def __init__(self, cfg: SwinConfig, kernels: str = "band", device=None):
        super().__init__()
        _check_kernels(kernels)
        if cfg.use_absolute_embeddings:
            raise NotImplementedError("absolute position embeddings are "
                                      "not in the JAX package either")
        self.cfg = cfg
        c = cfg
        self.patch_projection = PatchProject(c.patch_size, c.num_channels,
                                             c.embed_dim, device=device)
        self.patch_norm = LayerNorm(c.embed_dim, c.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(c.hidden_dropout_prob)
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths))
        H = W = c.image_size // c.patch_size
        dim, bi = c.embed_dim, 0
        self.layout = []    # the child modules' names, in forward order
        for s, depth in enumerate(c.depths):
            for b in range(depth):
                name = f"stage_{s}_block_{b}"
                self.add_module(name, SwinBlock(
                    c, dim, c.num_heads[s], (H, W), shift=(b % 2 == 1),
                    drop_path=float(dpr[bi]), kernels=kernels,
                    device=device))
                self.layout.append(name)
                bi += 1
            if s < len(c.depths) - 1:
                name = f"stage_{s}_downsample"
                self.add_module(name, PatchMerging(c, dim, (H, W),
                                                   device=device))
                self.layout.append(name)
                H, W = (H + 1) // 2, (W + 1) // 2
                dim *= 2
        self.layernorm = LayerNorm(dim, c.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.patch_projection(x)
        x = self.patch_norm(x.reshape(x.shape[0], -1, x.shape[-1]))
        x = self.dropout(x, generator)
        for name in self.layout:
            layer = getattr(self, name)
            x = (layer(x, generator) if isinstance(layer, SwinBlock)
                 else layer(x))
        # HF pooler: AdaptiveAvgPool1d(1); the mean in float32 as XLA's
        return self.layernorm(x).float().mean(dim=1).to(x.dtype)


def swin_param_order(cfg: SwinConfig) -> list:
    """[(HF name, Flax path)] in HF SwinModel's ``named_parameters()``
    order (JAX swin.py ``swin_torch_param_order``)."""
    order = [("embeddings.patch_embeddings.projection.weight",
              ("patch_projection", "kernel")),
             ("embeddings.patch_embeddings.projection.bias",
              ("patch_projection", "bias")),
             ("embeddings.norm.weight", ("patch_norm", "scale")),
             ("embeddings.norm.bias", ("patch_norm", "bias"))]
    dense = lambda t, f, hf, port: [(f"{t}{hf}.weight", (f, port, "kernel")),
                                    (f"{t}{hf}.bias", (f, port, "bias"))]
    norm = lambda t, f, hf, port: [(f"{t}{hf}.weight", (f, port, "scale")),
                                   (f"{t}{hf}.bias", (f, port, "bias"))]
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            t, f = f"encoder.layers.{s}.blocks.{b}.", f"stage_{s}_block_{b}"
            order += norm(t, f, "layernorm_before", "layernorm_before")
            order.append((t + "attention.self.relative_position_bias_table",
                          (f, "relative_position_bias_table")))
            for hf in ("query", "key", "value"):
                order += dense(t, f, "attention.self." + hf, hf)
            order += dense(t, f, "attention.output.dense", "attention_output")
            order += norm(t, f, "layernorm_after", "layernorm_after")
            order += dense(t, f, "intermediate.dense", "intermediate")
            order += dense(t, f, "output.dense", "output")
        if s < len(cfg.depths) - 1:
            t, f = f"encoder.layers.{s}.downsample.", f"stage_{s}_downsample"
            order.append((t + "reduction.weight", (f, "reduction", "kernel")))
            order += norm(t, f, "norm", "norm")
    return order + [("layernorm.weight", ("layernorm", "scale")),
                    ("layernorm.bias", ("layernorm", "bias"))]


def swin_frozen_paths(cfg: SwinConfig, freeze_before: int,
                      prefix: tuple = ()) -> set:
    """Flax paths of the parameters with index < freeze_before in HF's
    order (the reference freezes by index over
    SwinForImageClassification's parameters, the classifier last and never
    frozen: inbatch_sasrec_e2e_vision/run.py:58-60, 125-129)."""
    return {prefix + fpath for idx, (_, fpath)
            in enumerate(swin_param_order(cfg)) if idx < freeze_before}
