"""DeBERTa (v1) encoder (JAX twin: models/deberta.py), the deberta-base
geometry of HF ``DebertaModel``; the reference imports it in every text
variant (inbatch_sasrec_e2e_text/run.py:8), the JAX package completes it.

- embeddings: the word table (``ScatterEmbed``: its gradient through the
  ``scatter_add_rows`` kernel; no absolute positions,
  ``position_biased_input`` false in every v1 checkpoint), the token-type
  table's row 0 when ``type_vocab_size``, LayerNorm, the padded tokens'
  rows zeroed, dropout;
- disentangled self-attention: one bias-free ``in_proj`` (H, 3H) into q, k,
  v, the learned ``q_bias`` and ``v_bias`` added; scale sqrt(dh (1 +
  |pos_att_type|)); score(i, j) = (q_i / scale) . k_j + (q_i / scale) .
  pos_k[D(i, j)] (c2p) + k_j . (pos_q / scale)[D(i, j)] (p2c) in float32,
  with D(i, j) = clamp(i - j + span, 0, 2 span - 1) into the slice
  ``rel_embeddings[max_rel - span : max_rel + span]`` (span = min(T,
  max_rel)), which takes the hidden dropout in each layer; pos_k =
  rel ``pos_proj`` (no bias), pos_q = ``pos_q_proj``(rel); the pair mask
  m_i m_j at float32's least value, a float32 softmax cast back, then the
  attention dropout (plain PyTorch, as the JAX package runs no kernel
  there);
- post-LN blocks: ``attention_output``, dropout, ``attention_ln``; the FFN
  through ``ops/cuda/mlp.py`` ``fused_mlp`` without a LayerNorm, exact GELU,
  ``save_h`` (JAX deberta.py:174-188), then dropout and ``output_ln``.

Names follow the Flax tree: the bare parameters ``in_proj``, ``q_bias``,
``v_bias``, ``pos_proj`` (each (in, out)) and the model's
``rel_embeddings`` keep their Flax names and layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.mlp import fused_mlp
from .bert import ScatterEmbed
from .layers import Dense, Dropout, Embed, LayerNorm, normal_, on_device


@dataclasses.dataclass(frozen=True)
class DebertaConfig:
    """Defaults are deberta-base's."""
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    max_relative_positions: int = -1     # -1: max_position_embeddings
    type_vocab_size: int = 0
    layer_norm_eps: float = 1e-7
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pos_att_type: Tuple[str, ...] = ("c2p", "p2c")
    pad_token_id: int = 0

    @classmethod
    def from_dict(cls, hf: dict) -> "DebertaConfig":
        """From HF's ``config.json`` as a dict; a key it lacks takes HF
        DebertaConfig's default. Refuses what the JAX package refuses (a
        projected embedding, position_biased_input, talking heads), and
        pos_att_type without relative attention, where HF builds no
        relative table."""
        H = hf.get("hidden_size", cls.hidden_size)
        pos = hf.get("pos_att_type") or ()
        if isinstance(pos, str):
            pos = [p.strip() for p in pos.lower().split("|")]
        refused = [
            ("embedding_size", hf.get("embedding_size", H) != H),
            ("position_biased_input", hf.get("position_biased_input", True)),
            ("talking_head", hf.get("talking_head", False)),
            ("relative_attention",
             bool(pos) and not hf.get("relative_attention", False))]
        bad = [k for k, refuse in refused if refuse]
        if bad:
            raise NotImplementedError(
                f"DeBERTa config with "
                f"{', '.join(f'{k}={hf.get(k)!r}' for k in bad)}: not "
                f"ported (no v1 checkpoint uses it)")
        return cls(vocab_size=hf.get("vocab_size", cls.vocab_size),
                   hidden_size=H,
                   num_hidden_layers=hf.get("num_hidden_layers",
                                            cls.num_hidden_layers),
                   num_attention_heads=hf.get("num_attention_heads",
                                              cls.num_attention_heads),
                   intermediate_size=hf.get("intermediate_size",
                                            cls.intermediate_size),
                   max_position_embeddings=hf.get(
                       "max_position_embeddings",
                       cls.max_position_embeddings),
                   max_relative_positions=hf.get("max_relative_positions",
                                                 -1),
                   type_vocab_size=hf.get("type_vocab_size", 0),
                   layer_norm_eps=hf.get("layer_norm_eps",
                                         cls.layer_norm_eps),
                   hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
                   attention_probs_dropout_prob=hf.get(
                       "attention_probs_dropout_prob", 0.1),
                   pos_att_type=tuple(pos),
                   pad_token_id=hf.get("pad_token_id") or 0)

    @property
    def max_rel(self) -> int:
        return (self.max_relative_positions
                if self.max_relative_positions > 0
                else self.max_position_embeddings)


def relative_buckets(T: int, span: int) -> np.ndarray:
    """(T, T) D(i, j) = clamp(i - j + span, 0, 2 span - 1): the c2p index,
    and transposed the p2c one."""
    d = np.arange(T)[:, None] - np.arange(T)[None, :]
    return np.clip(d + span, 0, 2 * span - 1)


class DisentangledSelfAttention(nn.Module):
    def __init__(self, cfg: DebertaConfig, device=None):
        super().__init__()
        device = on_device(device)
        H = cfg.hidden_size
        self.cfg = cfg
        self.in_proj = nn.Parameter(torch.empty(H, 3 * H, device=device))
        self.q_bias = nn.Parameter(torch.empty(H, device=device))
        self.v_bias = nn.Parameter(torch.empty(H, device=device))
        self.pos_proj = (nn.Parameter(torch.empty(H, H, device=device))
                         if "c2p" in cfg.pos_att_type else None)
        self.pos_q_proj = (Dense(H, H, init=normal_(0.02), device=device)
                           if "p2c" in cfg.pos_att_type else None)
        self.rel_drop = Dropout(cfg.hidden_dropout_prob)
        self.drop = Dropout(cfg.attention_probs_dropout_prob)

    def reset_parameters(self, generator) -> None:
        normal_(0.02)(self.in_proj, generator)
        with torch.no_grad():
            self.q_bias.zero_()
            self.v_bias.zero_()
        if self.pos_proj is not None:
            normal_(0.02)(self.pos_proj, generator)

    def forward(self, hidden: torch.Tensor, pair_mask: torch.Tensor,
                rel_emb, generator=None) -> torch.Tensor:
        c = self.cfg
        B, T, H = hidden.shape
        nh = c.num_attention_heads
        dh = H // nh
        dt = hidden.dtype
        q, k, v = (hidden @ self.in_proj.to(dt)).split(H, dim=-1)
        q = q + self.q_bias.to(dt)
        v = v + self.v_bias.to(dt)
        scale = math.sqrt(dh * (1 + len(c.pos_att_type)))
        heads = lambda t: t.reshape(B, T, nh, dh).transpose(1, 2)
        qh, kh = heads(q / scale), heads(k)         # (B, nh, T, dh)
        scores = qh.float() @ kh.float().transpose(-1, -2)
        if rel_emb is not None and c.pos_att_type:
            span = min(T, c.max_rel)
            rel = self.rel_drop(rel_emb[c.max_rel - span:c.max_rel + span],
                                generator)          # (2 span, H)
            rows = lambda t: t.reshape(2 * span, nh, dh).permute(1, 2, 0)
            D = torch.from_numpy(relative_buckets(T, span)).to(
                hidden.device).expand(B, nh, T, T)
            if "c2p" in c.pos_att_type:
                pos_k = rows(rel @ self.pos_proj.to(rel.dtype))
                c2p = qh.float() @ pos_k.float()    # (B, nh, T, 2 span)
                scores = scores + c2p.gather(-1, D)
            if "p2c" in c.pos_att_type:
                pos_q = rows(self.pos_q_proj(rel) / scale)
                p2c = kh.float() @ pos_q.float()    # (B, nh, T_k, 2 span)
                # p2c(i, j) = k_j . pos_q[D(i, j)]: gather Dᵀ row-wise on
                # the key axis, then transpose (HF's gather + transpose)
                scores = scores + p2c.gather(-1, D.transpose(-1, -2)
                                             ).transpose(-1, -2)
        scores = scores.masked_fill(~pair_mask[:, None],
                                    torch.finfo(torch.float32).min)
        probs = self.drop(torch.softmax(scores, dim=-1).to(dt), generator)
        return (probs @ heads(v)).transpose(1, 2).reshape(B, T, H)


class DebertaLayer(nn.Module):
    def __init__(self, cfg: DebertaConfig, device=None):
        super().__init__()
        H, I, eps = (cfg.hidden_size, cfg.intermediate_size,
                     cfg.layer_norm_eps)
        self.attention_self = DisentangledSelfAttention(cfg, device=device)
        self.attention_output = Dense(H, H, device=device)
        self.attention_ln = LayerNorm(H, eps, device=device)
        self.intermediate = Dense(H, I, device=device)
        self.output = Dense(I, H, device=device)
        self.output_ln = LayerNorm(H, eps, device=device)
        self.drop = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, pair_mask: torch.Tensor,
                rel_emb, generator=None) -> torch.Tensor:
        attn = self.attention_self(hidden, pair_mask, rel_emb, generator)
        attn = self.drop(self.attention_output(attn), generator)
        hidden = self.attention_ln(hidden + attn)
        out = fused_mlp(hidden, self.intermediate.weight,
                        self.intermediate.bias, self.output.weight,
                        self.output.bias, ln=None, act="gelu", save_h=True)
        out = self.drop(out, generator)
        return self.output_ln(hidden + out)


class DebertaModel(nn.Module):
    """input_ids + attention_mask (B, T) -> last hidden state (B, T, H)."""

    def __init__(self, cfg: DebertaConfig, device=None):
        super().__init__()
        device = on_device(device)
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = ScatterEmbed(cfg.vocab_size, H, device=device)
        self.token_type_embeddings = (
            Embed(cfg.type_vocab_size, H, device=device)
            if cfg.type_vocab_size else None)
        self.embeddings_ln = LayerNorm(H, cfg.layer_norm_eps, device=device)
        self.drop = Dropout(cfg.hidden_dropout_prob)
        self.rel_embeddings = (
            nn.Parameter(torch.empty(2 * cfg.max_rel, H, device=device))
            if cfg.pos_att_type else None)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", DebertaLayer(cfg, device=device))

    def reset_parameters(self, generator) -> None:
        if self.rel_embeddings is not None:
            normal_(0.02)(self.rel_embeddings, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        h = self.word_embeddings(input_ids)
        if self.token_type_embeddings is not None:
            # single segment: token type 0 for every position
            h = h + self.token_type_embeddings.weight[0].to(h.dtype)
        h = self.embeddings_ln(h)
        mask = attention_mask.to(h.dtype)
        h = self.drop(h * mask[:, :, None], generator)   # pads zeroed
        pair_mask = (mask[:, :, None] * mask[:, None, :]) > 0
        for i in range(self.cfg.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h, pair_mask,
                                            self.rel_embeddings, generator)
        return h


def deberta_param_order(num_layers: int) -> List[Tuple[str, Tuple[str, ...]]]:
    """[(HF name, Flax path)] in HF ``DebertaModel.named_parameters()``
    order (JAX deberta.py ``deberta_torch_param_order``): the embeddings'
    3, each layer's 16 with q_bias and v_bias first (a module's own
    parameters precede its submodules'), rel_embeddings last."""
    order = [("embeddings.word_embeddings.weight",
              ("word_embeddings", "embedding")),
             ("embeddings.LayerNorm.weight", ("embeddings_ln", "scale")),
             ("embeddings.LayerNorm.bias", ("embeddings_ln", "bias"))]
    for i in range(num_layers):
        L, t = f"layer_{i}", f"encoder.layer.{i}."
        a = t + "attention."
        order += [
            (a + "self.q_bias", (L, "attention_self", "q_bias")),
            (a + "self.v_bias", (L, "attention_self", "v_bias")),
            (a + "self.in_proj.weight", (L, "attention_self", "in_proj")),
            (a + "self.pos_proj.weight", (L, "attention_self", "pos_proj")),
            (a + "self.pos_q_proj.weight",
             (L, "attention_self", "pos_q_proj", "kernel")),
            (a + "self.pos_q_proj.bias",
             (L, "attention_self", "pos_q_proj", "bias")),
            (a + "output.dense.weight", (L, "attention_output", "kernel")),
            (a + "output.dense.bias", (L, "attention_output", "bias")),
            (a + "output.LayerNorm.weight", (L, "attention_ln", "scale")),
            (a + "output.LayerNorm.bias", (L, "attention_ln", "bias")),
            (t + "intermediate.dense.weight", (L, "intermediate", "kernel")),
            (t + "intermediate.dense.bias", (L, "intermediate", "bias")),
            (t + "output.dense.weight", (L, "output", "kernel")),
            (t + "output.dense.bias", (L, "output", "bias")),
            (t + "output.LayerNorm.weight", (L, "output_ln", "scale")),
            (t + "output.LayerNorm.bias", (L, "output_ln", "bias"))]
    return order + [("encoder.rel_embeddings.weight", ("rel_embeddings",))]
