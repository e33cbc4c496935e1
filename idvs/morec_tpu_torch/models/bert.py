"""BERT / RoBERTa encoder (JAX twin: models/bert.py).

Parameter names follow the Flax tree (``query``/``key``/``value``,
``attention_output``, ``attention_ln``, ``intermediate``, ``output``,
``output_ln``), so ``convert.from_flax`` loads a JAX ``BertModel`` as it is.
The attention runs through the ``fused_mha`` kernel with BERT's key mask,
and the two post-LN tails through the ``fused_proj_resln`` and
``fused_mlp_resln`` kernels (exact GELU); the word table's gradient through
the ``scatter_add_rows`` kernel (``ScatterEmbed``). In training mode
(``module.train()``) the embeddings, the attention probabilities and both
tails drop at the config's rates, each site with its own seed from the
generator passed to ``forward``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.cuda.attention import fused_mha
from ..ops.cuda.embed_scatter import embed_gather
from ..ops.cuda.mlp import fused_mlp_resln, fused_proj_resln
from .layers import Dense, Dropout, Embed, LayerNorm, drop_call


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pad_token_id: int = 0
    position_offset: int = 0   # RoBERTa: pad_token_id + 1
    is_roberta: bool = False

    @classmethod
    def from_dict(cls, hf: dict) -> "BertConfig":
        """From HF's ``config.json`` as a dict (JAX bert.py ``from_hf``): a
        BERT or RoBERTa config (RoBERTa's positions start at pad_token_id +
        1), or a DistilBERT one (``dim``, ``n_layers``, ``n_heads``,
        ``hidden_dim``; no token-type table). A key it lacks takes the
        default here."""
        if hf.get("model_type") == "distilbert":
            return cls(vocab_size=hf.get("vocab_size", cls.vocab_size),
                       hidden_size=hf.get("dim", cls.hidden_size),
                       num_hidden_layers=hf.get("n_layers", 6),
                       num_attention_heads=hf.get("n_heads",
                                                  cls.num_attention_heads),
                       intermediate_size=hf.get("hidden_dim",
                                                cls.intermediate_size),
                       max_position_embeddings=hf.get(
                           "max_position_embeddings",
                           cls.max_position_embeddings),
                       type_vocab_size=0, layer_norm_eps=1e-12,
                       hidden_dropout_prob=hf.get("dropout", 0.1),
                       attention_probs_dropout_prob=hf.get(
                           "attention_dropout", 0.1),
                       pad_token_id=hf.get("pad_token_id", 0))
        roberta = hf.get("model_type") == "roberta"
        pad = hf.get("pad_token_id", 1 if roberta else 0)
        return cls(
            vocab_size=hf.get("vocab_size", cls.vocab_size),
            hidden_size=hf.get("hidden_size", cls.hidden_size),
            num_hidden_layers=hf.get("num_hidden_layers",
                                     cls.num_hidden_layers),
            num_attention_heads=hf.get("num_attention_heads",
                                       cls.num_attention_heads),
            intermediate_size=hf.get("intermediate_size",
                                     cls.intermediate_size),
            max_position_embeddings=hf.get("max_position_embeddings",
                                           cls.max_position_embeddings),
            type_vocab_size=hf.get("type_vocab_size", cls.type_vocab_size),
            layer_norm_eps=hf.get("layer_norm_eps", cls.layer_norm_eps),
            hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
            attention_probs_dropout_prob=hf.get(
                "attention_probs_dropout_prob", 0.1),
            pad_token_id=pad, position_offset=pad + 1 if roberta else 0,
            is_roberta=roberta)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.drop_rate = cfg.attention_probs_dropout_prob
        self.query = Dense(H, H, device=device)
        self.key = Dense(H, H, device=device)
        self.value = Dense(H, H, device=device)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        # one fused QKV matmul, as the JAX package runs it outside any kernel
        dt = hidden.dtype
        w = torch.cat([self.query.weight, self.key.weight,
                       self.value.weight], dim=1).to(dt)
        b = torch.cat([self.query.bias, self.key.bias,
                       self.value.bias]).to(dt)
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        return fused_mha(hidden @ w + b, attention_mask,
                         n_heads=self.n_heads, drop_rate=rate, seed=seed)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.eps = cfg.layer_norm_eps
        self.drop_rate = cfg.hidden_dropout_prob
        self.attention_self = BertSelfAttention(cfg, device=device)
        self.attention_output = Dense(H, H, device=device)
        self.attention_ln = LayerNorm(H, self.eps, device=device)
        self.intermediate = Dense(H, I, device=device)
        self.output = Dense(I, H, device=device)
        self.output_ln = LayerNorm(H, self.eps, device=device)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        ctx = self.attention_self(hidden, attention_mask, generator)
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        hidden = fused_proj_resln(
            ctx, hidden, self.attention_output.weight,
            self.attention_output.bias,
            ln=(self.attention_ln.weight, self.attention_ln.bias),
            eps=self.eps, drop_rate=rate, seed=seed)
        rate, seed = drop_call(self.training, self.drop_rate, generator)
        return fused_mlp_resln(
            hidden, self.intermediate.weight, self.intermediate.bias,
            self.output.weight, self.output.bias,
            ln=(self.output_ln.weight, self.output_ln.bias), eps=self.eps,
            act="gelu", drop_rate=rate, seed=seed)


class ScatterEmbed(Embed):
    """Embed whose table gradient runs as the scatter-add kernel
    (``embed_gather``; JAX models/bert.py _ScatterEmbed). Forward and
    parameters are Embed's."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_gather(self.weight, ids)


class BertModel(nn.Module):
    """input_ids + attention_mask (B, T) -> last hidden state (B, T, H)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = ScatterEmbed(cfg.vocab_size, H, device=device)
        self.position_embeddings = Embed(cfg.max_position_embeddings, H,
                                         device=device)
        self.token_type_embeddings = (
            Embed(cfg.type_vocab_size, H, device=device)
            if cfg.type_vocab_size else None)
        self.embeddings_ln = LayerNorm(H, cfg.layer_norm_eps, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, device=device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator=None) -> torch.Tensor:
        c = self.cfg
        T = input_ids.shape[1]
        if c.is_roberta:
            # HF RoBERTa: positions follow the running count of non-pad
            # tokens, offset by pad_token_id + 1
            keep = (input_ids != c.pad_token_id).long()
            pos = self.position_embeddings(
                torch.cumsum(keep, dim=1) * keep + c.pad_token_id)
        else:
            pos = self.position_embeddings.weight[:T][None]
        h = self.word_embeddings(input_ids) + pos
        if self.token_type_embeddings is not None:
            # single segment: token type 0 for every position
            h = h + self.token_type_embeddings.weight[0]
        h = self.dropout(self.embeddings_ln(h), generator)
        for i in range(c.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h, attention_mask, generator)
        return h
