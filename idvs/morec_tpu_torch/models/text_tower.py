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

``build_text_tower`` (JAX twin: models/text_tower.py) builds the tower of
an HF model directory, ``cfg.pretrained_models_dir/cfg.bert_model_load``:
its ``config.json`` read as JSON, the weights converted when the directory
holds them (``convert.load_torch_state_dict``).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, on_device, xavier_normal_

# Hidden sizes and pooler parameter indices by model size (JAX
# encoders_zoo.py:18-32; reference run.py:36-72 hard-codes them by
# bert_model_load)
TEXT_MODEL_TABLE = {
    "tiny":   dict(word_dim=128,  pooler=(37, 38)),
    "mini":   dict(word_dim=256,  pooler=(69, 70)),
    "small":  dict(word_dim=512,  pooler=(69, 70)),
    "medium": dict(word_dim=512,  pooler=(133, 134)),
    "base":   dict(word_dim=768,  pooler=(197, 198)),
    "large":  dict(word_dim=1024, pooler=(389, 390)),
}


def text_model_spec(bert_model_load: str) -> dict:
    for key, spec in TEXT_MODEL_TABLE.items():
        if key in bert_model_load:
            return spec
    return dict(word_dim=768, pooler=())


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


def _weights(path: str, convert_fn):
    """The converted state_dict of the directory's weights, or None when it
    holds no weight file."""
    from .. import convert
    try:
        return convert_fn(convert.load_torch_state_dict(path))
    except FileNotFoundError:
        return None


def build_text_tower(cfg, device=None) -> tuple:
    """The encoder bundle of end2end text MoRec (JAX text_tower.py:66-168):
    (``TextTower``, the state_dict of its pretrained ``net`` or None, the
    names of the parameters frozen under ``cfg.freeze_paras_before``,
    word_dim), built on ``device`` (the GPU when None, ``on_device``) from
    ``cfg.pretrained_models_dir/cfg.bert_model_load``, whose
    ``config.json`` must be there (FileNotFoundError naming it otherwise).
    As in the JAX package: a name holding "opt" is OPT, pooled by the
    masked mean (the reference's Text_Encoder_mean); else ``model_type``
    "deberta" is DeBERTa, "distilbert" DistilBERT (``BertModel`` without a
    token-type table), anything else BERT or RoBERTa, pooled by CLS;
    ``cfg.text_pooling`` overrides the pooling. The attributes of
    ``cfg.news_attributes`` (title, abstract, body) give the token lengths;
    the tower projects (``fc``) only in the end2end stage. The weights are
    converted when the directory holds ``model.safetensors`` or
    ``pytorch_model.bin``; the parameters are still to be drawn
    (``make_model``) and the state_dict loaded over the net."""
    from .. import convert
    from .bert import BertConfig, BertModel
    from .deberta import DebertaConfig, DebertaModel
    from .opt import OPTConfig, OPTModel
    device = on_device(device)
    name = cfg.bert_model_load
    path = os.path.join(cfg.pretrained_models_dir, name)
    config_path = os.path.join(path, "config.json")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"no HF config.json at {config_path}: a "
                                f"text tower reads its model directory")
    with open(config_path) as f:
        hf = json.load(f)
    n = cfg.freeze_paras_before
    if "opt" in name:
        c = OPTConfig.from_dict(hf)
        net, width, pooling = OPTModel(c, device=device), c.hidden_size, \
            "mean"
        L = c.num_hidden_layers
        state = _weights(path, lambda sd: convert.convert_opt_state_dict(
            sd, L))
        frozen = convert.opt_frozen_names(L, n)
    elif hf.get("model_type") == "deberta":
        c = DebertaConfig.from_dict(hf)
        net, width, pooling = DebertaModel(c, device=device), \
            c.hidden_size, "cls"
        L, heads = c.num_hidden_layers, c.num_attention_heads
        state = _weights(path, lambda sd: convert.convert_deberta_state_dict(
            sd, L, heads))
        frozen = convert.deberta_frozen_names(L, n)
    elif hf.get("model_type") == "distilbert":
        c = BertConfig.from_dict(hf)
        net, width, pooling = BertModel(c, device=device), c.hidden_size, \
            "cls"
        L = c.num_hidden_layers
        state = _weights(path, lambda sd:
                         convert.convert_distilbert_state_dict(sd, L))
        frozen = convert.distilbert_frozen_names(L, n)
    else:
        c = BertConfig.from_dict(hf)
        net, width, pooling = BertModel(c, device=device), c.hidden_size, \
            "cls"
        L = c.num_hidden_layers
        state = _weights(path, lambda sd: convert.convert_bert_state_dict(
            sd, L))
        frozen = convert.bert_frozen_names(L, n)
    lengths = {"title": cfg.num_words_title,
               "abstract": cfg.num_words_abstract,
               "body": cfg.num_words_body}
    attr_lengths = tuple(lengths[a] for a in ("title", "abstract", "body")
                         if a in cfg.news_attributes)
    if getattr(cfg, "text_pooling", ""):
        pooling = cfg.text_pooling
    tower = TextTower(net, cfg.embedding_dim, width, pooling=pooling,
                      attr_lengths=attr_lengths,
                      project=cfg.stage == "end2end", device=device)
    return tower, state, frozen, width
