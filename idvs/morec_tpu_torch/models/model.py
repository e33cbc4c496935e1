"""RecModel: the two-tower recommender (JAX twin: models/model.py).

Two user towers: SASRec over the item sequence (``user_states``) and
DSSM's user table under an MLP (``user_vec``, reference bce_text/
main-end2end(DSSM)/model/model.py:7-30). Four item towers at two stages
(``item_embs``):

- ``id``: an ID table whose padding row 0 is zero; under DSSM followed by
  its own MLP, ``id_encoder``;
- ``modal`` end2end: an injected content encoder such as ``TextTower`` or
  ``VisionTower``; two-stage: the frozen encoder's cached outputs
  (``word_embedding_dim`` wide) under ``modal_proj``, an exact GELU and,
  ``dnn_layers`` > 0, ``modal_mlp`` (reference bce_text/main-2stage(SASRec)/
  model/encoders.py:7-31);
- ``modal_id_add`` / ``modal_id_cat`` (ID+modality fusion, reference
  bce_text/id_plus_mo-end2end/model/encoders.py:8-39): end2end,
  ``fusion(id_embedding(ids), encoder(content))`` with ``AddFusion`` or a
  ``CatFusion`` ``cat_layers`` deep; two-stage,
  ``post_mlp(fusion(id_embedding(ids), turn_dim(cache)))`` with
  ``turn_dim`` an ``FCLayers`` ``mo_dnn_layers`` deep, a one-layer
  ``CatFusion``, and ``post_mlp`` only when ``dnn_layers`` > 0 (reference
  bce_text/id_plus_mo-2stage/model/model.py:25-51).

A bf16 parameter meets a float32 operand in the promoted dtype, as Flax
promotes: a two-stage head computes in float32 on its cast copies.

The train/eval mode is torch's (``model.train()`` / ``model.eval()``);
``item_embs``, ``user_states`` and ``user_vec`` take the host generator
that seeds the dropout in training mode (``models/layers.py``
``drop_call``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dssm import MLPEncoder
from .layers import (AddFusion, CatFusion, Dense, Embed, FCLayers, MLPLayers,
                     init_parameters, on_device, padded_xavier_normal_,
                     xavier_normal_)
from .sasrec import SASRecEncoder

FUSED = ("modal_id_add", "modal_id_cat")


class RecModel(nn.Module):
    # the submodules each tower reads: the train step runs a tower on the
    # cast copies of these alone
    TOWERS = {"item_embs": ("id_embedding", "id_encoder", "encoder",
                            "fusion", "modal_proj", "modal_mlp", "turn_dim",
                            "post_mlp"),
              "user_states": ("user_encoder",),
              "user_vec": ("user_embedding", "user_mlp")}

    def __init__(self, *, item_num: int, embedding_dim: int,
                 num_attention_heads: int, transformer_block: int,
                 max_seq_len: int, drop_rate: float = 0.0,
                 item_tower: str = "id",
                 user_tower: str = "sasrec", stage: str = "end2end",
                 user_num: int = 0, dnn_layers: int = 0,
                 word_embedding_dim: int = 768, mo_dnn_layers: int = 0,
                 cat_layers: int = 1,
                 encoder: Optional[nn.Module] = None, device=None):
        super().__init__()
        if user_tower not in ("sasrec", "dssm"):
            raise ValueError(f"user_tower={user_tower!r}")
        if item_tower not in ("id", "modal") + FUSED:
            raise ValueError(f"item_tower={item_tower!r}")
        if stage not in ("end2end", "two_stage"):
            raise ValueError(f"stage={stage!r}")
        use_modal = item_tower != "id"
        two_stage = use_modal and stage == "two_stage"
        if use_modal and not two_stage and encoder is None:
            raise ValueError("the end2end modal tower needs an encoder")
        self.item_tower = item_tower
        self.user_tower = user_tower
        self.stage = stage
        self.embedding_dim = embedding_dim
        self.dnn_layers = dnn_layers
        if user_tower == "sasrec":
            self.user_encoder = SASRecEncoder(
                embedding_dim, num_attention_heads, transformer_block,
                max_seq_len, drop_rate, device=device)
        else:
            self.user_embedding = Embed(user_num + 1, embedding_dim,
                                        init=padded_xavier_normal_,
                                        device=device)
            self.user_mlp = MLPEncoder(embedding_dim, dnn_layers, drop_rate,
                                       device=device)
        if item_tower != "modal":
            self.id_embedding = Embed(item_num + 1, embedding_dim,
                                      init=padded_xavier_normal_,
                                      device=device)
            if user_tower == "dssm" and not use_modal:
                # DSSM IDRec passes the id embedding through its own MLP
                # (bce_text/main-end2end(DSSM)/model/model.py:25-29)
                self.id_encoder = MLPEncoder(embedding_dim, dnn_layers,
                                             drop_rate, device=device)
        deep = [embedding_dim] * (dnn_layers + 1)
        if two_stage and item_tower in FUSED:
            # id_plus_mo-2stage: a mo_dnn_layers-deep FC stack turns the
            # cached content to embedding_dim before the fusion, and a
            # dnn_layers-deep MLP runs on the fused vector
            # (bce_text/id_plus_mo-2stage/model/model.py:25-27,38-40)
            self.turn_dim = FCLayers(word_embedding_dim, embedding_dim,
                                     mo_dnn_layers, drop_rate, device=device)
            if dnn_layers > 0:
                self.post_mlp = MLPLayers(deep, drop_rate, device=device)
        elif two_stage:
            # the frozen encoder's cached outputs under a trainable head
            # (bce_text/main-2stage(SASRec)/model/encoders.py:7-31)
            self.modal_proj = Dense(word_embedding_dim, embedding_dim,
                                    init=xavier_normal_, device=device)
            if dnn_layers > 0:
                self.modal_mlp = MLPLayers(deep, drop_rate, device=device)
        elif use_modal:
            self.encoder = encoder
        if item_tower == "modal_id_add":
            self.fusion = AddFusion()
        elif item_tower == "modal_id_cat":
            # the two-stage CAT is always one layer deep (bce_text/
            # id_plus_mo-2stage/model/model.py:31-34); end2end takes
            # cat_layers ('modal_cat_3': 3)
            self.fusion = CatFusion(embedding_dim, drop_rate,
                                    1 if two_stage else cat_layers,
                                    device=device)

    def forward(self, tower: str, *args) -> torch.Tensor:
        """Runs the tower named ``tower`` (a key of TOWERS), so that
        ``torch.func.functional_call`` can run it on other parameters."""
        return getattr(self, tower)(*args)

    def item_embs(self, item_ids: torch.Tensor,
                  content: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Item tower: ids (N,) (+ content: token rows (N, W), images
        (N, H, W, 3), or two-stage the cached encoder outputs (N,
        word_embedding_dim)) -> (N, D). pad_mask (N,): the image slots of
        the padding item, by default those of id 0."""
        if self.item_tower == "id":
            emb = self.id_embedding(item_ids)
            if self.user_tower == "dssm":
                emb = self.id_encoder(emb, generator)
            return emb
        fused = self.item_tower in FUSED
        if self.stage == "two_stage" and fused:
            # mlp(fusion(id, turn_dim(content)))
            # (bce_text/id_plus_mo-2stage/model/model.py:49-51)
            out = self.fusion(self.id_embedding(item_ids),
                              self.turn_dim(content, generator), generator)
            return (self.post_mlp(out, generator) if self.dnn_layers > 0
                    else out)
        if self.stage == "two_stage":
            modal = F.gelu(self.modal_proj(content))
            if self.dnn_layers > 0:
                modal = self.modal_mlp(modal, generator)
        elif content.dim() == 4:
            # images: id 0 is the padding item, whose image is zero in
            # normalised space, which uint8 content cannot say
            modal = self.encoder(content, generator,
                                 pad_mask=(item_ids == 0 if pad_mask is None
                                           else pad_mask))
        else:
            modal = self.encoder(content, generator)
        if fused:
            return self.fusion(self.id_embedding(item_ids), modal, generator)
        return modal

    def user_states(self, input_embs: torch.Tensor, log_mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """SASRec tower: (B, L, D) embeddings + (B, L) mask -> (B, L, D)."""
        return self.user_encoder(input_embs, log_mask, generator)

    def user_vec(self, user_ids: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """DSSM tower: (B,) user ids -> (B, D)."""
        return self.user_mlp(self.user_embedding(user_ids), generator)


def make_model(cfg, item_num: int, encoder: Optional[nn.Module] = None, *,
               user_num: int = 0, device=None,
               generator: Optional[torch.Generator] = None) -> RecModel:
    """RecModel from a config with the JAX package's ``Config`` fields
    (``item_tower``, ``user_tower``, ``stage``, ``embedding_dim``,
    ``num_attention_heads``, ``transformer_block``, ``max_seq_len``,
    ``dnn_layers`` (DSSM's and the two-stage heads' MLPs, 0 when absent),
    ``word_embedding_dim`` (the two-stage cache's width), ``mo_dnn_layers``,
    ``cat_layers`` (1 when absent) and ``drop_rate``, 0.1 when absent as in
    the JAX ``Config``). ``user_num``: the DSSM user
    table's users, ids 1..user_num (row 0 is padding). The model comes back
    in eval mode, for serving; ``train.state`` switches it.

    The model is built on ``device``, the GPU when None (``on_device``: it
    raises when none is visible; name ``"cpu"`` to build there). The
    encoder must have been built on the same device.

    Every parameter, the encoder's included, is drawn from ``generator``
    (a ``torch.Generator`` on ``device``; None draws from torch's default
    generator).
    """
    device = on_device(device)
    model = RecModel(item_num=item_num, embedding_dim=cfg.embedding_dim,
                     num_attention_heads=cfg.num_attention_heads,
                     transformer_block=cfg.transformer_block,
                     max_seq_len=cfg.max_seq_len,
                     drop_rate=getattr(cfg, "drop_rate", 0.1),
                     item_tower=cfg.item_tower,
                     user_tower=cfg.user_tower, stage=cfg.stage,
                     user_num=user_num,
                     dnn_layers=getattr(cfg, "dnn_layers", 0),
                     word_embedding_dim=getattr(cfg, "word_embedding_dim",
                                                768),
                     mo_dnn_layers=getattr(cfg, "mo_dnn_layers", 0),
                     cat_layers=getattr(cfg, "cat_layers", 1),
                     encoder=encoder, device=device)
    init_parameters(model, generator)
    return model.eval()
