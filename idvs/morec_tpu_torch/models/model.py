"""RecModel: the two-tower recommender (JAX twin: models/model.py).

The port covers the end2end stage with two user towers, SASRec over the
item sequence (``user_states``) and DSSM's user table under an MLP
(``user_vec``, reference bce_text/main-end2end(DSSM)/model/model.py:7-30),
and the item towers ``id`` (an ID table whose padding row 0 is zero; under
DSSM followed by its own MLP, ``id_encoder``) and ``modal`` (an injected
content encoder such as ``TextTower`` or ``VisionTower``). ID+modality
fusion and the two-stage towers are still to be ported.

The train/eval mode is torch's (``model.train()`` / ``model.eval()``);
``item_embs``, ``user_states`` and ``user_vec`` take the host generator
that seeds the dropout in training mode (``models/layers.py``
``drop_call``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .dssm import MLPEncoder
from .layers import (Embed, init_parameters, on_device,
                     padded_xavier_normal_)
from .sasrec import SASRecEncoder


class RecModel(nn.Module):
    # the submodules each tower reads: the train step runs a tower on the
    # cast copies of these alone
    TOWERS = {"item_embs": ("id_embedding", "id_encoder", "encoder"),
              "user_states": ("user_encoder",),
              "user_vec": ("user_embedding", "user_mlp")}

    def __init__(self, *, item_num: int, embedding_dim: int,
                 num_attention_heads: int, transformer_block: int,
                 max_seq_len: int, drop_rate: float = 0.0,
                 item_tower: str = "id",
                 user_tower: str = "sasrec", stage: str = "end2end",
                 user_num: int = 0, dnn_layers: int = 0,
                 encoder: Optional[nn.Module] = None, device=None):
        super().__init__()
        if user_tower not in ("sasrec", "dssm"):
            raise ValueError(f"user_tower={user_tower!r}")
        if stage != "end2end":
            raise NotImplementedError(
                f"stage={stage!r}: only the end2end model is ported "
                f"(two-stage: ROADMAP A4)")
        if item_tower not in ("id", "modal"):
            raise NotImplementedError(
                f"item_tower={item_tower!r}: only 'id' and 'modal' are "
                f"ported (fusion: ROADMAP A4)")
        if item_tower == "modal" and encoder is None:
            raise ValueError("the end2end modal tower needs an encoder")
        self.item_tower = item_tower
        self.user_tower = user_tower
        self.embedding_dim = embedding_dim
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
        if item_tower == "id":
            self.id_embedding = Embed(item_num + 1, embedding_dim,
                                      init=padded_xavier_normal_,
                                      device=device)
            if user_tower == "dssm":
                # DSSM IDRec passes the id embedding through its own MLP
                # (bce_text/main-end2end(DSSM)/model/model.py:25-29)
                self.id_encoder = MLPEncoder(embedding_dim, dnn_layers,
                                             drop_rate, device=device)
        else:
            self.encoder = encoder

    def forward(self, tower: str, *args) -> torch.Tensor:
        """Runs the tower named ``tower`` (a key of TOWERS), so that
        ``torch.func.functional_call`` can run it on other parameters."""
        return getattr(self, tower)(*args)

    def item_embs(self, item_ids: torch.Tensor,
                  content: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Item tower: ids (N,) (+ content: token rows (N, W) or images
        (N, H, W, 3)) -> (N, D)."""
        if self.item_tower == "id":
            emb = self.id_embedding(item_ids)
            if self.user_tower == "dssm":
                emb = self.id_encoder(emb, generator)
            return emb
        if content.dim() == 4:
            # images: id 0 is the padding item, whose image is zero in
            # normalised space, which uint8 content cannot say
            return self.encoder(content, generator, pad_mask=(item_ids == 0))
        return self.encoder(content, generator)

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
    ``dnn_layers`` (DSSM's MLPs, 0 when absent) and ``drop_rate``, 0.1
    when absent as in the JAX ``Config``). ``user_num``: the DSSM user
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
                     encoder=encoder, device=device)
    init_parameters(model, generator)
    return model.eval()
