"""Retrieval serving on one device (JAX twin: serve.py).

1. Encode the catalog once through the item tower and keep the
   (item_num + 1, D) table on the device.
2. ``recommend(histories)``: the SASRec user tower on the left-padded
   histories, the last position's state, a float32 (B, item_num + 1) score
   matmul against the table, the padding column and (optionally) each
   user's history set to -inf, then the top-k.
   ``recommend_users(user_ids)``: the DSSM user tower on trained user ids,
   the same scores with only the padding column at -inf (the JAX engine
   excludes no history for DSSM), then the top-k.

Requests pad up to the smallest configured batch bucket, as in the JAX
engine, so the shapes the kernels see come from a short fixed list. The
towers run in eval mode whatever mode the model is in (a model fresh from
``make_train_state`` is in training mode), and the model keeps its mode.
``update_items`` splices new or changed items into the live table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .train.evaluate import compute_item_embeddings, eval_mode


def pad_histories(histories: Sequence[Sequence[int]], max_seq_len: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pads item-id histories to (B, L) ids + a (B, L) 0/1 mask,
    keeping the most recent max_seq_len items (the reference's
    pad_to_fix_len)."""
    B, L = len(histories), max_seq_len
    ids = np.zeros((B, L), dtype=np.int64)
    mask = np.zeros((B, L), dtype=np.float32)
    for i, h in enumerate(histories):
        h = list(h)[-L:]
        if h:
            ids[i, L - len(h):] = h
            mask[i, L - len(h):] = 1.0
    return ids, mask


class Retriever:
    """Retrieval engine over a RecModel: ``recommend`` for a SASRec user
    tower, ``recommend_users`` for a DSSM one (the model's ``user_tower``).

    item_table: the (item_num + 1, D) catalog table on the model's device
    (``Retriever.encode_catalog`` builds one). batch_sizes: the request
    buckets.
    """

    def __init__(self, model, item_table: torch.Tensor, *,
                 max_seq_len: int = 20,
                 batch_sizes: Sequence[int] = (1, 8, 64),
                 exclude_history: bool = True):
        self.model = model
        self.user_tower = model.user_tower
        self.item_table = item_table
        self.max_seq_len = int(max_seq_len)
        self.batch_sizes = tuple(sorted(int(b) for b in batch_sizes))
        self.exclude_history = bool(exclude_history)

    @staticmethod
    def encode_catalog(model, item_num: int,
                       item_content: Optional[torch.Tensor],
                       embedding_dim: int,
                       batch_size: int = 512,
                       content_fn=None) -> torch.Tensor:
        """(item_num + 1, D) catalog table through the item tower;
        ``content_fn`` maps a chunk's ids to its content (images) where the
        catalog is no matrix on the device."""
        return compute_item_embeddings(model, item_num, item_content,
                                       embedding_dim, batch_size=batch_size,
                                       content_fn=content_fn)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        top = self.batch_sizes[-1]
        return (n + top - 1) // top * top

    def _top_k(self, uvec: torch.Tensor, top_k: int,
               history: Optional[torch.Tensor] = None) -> tuple:
        """float32 scores of the (B, D) user vectors against the table, the
        padding column and the ids of ``history`` at -inf, then the top-k."""
        scores = uvec.float() @ self.item_table.float().T    # (B, I + 1)
        scores[:, 0] = -torch.inf                            # padding item
        if history is not None:
            # history ids are left-padded with 0, whose column is -inf already
            scores.scatter_(1, history, -torch.inf)
        return torch.topk(scores, top_k, dim=1)

    @torch.no_grad()
    def recommend(self, histories: Sequence[Sequence[int]], top_k: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """histories: per-user item-id lists, most recent last ->
        (ids (B, top_k) int64, scores (B, top_k) float32), best first. A
        SASRec model's: a DSSM model serves ``recommend_users``."""
        if self.user_tower != "sasrec":
            raise ValueError("recommend takes item histories, which only a "
                             "SASRec user tower reads: a DSSM model serves "
                             "recommend_users")
        n = len(histories)
        B = self._bucket(n)
        ids, mask = pad_histories(histories, self.max_seq_len)
        if B > n:
            ids = np.pad(ids, ((0, B - n), (0, 0)))
            mask = np.pad(mask, ((0, B - n), (0, 0)))
        device = self.item_table.device
        ids = torch.from_numpy(ids).to(device)
        mask = torch.from_numpy(mask).to(device)
        table = self.item_table
        with eval_mode(self.model):
            states = self.model.user_states(table[ids], mask)
        vals, idx = self._top_k(states[:, -1], top_k,
                                ids if self.exclude_history else None)
        return idx[:n].cpu().numpy(), vals[:n].cpu().numpy()

    @torch.no_grad()
    def recommend_users(self, user_ids: Sequence[int], top_k: int = 10
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """DSSM tower: recommend for trained user ids -> (ids (B, top_k)
        int64, scores (B, top_k) float32), best first."""
        if self.user_tower != "dssm":
            raise ValueError("user-id serving is the DSSM path")
        n = len(user_ids)
        users = np.zeros(self._bucket(n), dtype=np.int64)
        users[:n] = np.asarray(list(user_ids), dtype=np.int64)
        users = torch.from_numpy(users).to(self.item_table.device)
        with eval_mode(self.model):
            uvec = self.model.user_vec(users)
        vals, idx = self._top_k(uvec, top_k)
        return idx[:n].cpu().numpy(), vals[:n].cpu().numpy()

    @torch.no_grad()
    def update_items(self, item_ids: Sequence[int],
                     content: Optional[torch.Tensor] = None,
                     embeddings: Optional[torch.Tensor] = None) -> None:
        """Splices new or updated items into the live table, from
        precomputed ``embeddings`` or from raw ``content`` (token rows,
        images, or a two-stage tower's cached rows) run through the item
        tower with the ids. The table is updated in place."""
        device = self.item_table.device
        ids = torch.as_tensor(list(item_ids), dtype=torch.long, device=device)
        if embeddings is None:
            if content is None:
                raise ValueError("update_items needs content or embeddings")
            with eval_mode(self.model):
                embeddings = self.model.item_embs(
                    ids, torch.as_tensor(content).to(device))
        self.item_table[ids] = embeddings.to(device, self.item_table.dtype)
