"""Cold-start and new-item evaluation (JAX twin: idvs/morec_tpu/train/
special_eval.py; reference inbatch_sasrec_e2e_text/data_utils/
special.py:44-214).

- cold: users whose target item is in the training catalog but was cold,
  evaluated over the whole catalog with their own histories
  (``eval_cold``: the runner's ``evaluate`` over ``EvalBatches``);
- new: users whose target item was never seen; its embedding comes fresh
  from the item tower and is appended to the catalog for that user alone
  before ranking (special.py:196-210). On the device the appended column is
  one more float32 dot product a user (``make_new_item_eval_step``).

Both score SASRec users (the JAX package passes "sasrec"), on the model's
device, in eval mode.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.loader import EvalBatches, pad_histories, pad_user_sequences
from ..ops.metrics import hit_and_ndcg, masked_catalog_scores
from .evaluate import eval_mode, evaluate


def read_behaviors_special(file_for_cold: str, file_for_new: Optional[str],
                           item_name_to_id: Dict[str, int],
                           before_item_id_to_dic: Dict[int, object],
                           before_item_name_to_id: Dict[str, int],
                           use_modal: bool):
    """(seqs_for_cold, history_for_cold, seqs_for_new, history_for_new,
    new_item_id_to_content), reference special.py:44-94. A cold line's items
    are catalog ids. A new line's inputs are catalog ids and its last item,
    looked up in the "before" catalog, gets a new id: 1, 2, ... in the order
    new items first appear; new_item_id_to_content maps those ids to the
    before catalog's content. Without a modal tower or a new file, the last
    three are None."""
    seqs_for_cold, history_for_cold = {}, {}
    with open(file_for_cold) as f:
        for uid, line in enumerate(f):
            names = line.strip("\n").split("\t")[1].split(" ")
            seq = [item_name_to_id[n] for n in names]
            seqs_for_cold[uid] = seq
            history_for_cold[uid] = np.asarray(seq[:-1], dtype=np.int64)

    if not use_modal or file_for_new is None:
        return seqs_for_cold, history_for_cold, None, None, None

    new_item_id_to_content = {}
    item_id_before_to_new = {}
    seqs_for_new, history_for_new = {}, {}
    with open(file_for_new) as f:
        for uid, line in enumerate(f):
            names = line.strip("\n").split("\t")[1].split(" ")
            before_id = before_item_name_to_id[names[-1]]
            if before_id not in item_id_before_to_new:
                new_id = len(item_id_before_to_new) + 1
                item_id_before_to_new[before_id] = new_id
                new_item_id_to_content[new_id] = before_item_id_to_dic[
                    before_id]
            inputs = [item_name_to_id[n] for n in names[:-1]]
            seqs_for_new[uid] = inputs + [item_id_before_to_new[before_id]]
            history_for_new[uid] = np.asarray(inputs, dtype=np.int64)
    return (seqs_for_cold, history_for_cold, seqs_for_new, history_for_new,
            new_item_id_to_content)


def eval_cold(model, item_table: torch.Tensor, seqs_for_cold,
              history_for_cold, max_seq_len: int, batch_size: int,
              topk: int = 10, per_user: bool = False):
    """Cold eval: the full-catalog eval over the cold users
    (special.py:151-181), histories max_seq_len + 2 wide; ``evaluate``'s
    result (per_user: with the per-user hits and nDCGs)."""
    seqs, lens = pad_user_sequences(seqs_for_cold, max_seq_len + 1)
    hist = pad_histories(history_for_cold, max_seq_len + 2)
    batches = EvalBatches(seqs, lens, max_seq_len, batch_size, hist)
    return evaluate(model, item_table, batches, topk, per_user=per_user)


def make_new_item_eval_step(model, topk: int = 10):
    """step(item_table, new_embs, ids, log_mask, new_target, history,
    valid) -> per-user (hit, ndcg, valid) float32 vectors, zero on padding
    users: the SASRec state at the last position scored against the
    history-masked catalog, and the user's new item as one more column, its
    float32 dot product; its rank counts the catalog items (padding column
    left out) that score strictly higher."""

    @torch.no_grad()
    def step(item_table, new_embs, ids, log_mask, new_target, history,
             valid):
        with eval_mode(model):
            uvec = model.user_states(item_table[ids], log_mask)[:, -1]
        scores = masked_catalog_scores(uvec, item_table, history)
        tgt = (uvec.float() * new_embs[new_target].float()).sum(-1)
        rank = (scores[:, 1:] > tgt[:, None]).sum(1) + 1
        hit, ndcg = hit_and_ndcg(rank, topk)
        v = valid.float()
        return hit * v, ndcg * v, v

    return step


def eval_new(model, item_table: torch.Tensor, new_item_embs: torch.Tensor,
             seqs_for_new, history_for_new, max_seq_len: int,
             batch_size: int, topk: int = 10, per_user: bool = False):
    """New-item eval (special.py:182-214): (HR@topk, nDCG@topk) over the new
    users, with (per_user) their hits and nDCGs. seqs_for_new's last item of
    each user is a new-item id, a row of new_item_embs (row 0 padding), not
    a catalog id. The inputs are left-padded to max_seq_len; the last batch
    is padded with the last user, masked out by ``valid``."""
    device = item_table.device
    uids = sorted(seqs_for_new)
    seqs, lens = pad_user_sequences({u: seqs_for_new[u][:-1] for u in uids},
                                    max_seq_len)
    targets = np.asarray([seqs_for_new[u][-1] for u in uids], np.int64)
    hist = pad_histories(history_for_new, max_seq_len + 2)
    n, L = seqs.shape
    step = make_new_item_eval_step(model, topk)
    pos = np.arange(L)[None, :]
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)
    hits, ndcgs, valids = [], [], []
    for i in range(0, -(-n // batch_size) * batch_size, batch_size):
        idx = np.minimum(np.arange(i, i + batch_size), n - 1)
        lm = (pos >= (L - lens[idx])[:, None]).astype(np.float32)
        h, nd, v = step(item_table, new_item_embs, t(seqs[idx], torch.long),
                        t(lm, torch.float32), t(targets[idx], torch.long),
                        t(hist[idx], torch.long),
                        t(np.arange(i, i + batch_size) < n, torch.bool))
        hits.append(h)
        ndcgs.append(nd)
        valids.append(v)
    h, nd, v = (torch.cat(x).cpu().numpy() for x in (hits, ndcgs, valids))
    count = max(float(v.sum(dtype=np.float64)), 1.0)
    hr = float(h.sum(dtype=np.float64)) / count
    ndcg = float(nd.sum(dtype=np.float64)) / count
    if per_user:
        keep = v > 0
        return hr, ndcg, h[keep], nd[keep]
    return hr, ndcg


@torch.no_grad()
def encode_new_items(model, content, batch_size: int,
                     images: bool = False) -> torch.Tensor:
    """The new items' (n + 1, D) float32 embeddings through the item tower,
    in eval mode and in chunks of ``batch_size``, from their content (token
    rows or images, row 0 the padding item's) on the model's device. Every
    id is 0, as in the JAX runner: an ID+modality fusion tower adds its
    padding ID row, never a catalog item's. Images are the padding item's
    only in row 0 (the JAX runner's zero ids mark every image so: ROADMAP
    C13)."""
    device = next(model.parameters()).device
    n = content.shape[0]
    out = torch.empty((n, model.embedding_dim), dtype=torch.float32,
                      device=device)
    with eval_mode(model):
        for start in range(0, n, batch_size):
            chunk = torch.as_tensor(content[start:start + batch_size]
                                    ).to(device)
            ids = torch.zeros(chunk.shape[0], dtype=torch.long,
                              device=device)
            pad = (torch.arange(start, start + chunk.shape[0],
                                device=device) == 0) if images else None
            out[start:start + chunk.shape[0]] = model.item_embs(
                ids, chunk, pad_mask=pad).float()
    return out
