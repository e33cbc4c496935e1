"""Full-catalog evaluation on one device (JAX twin: idvs/morec_tpu/train/
evaluate.py).

Replaces the reference eval path (inbatch_sasrec_e2e_text/data_utils/
metrics.py:60-107):
- the catalog encode: the item tower over every id in fixed chunks
  (``compute_item_embeddings``; the reference's get_item_embeddings);
- user scoring: one batched step a user batch, the SASRec state at the last
  position (DSSM: the user tower's vector of the batch's user ids), the
  (B, I+1) float32 catalog product, the history set to -inf, the rank of
  the target, HR@10 / nDCG@10 (``make_eval_step``; the reference's
  per-user Python loop, metrics.py:90-102, and DSSM's, bce_text/
  main-end2end(DSSM)/data_utils/metrics.py:93-120);
- aggregation: padding users are masked out exactly, reproducing
  SequentialDistributedSampler's pad-then-truncate semantics
  (dataset.py:68-94, metrics.py:33-46).

Both run under ``eval_mode``, so the result is the same whatever mode the
model is in: a ResNet's BatchNorm normalises with its running averages, and
ViT-MAE masks each chunk's patches with a generator seeded as the JAX
encode seeds its ``masking`` key (evaluate.py:59), so two encodes of a
catalog agree. The host builds the next user batch on a worker thread while
the device scores the current one (``data/vision_loader.py``
``Prefetcher``), in order, so prefetching changes no result.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..data.vision_loader import Prefetcher
from ..ops.metrics import hit_and_ndcg, masked_catalog_scores, target_rank


@contextlib.contextmanager
def eval_mode(model):
    """Runs the block with ``model`` in eval mode (no dropout, no DropPath:
    the JAX package passes ``deterministic=True`` to every encode and
    request), then restores the caller's mode."""
    training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(training)


@torch.no_grad()
def compute_item_embeddings(model, item_num: int,
                            item_content: Optional[torch.Tensor],
                            embedding_dim: int,
                            batch_size: int = 512,
                            content_fn=None) -> torch.Tensor:
    """Runs the item tower over ids 0..item_num -> (item_num + 1, D) float32
    table on the model's device, in eval mode (``eval_mode``).

    The catalog goes through in fixed chunks of ``batch_size`` ids (the
    reference's item_emb_batch_size); the last chunk is padded with the last
    id so every chunk has the same shape. ``item_content`` holds the
    (item_num + 1, W) token rows, or a two-stage tower's float32 cache, on
    the device (None for the ID tower); the tower takes each chunk's ids
    with its content (ID+modality fusion reads both).
    ``content_fn``, when given, takes its place: it maps a chunk's ids (a
    numpy array) to the chunk's content (images from a store), as a numpy
    array or a tensor, which is moved to the model's device.
    """
    device = next(model.parameters()).device
    total = item_num + 1
    table = torch.empty((total, embedding_dim), dtype=torch.float32,
                        device=device)
    with eval_mode(model):
        for start in range(0, total, batch_size):
            ids = torch.arange(start, start + batch_size, device=device)
            ids = ids.clamp_max(item_num)
            if content_fn is not None:
                content = torch.as_tensor(content_fn(ids.cpu().numpy())
                                          ).to(device)
            else:
                content = None if item_content is None else item_content[ids]
            chunk = model.item_embs(ids, content)
            n = min(batch_size, total - start)
            table[start:start + n] = chunk[:n].float()
    return table


def make_eval_step(model, topk: int = 10):
    """step(item_table, ids, log_mask, target, history, valid) -> per-user
    (hit, ndcg, valid) float32 vectors on the device, zero on padding users,
    so the caller can take exact means (and tests can compare per-user
    values against the reference's metrics_topK outputs). The towers run in
    eval mode. By the model's user tower (the JAX ``user_tower``
    argument): SASRec scores the state of the item ids at the last
    position; DSSM takes ``ids`` as (B,) user ids and scores their
    ``user_vec`` (the log mask unused)."""

    @torch.no_grad()
    def step(item_table, ids, log_mask, target, history, valid):
        with eval_mode(model):
            if model.user_tower == "dssm":
                uvec = model.user_vec(ids)
            else:
                uvec = model.user_states(item_table[ids], log_mask)[:, -1]
        scores = masked_catalog_scores(uvec, item_table, history)
        hit, ndcg = hit_and_ndcg(target_rank(scores, target), topk)
        v = valid.float()
        return hit * v, ndcg * v, v

    return step


def evaluate(model, item_table: torch.Tensor, eval_batches,
             topk: int = 10, per_user: bool = False):
    """Mean HR@topk and nDCG@topk over all true users of ``eval_batches``
    (``data/loader.py`` ``EvalBatches``, or the runner's DSSM pair batches
    with user ids in the id slot), scored against ``item_table`` on its
    device.

    per_user=True additionally returns (hits, ndcgs) numpy arrays of the
    true users in order -- the reference's stacked eval_all_user tensors
    before eval_concat's mean (metrics.py:103-106).
    """
    step = make_eval_step(model, topk)
    device = item_table.device
    dtypes = (torch.long, torch.float32, torch.long, torch.long, torch.bool)

    def host(raw):   # on the worker thread
        return [torch.from_numpy(np.asarray(x)).to(dt)
                for x, dt in zip(raw, dtypes)]

    hits, ndcgs, valids = [], [], []
    for batch in Prefetcher(iter(eval_batches), host):
        h, n, v = step(item_table, *(x.to(device) for x in batch))
        hits.append(h)
        ndcgs.append(n)
        valids.append(v)
    h, n, v = (torch.cat(x).cpu().numpy() for x in (hits, ndcgs, valids))
    count = max(float(v.sum(dtype=np.float64)), 1.0)
    hr = float(h.sum(dtype=np.float64)) / count
    nd = float(n.sum(dtype=np.float64)) / count
    if per_user:
        keep = v > 0
        return hr, nd, h[keep], n[keep]
    return hr, nd
