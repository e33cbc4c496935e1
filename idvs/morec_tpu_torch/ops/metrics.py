"""Full-catalog retrieval metrics on the device (JAX twin: idvs/morec_tpu/
ops/metrics.py).

Replaces the reference's per-user Python scoring loop
(inbatch_sasrec_e2e_text/data_utils/metrics.py:90-102) with one batched
computation:

    scores  = user_emb @ item_embs.T          (B, I+1) float32 matmul
    history -> -inf scatter                   (metrics.py:99-100)
    drop padding column 0                     (metrics.py:101 'score[1:]')
    rank of target                            (metrics.py:49-57)
    HR@K = rank <= K ; nDCG@K = 1/log2(rank+1)

Rank semantics: the reference sorts descending and takes the target's
1-based position; rank = 1 + #{j : score_j > score_target} is the same but
for exact ties, which continuous scores make measure-zero.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_catalog_scores(user_emb: torch.Tensor, item_embs: torch.Tensor,
                          history: torch.Tensor) -> torch.Tensor:
    """(B, D) x (I+1, D) -> (B, I+1) float32 scores with history positions
    at -inf.

    history: (B, H) int ids padded with 0; padding clobbers column 0, which is
    the padding item and gets dropped before ranking anyway (metrics.py:101).
    The product is the library's float32 matmul, as the JAX package's is
    ``jnp.dot`` outside any kernel.
    """
    scores = user_emb.float() @ item_embs.float().T
    return scores.scatter_(1, history.long(), -torch.inf)


def target_rank(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1-based rank of `target` (id >= 1) among columns 1..I of `scores`.

    scores: (B, I+1) history-masked; target: (B,) int ids.
    """
    tgt = scores.gather(1, target.long()[:, None])                # (B, 1)
    # count over real items only (drop padding column 0)
    return (scores[:, 1:] > tgt).sum(dim=1) + 1


def hit_and_ndcg(rank: torch.Tensor, topk: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HR@K and nDCG@K per user, float32 (reference metrics.py:49-57)."""
    hit = (rank <= topk).float()
    return hit, hit / torch.log2(rank.float() + 1.0)
