"""The reference losses (JAX twin: idvs/morec_tpu/ops/losses.py), in plain
PyTorch.

The in-batch debiased cross-entropy is a (B*L, N) score matmul and
elementwise masks. The kernel edition, ``ops/cuda/inbatch_ce.py`` (the JAX
package's ``fused_inbatch_ce``), runs under ``use_pallas``; on the CPU it
runs ``inbatch_ce_candidates`` below, so this composition is its plain
version.

With ``gather_negatives`` the candidates are every rank's items: the
embeddings, ids, column masks and log popularity are all-gathered over the
process group (``parallel/mesh.py``), and the labels of rank r's rows sit
r * B * S columns in.

The two BCE losses (sampled negatives for SASRec, the (1 + neg) candidates
of DSSM) are dot products and a softplus, which the JAX package computes
outside any Pallas kernel too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import mesh
from .masking import label_columns

MASK_VAL = -1e4   # the reference masks logits to -1e4, not -inf


def _log_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean softmax CE: the mean over rows whose weight is not 0."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt = logp.gather(-1, labels[..., None])[..., 0]
    w = (weights != 0).to(logits.dtype)
    return -(tgt * w).sum() / w.sum().clamp_min(1.0)


def inbatch_ce_candidates(user_vec: torch.Tensor, cand_embs: torch.Tensor,
                          item_ids: torch.Tensor, log_mask: torch.Tensor,
                          cand_ids: torch.Tensor, cand_colmask: torch.Tensor,
                          cand_logpop: torch.Tensor,
                          label_off: int = 0) -> torch.Tensor:
    """The CE of the local rows against explicit candidates (the inputs of
    the JAX ``_fused_ce``, ops/pallas/inbatch_ce.py:175).

    user_vec (B, L, D); cand_embs (WB, S, D), S = L + 1; item_ids (B, S)
    the local users' ids; log_mask (B, L); cand_ids, cand_colmask and
    cand_logpop (WB, S). Row (i, j) scores every candidate column c:
    u . cand - logpop in float32, -1e4 where the column mask is 0 or where
    the candidate's id is among user i's ids, except at its label column
    label_off + i * S + j + 1. Returns the mean CE over the rows whose log
    mask is not 0.
    """
    B, L, D = user_vec.shape
    N = cand_embs.shape[0] * cand_embs.shape[1]
    logits = user_vec.reshape(B * L, D).float() @ \
        cand_embs.reshape(N, D).float().T
    logits = logits - cand_logpop.reshape(1, -1).float()
    masked = torch.full_like(logits, MASK_VAL)
    logits = torch.where(cand_colmask.reshape(1, -1) == 0, masked, logits)
    # reject[i, c]: candidate c's id is in user i's list; the label of row
    # (i, j) is exempt
    reject = (item_ids[:, :, None] == cand_ids.reshape(1, 1, -1)).any(dim=1)
    lab = label_columns(B, L, device=user_vec.device) + int(label_off)
    onehot = torch.zeros(B, L, N, dtype=torch.bool, device=user_vec.device)
    onehot.scatter_(2, lab[..., None], True)
    reject3 = (reject[:, None, :] & ~onehot).reshape(B * L, N)
    logits = torch.where(reject3, masked, logits)
    return _log_softmax_ce(logits, lab.reshape(-1), log_mask.reshape(-1))


def candidate_colmask(log_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) column mask of a batch's items: the log mask of the first L
    slots, the last slot always on."""
    return torch.cat([log_mask, log_mask.new_ones(log_mask.shape[0], 1)],
                     dim=1)


def gathered_candidates(item_embs, item_ids, log_mask, log_pop, pg):
    """(cand_embs, cand_ids, cand_colmask, cand_logpop, label_off) of the
    global batch: every rank's (B, S) candidates, rank-major, the
    embeddings' gradient flowing back through the reduce-scatter; label_off
    = rank * B * S."""
    if pg is None:
        raise RuntimeError("gather_negatives needs a process group: call "
                           "parallel.mesh.init_distributed first")
    B, S = item_ids.shape
    label_off = mesh.process_index(pg) * B * S
    return (mesh.all_gather(item_embs, pg), mesh.all_gather(item_ids, pg),
            mesh.all_gather(candidate_colmask(log_mask), pg),
            mesh.all_gather(log_pop, pg), label_off)


def inbatch_debiased_ce(user_vec: torch.Tensor, item_embs: torch.Tensor,
                        item_ids: torch.Tensor, log_mask: torch.Tensor,
                        log_pop: torch.Tensor,
                        gather_negatives: bool = False,
                        pg=None) -> torch.Tensor:
    """In-batch debiased cross-entropy (reference model.py:31-69).

    user_vec (B, L, D) user states; item_embs (B, S, D), S = L + 1, the
    embeddings of the padded item sequence (the candidates); item_ids (B, S)
    (0 = padding); log_mask (B, L) 0/1 validity of each transition; log_pop
    (B, S) log popularity of each item. Returns the mean CE over valid rows:
    logits in float32, minus log_pop (the debias); padding columns and the
    columns of a user's own items, except the label, at -1e4. With
    ``gather_negatives`` the candidates are the global batch's, gathered
    over the process group ``pg`` (the local mean; the train step averages
    over the ranks).
    """
    if gather_negatives:
        embs, ids, colmask, logpop, off = gathered_candidates(
            item_embs, item_ids, log_mask, log_pop, pg)
        return inbatch_ce_candidates(user_vec, embs, item_ids, log_mask, ids,
                                     colmask, logpop, off)
    return inbatch_ce_candidates(user_vec, item_embs, item_ids, log_mask,
                                 item_ids, candidate_colmask(log_mask),
                                 log_pop)


def bce_sasrec_loss(user_vec: torch.Tensor, pos_embs: torch.Tensor,
                    neg_embs: torch.Tensor,
                    log_mask: torch.Tensor) -> torch.Tensor:
    """BCE over per-position (pos, neg) dot scores (reference
    bce_text/main-end2end/model/model.py:43-51).

    user_vec (B, L, D) user states; pos_embs and neg_embs (B, L, D) the
    embeddings of the next positives and of the sampled negatives; log_mask
    (B, L). Scores and softplus in float32 whatever the inputs' dtype; mean
    BCE(pos, 1) plus mean BCE(neg, 0), both over the valid positions, n =
    max(#valid, 1).
    """
    u = user_vec.float()
    pos_score = (u * pos_embs.float()).sum(-1)
    neg_score = (u * neg_embs.float()).sum(-1)
    w = (log_mask != 0).float()
    n = w.sum().clamp_min(1.0)
    # BCEWithLogits: softplus(-x) for label 1, softplus(x) for label 0
    pos_loss = (F.softplus(-pos_score) * w).sum() / n
    neg_loss = (F.softplus(neg_score) * w).sum() / n
    return pos_loss + neg_loss


def bce_dssm_loss(user_vec: torch.Tensor, item_vecs: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """DSSM pointwise BCE (reference bce_text/main-end2end(DSSM)/model/
    model.py:40-43): user_vec (B, D), item_vecs (B, 1 + neg, D), labels
    (B, 1 + neg) in {0, 1}; the mean over every element, in float32."""
    scores = torch.einsum("bnd,bd->bn", item_vecs.float(), user_vec.float())
    per = F.softplus(scores) - scores * labels.float()
    return per.mean()
