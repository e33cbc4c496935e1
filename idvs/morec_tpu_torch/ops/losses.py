"""The in-batch debiased cross-entropy (JAX twin: idvs/morec_tpu/ops/
losses.py), in plain PyTorch: on the main path it is a composition of a
(B*L, B*S) score matmul and elementwise masks, not a kernel (the JAX
package's Pallas edition, ``fused_inbatch_ce``, is off by default).
"""

from __future__ import annotations

import torch

from .masking import label_columns

MASK_VAL = -1e4   # the reference masks logits to -1e4, not -inf


def _log_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean softmax CE: the mean over rows whose weight is not 0."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt = logp.gather(-1, labels[..., None])[..., 0]
    w = (weights != 0).to(logits.dtype)
    return -(tgt * w).sum() / w.sum().clamp_min(1.0)


def inbatch_debiased_ce(user_vec: torch.Tensor, item_embs: torch.Tensor,
                        item_ids: torch.Tensor, log_mask: torch.Tensor,
                        log_pop: torch.Tensor,
                        gather_negatives: bool = False) -> torch.Tensor:
    """In-batch debiased cross-entropy (reference model.py:31-69).

    user_vec (B, L, D) user states; item_embs (B, S, D), S = L + 1, the
    embeddings of the padded item sequence (the candidates); item_ids (B, S)
    (0 = padding); log_mask (B, L) 0/1 validity of each transition; log_pop
    (B, S) log popularity of each item. Returns the mean CE over valid rows:
    logits in float32, minus log_pop (the debias); padding columns and the
    columns of a user's own items, except the label, at -1e4.
    """
    if gather_negatives:
        raise NotImplementedError(
            "gather_negatives needs the mesh, which is not ported")
    B, L, D = user_vec.shape
    S = L + 1
    logits = user_vec.reshape(B * L, D).float() @ \
        item_embs.reshape(B * S, D).float().T
    logits = logits - log_pop.reshape(-1)[None, :].float()
    colmask = torch.cat([log_mask, log_mask.new_ones(B, 1)], dim=1)
    masked = torch.full_like(logits, MASK_VAL)
    logits = torch.where(colmask.reshape(1, -1) == 0, masked, logits)
    # reject[i, c]: candidate c's id is in user i's list; the label of row
    # (i, j) is exempt
    flat_ids = item_ids.reshape(-1)
    reject = (item_ids[:, :, None] == flat_ids[None, None, :]).any(dim=1)
    lab = label_columns(B, L, device=user_vec.device)
    onehot = torch.zeros(B, L, B * S, dtype=torch.bool,
                         device=user_vec.device)
    onehot.scatter_(2, lab[..., None], True)
    reject3 = (reject[:, None, :] & ~onehot).reshape(B * L, B * S)
    logits = torch.where(reject3, masked, logits)
    return _log_softmax_ce(logits, lab.reshape(-1), log_mask.reshape(-1))
