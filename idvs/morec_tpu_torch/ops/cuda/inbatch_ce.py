"""In-batch debiased cross-entropy with an online softmax: the kernel
edition of ``ops/losses.py`` (``use_pallas`` in the train step).

Kernels: ``csrc/inbatch_ce.cu``. They replace the TPU kernels
``idvs/morec_tpu/ops/pallas/inbatch_ce.py`` ``fused_inbatch_ce`` and
``fused_inbatch_ce_gathered`` (``_fwd_kernel`` and ``_bwd_kernel``): the
(B*L, N) logits and the rejection and one-hot masks never exist in device
memory. The forward walks the candidate columns in tiles with a running
max, sum and label logit a row; the backward recomputes the logits from
the saved max and sum and returns du and dcand from two passes that each
own their output (no atomics: two runs give the same bits). On the H100
the work is three to five products of 2*M*N*D operations, bound by the
card's float FMA rate; the .cu header has the design.

``fused_ce`` takes explicit candidates (the JAX ``_fused_ce``):
``fused_inbatch_ce`` passes the batch's own items, and
``fused_inbatch_ce_gathered`` every rank's items, all-gathered over the
process group, with the label offset of its rows. For tensors on the CPU
``fused_ce`` runs the plain version ``inbatch_ce_candidates`` (autograd
gives its gradient); for tensors on the card it launches the forward
kernel through a ``torch.autograd.Function`` whose backward is
``fused_inbatch_ce_bwd``, and it raises for what the kernels do not take.
``fused_inbatch_ce.launches`` counts the forward's launches (both
editions), ``fused_inbatch_ce_bwd.launches`` the backward's.
"""

from __future__ import annotations

import torch

from ..losses import (candidate_colmask, gathered_candidates,
                      inbatch_ce_candidates)
from . import lib
from .gemm import sm_count

ROWS, COLS, DEPTH = 32, 128, 16   # a block's rows, a column tile, a slice


def _geometry(user_vec, cand_embs, item_ids, log_mask, cand_ids,
              cand_colmask, cand_logpop):
    if user_vec.dim() != 3 or cand_embs.dim() != 3:
        raise ValueError(f"user_vec (B, L, D) and cand_embs (WB, S, D), got "
                         f"{tuple(user_vec.shape)} and "
                         f"{tuple(cand_embs.shape)}")
    B, L, D = user_vec.shape
    WB, S, Dc = cand_embs.shape
    if S != L + 1 or Dc != D:
        raise ValueError(f"cand_embs must be (WB, {L + 1}, {D}), got "
                         f"{tuple(cand_embs.shape)}")
    if tuple(item_ids.shape) != (B, S) or tuple(log_mask.shape) != (B, L):
        raise ValueError(f"item_ids (B, S) = {(B, S)} and log_mask (B, L) = "
                         f"{(B, L)}, got {tuple(item_ids.shape)} and "
                         f"{tuple(log_mask.shape)}")
    for name, t in (("cand_ids", cand_ids), ("cand_colmask", cand_colmask),
                    ("cand_logpop", cand_logpop)):
        if tuple(t.shape) != (WB, S):
            raise ValueError(f"{name} must be {(WB, S)}, got "
                             f"{tuple(t.shape)}")
    return B, L, D, WB * S


def _operands(user_vec, cand_embs, item_ids, log_mask, cand_ids,
              cand_colmask, cand_logpop, label_off):
    """The launch's operands; raises for what the kernels do not take."""
    B, L, D, N = _geometry(user_vec, cand_embs, item_ids, log_mask,
                           cand_ids, cand_colmask, cand_logpop)
    code = lib.dtype_code(user_vec)
    if cand_embs.dtype != user_vec.dtype:
        raise TypeError(f"user_vec and cand_embs must share a dtype, got "
                        f"{user_vec.dtype} and {cand_embs.dtype}")
    if D % DEPTH:
        raise ValueError(f"the kernels take D a multiple of {DEPTH}, got {D}")
    if not (user_vec.is_contiguous() and cand_embs.is_contiguous()):
        raise ValueError("user_vec and cand_embs must be contiguous")
    lib.check_device(user_vec, cand_embs, item_ids, log_mask, cand_ids,
                     cand_colmask, cand_logpop)
    lib.check_aligned(user_vec, cand_embs)
    aux = (item_ids.to(torch.int32).contiguous(),
           cand_ids.to(torch.int32).contiguous(),
           cand_colmask.float().contiguous(),
           cand_logpop.float().contiguous())
    w = (log_mask.reshape(-1) != 0).float()
    return (B, L, D, N, int(label_off), code), aux, w


def _splits(M, N, sms):
    """(per, splits): the N / 128 column tiles of a row tile split over
    enough blocks for two waves, `per` tiles each, none empty."""
    tiles = -(-N // COLS)
    want = max(1, min(tiles, -(-2 * sms // -(-M // ROWS))))
    per = -(-tiles // want)
    return per, -(-tiles // per)


def _launch_fwd(user_vec, cand_embs, geo, aux):
    """(ce, m, l) of every row, float32 (M,)."""
    B, L, D, N, label_off, code = geo
    M = B * L
    per, splits = _splits(M, N, sm_count(user_vec.device.index or 0))
    part = torch.empty(3 * splits * M, device=user_vec.device)
    ce, m, l = (torch.empty(M, device=user_vec.device) for _ in range(3))
    err = lib.library().idvs_inbatch_ce_fwd(
        user_vec.data_ptr(), cand_embs.data_ptr(),
        *(t.data_ptr() for t in aux), part.data_ptr(), ce.data_ptr(),
        m.data_ptr(), l.data_ptr(), M, N, D, L, L + 1, label_off, per,
        splits, code, lib.stream_handle(user_vec))
    lib.check(err, "fused_inbatch_ce")
    fused_inbatch_ce.launches += 1
    return ce, m, l


def fused_inbatch_ce_bwd(user_vec, cand_embs, geo, aux, m, l, ws):
    """(du, dcand) in the inputs' dtypes and shapes, from the forward's
    operands, its row max m and sum l, and ws = w * g / n_valid."""
    B, L, D, N, label_off, code = geo
    du = torch.empty_like(user_vec)
    dcand = torch.empty_like(cand_embs)
    err = lib.library().idvs_inbatch_ce_bwd(
        user_vec.data_ptr(), cand_embs.data_ptr(),
        *(t.data_ptr() for t in aux), m.data_ptr(), l.data_ptr(),
        ws.data_ptr(), du.data_ptr(), dcand.data_ptr(), B * L, N, D, L,
        L + 1, label_off, code, lib.stream_handle(user_vec))
    lib.check(err, "fused_inbatch_ce_bwd")
    fused_inbatch_ce_bwd.launches += 1
    return du, dcand


def _loss(ce, w):
    n_valid = w.sum().clamp_min(1.0)
    return (ce * w).sum() / n_valid, n_valid


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_vec, cand_embs, geo, aux, w):
        ce, m, l = _launch_fwd(user_vec, cand_embs, geo, aux)
        loss, n_valid = _loss(ce, w)
        ctx.save_for_backward(user_vec, cand_embs, m, l, w, n_valid)
        ctx.geo, ctx.aux = geo, aux
        return loss

    @staticmethod
    def backward(ctx, g):
        user_vec, cand_embs, m, l, w, n_valid = ctx.saved_tensors
        ws = (w * g / n_valid).contiguous()
        du, dcand = fused_inbatch_ce_bwd(user_vec, cand_embs, ctx.geo,
                                         ctx.aux, m, l, ws)
        return du, dcand, None, None, None


def fused_ce(user_vec: torch.Tensor, cand_embs: torch.Tensor,
             item_ids: torch.Tensor, log_mask: torch.Tensor,
             cand_ids: torch.Tensor, cand_colmask: torch.Tensor,
             cand_logpop: torch.Tensor, label_off: int = 0) -> torch.Tensor:
    """The in-batch CE of the local rows against explicit candidates (the
    arguments of ``inbatch_ce_candidates``): user_vec (B, L, D) and
    cand_embs (WB, S, D) float32 or bfloat16, both of one dtype, D a
    multiple of 16; the loss is float32, du and dcand in the inputs'
    dtypes."""
    _geometry(user_vec, cand_embs, item_ids, log_mask, cand_ids,
              cand_colmask, cand_logpop)
    if user_vec.device.type == "cpu":
        return inbatch_ce_candidates(user_vec, cand_embs, item_ids, log_mask,
                                     cand_ids, cand_colmask, cand_logpop,
                                     label_off)
    geo, aux, w = _operands(user_vec, cand_embs, item_ids, log_mask,
                            cand_ids, cand_colmask, cand_logpop, label_off)
    if torch.is_grad_enabled() and (user_vec.requires_grad
                                    or cand_embs.requires_grad):
        return _FusedCE.apply(user_vec, cand_embs, geo, aux, w)
    return _loss(_launch_fwd(user_vec, cand_embs, geo, aux)[0], w)[0]


def fused_inbatch_ce(user_vec: torch.Tensor, item_embs: torch.Tensor,
                     item_ids: torch.Tensor, log_mask: torch.Tensor,
                     log_pop: torch.Tensor) -> torch.Tensor:
    """``ops.losses.inbatch_debiased_ce`` with the batch's own items as the
    candidates (JAX ``fused_inbatch_ce``); log_pop is (B, S)."""
    return fused_ce(user_vec, item_embs, item_ids, log_mask, item_ids,
                    candidate_colmask(log_mask), log_pop)


def fused_inbatch_ce_gathered(user_vec: torch.Tensor,
                              item_embs: torch.Tensor,
                              item_ids: torch.Tensor, log_mask: torch.Tensor,
                              log_pop: torch.Tensor, pg) -> torch.Tensor:
    """The ``gather_negatives`` edition (JAX ``fused_inbatch_ce_gathered``,
    the process group ``pg`` in place of ``axis_name``): the candidates are
    every rank's items, the rows stay local, and the gradient of the
    gathered embeddings flows back through the reduce-scatter. With W
    ranks the logits are (B*L, W*B*S), which the composition would hold in
    device memory and the kernels never do."""
    embs, ids, colmask, logpop, off = gathered_candidates(
        item_embs, item_ids, log_mask, log_pop, pg)
    return fused_ce(user_vec, embs, item_ids, log_mask, ids, colmask, logpop,
                    off)


fused_inbatch_ce.launches = 0
fused_inbatch_ce_bwd.launches = 0
