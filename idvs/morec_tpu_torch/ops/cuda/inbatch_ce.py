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
the work is four products of 2*M*N*D operations, on the tensor cores
(bf16 ``mma.sync``, float32 as 3xTF32); the .cu header has the design and
``ce_plan`` the block plan that the kernels check.

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

import functools
import heapq

import torch

from ..losses import (candidate_colmask, gathered_candidates,
                      inbatch_ce_candidates)
from . import lib
from .gemm import ptr, sm_count

DEPTH = 16                  # D is a multiple of this
OWN, OTHER = 64, 128        # a block's own rows, the other side's tile
# the cp.async rings by compute dtype (csrc/inbatch_ce.cu FwdRing,
# BwdRing): stages, bytes of a logit slice's row, and the backward's other
# rows a gradient slice
FWD_RING = {torch.bfloat16: (2, 256), torch.float32: (3, 128)}
BWD_RING = {torch.bfloat16: (2, 512, 64), torch.float32: (3, 256, 16)}
META_ROWS = 128             # rows of either side a tile stages
GRAD_COLS = (128, 256, 512)     # the gradient columns DC a block may own
BLOCKS_PER_SM = {"fwd": 2, "bwd": 1}    # the kernels' launch bounds
# a block's operations a second on one SM (the tensor cores' mma.sync
# rate of gemm.cu, PERF.md: bf16 about 150 TFLOP/s, 3xTF32 about 40, on 132
# SMs), a block's fixed cost and the partial sums' rate, seconds: only the
# ranking of plans depends on them
SM_RATE = {torch.bfloat16: 150e12 / 132, torch.float32: 40e12 / 132}
BLOCK_COST, PARTIAL_RATE = 2e-6, 2.5e12


def _meta_words(L: int, S: int, fwd: bool) -> int:
    """csrc/inbatch_ce.cu meta_words: the staged rows and columns, the
    users' rejection bits and ids (S rounded up to a multiple of 4), the
    forward's warp partials."""
    users = META_ROWS // L + 2
    return (8 * META_ROWS + users * (4 + -(-S // 4) * 4)
            + (3 * 4 * OWN if fwd else 0))


def _stage_elems(it: int, slice_bytes: int, rows: int = 0,
                 dc: int = 0) -> int:
    """Elements of a ring stage: a logit slice of `slice_bytes` a row for
    the own and other rows, or a gradient slice of `rows` other rows' DC
    columns (csrc/inbatch_ce.cu Tiles)."""
    logit = (OWN + OTHER) * (slice_bytes // it + 8)
    return max(logit, rows * (dc + (8 if it == 2 else 4)))


def _makespan(costs, slots: int) -> float:
    """Blocks dispatched in grid order to the first free one of `slots`
    places: the time the last one ends."""
    if len(costs) <= slots:
        return max(costs)
    ends = [0.0] * slots
    for c in costs:
        heapq.heapreplace(ends, ends[0] + c)
    return max(ends)


def _split_options(tiles: int, most: int):
    """(per, splits) of every way to cut `tiles` into `splits` non-empty
    ranges of `per`, at most `most` ranges."""
    seen = []
    for want in range(1, min(tiles, most) + 1):
        per = -(-tiles // want)
        opt = (per, -(-tiles // per))
        if opt not in seen:
            seen.append(opt)
    return seen


@functools.lru_cache(maxsize=None)
def ce_plan(M: int, N: int, D: int, L: int, dtype: torch.dtype,
            sms: int = 132) -> dict:
    """The launch plan of the CE kernels for M rows of L positions, N
    candidates of D columns, on a card of ``sms`` SMs. Both passes cut the
    work into tiles of ``own`` rows of one side by ``other`` of the other.
    The forward: a block owns a row tile and a range of ``fwd_per`` column
    tiles, ``fwd_splits`` ranges a row tile. The backward: blocks own a
    tile of u's rows (the du pass) or of the candidates (the dcand pass)
    and ``dc`` gradient columns (``chunks`` of them cover D), and walk a
    range of the other side's tiles, ``per_u`` / ``per_c`` tiles in
    ``splits_u`` / ``splits_c`` ranges; a pass split more than once sums
    float partials. The splits are those that end soonest when the blocks
    run in grid order on ``BLOCKS_PER_SM`` places an SM (one split fewer
    where that costs under 2 %). ``fwd_smem`` / ``bwd_smem``: the blocks'
    shared-memory bytes, which the kernels check."""
    if D < DEPTH or D % DEPTH:
        raise ValueError(f"the kernels take D a multiple of {DEPTH}, got {D}")
    if M < 1 or N < 1 or L < 1 or M % L:
        raise ValueError(f"M = {M} rows of L = {L} positions, N = {N}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    it, S = (2 if dtype == torch.bfloat16 else 4), L + 1
    rate = SM_RATE[dtype]
    tile_ops = 2 * OWN * OTHER

    def best(options, cost, splits):
        """The option that ends soonest, or the one of fewest splits
        within 2 % of it."""
        costs = [cost(o) for o in options]
        near = [o for o, c in zip(options, costs) if c <= 1.02 * min(costs)]
        return min(near, key=splits)

    # forward: blocks (row tile, split), row tiles first
    rows, cols = -(-M // OWN), -(-N // OTHER)
    slots = BLOCKS_PER_SM["fwd"] * sms
    block_rate = rate / BLOCKS_PER_SM["fwd"]

    def fwd_cost(opt):
        per, splits = opt
        costs = []
        for y in range(splits):
            n = min(per, cols - y * per)
            costs += [n * tile_ops * D / block_rate + BLOCK_COST] * rows
        return _makespan(costs, slots) + 12 * splits * M / PARTIAL_RATE

    fwd_per, fwd_splits = best(
        [(p, s) for p, s in _split_options(cols, 64) if rows * s <= 8 * slots
         or s == 1], fwd_cost, lambda o: o[1])

    # backward: du blocks, then dcand blocks; own tile fastest, then the
    # split, then the gradient chunk
    dc = next(c for c in GRAD_COLS if D <= c or c == GRAD_COLS[-1])
    chunks = -(-D // dc)
    own_u, other_u = -(-M // OWN), -(-N // OTHER)
    own_c, other_c = -(-N // OWN), -(-M // OTHER)
    slots = BLOCKS_PER_SM["bwd"] * sms
    block_rate = rate / BLOCKS_PER_SM["bwd"]

    def pass_costs(own, other, per, splits):
        costs = []
        for y in range(splits):
            n = min(per, other - y * per)
            costs += [n * tile_ops * (D + dc) / block_rate + BLOCK_COST] * own
        return costs * chunks

    def bwd_cost(opt):
        (pu, su), (pc, sc) = opt
        costs = pass_costs(own_u, other_u, pu, su) + \
            pass_costs(own_c, other_c, pc, sc)
        partial = sum(s * rows_ * D * 8 for s, rows_ in ((su, M), (sc, N))
                      if s > 1)
        return _makespan(costs, slots) + partial / PARTIAL_RATE

    opts_u = [o for o in _split_options(other_u, 16)
              if own_u * chunks * o[1] <= 8 * slots or o[1] == 1]
    opts_c = [o for o in _split_options(other_c, 16)
              if own_c * chunks * o[1] <= 8 * slots or o[1] == 1]
    (per_u, splits_u), (per_c, splits_c) = best(
        [(a, b) for a in opts_u for b in opts_c], bwd_cost,
        lambda o: o[0][1] + o[1][1])

    stages, slice_bytes = FWD_RING[dtype]
    fwd_smem = (it * stages * _stage_elems(it, slice_bytes)
                + 4 * _meta_words(L, S, True))
    stages, slice_bytes, rows = BWD_RING[dtype]
    bwd_smem = (it * (stages * _stage_elems(it, slice_bytes, rows, dc)
                      + OWN * (OTHER + 8)) + 4 * _meta_words(L, S, False))
    if max(fwd_smem, bwd_smem) > lib.MAX_SMEM:
        raise ValueError(f"L = {L}: the staged users' ids do not fit a "
                         f"block's shared memory")
    return dict(own=OWN, other=OTHER, fwd_per=fwd_per, fwd_splits=fwd_splits,
                fwd_smem=fwd_smem, dc=dc, chunks=chunks, per_u=per_u,
                splits_u=splits_u, per_c=per_c, splits_c=splits_c,
                bwd_smem=bwd_smem)


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


def _plan(user_vec, M, N, D, L) -> dict:
    return ce_plan(M, N, D, L, user_vec.dtype,
                   sm_count(user_vec.device.index or 0))


def _launch_fwd(user_vec, cand_embs, geo, aux):
    """(ce, m, l) of every row, float32 (M,)."""
    B, L, D, N, label_off, code = geo
    M = B * L
    k = _plan(user_vec, M, N, D, L)
    part = torch.empty(3 * k["fwd_splits"] * M, device=user_vec.device)
    ce, m, l = (torch.empty(M, device=user_vec.device) for _ in range(3))
    err = lib.library().idvs_inbatch_ce_fwd(
        user_vec.data_ptr(), cand_embs.data_ptr(),
        *(t.data_ptr() for t in aux), part.data_ptr(), ce.data_ptr(),
        m.data_ptr(), l.data_ptr(), M, N, D, L, L + 1, label_off,
        k["fwd_per"], k["fwd_splits"], k["fwd_smem"], code,
        lib.stream_handle(user_vec))
    lib.check(err, "fused_inbatch_ce")
    fused_inbatch_ce.launches += 1
    return ce, m, l


def fused_inbatch_ce_bwd(user_vec, cand_embs, geo, aux, m, l, ws):
    """(du, dcand) in the inputs' dtypes and shapes, from the forward's
    operands, its row max m and sum l, and ws = w * g / n_valid."""
    B, L, D, N, label_off, code = geo
    M = B * L
    k = _plan(user_vec, M, N, D, L)
    du = torch.empty_like(user_vec)
    dcand = torch.empty_like(cand_embs)
    # the float partials of a pass split more than once
    part_u, part_c = (
        torch.empty(s * rows * D, device=user_vec.device) if s > 1 else None
        for s, rows in ((k["splits_u"], M), (k["splits_c"], N)))
    err = lib.library().idvs_inbatch_ce_bwd(
        user_vec.data_ptr(), cand_embs.data_ptr(),
        *(t.data_ptr() for t in aux), m.data_ptr(), l.data_ptr(),
        ws.data_ptr(), du.data_ptr(), dcand.data_ptr(), ptr(part_u),
        ptr(part_c), M, N, D, L, L + 1, label_off, k["dc"], k["per_u"],
        k["splits_u"], k["per_c"], k["splits_c"], k["bwd_smem"], code,
        lib.stream_handle(user_vec))
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
