"""Data-parallel process groups (JAX twin: idvs/morec_tpu/parallel/mesh.py).

The reference trains data-parallel over NCCL, one process per GPU
(inbatch_sasrec_e2e_text/run.py:321). The JAX package runs one process per
host and a 'data' mesh axis over its chips; here each process drives one
card, which is its ``cuda:0`` (the kernels launch on device 0, so a launcher
gives each process its own card through ``CUDA_VISIBLE_DEVICES``), and the
'data' axis is the default ``torch.distributed`` group. Batches are split
by rows (``host_rows``), parameters are replicated, and the train step
averages the gradients over the group (JAX's ``pmean``).

Only what the data-parallel train step and the runner need is here: the
group, the row split, the rank and world size, rank 0's gate for logging
and checkpoints (``is_coordinator``), an all-gather whose gradient is the
reduce-scatter (the ``gather_negatives`` candidates), and a mean over the
group whose gradient is the mean of the ranks' gradients (``all_mean``:
the ResNet towers' SyncBN statistics, JAX's ``pmean`` inside
``value_and_grad``). ZeRO-1, sharded evaluation and multi-host batch
assembly are not ported.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor collectives and warns under the old names
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def init_distributed(rank: int, world_size: int, *,
                     init_method: Optional[str] = None, store=None,
                     backend: str = "nccl") -> None:
    """``torch.distributed.init_process_group`` (JAX's
    ``jax.distributed.initialize``): NCCL over the cards by default, "gloo"
    on the CPU. Give it ``init_method`` ("tcp://host:port",
    "file:///path") or a ``store`` (e.g. a ``FileStore``); with neither,
    the MASTER_ADDR / MASTER_PORT environment variables."""
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size)


def group():
    """The default process group, or None when none is up (one process,
    the single-device step)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def process_index(pg=None) -> int:
    return dist.get_rank(pg) if group() is not None else 0


def process_count(pg=None) -> int:
    return dist.get_world_size(pg) if group() is not None else 1


def is_coordinator() -> bool:
    """Rank 0's gate for logging and checkpointing (the reference's rank-0
    gating, run.py:265-267); True on one process."""
    return process_index() == 0


def host_rows(global_n: int) -> slice:
    """This process's contiguous row range of a global batch: rank p owns
    rows [p * per, (p + 1) * per); global_n must divide evenly."""
    world, rank = process_count(), process_index()
    if global_n % world:
        raise ValueError(f"a global batch of {global_n} rows does not split "
                         f"over {world} ranks")
    per = global_n // world
    return slice(rank * per, (rank + 1) * per)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along dim 0; its transpose is the reduce-scatter
    (SUM), JAX's ``psum_scatter``: a rank's rows collect the gradient of
    every rank's use of them."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _gather(x, pg)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.pg),)
                          + tuple(g.shape[1:]))
        _reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM,
                               group=ctx.pg)
        return out, None


def all_gather(x: torch.Tensor, pg) -> torch.Tensor:
    """(W * n, ...) of every rank's (n, ...) x, rank-major (JAX's
    ``all_gather(tiled=True)``), differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, pg)
    return _gather(x, pg)


def _gather(x, pg):
    out = x.new_empty((dist.get_world_size(pg) * x.shape[0],)
                      + tuple(x.shape[1:]))
    _all_gather_tensor(out, x.contiguous(), group=pg)
    return out


class _AllMean(torch.autograd.Function):
    """The group's mean (JAX's ``pmean``); its transpose is the mean of the
    ranks' cotangents, as JAX transposes ``pmean`` under ``shard_map``."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _mean(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.pg), None


def _mean(x, pg):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=pg)
    return out / dist.get_world_size(pg)


def all_mean(x: torch.Tensor, pg) -> torch.Tensor:
    """x's mean over the group's ranks (one all-reduce), differentiable in
    x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllMean.apply(x, pg)
    return _mean(x, pg)


def mean_(tensors: Iterable[torch.Tensor], pg) -> None:
    """Replaces each tensor by its mean over the group (JAX's ``pmean``),
    in place: one all-reduce over the tensors packed by dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    world = dist.get_world_size(pg)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=pg)
        flat /= world
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def broadcast_(tensors: Iterable[torch.Tensor], pg, src: int = 0) -> None:
    """Copies rank ``src``'s values of each tensor to every rank, in
    place."""
    for t in tensors:
        dist.broadcast(t, src, group=pg)
