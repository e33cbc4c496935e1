"""Embedding lookup whose backward is the scatter-add kernel.

Kernel: ``csrc/embed_scatter.cu``. It replaces the TPU kernel
``idvs/morec_tpu/ops/pallas/embed_scatter.py`` ``scatter_add_rows`` (the
backward of ``embed_gather``): dE[ids[i]] += dX[i], float accumulation
whatever dX's dtype, duplicates adding up, the result cast to dX's dtype.
On the H100 it is bound by bytes: dX read once and the table written once.
An id that occurs once has its row written as it is; only repeated ids
accumulate in float (float atomics that resolve in the 50 MB L2, each
warp's runs of one id summed in registers first); every table row is
written once, zeros where no id points (the .cu header has the details).
The forward is a plain gather, as in the JAX package.

``scatter_add_rows`` runs the plain version ``scatter_add_rows_plain`` for
tensors on the CPU and launches the kernel for tensors on the card;
``scatter_add_rows.launches`` counts launches. ``embed_gather`` is the
lookup with that backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lib


def scatter_add_rows_plain(ids: torch.Tensor, dx: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """sum_i onehot(ids[i])[:, None] * dx[i] as (num_rows, D), accumulated
    in float32 and cast to dx's dtype."""
    out = torch.zeros(num_rows, dx.shape[-1], device=dx.device)
    return out.index_add_(0, ids.reshape(-1), dx.reshape(-1, dx.shape[-1])
                          .float()).to(dx.dtype)


def scatter_add_rows(ids: torch.Tensor, dx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """ids (...) int in [0, num_rows) and dx (..., D) float32/bfloat16 ->
    the (num_rows, D) table gradient in dx's dtype."""
    D = dx.shape[-1]
    if tuple(ids.shape) != tuple(dx.shape[:-1]):
        raise ValueError(f"ids {tuple(ids.shape)} and dx {tuple(dx.shape)} "
                         f"disagree")
    if dx.device.type == "cpu":
        return scatter_add_rows_plain(ids, dx, num_rows)
    code = lib.dtype_code(dx)
    ids2 = ids.reshape(-1)
    if ids2.dtype != torch.int64:
        ids2 = ids2.long()
    ids2, dx2 = ids2.contiguous(), dx.reshape(-1, D).contiguous()
    lib.check_device(ids2, dx2)
    # one float scratch: the rows of the ids that repeat (the output itself
    # in float32), then the (num_rows,) int32 counts
    rows = num_rows * D
    scratch = torch.empty(rows + num_rows, device=dx.device)
    table = scratch.data_ptr()
    out = (scratch if dx.dtype == torch.float32 else
           torch.empty(rows, dtype=dx.dtype, device=dx.device))
    err = lib.library().idvs_scatter_add_rows(
        ids2.data_ptr(), dx2.data_ptr(), table + 4 * rows, table,
        out.data_ptr(), ids2.shape[0], D, num_rows, code,
        lib.stream_handle(dx2))
    lib.check(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out.as_strided((num_rows, D), (D, 1))


class _EmbedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_add_rows(ids, g, ctx.num_rows), None


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] whose table gradient is ``scatter_add_rows`` (JAX
    ops/pallas/embed_scatter.py embed_gather)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return F.embedding(ids, table)
    return _EmbedGather.apply(table, ids)


scatter_add_rows.launches = 0
