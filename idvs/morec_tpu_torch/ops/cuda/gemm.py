"""The tiled product kernel and the column sums the backward kernels share
(``csrc/gemm.cu``, ``csrc/resln_bwd.cu``): hand-written float-FMA products
with the epilogues the backward passes need, and sums over rows added in a
fixed order. ``ops/cuda/mlp.py`` and ``ops/cuda/attention.py`` compose them
with their own row and attention kernels."""

from __future__ import annotations

import functools

import torch

from . import lib

ACTS = {"gelu": 1, "relu": 2, "quick_gelu": 3}   # csrc/gemm.cu Act


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The card's streaming multiprocessors: they size the row pass's
    partial sums and the split over K of a product."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t):
    return None if t is None else t.data_ptr()


def _splits(M, N, K, sms):
    """K slices of a product: enough blocks for two waves on the sms
    multiprocessors of the card, each slice at least 1024 deep."""
    tiles = -(-M // 128) * -(-N // 128)
    if tiles >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), K // 1024))


def gemm(A, B, M, N, K, sa, sb, code, *, add=None, gate=None, act="gelu",
         pro_act=False, bias=None, out_f32=False, dtype=None):
    """(M, N) = epi(pro(A) @ B) (csrc/gemm.cu); sa = (sam, sak) and sb =
    (sbk, sbn) are the element strides of A(m, k), B(k, n). B is in the
    compute dtype ``dtype`` (A's when None); A and gate are in it or in
    float32; the result is in it, or float32 with ``out_f32``."""
    dt = dtype or A.dtype
    out = torch.empty(M, N, dtype=torch.float32 if out_f32 else dt,
                      device=A.device)
    splits = _splits(M, N, K, sm_count(A.device.index or 0))
    ws = (torch.empty(splits * M * N, device=A.device) if splits > 1
          else None)
    err = lib.library().idvs_gemm(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), ptr(add), ptr(gate),
        ptr(bias), ptr(ws), M, N, K, *sa, *sb, splits,
        ACTS[act] if pro_act else 0, ACTS[act], int(out_f32),
        int(A.dtype == torch.float32),
        int(gate is not None and gate.dtype == torch.float32), code,
        lib.stream_handle(A))
    lib.check(err, "gemm")
    return out


def row_groups(M: int) -> int:
    """Row groups of a column sum over M rows: each group's partial sums
    are added in a second pass, in a fixed order."""
    return max(1, min(M, 256 if M < 2 ** 16 else 1024))


def colsum(x2, code):
    """(N,) float32 column sums of x2 (M, N) in the compute dtype, through
    row groups added in a fixed order (csrc/resln_bwd.cu)."""
    M, N = x2.shape
    nb = row_groups(M)
    part = torch.empty(nb * N, device=x2.device)
    out = torch.empty(N, device=x2.device)
    err = lib.library().idvs_colsum(x2.data_ptr(), part.data_ptr(),
                                    out.data_ptr(), nb, M, N, code,
                                    lib.stream_handle(x2))
    lib.check(err, "colsum")
    return out
