"""The tiled product kernel and the column sums the backward kernels share
(``csrc/gemm.cu``, ``csrc/resln_bwd.cu``): hand-written products with the
epilogues the backward passes need, on the tensor cores (``mma.sync`` with
``cp.async`` stages) in bf16 and in float32 as 3xTF32 (each float split
into two tf32 terms, three products a step, about float32's accuracy),
split over K with a fixed-order second pass; and sums over rows added in a
fixed order.
``ops/cuda/mlp.py`` and ``ops/cuda/attention.py`` compose them with their
own row and attention kernels.

``gemm`` launches the kernel for tensors on the card (``gemm.launches``
counts launches) and runs ``gemm_plain``, the kernel's contract in PyTorch
ops, for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from . import lib

ACTS = {"gelu": 1, "relu": 2, "quick_gelu": 3}   # csrc/gemm.cu Act


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The card's streaming multiprocessors: they size the row passes'
    partial sums."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def splits_of(M: int, N: int, K: int, code: int, max_depth: int = 0) -> int:
    """K slices of an (M, N) product over K, as the kernel chooses them
    (csrc/gemm.cu choose_splits; none deeper than max_depth when it is
    above 0): the workspace holds one float (M, N) partial a slice."""
    return lib.library().idvs_gemm_splits(M, N, K, code, max_depth)


def _check_rows(t, strides, what):
    """The product copies 16-byte chunks of every operand row: the base
    16-byte aligned, one stride 1 and the other a multiple of 8."""
    s0, s1 = strides
    if t.data_ptr() % 16 or (s0 == 1) == (s1 == 1) or max(s0, s1) % 8:
        raise ValueError(
            f"gemm: operand {what} needs a 16-byte aligned base, one stride "
            f"of 1 and the other a multiple of 8, got strides {strides} at "
            f"an address {t.data_ptr() % 16} bytes past 16")


def act_of(h: torch.Tensor, act: str) -> torch.Tensor:
    """act(h): exact GELU, ReLU or quick_gelu (h * sigmoid(1.702 h))."""
    if act == "relu":
        return torch.relu(h)
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return torch.nn.functional.gelu(h, approximate="none")


def _dact_f32(h, act):
    if act == "relu":
        return (h > 0).float()
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        return s + h * 1.702 * s * (1.0 - s)
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * 0.3989422804014327 * torch.exp(-0.5 * h * h)


def _act_cast(A, M, K, sa, act):
    """cast(act(A)) in bf16 (the cast alone when act is None), in A's own
    layout: the pre-pass of a bf16 product whose A needs its prologue
    (csrc/gemm.cu act_cast_kernel), over every element from A's first to
    its last, row padding included."""
    inner, outer, ld = (K, M, sa[0]) if sa[1] == 1 else (M, K, sa[1])
    n = (outer - 1) * ld + inner
    out = torch.empty(n, dtype=torch.bfloat16, device=A.device)
    lib.check(lib.library().idvs_gemm_act_cast(
        A.data_ptr(), out.data_ptr(), n, ACTS[act] if act else 0,
        int(A.dtype == torch.float32), lib.stream_handle(A)), "gemm act_cast")
    return out


def act_cast(A: torch.Tensor, act=None) -> torch.Tensor:
    """cast(act(A)) in bf16 of a contiguous (M, K) A (the cast alone when
    act is None): the product's pre-pass on the card, its plain version on
    the CPU."""
    if A.device.type == "cpu":
        a = A.float()
        return (act_of(a, act) if act else a).to(torch.bfloat16)
    M, K = A.shape
    return _act_cast(A, M, K, (K, 1), act).view(M, K)


def gemm_plain(A, B, M, N, K, sa, sb, *, add=None, gate=None, act="gelu",
               pro_act=False, bias=None, out_f32=False, dtype=None,
               out_act=None):
    """The kernel's contract in PyTorch ops (csrc/gemm.cu's header): A(m, k)
    and B(k, n) taken through their strides, pro(A) rounded to the compute
    dtype, the product in float32, then bias, addend, out_act and
    act'(gate) in the order of the kernel's epilogue, and the cast."""
    dt = dtype or A.dtype
    a = A.as_strided((M, K), sa).float()
    if pro_act:
        a = act_of(a, act)
    a = a.to(dt).float()
    y = a @ B.as_strided((K, N), sb).float()
    if bias is not None:
        y = y + bias.float()
    if add is not None:
        y = y + add.reshape(M, N).float()
    if out_act is not None:
        y = act_of(y, out_act)
    if gate is not None:
        y = y * _dact_f32(gate.reshape(M, N).float(), act)
    return y if out_f32 else y.to(dt)


# csrc/gemm.cu's body by compute dtype, which gemm() records in
# gemm.bodies as it launches it
BODIES = {torch.bfloat16: "gemm_mma_kernel<bf16> (mma.sync m16n8k16)",
          torch.float32: "gemm_mma_kernel<float> (3xTF32, mma.sync m16n8k8 "
                         "tf32)"}


def gemm(A, B, M, N, K, sa, sb, code, *, add=None, gate=None, act="gelu",
         pro_act=False, bias=None, out_f32=False, dtype=None, max_depth=0,
         out_act=None):
    """(M, N) = epi(pro(A) @ B) (csrc/gemm.cu); sa = (sam, sak) and sb =
    (sbk, sbn) are the element strides of A(m, k), B(k, n). B is in the
    compute dtype ``dtype`` (A's when None); A and gate are in it or in
    float32; the result is in it, or float32 with ``out_f32``. A and B need
    16-byte aligned rows (``_check_rows``); it raises otherwise. max_depth
    > 0 bounds the K a slice accumulates on the tensor cores before the
    slices are added in float (``splits_of``); it changes only the float
    sum's order, so the plain version ignores it. out_act ("gelu", "relu",
    "quick_gelu" or None) is applied to the sum after the bias and addend.
    A float32 product runs as 3xTF32 (csrc/gemm.cu's header): within
    float32's rounding of the plain version, not bit for bit."""
    if A.device.type == "cpu":
        return gemm_plain(A, B, M, N, K, sa, sb, add=add, gate=gate, act=act,
                          pro_act=pro_act, bias=bias, out_f32=out_f32,
                          dtype=dtype, out_act=out_act)
    dt = dtype or A.dtype
    _check_rows(A, sa, "A")
    _check_rows(B, sb, "B")
    if dt == torch.bfloat16 and (pro_act or A.dtype == torch.float32):
        A = _act_cast(A, M, K, sa, act if pro_act else None)
        pro_act = False
    out = torch.empty(M, N, dtype=torch.float32 if out_f32 else dt,
                      device=A.device)
    splits = splits_of(M, N, K, code, max_depth)
    ws = (torch.empty(splits * M * N, device=A.device) if splits > 1
          else None)
    err = lib.library().idvs_gemm(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), ptr(add), ptr(gate),
        ptr(bias), ptr(ws), M, N, K, *sa, *sb, splits,
        ACTS[act] if pro_act else 0, ACTS[act],
        ACTS[out_act] if out_act else 0, int(out_f32),
        int(A.dtype == torch.float32),
        int(gate is not None and gate.dtype == torch.float32), code,
        lib.stream_handle(A))
    lib.check(err, "gemm")
    gemm.launches += 1
    gemm.bodies.add(BODIES[dt])
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


gemm.launches = 0
gemm.bodies = set()
