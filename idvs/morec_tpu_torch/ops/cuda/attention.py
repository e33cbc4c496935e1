"""Fused multi-head self-attention: over packed QKV (forward and backward),
and Swin's windowed attention with its projections (forward and backward).

``fused_mha_proj`` and ``fused_mha_proj_band`` are at the end of the module;
first ``fused_mha``. Kernels: ``csrc/fused_mha.cu``. They replace the TPU kernel
``idvs/morec_tpu/ops/pallas/attention.py`` ``fused_mha`` (``_fwd_kernel``
and ``_bwd_kernel``), with the in-kernel dropout of the attention
probabilities (``ops/dropout.py``). On the H100 they are bound by bytes: a
(row, head) tile of T <= 128 rows does about T operations per byte it
moves. The bf16 kernels keep q, k, v (and dout) as bf16 tiles in shared
memory, copied with 16-byte ``cp.async`` from the natural (B, T, 3H) /
(B, T, H) layouts, run every (T, T, dh) product as ``mma.sync`` bf16 tiles
with float32 accumulators, and keep the scores, the softmax, the dropout
and (backward) dp and ds in registers, one warp to 16 query rows; blocks
are persistent and copy the next tile while they compute the current one.
The float32 kernels, forward and backward, have the same structure with
float tiles, every product as 3xTF32 on the tensor cores (each float split
into two tf32 terms, three products a step). The backward recomputes the
probabilities and returns the packed dqkv; a bias that requires a gradient
(Swin's relative-position table under attention dropout) gets one from the
backward's dbias edition, summed over the rows that share a bias row in a
fixed order. The kernels choose their own blocking; the header of the .cu
file has the details.

``fused_mha`` runs the plain PyTorch version ``fused_mha_plain`` (autograd
gives its gradient) for tensors on the CPU. For tensors on the card it
launches the forward kernel, through a ``torch.autograd.Function`` whose
backward is ``fused_mha_bwd`` (or ``fused_mha_bwd_dbias`` for a trainable
bias) when a gradient is wanted; it raises for anything the kernels do not
take. ``fused_mha.launches``, ``fused_mha_bwd.launches`` and
``fused_mha_bwd_dbias.launches`` count launches; their ``bodies`` name the
device kernels each launched (``FWD_BODIES``, ``BWD_BODIES``).
"""

from __future__ import annotations

import math

import torch

from .. import dropout
from . import lib
from .gemm import colsum, gemm

NEG = -1e9
MAX_T = 128
SMEM = 232448


def _geometry(qkv, mask, bias, n_heads):
    if (mask is None) == (bias is None):
        raise ValueError("pass exactly one of mask / bias")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, T, 3H), got {tuple(qkv.shape)}")
    B, T, H3 = qkv.shape
    H = H3 // 3
    if H % n_heads:
        raise ValueError(f"H={H} is not a multiple of n_heads={n_heads}")
    if mask is not None and tuple(mask.shape) != (B, T):
        raise ValueError(f"mask must be (B, T) = {(B, T)}, got "
                         f"{tuple(mask.shape)}")
    if bias is not None:
        if (bias.dim() != 4 or bias.shape[1] not in (1, n_heads)
                or tuple(bias.shape[2:]) != (T, T)):
            raise ValueError(f"bias must be (P, {n_heads} or 1, {T}, {T}), "
                             f"got {tuple(bias.shape)}")
        if B % bias.shape[0]:
            raise ValueError(f"bias period {bias.shape[0]} must divide "
                             f"B={B}")
    return B, T, H, H // n_heads


def fused_mha_plain(qkv: torch.Tensor, mask: torch.Tensor = None, *,
                    n_heads: int, bias: torch.Tensor = None,
                    drop_rate: float = 0.0, seed: int = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (same casts, float32 math)."""
    B, T, H, dh = _geometry(qkv, mask, bias, n_heads)
    q, k, v = (t.float().reshape(B, T, n_heads, dh).transpose(1, 2)
               for t in qkv.split(H, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if mask is not None:
        key_bias = (1.0 - mask.to(qkv.dtype).float()) * NEG
        scores = scores + key_bias[:, None, None, :]
    else:
        # row r takes bias[r % P]: tiling the period P up to B rows
        b = bias.to(qkv.dtype).float()
        scores = scores + b.repeat(B // b.shape[0], 1, 1, 1)
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    # dropout on the cast (B, nh, T, T) probabilities (attention.py:166-170)
    probs = dropout.apply(probs, drop_rate, seed).to(qkv.dtype).float()
    out = (probs @ v).transpose(1, 2).reshape(B, T, H)
    return out.to(qkv.dtype)


def _operands(qkv, mask, bias, n_heads, B, T, dh):
    """(qkv, float mask/bias table, int args) of a launch; raises for what
    the kernels do not take."""
    if T > MAX_T:
        raise ValueError(f"fused_mha kernel takes T <= {MAX_T}, got {T}")
    code = lib.dtype_code(qkv)
    qkv = qkv.contiguous()
    if mask is not None:
        table = mask.detach().to(qkv.dtype).float().contiguous()
        mode, period, sp, sh = 0, B, 0, 0
    else:
        table = bias.detach().to(qkv.dtype).float().contiguous()
        mode, period, sp = 1, table.shape[0], table.stride(0)
        sh = table.stride(1) if table.shape[1] == n_heads else 0
    lib.check_device(qkv, table)
    args = (B, T, n_heads, dh, mode, period, sp, sh, 1.0 / math.sqrt(dh))
    return qkv, table, args, code


# editions of the kernel library's shared-memory query (csrc/fused_mha.cu)
FWD, BWD, DBIAS = 0, 1, 2
# the forward's and the backward's body by compute dtype, which the
# wrappers record in their ``bodies`` as they launch them (the backward's
# serves fused_mha_bwd, its dbias edition and the windowed attention's core)
FWD_BODIES = {torch.bfloat16: "mha_fwd_mma_kernel (bf16, mma.sync m16n8k16)",
              torch.float32: "mha_fwd_tf32_kernel (3xTF32, mma.sync m16n8k8 "
                             "tf32)"}
BWD_BODIES = {torch.bfloat16: "mha_bwd_mma_kernel (bf16, mma.sync m16n8k16)",
              torch.float32: "mha_bwd_tf32_kernel (3xTF32, mma.sync m16n8k8 "
                             "tf32)"}


def mha_smem(T, dh, edition, code) -> int:
    """Bytes of shared memory a block of the edition (FWD, BWD, DBIAS)
    needs at (T, dh) in the compute dtype ``code``, as the .cu file's
    blocking lays it out."""
    return lib.library().idvs_fused_mha_smem(T, dh, edition, code)


def _check_smem(name, T, dh, edition, code):
    """Raises if a block of the edition does not fit a block's shared
    memory at (T, dh) in the compute dtype."""
    smem = mha_smem(T, dh, edition, code)
    if smem > SMEM:
        raise ValueError(f"{name} kernel: T={T}, dh={dh} needs {smem} B of "
                         f"shared memory, above the 227 KB a block has")


def _launch_fwd(qkv, table, args, code, drop):
    B, T, nh, dh = args[:4]
    _check_smem("fused_mha", T, dh, FWD, code)
    out = torch.empty((B, T, nh * dh), dtype=qkv.dtype, device=qkv.device)
    err = lib.library().idvs_fused_mha_fwd(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), *args, *drop, code,
        lib.stream_handle(qkv))
    lib.check(err, "fused_mha")
    fused_mha.launches += 1
    fused_mha.bodies.add(FWD_BODIES[qkv.dtype])
    return out


def fused_mha_bwd(qkv, table, dout, args, code, drop) -> torch.Tensor:
    """Packed (B, T, 3H) dqkv of the forward launched with the same table,
    geometry ``args`` and dropout ``drop`` (key, thresh, scale)."""
    B, T, nh, dh = args[:4]
    _check_smem("fused_mha backward", T, dh, BWD, code)
    dout = dout.to(qkv.dtype).contiguous()
    lib.check_device(dout)
    dqkv = torch.empty_like(qkv)
    err = lib.library().idvs_fused_mha_bwd(
        qkv.data_ptr(), table.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        *args, *drop, code, lib.stream_handle(qkv))
    lib.check(err, "fused_mha_bwd")
    fused_mha_bwd.launches += 1
    fused_mha_bwd.bodies.add(BWD_BODIES[qkv.dtype])
    return dqkv


def dbias_chunks(B, T, nh, dh, P, code) -> int:
    """Shares of the B / P rows that take one bias row, one block each per
    (row of the bias, head), as the dbias edition's kernel for the compute
    dtype ``code`` chooses them (csrc/fused_mha.cu ``dbias_chunks``)."""
    chunks = lib.library().idvs_fused_mha_dbias_chunks(B, T, nh, dh, P, code)
    if chunks < 0:
        lib.check(-chunks, "fused_mha_bwd_dbias chunks")
    return chunks


def sum_partials(part: torch.Tensor, out: torch.Tensor, nb: int) -> None:
    """out (E floats) = the sum of part's nb planes of E floats, in order
    (csrc/reduce.cuh)."""
    err = lib.library().idvs_sum_partials(part.data_ptr(), out.data_ptr(),
                                          nb, out.numel(),
                                          lib.stream_handle(out))
    lib.check(err, "sum_partials")


def fused_mha_bwd_dbias(qkv, table, dout, args, code, drop, heads):
    """The dbias edition of ``fused_mha_bwd`` (additive bias only): (dqkv,
    dbias (P, heads, T, T) float32), dbias the unscaled softmax backward
    summed over the rows r with r % P = p (and over the heads when
    ``heads`` is 1) in a fixed order."""
    B, T, nh, dh, _, P, sp, sh, scale = args
    _check_smem("fused_mha dbias backward", T, dh, DBIAS, code)
    dout = dout.to(qkv.dtype).contiguous()
    lib.check_device(dout)
    chunks = dbias_chunks(B, T, nh, dh, P, code)
    part = torch.empty(chunks * nh * P * T * T, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    err = lib.library().idvs_fused_mha_bwd_dbias(
        qkv.data_ptr(), table.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        part.data_ptr(), B, T, nh, dh, P, chunks, sp, sh, scale, *drop, code,
        lib.stream_handle(qkv))
    lib.check(err, "fused_mha_bwd_dbias")
    dbias = torch.empty(P, heads, T, T, device=qkv.device)
    # a bias shared by the heads sums the heads' planes too (sh == 0)
    sum_partials(part, dbias, chunks * nh if sh == 0 else chunks)
    fused_mha_bwd_dbias.launches += 1
    fused_mha_bwd_dbias.bodies.add(BWD_BODIES[qkv.dtype])
    return dqkv, dbias


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, table, args, code, drop):
        # bias: the caller's trainable bias cast to qkv's dtype (the kernels
        # read ``table``, its float copy), or None
        ctx.save_for_backward(qkv, table)
        ctx.meta = (args, code, drop)
        ctx.bias_heads = None if bias is None else bias.shape[1]
        return _launch_fwd(qkv, table, args, code, drop)

    @staticmethod
    def backward(ctx, dout):
        qkv, table = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return (fused_mha_bwd(qkv, table, dout, *ctx.meta),
                    None, None, None, None, None)
        dqkv, dbias = fused_mha_bwd_dbias(qkv, table, dout, *ctx.meta,
                                          ctx.bias_heads)
        # in the dtype of the bias the kernel saw, as the TPU kernel's VJP
        return dqkv, dbias.to(qkv.dtype), None, None, None, None


def fused_mha(qkv: torch.Tensor, mask: torch.Tensor = None, *, n_heads: int,
              bias: torch.Tensor = None, drop_rate: float = 0.0,
              seed: int = None) -> torch.Tensor:
    """(B, T, 3H) packed QKV -> (B, T, H) context.

    Exactly one of
      mask -- (B, T) key-validity mask: invalid keys get -1e9 (BERT);
      bias -- (P, nh or 1, T, T) additive score bias; P divides B and row r
              takes bias[r % P]; a head dim of 1 is shared by all heads
              (SASRec's (B, 1, L, L) causal mask, never broadcast in memory).
    Both are cast to qkv's dtype first, as in the JAX kernel. The mask
    gets no gradient; a bias that requires one (Swin's relative-position
    table) gets it through that cast, so in bf16 it is rounded to bf16 as in
    the JAX kernel's VJP. drop_rate > 0 drops the cast probabilities with
    the mask of ``seed`` (``ops/dropout.py``).
    """
    B, T, H, dh = _geometry(qkv, mask, bias, n_heads)
    drop = dropout.kernel_args(drop_rate, seed)
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, mask, n_heads=n_heads, bias=bias,
                               drop_rate=drop_rate, seed=seed)
    qkv_c, table, args, code = _operands(qkv, mask, bias, n_heads, B, T, dh)
    trains_bias = bias is not None and bias.requires_grad
    if torch.is_grad_enabled() and (qkv.requires_grad or trains_bias):
        return _FusedMHA.apply(qkv_c, bias.to(qkv.dtype) if trains_bias
                               else None, table, args, code, drop)
    return _launch_fwd(qkv_c, table, args, code, drop)


# -- windowed attention with its projections (Swin) ---------------------------
#
# Kernels: ``csrc/win_attn.cu``. They replace the TPU kernels
# ``idvs/morec_tpu/ops/pallas/attention.py`` ``fused_mha_proj``
# (``_pfwd_kernel``) and ``fused_mha_proj_band`` (``_bfwd_kernel``): QKV
# projection, biased windowed attention and output projection, the (T, T)
# scores and the packed qkv never in device memory. One device body serves
# both; the window layout reads window r from (B, T, C), the band layout
# reads a window's tokens from the (N, Hp, Wp, C) map and writes them back
# there, so the window partition and its reverse never exist. The work is
# 95 % projections: both dtypes run them and the attention on the tensor
# cores (bf16 as such, float32 as 3xTF32) with the block plan of
# ``win_attn_plan`` for the dtype; the output projection is gemm.cu's
# product (3xTF32 in float32); the .cu header has the design.
# ``fused_mha_proj.bodies`` and ``fused_mha_proj_band.bodies`` name the
# forward's window kernel (``WIN_BODIES``). The backward
# (``csrc/win_attn_bwd.cu`` and the products of ``csrc/gemm.cu``) saves
# nothing but x, the bias and the weights: it
# recomputes qkv and the probabilities and returns the gradients of x, of
# the four weights and of the bias, the latter summed over the windows that
# share a bias row, in a fixed order. Its products are row-wise, so they run
# on x's rows as they lie, and its attention core (fused_mha.cu's
# tensor-core backward in either dtype, ``BWD_BODIES``, shared through
# ``csrc/mha_mma.cuh``) reads and writes a window's tokens through the
# forward's row index map (``csrc/win_map.cuh``, twin ``band_token_rows``):
# the band layout's backward copies nothing into windows.
# ``fused_mha_proj_bwd.launches`` and ``fused_mha_proj_band_bwd.launches``
# count the backward's launches, their ``bodies`` the core's kernels.

LINEAR_WIDTHS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
CUDA_INVALID_VALUE = 1     # cudaErrorInvalidValue
# csrc/win_attn.cu's bodies: a warp's projection tile (rows, columns) and
# at most 8 warps a block are planned; bf16 streams 32-deep K slices of
# bf16 through 3 stages, float32 16-deep slices of floats through 3
_WARP_ROWS, _WARP_COLS, _WARPS = 32, 48, 8
_SLICE_K = {torch.bfloat16: 32, torch.float32: 16}
_STAGES = 3
# the device kernel of each dtype's body, for the wrappers' ``bodies``
WIN_BODIES = {torch.float32: "win_attn_tf32_kernel",
              torch.bfloat16: "win_attn_mma_kernel"}


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _win_smem(dtype, G, HG, Tp, Dp, WM, passes) -> int:
    """Shared-memory bytes of a window block (csrc/win_attn.cu mma_smem and
    tf32_smem): the row and column maps (int), the block's q | k | v ([G
    Tp][3 HG Dp + 8]) and the ring's stages of x rows ([32 WM][slice + 8])
    and Wqkv columns ([slice][3 HG Dp + 8], float32 + 4)."""
    R, Np, PR, K = G * Tp, 3 * HG * Dp, _WARP_ROWS * WM, _SLICE_K[dtype]
    if dtype == torch.float32:
        return (4 * (passes * PR + Np) + 4 * R * (Np + 8)
                + 4 * _STAGES * (PR * (K + 8) + K * (Np + 4)))
    return (4 * (passes * PR + Np) + 2 * R * (Np + 8)
            + 2 * _STAGES * (PR * (K + 8) + K * (Np + 8)))


def win_attn_plan(T: int, C: int, n_heads: int,
                  dtype: torch.dtype = torch.bfloat16):
    """The block plan of the window kernel of `dtype` (csrc/win_attn.cu
    win_attn_mma_kernel, win_attn_tf32_kernel), which the launch passes to
    it: G windows and a group of HG heads a block, T and dh padded to t_pad
    and dh_pad (multiples of 16), warps_m x warps_n warps each owning a 32
    x 48 tile of the qkv projection (warps_n = 3 HG dh_pad / 48), in
    ``passes`` of 32 warps_m rows over the G t_pad rows, and the
    shared-memory bytes. Of the plans that fit, the one that reads the
    fewest bytes from L2 (x's rows once a head group, Wqkv's columns once a
    pass) for each (window, head), then the one with the fewest padded
    rows, then the fewest windows a block. None when no head group fits
    (dh above 128)."""
    dh = C // n_heads
    Tp, Dp = _up16(T), _up16(dh)
    best = None
    for HG in range(1, n_heads + 1):
        if n_heads % HG or HG * Dp > 128:
            continue
        WN = HG * Dp // 16
        WM = max(1, _WARPS // WN)
        PR, Np = _WARP_ROWS * WM, 3 * HG * Dp
        for G in range(1, 9):
            R = G * Tp
            passes = -(-R // PR)
            smem = _win_smem(dtype, G, HG, Tp, Dp, WM, passes)
            if smem > lib.MAX_SMEM:
                break
            key = ((R * C + passes * C * Np) / (G * HG), passes * PR - R, G)
            if best is None or key < best[0]:
                best = (key, dict(G=G, HG=HG, t_pad=Tp, dh_pad=Dp,
                                  warps_m=WM, warps_n=WN, passes=passes,
                                  smem=smem))
    return None if best is None else best[1]


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(N, H, W, C) -> (N * nW, w * w, C), windows of an image in raster
    order."""
    N, H, W, C = x.shape
    x = x.reshape(N, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def band_token_rows(N: int, Hp: int, Wp: int, w: int) -> torch.Tensor:
    """The rows of an (N, Hp, Wp, C) map, as (N * Hp * Wp, C), that the
    band layout's windows read, window by window in raster order and token
    by token within each (csrc/win_map.cuh): x.reshape(-1, C)[rows] is
    window_partition(x, w).reshape(-1, C)."""
    nwr, nwc = Hp // w, Wp // w
    img = torch.arange(N).reshape(N, 1, 1, 1, 1)
    wy = torch.arange(nwr).reshape(1, nwr, 1, 1, 1)
    wx = torch.arange(nwc).reshape(1, 1, nwc, 1, 1)
    ty = torch.arange(w).reshape(1, 1, 1, w, 1)
    tx = torch.arange(w).reshape(1, 1, 1, 1, w)
    base = (img * nwr * w + wy * w) * (nwc * w) + wx * w
    return (base + ty * (nwc * w) + tx).reshape(-1)


def window_reverse(wins: torch.Tensor, w: int, H: int, W: int
                   ) -> torch.Tensor:
    """The inverse of ``window_partition``: (N * nW, w * w, C) ->
    (N, H, W, C)."""
    N = wins.shape[0] // ((H // w) * (W // w))
    x = wins.reshape(N, H // w, W // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(N, H, W, -1)


def _proj_geometry(x, bias, wqkv, bqkv, wo, bo, n_heads, windows, T):
    C = x.shape[-1]
    if C % n_heads:
        raise ValueError(f"C={C} is not a multiple of n_heads={n_heads}")
    if (tuple(wqkv.shape) != (C, 3 * C) or tuple(bqkv.shape) != (3 * C,)
            or tuple(wo.shape) != (C, C) or tuple(bo.shape) != (C,)):
        raise ValueError("windowed attention: weight shapes disagree with "
                         f"C={C}")
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (n_heads, T, T):
        raise ValueError(f"bias must be (P, {n_heads}, {T}, {T}), got "
                         f"{tuple(bias.shape)}")
    if windows % bias.shape[0]:
        raise ValueError(f"bias period {bias.shape[0]} must divide the "
                         f"{windows} windows")


def fused_mha_proj_plain(x: torch.Tensor, bias: torch.Tensor,
                         wqkv: torch.Tensor, bqkv: torch.Tensor,
                         wo: torch.Tensor, bo: torch.Tensor, *,
                         n_heads: int) -> torch.Tensor:
    """The window-layout kernel's function in plain PyTorch: float32
    products, qkv, the probabilities, the context and the output each cast
    to x's dtype, the bias cast to x's dtype before it is added."""
    B, T, C = x.shape
    _proj_geometry(x, bias, wqkv, bqkv, wo, bo, n_heads, B, T)
    dt, dh = x.dtype, C // n_heads
    qkv = (x.float() @ wqkv.to(dt).float() + bqkv.to(dt).float()).to(dt)
    q, k, v = (t.float().reshape(B, T, n_heads, dh).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    b = bias.to(dt).float()
    scores = scores + b.repeat(B // b.shape[0], 1, 1, 1)  # row r: bias[r % P]
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    ctx = (probs @ v).transpose(1, 2).reshape(B, T, C).to(dt)
    return (ctx.float() @ wo.to(dt).float() + bo.to(dt).float()).to(dt)


def fused_mha_proj_band_plain(x: torch.Tensor, bias: torch.Tensor,
                              wqkv: torch.Tensor, bqkv: torch.Tensor,
                              wo: torch.Tensor, bo: torch.Tensor, *,
                              n_heads: int, window: int) -> torch.Tensor:
    """The band kernel's function in plain PyTorch: partition, the window
    layout's plain version, reverse."""
    N, Hp, Wp, C = x.shape
    wins = window_partition(x, window)
    out = fused_mha_proj_plain(wins, bias, wqkv, bqkv, wo, bo,
                               n_heads=n_heads)
    return window_reverse(out, window, Hp, Wp)


def fused_mha_proj_padded(x: torch.Tensor, bias: torch.Tensor,
                          wqkv: torch.Tensor, bqkv: torch.Tensor,
                          wo: torch.Tensor, bo: torch.Tensor, *,
                          n_heads: int, t_pad: int,
                          dh_pad: int) -> torch.Tensor:
    """``fused_mha_proj_plain`` as the bf16 kernel computes it, at its
    padding: each window's T tokens followed by t_pad - T zero tokens whose
    keys get -inf before the softmax and whose queries are dropped, each
    head's q, k and v followed by dh_pad - dh zero columns (Wqkv's and
    bqkv's columns zero-filled)."""
    B, T, C = x.shape
    _proj_geometry(x, bias, wqkv, bqkv, wo, bo, n_heads, B, T)
    dt, dh = x.dtype, C // n_heads
    xp = torch.zeros(B, t_pad, C, dtype=dt)
    xp[:, :T] = x
    w = torch.zeros(C, 3, n_heads, dh_pad, dtype=dt)
    w[..., :dh] = wqkv.to(dt).reshape(C, 3, n_heads, dh)
    b = torch.zeros(3, n_heads, dh_pad, dtype=dt)
    b[..., :dh] = bqkv.to(dt).reshape(3, n_heads, dh)
    qkv = (xp.float() @ w.reshape(C, -1).float()
           + b.reshape(-1).float()).to(dt)
    q, k, v = (t.float().reshape(B, t_pad, n_heads, dh_pad).transpose(1, 2)
               for t in qkv.split(n_heads * dh_pad, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    bp = torch.full((bias.shape[0], n_heads, t_pad, t_pad), -math.inf)
    bp[:, :, :T, :T] = bias.to(dt).float()
    bp[:, :, T:, :T] = bias.to(dt).float()[:, :, T - 1:T]   # dropped rows
    scores = scores + bp.repeat(B // bias.shape[0], 1, 1, 1)
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    ctx = (probs @ v)[:, :, :T, :dh].transpose(1, 2).reshape(B, T, C).to(dt)
    return (ctx.float() @ wo.to(dt).float() + bo.to(dt).float()).to(dt)


def _no_blocking(name, T, C, n_heads):
    return ValueError(
        f"{name} kernel: no blocking for T={T}, C={C}, n_heads={n_heads}: "
        f"it takes heads of a multiple of 4 columns, at most 128, whose "
        f"window fits a block's shared memory")


def _windowed_fwd(name, x, table, ops, n_heads, windows, T, band, code):
    """Launches the kernel pair of csrc/win_attn.cu on contiguous x in the
    window layout (band None) or the band layout (band = (w, nwc, nwr))."""
    C = x.shape[-1]
    plan = win_attn_plan(T, C, n_heads, x.dtype)
    if plan is None:
        raise _no_blocking(name, T, C, n_heads)
    ctx, out = torch.empty_like(x), torch.empty_like(x)
    w, nwc, nwr = band if band is not None else (0, 0, 0)
    k = [plan[n] for n in ("G", "HG", "t_pad", "dh_pad", "warps_m",
                           "warps_n", "passes", "smem")]
    err = lib.library().idvs_win_attn_fwd(
        x.data_ptr(), table.data_ptr(), *(t.data_ptr() for t in ops),
        ctx.data_ptr(), out.data_ptr(), windows, T, C, n_heads,
        table.shape[0], table.stride(0), table.stride(1),
        int(band is not None), w, nwc, nwr,
        1.0 / math.sqrt(C // n_heads), *k, code, lib.stream_handle(x))
    lib.check(err, name)
    return out


def win_attn_bwd_chunks(windows, T, n_heads, dh, P, code) -> int:
    """Shares of the windows / P windows that take one bias row, one block
    each per (row of the bias, head), as the attention core of the windowed
    backward cuts them (csrc/mha_mma.cuh ``dbias_chunks``); raises for a
    geometry whose tiles do not fit a block's shared memory."""
    chunks = lib.library().idvs_win_attn_bwd_chunks(windows, T, n_heads, dh,
                                                    P, code)
    if chunks == -CUDA_INVALID_VALUE:
        raise ValueError(
            f"windowed attention backward: a head's tiles at T={T}, "
            f"dh={dh} do not fit a block's shared memory")
    if chunks < 0:
        lib.check(-chunks, "win_attn_bwd chunks")
    return chunks


def _windowed_bwd(x, table, dout, wqkv, bqkv, wo, n_heads, windows, T, band,
                  code):
    """Backward on x's rows as they lie: x and dout (the output's
    cotangent) are contiguous (B, T, C) windows (band None) or an (N, Hp,
    Wp, C) map (band = (w, nwc, nwr)), in the compute dtype. Returns (dx
    shaped as x, dbias (P, nh, T, T) float32, dwqkv, dbqkv, dwo, dbo), the
    weights' in the compute dtype."""
    C = x.shape[-1]
    M, dh, P = x.numel() // C, C // n_heads, table.shape[0]
    dt, dev = x.dtype, x.device
    chunks = win_attn_bwd_chunks(windows, T, n_heads, dh, P, code)
    x2, d2 = x.reshape(M, C), dout.reshape(M, C)
    qkv = gemm(x2, wqkv, M, 3 * C, C, (C, 1), (3 * C, 1), code, bias=bqkv)
    dctx = gemm(d2, wo, M, C, C, (C, 1), (1, C), code)          # dout woᵀ
    part = torch.empty(chunks * P * n_heads * T * T, device=dev)
    dbias = torch.empty(P, n_heads, T, T, device=dev)
    dqkv, ctx = torch.empty_like(qkv), torch.empty_like(x2)
    w, nwc, nwr = band if band is not None else (0, 0, 0)
    err = lib.library().idvs_win_attn_bwd(
        qkv.data_ptr(), table.data_ptr(), dctx.data_ptr(), dqkv.data_ptr(),
        ctx.data_ptr(), part.data_ptr(), dbias.data_ptr(), windows, T,
        n_heads, dh, P, chunks, table.stride(0), table.stride(1),
        int(band is not None), w, nwc, nwr, 1.0 / math.sqrt(dh), code,
        lib.stream_handle(x))
    lib.check(err, "win_attn_bwd")
    del qkv, dctx
    dwo = gemm(ctx, d2, C, C, M, (1, C), (C, 1), code)          # ctxᵀ dout
    dbo = colsum(d2, code)
    dwqkv = gemm(x2, dqkv, C, 3 * C, M, (1, C), (3 * C, 1), code)
    dbqkv = colsum(dqkv, code)
    dx = gemm(dqkv, wqkv, M, C, 3 * C, (3 * C, 1), (1, 3 * C), code)
    return (dx.reshape(x.shape), dbias, dwqkv, dbqkv.to(dt), dwo, dbo.to(dt))


def fused_mha_proj_bwd(xw, table, dout, wqkv, bqkv, wo, *, n_heads, code):
    """Backward of ``fused_mha_proj`` on the card (``_windowed_bwd``)."""
    B, T, _ = xw.shape
    grads = _windowed_bwd(xw, table, dout.to(xw.dtype).contiguous(), wqkv,
                          bqkv, wo, n_heads, B, T, None, code)
    fused_mha_proj_bwd.launches += 1
    fused_mha_proj_bwd.bodies.add(BWD_BODIES[xw.dtype])
    return grads


def fused_mha_proj_band_bwd(x, table, dout, wqkv, bqkv, wo, *, n_heads,
                            window, code):
    """Backward of ``fused_mha_proj_band`` on the card: x and dout are
    (N, Hp, Wp, C) maps, read in place through the band layout's row map;
    dx comes back as a map."""
    N, Hp, Wp, _ = x.shape
    nwr, nwc = Hp // window, Wp // window
    grads = _windowed_bwd(x, table, dout.to(x.dtype).contiguous(), wqkv,
                          bqkv, wo, n_heads, N * nwr * nwc, window * window,
                          (window, nwc, nwr), code)
    fused_mha_proj_band_bwd.launches += 1
    fused_mha_proj_band_bwd.bodies.add(BWD_BODIES[x.dtype])
    return grads


class _WindowedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, wqkv, bqkv, wo, bo, meta):
        name, n_heads, windows, T, band, code = meta
        # bias arrives in the compute dtype; the kernels read it as floats
        table = bias.float().contiguous()
        ctx.save_for_backward(x, table, wqkv, bqkv, wo)
        ctx.meta = meta
        return _windowed_fwd(name, x, table, (wqkv, bqkv, wo, bo), n_heads,
                             windows, T, band, code)

    @staticmethod
    def backward(ctx, dout):
        x, table, wqkv, bqkv, wo = ctx.saved_tensors
        _, n_heads, _, _, band, code = ctx.meta
        if band is None:
            g = fused_mha_proj_bwd(x, table, dout, wqkv, bqkv, wo,
                                   n_heads=n_heads, code=code)
        else:
            g = fused_mha_proj_band_bwd(x, table, dout, wqkv, bqkv, wo,
                                        n_heads=n_heads, window=band[0],
                                        code=code)
        dx, dbias, dwqkv, dbqkv, dwo, dbo = g
        # in the dtype of the bias the kernel saw, as the TPU kernel's VJP
        return dx, dbias.to(x.dtype), dwqkv, dbqkv, dwo, dbo, None


def _launch_windowed(name, x, bias, wqkv, bqkv, wo, bo, n_heads, windows, T,
                     band):
    """Validates the operands and runs the forward, through the autograd
    function when a gradient is wanted."""
    C = x.shape[-1]
    if C not in LINEAR_WIDTHS:
        raise ValueError(f"{name} kernel takes C in {LINEAR_WIDTHS}, got "
                         f"{C}")
    code = lib.dtype_code(x)
    dt = x.dtype
    x = x.contiguous()
    ops = [t.to(dt).contiguous() for t in (wqkv, bqkv, wo, bo)]
    # the bias is cast first, as in the JAX wrapper, so its gradient is
    # rounded through the compute dtype on the way back
    bias = bias.to(dt)
    lib.check_device(x, bias, *ops)
    lib.check_aligned(x, *ops)
    meta = (name, n_heads, windows, T, band, code)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, bias, *ops)):
        return _WindowedMHA.apply(x, bias, *ops, meta)
    with torch.no_grad():
        return _windowed_fwd(name, x, bias.float().contiguous(), ops,
                             n_heads, windows, T, band, code)


def fused_mha_proj(x: torch.Tensor, bias: torch.Tensor, wqkv: torch.Tensor,
                   bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                   *, n_heads: int) -> torch.Tensor:
    """(B, T, C) windows -> (B, T, C): QKV projection, biased multi-head
    attention and output projection in one call.

    bias: (P, nh, T, T) additive score bias, cast to x's dtype first; P
    divides B and window r takes bias[r % P]. wqkv (C, 3C), bqkv (3C,), wo
    (C, C), bo (C,) in (in, out) layout, cast to x's dtype.
    """
    B, T, C = x.shape
    _proj_geometry(x, bias, wqkv, bqkv, wo, bo, n_heads, B, T)
    if x.device.type == "cpu":
        return fused_mha_proj_plain(x, bias, wqkv, bqkv, wo, bo,
                                    n_heads=n_heads)
    if not B:
        return torch.empty_like(x)
    out = _launch_windowed("fused_mha_proj", x, bias, wqkv, bqkv, wo, bo,
                           n_heads, B, T, None)
    fused_mha_proj.launches += 1
    fused_mha_proj.bodies.add(WIN_BODIES[x.dtype])
    return out


def fused_mha_proj_band(x: torch.Tensor, bias: torch.Tensor,
                        wqkv: torch.Tensor, bqkv: torch.Tensor,
                        wo: torch.Tensor, bo: torch.Tensor, *, n_heads: int,
                        window: int) -> torch.Tensor:
    """(N, Hp, Wp, C) feature map -> (N, Hp, Wp, C): the same function over
    the map's window x window tiles, windows formed inside the kernel.

    bias: (P, nh, w*w, w*w) with P = 1 (every window) or P = nW, the
    windows of an image in raster order (the shifted blocks' mask). Hp and
    Wp are multiples of ``window``; the caller rolls the map for shifted
    blocks.
    """
    N, Hp, Wp, C = x.shape
    w = window
    if Hp % w or Wp % w:
        raise ValueError(f"the map {Hp}x{Wp} is not a multiple of the "
                         f"window {w}")
    nwr, nwc = Hp // w, Wp // w
    if bias.shape[0] not in (1, nwr * nwc):
        raise ValueError(f"bias period must be 1 or {nwr * nwc}, got "
                         f"{bias.shape[0]}")
    _proj_geometry(x, bias, wqkv, bqkv, wo, bo, n_heads, N * nwr * nwc,
                   w * w)
    if x.device.type == "cpu":
        return fused_mha_proj_band_plain(x, bias, wqkv, bqkv, wo, bo,
                                         n_heads=n_heads, window=w)
    if not N:
        return torch.empty_like(x)
    out = _launch_windowed("fused_mha_proj_band", x, bias, wqkv, bqkv, wo,
                           bo, n_heads, N * nwr * nwc, w * w, (w, nwc, nwr))
    fused_mha_proj_band.launches += 1
    fused_mha_proj_band.bodies.add(WIN_BODIES[x.dtype])
    return out


fused_mha.launches = 0
fused_mha.bodies = set()
fused_mha_bwd.launches = 0
fused_mha_bwd.bodies = set()
fused_mha_bwd_dbias.launches = 0
fused_mha_bwd_dbias.bodies = set()
fused_mha_proj.launches = 0
fused_mha_proj.bodies = set()
fused_mha_proj_bwd.launches = 0
fused_mha_proj_bwd.bodies = set()
fused_mha_proj_band.launches = 0
fused_mha_proj_band.bodies = set()
fused_mha_proj_band_bwd.launches = 0
fused_mha_proj_band_bwd.bodies = set()
