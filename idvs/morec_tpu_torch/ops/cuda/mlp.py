"""Post-LN epilogue kernels: the projection tail and the FFN tail, forward
and backward; and the pre-LN MLP sub-block (``fused_mlp``,
``fused_mlp_res``, forward and backward), at the end of the module.

Kernels: ``csrc/proj_resln.cu`` and ``csrc/mlp_resln.cu`` (forward),
``csrc/resln_bwd.cu`` and ``csrc/gemm.cu`` (backward). They replace the TPU
kernels ``idvs/morec_tpu/ops/pallas/mlp.py`` ``fused_proj_resln``
(``_fwd_proj_only_kernel``, ``_fwd_proj_kernel``, ``_bwd_proj_kernel``) and
``fused_mlp_resln`` (``_fwd_post_only_kernel``, ``_fwd_post_kernel``,
``_bwd_post_kernel``), with the in-kernel dropout of ``ops/dropout.py``.
Forward in bf16 at C <= 512: each block owns its rows and all C columns,
the products run on the tensor cores with the block plans of
``proj_resln_plan`` and ``mlp_resln_plan``, and the dropout, the residual
add, the cast to the compute dtype and the LayerNorm run on the
accumulators, so the FFN's (M, F) intermediate never leaves the block
unless the training edition saves it. At C = 2048 (SASRec under the vision
tower, 10 to 640 rows), and for both tails in float32 at every C, the
products go through gemm.cu (bf16, or float32 as 3xTF32 on the tensor
cores) and a row pass adds the rest (``proj_resln_products``,
``mlp_resln_products``). Backward: a row pass recomputes the LN statistics
from the saved pre-LN sum, and gemm.cu runs the products, split over M
with a deterministic second pass for the weight gradients. The .cu headers
have the details.

Each wrapper runs its plain PyTorch version (autograd gives its gradient)
for tensors on the CPU. For tensors on the card it launches the forward-only
edition when nothing needs a gradient, as the JAX ``custom_vjp`` primal
does, and otherwise a ``torch.autograd.Function`` over the training edition
(which also saves y_pre, and h) and the backward; it raises for anything the
kernels do not take. ``<function>.launches`` counts launches of
``fused_proj_resln`` / ``fused_mlp_resln`` (forward-only), ``*_res``
(training forward) and ``*_bwd`` (backward).
"""

from __future__ import annotations

import functools

import torch

from .. import dropout
from . import lib
from .gemm import (BODIES as GEMM_BODIES, act_cast, act_of as _act, colsum,
                   gemm, gemm_plain, ptr, row_groups, sm_count, splits_of)
from ...models.layers import layer_norm

KERNEL_WIDTHS = (128, 256, 512, 2048)   # C the kernels are instantiated for
F_CHUNK = {128: 128, 256: 128, 512: 256, 2048: 1024}   # F: a multiple of
PRODUCTS_WIDTH = 2048   # the tails' C whose sums go through memory
# K a bf16 slice of that tail's dense1 accumulates on the tensor cores, in
# training, before the slices are added in float: the depth of the C = 512
# tail's dense1, whose h then sits as close to an IEEE float sum as
# torch.matmul's float32 product (PERF.md); a forward alone has no branch
# to decide and takes gemm.cu's fastest split
DENSE1_DEPTH = 512
# csrc/mlp_resln.cu Act; the backward's products take gemm.py's numbering
ACTS = {"gelu": 0, "relu": 1, "quick_gelu": 2}


def _post_ln(ypre: torch.Tensor, dtype, ln, eps: float) -> torch.Tensor:
    # the pre-LN sum is cast to the compute dtype BEFORE the LN statistics
    # (JAX ops/pallas/mlp.py:413-420)
    return layer_norm(ypre.to(dtype), ln[0], ln[1], eps)


def fused_proj_resln_plain(x, res, w, b, *, ln, eps, drop_rate=0.0,
                           seed=None):
    """LN(res + dropout(x @ w + b)) in plain PyTorch, float32
    accumulation; the dropout index is the element's in the (M, C) view."""
    dt = x.dtype
    y = x.float() @ w.to(dt).float() + b.to(dt).float()
    y = dropout.apply(y, drop_rate, seed)
    return _post_ln(y + res.float(), dt, ln, eps)


def relu_kink(h, x, w1, b1) -> torch.Tensor:
    """The pre-activations h = x w1 + b1 that lie within float32's rounding
    of ReLU's kink, where two float32 sums in different orders may fall on
    either side of 0: |h| <= sqrt(K) 2^-24 (|x| |w1| + |b1|), the
    probabilistic rounding bound of a K-term float32 sum (Higham and Mary,
    2019). A bool mask shaped as h."""
    K = x.shape[-1]
    bound = K ** 0.5 * 2.0 ** -24 * (x.float().abs() @ w1.float().abs()
                                     + b1.float().abs())
    return h.abs() <= bound


def fused_mlp_resln_plain(x, w1, b1, w2, b2, *, ln, eps, act="gelu",
                          drop_rate=0.0, seed=None, kink_from=None):
    """LN(x + dropout(act(x @ w1 + b1) @ w2 + b2)) in plain PyTorch; act(h)
    is cast to the compute dtype before dense2 (JAX ops/pallas/mlp.py:406).
    kink_from: with act "relu", the pre-activation of another float32 sum
    (a kernel's saved h) whose sign takes ReLU's branch where this h lies
    within rounding of the kink (``relu_kink``); h > 0 decides elsewhere.
    A check of a kernel's gradient passes it: no float32 sum decides those
    units' branch."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    if kink_from is None:
        g = _act(h, act)
    elif act == "relu":
        h0 = h.detach()
        at_kink = relu_kink(h0, x.detach(), w1.detach().to(dt),
                            b1.detach().to(dt))
        g = h * torch.where(at_kink, kink_from > 0, h0 > 0)
    else:
        raise ValueError(f"kink_from takes act 'relu', got {act!r}")
    g = g.to(dt).float()
    y = g @ w2.to(dt).float() + b2.to(dt).float()
    y = dropout.apply(y, drop_rate, seed)
    return _post_ln(y + x.float(), dt, ln, eps)


def _check_width(x, C):
    if x.shape[-1] != C:
        raise ValueError(f"x has width {x.shape[-1]}, weights expect {C}")


def _kernel_args(x, C, *vectors_and_weights):
    """Validates a launch and returns (code, x2d, contiguous operands...)."""
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"kernel takes C in {KERNEL_WIDTHS}, got {C}")
    code = lib.dtype_code(x)
    ops = [t.contiguous() for t in vectors_and_weights]
    x2 = x.reshape(-1, C).contiguous()
    lib.check_device(x2, *ops)
    lib.check_aligned(x2, *ops)
    return code, x2, ops


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# -- the projection tail ------------------------------------------------------

# csrc/proj_resln.cu's bf16 body by C: (row warps, column warps, stages of
# W's [32][C] slices) of its tiles of 64 rows, then of fewer, which M takes
# where the wider tiles would not give half the SMs a block (the layouts
# measured best on the H100 at M = 23040, 5120, 2560 and 1280, PERF.md)
_PROJ_MMA = {128: ((4, 1, 3), (1, 2, 3)), 256: ((4, 2, 3), (1, 4, 3)),
             512: ((4, 4, 2), (2, 4, 3), (1, 8, 3))}


@functools.lru_cache(maxsize=None)
def proj_resln_plan(C: int, dtype: torch.dtype, M: int,
                    sms: int = 132) -> dict:
    """The launch plan of the projection tail at width C for M rows on a
    card of ``sms`` SMs. bf16 at C <= 512: route "block", the block plan
    of csrc/proj_resln.cu's proj_resln_mma_kernel, which the launch passes
    to the kernel (it refuses any other): rows a block, threads and
    shared-memory bytes, the warps' layout, the ring's stages and the
    accumulators a thread holds. C = 2048 and float32 at every C: route
    "products", x w through gemm.cu and then the row pass
    (``proj_resln_products``). "kernels" names the device kernels the
    route launches."""
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"kernel takes C in {KERNEL_WIDTHS}, got {C}")
    if C == PRODUCTS_WIDTH or dtype == torch.float32:
        return dict(route="products",
                    kernels=(GEMM_BODIES[dtype], "post_ln_rows_kernel"))
    tiers = _PROJ_MMA[C]
    RW, WN, S = next((t for t in tiers if -(-M // (16 * t[0])) >= sms // 2),
                     tiers[-1])
    rows, threads = 16 * RW, 32 * RW * WN
    # the x tile, the ring, the epilogue's row sums
    smem = 2 * (rows + S * 32) * (C + 8) + 4 * 2 * WN * rows
    return dict(route="block", kernels=("proj_resln_mma_kernel",), rows=rows,
                threads=threads, smem=smem, row_warps=RW, col_warps=WN,
                stages=S, acc_floats=rows * C // threads)


def proj_resln_products(x2, r2, w, b, ln, *, eps, drop, train):
    """The projection tail as gemm.cu's product and the row pass: y =
    f32(x w), then LN(cast(dropout(y + b) + res)) (csrc/proj_resln.cu's
    header), in one call (idvs_proj_resln_products) that counts as one
    launch of gemm.cu's product. (out, ypre) in training, (out, None)
    otherwise. On the CPU every piece is its plain version, so this is the
    composition's order and rounding points in plain PyTorch."""
    M, C = x2.shape
    if x2.device.type == "cpu":
        y = gemm_plain(x2, w, M, C, C, (C, 1), (C, 1), out_f32=True)
        out, ypre = post_ln_rows_plain(y, b, r2, ln, eps=eps, drop=drop)
        return out, ypre if train else None
    code = lib.dtype_code(x2)
    splits = splits_of(M, C, C, code)
    # y, then the K slices' partial sums
    ws = torch.empty((1 + splits * (splits > 1)) * M * C, device=x2.device)
    out = torch.empty_like(x2)
    ypre = torch.empty_like(x2) if train else None
    err = lib.library().idvs_proj_resln_products(
        x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(),
        ln[0].data_ptr(), ln[1].data_ptr(), out.data_ptr(), ptr(ypre),
        ws.data_ptr(), splits, M, C, float(eps), *drop, code,
        lib.stream_handle(x2))
    lib.check(err, "fused_proj_resln")
    gemm.launches += 1
    gemm.bodies.add(GEMM_BODIES[x2.dtype])
    return out, ypre


def _launch_proj(x2, r2, w, b, g, bt, eps, drop, code, train):
    """(out, ypre) of the projection tail on the card; ypre only in
    training."""
    M, C = x2.shape
    k = proj_resln_plan(C, x2.dtype, M, sm_count(x2.device.index or 0))
    (fused_proj_resln_res if train else fused_proj_resln).bodies.update(
        k["kernels"])
    if k["route"] == "products":
        return proj_resln_products(x2, r2, w, b, (g, bt), eps=eps,
                                   drop=drop, train=train)
    out = torch.empty_like(x2)
    ypre = torch.empty_like(x2) if train else None
    err = lib.library().idvs_proj_resln_fwd(
        x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(),
        g.data_ptr(), bt.data_ptr(), out.data_ptr(), ptr(ypre), M, C,
        float(eps), *drop, k["rows"], k["threads"], k["smem"], code,
        lib.stream_handle(x2))
    lib.check(err, "fused_proj_resln")
    return out, ypre


def fused_proj_resln_res(x2, r2, w, b, g, bt, *, eps, drop, code):
    """Training edition: (out, y_pre), y_pre the cast pre-LN sum."""
    out, ypre = _launch_proj(x2, r2, w, b, g, bt, eps, drop, code, True)
    fused_proj_resln_res.launches += 1
    return out, ypre


def _rows_bwd(ypre, dout, gamma, eps, drop, code, *, dres: bool):
    """LN backward rows (csrc/resln_bwd.cu): (dz, dres or None, dyp or None,
    sums (3, C) = dgamma, dbeta, db)."""
    M, C = ypre.shape
    dz = torch.empty_like(ypre)
    dres_t = torch.empty_like(ypre) if dres else None
    dyp = None if dres else torch.empty(M, C, device=ypre.device)
    nb = max(1, min((M + 7) // 8, 4 * sm_count(ypre.device.index or 0)))
    part = torch.empty(nb * 3 * C, device=ypre.device)
    sums = torch.empty(3, C, device=ypre.device)
    err = lib.library().idvs_resln_bwd_rows(
        ypre.data_ptr(), dout.data_ptr(), gamma.data_ptr(), ptr(dres_t),
        ptr(dyp), dz.data_ptr(), part.data_ptr(), sums.data_ptr(), nb, M, C,
        float(eps), *drop, code, lib.stream_handle(ypre))
    lib.check(err, "resln_bwd_rows")
    return dz, dres_t, dyp, sums


def fused_proj_resln_bwd(x2, w, g, ypre, dout, *, eps, drop, code):
    """Backward of the training edition: (dx, dres, dw, db, dgamma, dbeta);
    dw and db in the compute dtype, dgamma and dbeta float."""
    M, C = x2.shape
    dout = dout.reshape(M, C).to(x2.dtype).contiguous()
    lib.check_device(dout)
    lib.check_aligned(dout)
    dz, dres, _, sums = _rows_bwd(ypre, dout, g, eps, drop, code, dres=True)
    dw = gemm(x2, dz, C, C, M, (1, C), (C, 1), code)           # xᵀ dz
    dx = gemm(dz, w, M, C, C, (C, 1), (1, C), code)            # dz wᵀ
    fused_proj_resln_bwd.launches += 1
    return dx, dres, dw, sums[2].to(x2.dtype), sums[0], sums[1]


class _ProjResLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, w, b, g, bt, eps, drop, code):
        out, ypre = fused_proj_resln_res(x2, r2, w, b, g, bt, eps=eps,
                                         drop=drop, code=code)
        ctx.save_for_backward(x2, w, g, ypre)
        ctx.meta = dict(eps=eps, drop=drop, code=code)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, w, g, ypre = ctx.saved_tensors
        grads = fused_proj_resln_bwd(x2, w, g, ypre, dout, **ctx.meta)
        return (*grads, None, None, None)


def fused_proj_resln(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, *, ln, eps: float,
                     drop_rate: float = 0.0, seed: int = None
                     ) -> torch.Tensor:
    """(..., C) -> (..., C): LN(res + dropout(x @ w + b)); w is (C, C) in
    (in, out) layout, ln = (scale, bias) of the LayerNorm, eps its epsilon;
    drop_rate > 0 drops with the mask of ``seed``."""
    C = w.shape[1]
    _check_width(x, C)
    if w.shape != (C, C) or res.shape != x.shape or b.shape != (C,):
        raise ValueError("fused_proj_resln: shapes disagree")
    drop = dropout.kernel_args(drop_rate, seed)
    if x.device.type == "cpu":
        return fused_proj_resln_plain(x, res, w, b, ln=ln, eps=eps,
                                      drop_rate=drop_rate, seed=seed)
    dt = x.dtype
    code, x2, (r2, w_, b_, g_, bt_) = _kernel_args(
        x, C, res.reshape(-1, C).to(dt), w.to(dt), b.to(dt), ln[0].float(),
        ln[1].float())
    if not x2.shape[0]:
        return torch.empty_like(x)
    if _needs_grad(x, res, w, b, ln[0], ln[1]):
        out = _ProjResLN.apply(x2, r2, w_, b_, g_, bt_, float(eps), drop,
                               code)
    else:
        out = _launch_proj(x2, r2, w_, b_, g_, bt_, eps, drop, code,
                           False)[0]
        fused_proj_resln.launches += 1
    return out.reshape(x.shape)


# -- the FFN tail -------------------------------------------------------------

def mlp_resln_plan(C: int, dtype: torch.dtype) -> dict:
    """The launch plan of the FFN tail at width C. bf16 at C <= 512:
    route "block", the block plan of csrc/mlp_resln.cu's
    mlp_resln_mma_kernel, which the launch passes to the kernel (it
    refuses any other): rows a block, the F chunk, threads and
    shared-memory bytes, the warps' layout, the ring's stages and the
    accumulators a thread holds, which are premlp_plan's (the two share
    csrc/mlp_mma.cuh's chain), with the epilogue's row sums after the
    chain. C = 2048 and float32 at every C: route "products", h through
    device memory between gemm.cu's products and then the row pass
    (``mlp_resln_products``; their splits are gemm.cu's choose_splits).
    "kernels" names the device kernels the route launches; F must be a
    multiple of "f_chunk"."""
    if C not in F_CHUNK:
        raise ValueError(f"kernel takes C in {KERNEL_WIDTHS}, got {C}")
    if C == PRODUCTS_WIDTH or dtype == torch.float32:
        return dict(route="products", f_chunk=F_CHUNK[C],
                    kernels=(GEMM_BODIES[dtype], "post_ln_rows_kernel"))
    k = premlp_plan(C, dtype)
    return dict(k, route="block", kernels=("mlp_resln_mma_kernel",),
                smem=k["smem"] + 4 * 2 * k["col_warps"] * k["rows"])


def post_ln_rows_plain(y, b, res, ln, *, eps, drop):
    """The row pass in plain PyTorch: (LN(ypre), ypre) with ypre =
    cast(dropout(y + b) + res), y the float sum of the products, res the
    residual (the FFN tail's x) and ``drop`` the call's kernel arguments
    (``ops/dropout.py``)."""
    dt = res.dtype
    v = dropout.apply_args(y.float() + b.to(dt).float(), drop)
    ypre = (v + res.float()).to(dt)
    return _post_ln(ypre, dt, ln, eps), ypre


def post_ln_rows(y, b, res, ln, *, eps, drop, train):
    """The row pass (csrc/mlp_resln.cu post_ln_rows_kernel, C in
    KERNEL_WIDTHS) on the card, its plain version on the CPU: (out, ypre,
    or None outside training)."""
    if y.device.type == "cpu":
        out, ypre = post_ln_rows_plain(y, b, res, ln, eps=eps, drop=drop)
        return out, ypre if train else None
    M, C = res.shape
    out = torch.empty_like(res)
    ypre = torch.empty_like(res) if train else None
    err = lib.library().idvs_post_ln_rows(
        y.data_ptr(), b.data_ptr(), res.data_ptr(), ln[0].data_ptr(),
        ln[1].data_ptr(), out.data_ptr(), ptr(ypre), M, C, float(eps), *drop,
        lib.dtype_code(res), lib.stream_handle(res))
    lib.check(err, "post_ln_rows")
    return out, ypre


def mlp_resln_products(x2, w1, b1, w2, b2, ln, *, eps, act, drop, train):
    """The FFN tail at C = 2048 and in float32 (csrc/mlp_resln.cu's
    header): h = f32(x w1) + b1 and y = f32(cast(act(h)) w2) through
    gemm.cu, then the row pass; a float32 forward alone applies act in
    dense1's epilogue, once an element, rather than on dense2's load.
    (out, ypre, h) in training, h cast to the compute dtype; (out, None,
    None) otherwise. On the CPU every piece is its plain version, so this
    is the composition's order and rounding points in plain PyTorch."""
    M, C = x2.shape
    F = w1.shape[1]
    dt, code = x2.dtype, lib.dtype_code(x2)
    if dt == torch.float32 and not train:
        # act in dense1's epilogue, once an element: g = act(x w1 + b1)
        g = gemm(x2, w1, M, F, C, (C, 1), (F, 1), code, bias=b1,
                 out_f32=True, out_act=act)
        y = gemm(g, w2, M, C, F, (F, 1), (C, 1), code, out_f32=True)
        out, _ = post_ln_rows(y, b2, x2, ln, eps=eps, drop=drop, train=False)
        return out, None, None
    # in training, h decides the backward's branch at a ReLU's kink: at
    # most DENSE1_DEPTH of K a tensor-core slice
    h = gemm(x2, w1, M, F, C, (C, 1), (F, 1), code, bias=b1, out_f32=True,
             max_depth=DENSE1_DEPTH if train else 0)
    y = gemm(h, w2, M, C, F, (F, 1), (C, 1), code, act=act, pro_act=True,
             out_f32=True, dtype=dt)
    out, ypre = post_ln_rows(y, b2, x2, ln, eps=eps, drop=drop, train=train)
    if not train:
        return out, None, None
    return out, ypre, h if dt == torch.float32 else act_cast(h)


def _launch_mlp(x2, w1, b1, w2, b2, g, bt, eps, act, drop, code, train):
    """(out, ypre, h) of the tail on the card; ypre and h only in
    training."""
    M, C = x2.shape
    F = w1.shape[1]
    k = mlp_resln_plan(C, x2.dtype)
    (fused_mlp_resln_res if train else fused_mlp_resln).bodies.update(
        k["kernels"])
    if k["route"] == "products":
        return mlp_resln_products(x2, w1, b1, w2, b2, (g, bt), eps=eps,
                                  act=act, drop=drop, train=train)
    out = torch.empty_like(x2)
    ypre = torch.empty_like(x2) if train else None
    h = (torch.empty(M, F, dtype=x2.dtype, device=x2.device) if train
         else None)
    err = lib.library().idvs_mlp_resln_fwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), g.data_ptr(), bt.data_ptr(), out.data_ptr(),
        ptr(ypre), ptr(h), M, C, F, float(eps), ACTS[act], *drop,
        k["rows"], k["f_chunk"], k["threads"], k["smem"], code,
        lib.stream_handle(x2))
    lib.check(err, "fused_mlp_resln")
    return out, ypre, h


def fused_mlp_resln_res(x2, w1, b1, w2, b2, g, bt, *, eps, act, drop,
                        code):
    """Training edition: (out, y_pre, h), y_pre the cast pre-LN sum and h
    the cast pre-activation x @ w1 + b1."""
    out, ypre, h = _launch_mlp(x2, w1, b1, w2, b2, g, bt, eps, act, drop,
                               code, True)
    fused_mlp_resln_res.launches += 1
    return out, ypre, h


def fused_mlp_resln_bwd(x2, w1, w2, g, ypre, h, dout, *, eps, act, drop,
                        code):
    """Backward of the training edition (mlp.py:463-495): (dx, dw1, db1,
    dw2, db2, dgamma, dbeta); weights and biases in the compute dtype,
    dgamma and dbeta float."""
    M, C = x2.shape
    F = w1.shape[1]
    dout = dout.reshape(M, C).to(x2.dtype).contiguous()
    lib.check_device(dout)
    lib.check_aligned(dout)
    dz, _, dyp, sums = _rows_bwd(ypre, dout, g, eps, drop, code, dres=False)
    # dw2 = cast(act(h))ᵀ dz
    dw2 = gemm(h, dz, F, C, M, (1, F), (C, 1), code, act=act, pro_act=True)
    # dh = cast((dz w2ᵀ) * act'(h))
    dh = gemm(dz, w2, M, F, C, (C, 1), (1, C), code, gate=h, act=act)
    # dw1 = xᵀ dh;  dx = dh w1ᵀ + dyp
    dw1 = gemm(x2, dh, C, F, M, (1, C), (F, 1), code)
    dx = gemm(dh, w1, M, C, F, (F, 1), (1, F), code, add=dyp)
    db1 = colsum(dh, code)
    fused_mlp_resln_bwd.launches += 1
    dt = x2.dtype
    return dx, dw1, db1.to(dt), dw2, sums[2].to(dt), sums[0], sums[1]


class _MLPResLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, g, bt, eps, act, drop, code):
        out, ypre, h = fused_mlp_resln_res(x2, w1, b1, w2, b2, g, bt,
                                           eps=eps, act=act, drop=drop,
                                           code=code)
        ctx.save_for_backward(x2, w1, w2, g, ypre, h)
        ctx.meta = dict(eps=eps, act=act, drop=drop, code=code)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, w1, w2, g, ypre, h = ctx.saved_tensors
        grads = fused_mlp_resln_bwd(x2, w1, w2, g, ypre, h, dout,
                                    **ctx.meta)
        return (*grads, None, None, None, None)


def fused_mlp_resln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, *, ln, eps: float,
                    drop_rate: float = 0.0, seed: int = None,
                    act: str = "gelu") -> torch.Tensor:
    """(..., C) -> (..., C): LN(x + dropout(act(x @ w1 + b1) @ w2 + b2));
    w1 (C, F) and w2 (F, C) in (in, out) layout; act is exact "gelu",
    "relu" or "quick_gelu" (h * sigmoid(1.702 h)); drop_rate > 0 drops with
    the mask of ``seed``."""
    C, F = w1.shape
    _check_width(x, C)
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if w2.shape != (F, C) or b1.shape != (F,) or b2.shape != (C,):
        raise ValueError("fused_mlp_resln: shapes disagree")
    drop = dropout.kernel_args(drop_rate, seed)
    if x.device.type == "cpu":
        return fused_mlp_resln_plain(x, w1, b1, w2, b2, ln=ln, eps=eps,
                                     act=act, drop_rate=drop_rate, seed=seed)
    dt = x.dtype
    code, x2, (w1_, b1_, w2_, b2_, g_, bt_) = _kernel_args(
        x, C, w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt), ln[0].float(),
        ln[1].float())
    if F % F_CHUNK[C]:
        raise ValueError(f"kernel takes F a multiple of {F_CHUNK[C]} at "
                         f"C={C}, got {F}")
    if not x2.shape[0]:
        return torch.empty_like(x)
    if _needs_grad(x, w1, b1, w2, b2, ln[0], ln[1]):
        out = _MLPResLN.apply(x2, w1_, b1_, w2_, b2_, g_, bt_, float(eps),
                              act, drop, code)
    else:
        out = _launch_mlp(x2, w1_, b1_, w2_, b2_, g_, bt_, eps, act, drop,
                          code, False)[0]
        fused_mlp_resln.launches += 1
    return out.reshape(x.shape)


# -- the pre-LN MLP sub-block (Swin) ------------------------------------------
#
# Kernels: ``csrc/premlp.cu`` (forward), ``csrc/premlp_bwd.cu`` and
# ``csrc/gemm.cu`` (backward). They replace the TPU kernels
# ``idvs/morec_tpu/ops/pallas/mlp.py`` ``fused_mlp`` and ``fused_mlp_res``
# (``_fwd_kernel``, ``_bwd_kernel``): the LayerNorm as a prologue, dense1,
# the activation and dense2 with the (M, F) intermediate never in device
# memory, and for ``fused_mlp_res`` the residual (and DropPath's per-row
# scale) on the accumulator. The backward recomputes the LayerNorm and h
# from x (or reads the h that ``save_h`` stored), runs its four products
# through the tiled kernel of gemm.cu with the activation on load and its
# derivative as an epilogue, and the LayerNorm's backward as a row pass;
# every sum over rows is added in a fixed order. bf16 runs on the tensor
# cores; in float32 the forward runs on the float FMA units and the
# backward's products on the tensor cores as 3xTF32 (gemm.cu); the .cu
# headers have the design.
# ``fused_mlp_bwd.launches`` and ``fused_mlp_res_bwd.launches`` count the
# backward's launches.

PRE_ACTS = {"gelu": 0, "relu": 1, "quick_gelu": 2}
# The bf16 body (premlp_mma_kernel) by C: (F chunk, row warps, column warps,
# stages of the weight ring). At most 96 float accumulators of the (rows,
# C) output a thread; one column warp (h packed in registers) and 128 rows
# up to C = 128, two (h through shared memory) and 64 rows at C = 192 and
# 256; from C = 384 on 16 warps, which one block an SM holds with the
# (rows, C + 8) tile of xn and the ring, and chunks as wide as the float32
# body's, so that each W1 slice gives every warp at least 12 products
# between two barriers. The layouts measured best of those tried on the
# H100 (PERF.md).
_PRE_MMA = {32: (32, 8, 1, 3), 64: (64, 8, 1, 3), 96: (96, 8, 1, 3),
            128: (64, 8, 1, 3), 192: (96, 4, 2, 3), 256: (128, 4, 2, 3),
            384: (192, 4, 4, 3), 512: (256, 4, 4, 3), 768: (384, 2, 8, 3),
            1024: (256, 2, 8, 2)}
# The float32 body (premlp_kernel) by C: (TX, NG, NG1, KB) of tile.cuh
_PRE_FMA = {32: (8, 1, 1, 16), 64: (16, 1, 1, 16), 96: (8, 3, 3, 16),
            128: (32, 1, 1, 16), 192: (16, 3, 3, 16), 256: (32, 2, 2, 16),
            384: (32, 3, 3, 16), 512: (32, 4, 2, 16), 768: (32, 6, 3, 8),
            1024: (32, 8, 2, 4)}
# C the kernel is instantiated for -> the chunk F must be a multiple of: the
# float32 body's (4 TX NG1), which the bf16 body's divides
PRE_F_CHUNK = {C: 4 * TX * NG1 for C, (TX, _, NG1, _) in _PRE_FMA.items()}


def premlp_plan(C: int, dtype: torch.dtype) -> dict:
    """The block plan of csrc/premlp.cu at width C, which the launch passes
    to the kernel (the kernel refuses any other): rows a block, the F chunk,
    threads and shared-memory bytes; for bf16 also the warps' layout, the
    ring's stages and the accumulators a thread holds."""
    if dtype == torch.bfloat16:
        FC, RW, WN, S = _PRE_MMA[C]
        rows = 16 * RW
        slot = 32 * (max(FC, C) + 8)
        smem = 2 * (rows * (C + 8) + S * slot
                    + (rows * (FC + 8) if WN > 1 else 0))
        return dict(rows=rows, f_chunk=FC, threads=32 * RW * WN, smem=smem,
                    row_warps=RW, col_warps=WN, stages=S,
                    acc_floats=rows * C // (32 * RW * WN),
                    h_floats=16 * FC // WN // 32)
    TX, _, _, KB = _PRE_FMA[C]
    rows, FC = 4 * (256 // TX), PRE_F_CHUNK[C]
    return dict(rows=rows, f_chunk=FC, threads=256,
                smem=4 * ((C + FC) * (rows + 4) + 2 * KB * C))


def _pre_mlp(x2, w1, b1, w2, b2, ln, eps, act, save_h=False):
    """float32 dense2(cast(act(dense1(cast(LN(x)))))) of (M, C) rows. With
    save_h the value is the same (the forward's activation reads the float32
    h) and the gradient is the one of the edition that stores cast(h): its
    backward takes act and act' at the stored h (JAX ops/pallas/mlp.py
    :124-127, :173-177)."""
    dt = x2.dtype
    xn = x2 if ln is None else layer_norm(x2, ln[0], ln[1], eps)
    h = xn.float() @ w1.to(dt).float() + b1.to(dt).float()
    g = _act(h, act).to(dt).float()
    w2f = w2.to(dt).float()
    if save_h:
        y = _Dense2SavedH.apply(g.detach(),
                                _act(h.to(dt).float(), act).to(dt).float(),
                                w2f)
    else:
        y = g @ w2f
    return y + b2.to(dt).float()


class _Dense2SavedH(torch.autograd.Function):
    """g_fwd @ w2 whose backward sees g_bwd, the activation recomputed from
    the stored h: dw2 = g_bwdᵀ dy, and dy w2ᵀ flows on through g_bwd."""

    @staticmethod
    def forward(ctx, g_fwd, g_bwd, w2f):
        ctx.save_for_backward(g_bwd, w2f)
        return g_fwd @ w2f

    @staticmethod
    def backward(ctx, dy):
        g_bwd, w2f = ctx.saved_tensors
        return None, dy @ w2f.t(), g_bwd.t() @ dy


def fused_mlp_plain(x, w1, b1, w2, b2, *, ln=None, eps=1e-5, act="gelu",
                    save_h=False):
    """The kernel's function in plain PyTorch, same rounding points."""
    y = _pre_mlp(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, ln, eps, act,
                 save_h)
    return y.to(x.dtype).reshape(x.shape)


def fused_mlp_res_plain(x, scale, w1, b1, w2, b2, *, ln, eps=1e-5,
                        act="gelu"):
    """x + scale * mlp(LN(x)) in plain PyTorch; scale None is the unit
    edition."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _pre_mlp(x2, w1, b1, w2, b2, ln, eps, act)
    if scale is not None:
        y = scale.float().reshape(-1, 1) * y
    return (x2.float() + y).to(x.dtype).reshape(x.shape)


def _premlp_fwd(name, x2, s, ops, lnf, eps, act, res, code, hsave=None):
    """Launches csrc/premlp.cu on validated, contiguous operands."""
    C, F = ops[0].shape
    out = torch.empty_like(x2)
    k = premlp_plan(C, x2.dtype)
    err = lib.library().idvs_premlp_fwd(
        x2.data_ptr(), *(t.data_ptr() for t in ops), ptr(lnf[0]),
        ptr(lnf[1]), ptr(s), out.data_ptr(), ptr(hsave), x2.shape[0], C, F,
        float(eps), PRE_ACTS[act], res, k["rows"], k["f_chunk"],
        k["threads"], k["smem"], code, lib.stream_handle(x2))
    lib.check(err, name)
    return out


def _premlp_bwd(x2, dout, s, w1, b1, w2, lnf, h, eps, act, res, code):
    """(dx, dw1, db1, dw2, db2, dgamma, dbeta) of the pre-LN MLP
    (csrc/premlp_bwd.cu has the plan); weights and biases in the compute
    dtype, dgamma and dbeta float32 (None without a LayerNorm)."""
    M, C = x2.shape
    F = w1.shape[1]
    dt, dev = x2.dtype, x2.device
    k = lib.library()
    stream = lib.stream_handle(x2)
    dout = dout.reshape(M, C).to(dt).contiguous()
    lib.check_device(dout)
    ln = lnf[0] is not None
    xn = x2
    if ln:
        xn = torch.empty_like(x2)
        stats = torch.empty(M, 2, device=dev)
        lib.check(k.idvs_premlp_ln_rows(
            x2.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(),
            xn.data_ptr(), stats.data_ptr(), M, C, float(eps), code, stream),
            "premlp_ln_rows")
    if h is None:
        h = gemm(xn, w1, M, F, C, (C, 1), (F, 1), code, bias=b1,
                  out_f32=True)
    dy = dout
    if s is not None:
        dy = torch.empty_like(dout)
        lib.check(k.idvs_scale_rows(dout.data_ptr(), s.data_ptr(),
                                    dy.data_ptr(), M, C, code, stream),
                  "scale_rows")
    # dw2 = cast(act(h))ᵀ dy;  dh = cast((dy w2ᵀ) * act'(h))
    dw2 = gemm(h, dy, F, C, M, (1, F), (C, 1), code, act=act, pro_act=True,
                dtype=dt)
    db2 = colsum(dy, code)
    dh = gemm(dy, w2, M, F, C, (C, 1), (1, C), code, gate=h, act=act)
    del h
    # dw1 = xnᵀ dh;  dxn = dh w1ᵀ
    dw1 = gemm(xn, dh, C, F, M, (1, C), (F, 1), code)
    db1 = colsum(dh, code)
    dxn = gemm(dh, w1, M, C, F, (F, 1), (1, F), code, out_f32=ln)
    if not ln:      # fused_mlp without its LayerNorm: dxn is dx
        return dxn, dw1, db1.to(dt), dw2, db2.to(dt), None, None
    dx = torch.empty_like(x2)
    nb = row_groups(M)
    part = torch.empty(nb * 2 * C, device=dev)
    sums = torch.empty(2, C, device=dev)
    lib.check(k.idvs_premlp_ln_bwd(
        x2.data_ptr(), dxn.data_ptr(), lnf[0].data_ptr(), stats.data_ptr(),
        dout.data_ptr() if res else None, dx.data_ptr(), part.data_ptr(),
        sums.data_ptr(), nb, M, C, code, stream), "premlp_ln_bwd")
    return dx, dw1, db1.to(dt), dw2, db2.to(dt), sums[0], sums[1]


def fused_mlp_bwd(x2, dout, w1, b1, w2, lnf, h, *, eps, act, code):
    """Backward of ``fused_mlp`` on the card: x2 (M, C) and dout in the
    compute dtype, lnf the LayerNorm's float32 (scale, bias) or (None,
    None), h the (M, F) residual of the save_h edition or None."""
    grads = _premlp_bwd(x2, dout, None, w1, b1, w2, lnf, h, eps, act, False,
                        code)
    fused_mlp_bwd.launches += 1
    return grads


def fused_mlp_res_bwd(x2, dout, s, w1, b1, w2, lnf, *, eps, act, code):
    """Backward of ``fused_mlp_res``: the MLP chain sees s * dout (dout in
    the unit edition, s None), the residual adds the raw dout to dx; s gets
    no gradient."""
    grads = _premlp_bwd(x2, dout, s, w1, b1, w2, lnf, None, eps, act, True,
                        code)
    fused_mlp_res_bwd.launches += 1
    return grads


class _PreMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, s, w1, b1, w2, b2, gamma, beta, meta):
        name, eps, act, res, save_h, code = meta
        h = (torch.empty(x2.shape[0], w1.shape[1], dtype=x2.dtype,
                         device=x2.device) if save_h else None)
        out = _premlp_fwd(name, x2, s, (w1, b1, w2, b2), (gamma, beta), eps,
                          act, res, code, h)
        ctx.save_for_backward(x2, s, w1, b1, w2, gamma, beta, h)
        ctx.meta = meta
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, s, w1, b1, w2, gamma, beta, h = ctx.saved_tensors
        _, eps, act, res, _, code = ctx.meta
        if res:
            g = fused_mlp_res_bwd(x2, dout, s, w1, b1, w2, (gamma, beta),
                                  eps=eps, act=act, code=code)
        else:
            g = fused_mlp_bwd(x2, dout, w1, b1, w2, (gamma, beta), h, eps=eps,
                              act=act, code=code)
        dx, dw1, db1, dw2, db2, dgamma, dbeta = g
        return dx, None, dw1, db1, dw2, db2, dgamma, dbeta, None


def _launch_premlp(name, x, scale, w1, b1, w2, b2, ln, eps, act, res,
                   save_h=False):
    C, F = w1.shape
    if C not in PRE_F_CHUNK:
        raise ValueError(f"{name} kernel takes C in {sorted(PRE_F_CHUNK)}, "
                         f"got {C}")
    if F % PRE_F_CHUNK[C]:
        raise ValueError(f"{name} kernel takes F a multiple of "
                         f"{PRE_F_CHUNK[C]} at C={C}, got {F}")
    dt = x.dtype
    code = lib.dtype_code(x)
    x2 = x.reshape(-1, C).contiguous()
    ops = [t.to(dt).contiguous() for t in (w1, b1, w2, b2)]
    lnf = ([t.float().contiguous() for t in ln] if ln is not None
           else [None, None])
    s = None
    if scale is not None:
        s = scale.detach().float().reshape(-1).contiguous()
        if s.shape[0] != x2.shape[0]:
            raise ValueError(f"{name}: scale has {s.shape[0]} rows, x has "
                             f"{x2.shape[0]}")
    live = [t for t in (*lnf, s) if t is not None]
    lib.check_device(x2, *ops, *live)
    lib.check_aligned(x2, *ops)
    if not x2.shape[0]:
        return torch.empty_like(x)
    if _needs_grad(x2, *ops, *live):
        out = _PreMLP.apply(x2, s, *ops, *lnf,
                            (name, float(eps), act, res, save_h, code))
    else:
        with torch.no_grad():
            out = _premlp_fwd(name, x2, s, ops, lnf, eps, act, res, code)
    return out.reshape(x.shape)


def _check_premlp(name, x, w1, b1, w2, b2, ln, act):
    C, F = w1.shape
    _check_width(x, C)
    if act not in PRE_ACTS:
        raise ValueError(f"act must be one of {sorted(PRE_ACTS)}, got "
                         f"{act!r}")
    if (w2.shape != (F, C) or b1.shape != (F,) or b2.shape != (C,)
            or (ln is not None and (ln[0].shape != (C,)
                                    or ln[1].shape != (C,)))):
        raise ValueError(f"{name}: shapes disagree")


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, *, ln=None,
              eps: float = 1e-5, act: str = "gelu",
              save_h: bool = False) -> torch.Tensor:
    """(..., C) -> (..., C): dense2(act(dense1(maybe_LN(x)))); ln is None
    or the LayerNorm's (scale, bias), applied first; act is exact "gelu",
    "relu" or "quick_gelu" (x * sigmoid(1.702 x)). The residual add stays
    with the caller. The backward recomputes h = dense1(...) from x; with
    ``save_h`` the forward stores it (M x F in x's dtype) when a gradient is
    wanted and the backward reads it instead."""
    _check_premlp("fused_mlp", x, w1, b1, w2, b2, ln, act)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, ln=ln, eps=eps, act=act,
                               save_h=save_h)
    out = _launch_premlp("fused_mlp", x, None, w1, b1, w2, b2, ln, eps, act,
                         0, save_h)
    fused_mlp.launches += 1
    return out


def fused_mlp_res(x: torch.Tensor, scale, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                  ln, eps: float = 1e-5, act: str = "gelu") -> torch.Tensor:
    """(..., C) -> (..., C): x + scale * dense2(act(dense1(LN(x)))), the
    pre-LN residual tail. scale is a float factor per row (DropPath's keep
    mask over the keep probability; it gets no gradient), or None for
    x + mlp(LN(x))."""
    _check_premlp("fused_mlp_res", x, w1, b1, w2, b2, ln, act)
    if ln is None:
        raise ValueError("fused_mlp_res needs the LayerNorm's (scale, bias)")
    if x.device.type == "cpu":
        return fused_mlp_res_plain(x, scale, w1, b1, w2, b2, ln=ln, eps=eps,
                                   act=act)
    out = _launch_premlp("fused_mlp_res", x, scale, w1, b1, w2, b2, ln, eps,
                         act, 1 if scale is None else 2)
    fused_mlp_res.launches += 1
    return out


fused_mlp.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_res.launches = 0
fused_mlp_res_bwd.launches = 0
fused_proj_resln.launches = 0
fused_proj_resln_res.launches = 0
fused_proj_resln_bwd.launches = 0
fused_mlp_resln.launches = 0
fused_mlp_resln_res.launches = 0
fused_mlp_resln_bwd.launches = 0
# the device kernels each forward wrapper launched, by its plans' "kernels"
for _wrapper in (fused_proj_resln, fused_proj_resln_res, fused_mlp_resln,
                 fused_mlp_resln_res):
    _wrapper.bodies = set()
