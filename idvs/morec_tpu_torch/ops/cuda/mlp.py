"""Post-LN epilogue kernels: the projection tail and the FFN tail, forward
and backward; and the pre-LN MLP sub-block (``fused_mlp``,
``fused_mlp_res``, forward), at the end of the module.

Kernels: ``csrc/proj_resln.cu`` and ``csrc/mlp_resln.cu`` (forward),
``csrc/resln_bwd.cu`` and ``csrc/gemm.cu`` (backward). They replace the TPU
kernels ``idvs/morec_tpu/ops/pallas/mlp.py`` ``fused_proj_resln``
(``_fwd_proj_only_kernel``, ``_fwd_proj_kernel``, ``_bwd_proj_kernel``) and
``fused_mlp_resln`` (``_fwd_post_only_kernel``, ``_fwd_post_kernel``,
``_bwd_post_kernel``), with the in-kernel dropout of ``ops/dropout.py``.
In float32 (no TF32, for parity) all are bound by the card's float FMA
rate. Forward: each block owns 32 rows (8 at C = 2048, where only the
forward-only editions exist) and all C columns, so the dropout,
the residual add, the cast to the compute dtype and the LayerNorm run on the
accumulator, and the FFN's (M, F) intermediate never leaves the block
unless the training edition saves it. Backward: a row pass recomputes the
LN statistics from the saved pre-LN sum, and one tiled kernel runs the
products, split over M with a deterministic second pass for the weight
gradients. The .cu headers have the details.

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
from ...models.layers import layer_norm

KERNEL_WIDTHS = (128, 256, 512, 2048)   # C the kernels are instantiated for
FORWARD_ONLY_WIDTHS = (2048,)   # no training edition yet (8-row tiles)
F_CHUNK = {128: 128, 256: 128, 512: 256, 2048: 1024}   # F: a multiple of
ACTS = {"gelu": 0, "relu": 1}
GEMM_ACTS = {"gelu": 1, "relu": 2}   # csrc/gemm.cu Act


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The card's streaming multiprocessors: they size the row pass's
    partial sums and the split over K of a product."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(h)
    return torch.nn.functional.gelu(h, approximate="none")


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


def fused_mlp_resln_plain(x, w1, b1, w2, b2, *, ln, eps, act="gelu",
                          drop_rate=0.0, seed=None):
    """LN(x + dropout(act(x @ w1 + b1) @ w2 + b2)) in plain PyTorch; act(h)
    is cast to the compute dtype before dense2 (JAX ops/pallas/mlp.py:406)."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    g = _act(h, act).to(dt).float()
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


def _check_trainable(C, name):
    if C in FORWARD_ONLY_WIDTHS:
        raise NotImplementedError(
            f"{name}: the training edition at C={C} is not ported; it comes "
            f"with the vision-training slice")


def _ptr(t):
    return None if t is None else t.data_ptr()


# -- the projection tail ------------------------------------------------------

def _launch_proj(x2, r2, w, b, g, bt, ypre, eps, drop, code):
    M, C = x2.shape
    out = torch.empty_like(x2)
    err = lib.library().idvs_proj_resln_fwd(
        x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(),
        g.data_ptr(), bt.data_ptr(), out.data_ptr(), _ptr(ypre), M, C,
        float(eps), *drop, code, lib.stream_handle(x2))
    lib.check(err, "fused_proj_resln")
    return out


def fused_proj_resln_res(x2, r2, w, b, g, bt, *, eps, drop, code):
    """Training edition: (out, y_pre), y_pre the cast pre-LN sum."""
    ypre = torch.empty_like(x2)
    out = _launch_proj(x2, r2, w, b, g, bt, ypre, eps, drop, code)
    fused_proj_resln_res.launches += 1
    return out, ypre


def _rows_bwd(ypre, dout, gamma, eps, drop, code, *, dres: bool):
    """LN backward rows (csrc/resln_bwd.cu): (dz, dres or None, dyp or None,
    sums (3, C) = dgamma, dbeta, db)."""
    M, C = ypre.shape
    dz = torch.empty_like(ypre)
    dres_t = torch.empty_like(ypre) if dres else None
    dyp = None if dres else torch.empty(M, C, device=ypre.device)
    nb = max(1, min((M + 7) // 8, 4 * _sm_count(ypre.device.index or 0)))
    part = torch.empty(nb * 3 * C, device=ypre.device)
    sums = torch.empty(3, C, device=ypre.device)
    err = lib.library().idvs_resln_bwd_rows(
        ypre.data_ptr(), dout.data_ptr(), gamma.data_ptr(), _ptr(dres_t),
        _ptr(dyp), dz.data_ptr(), part.data_ptr(), sums.data_ptr(), nb, M, C,
        float(eps), *drop, code, lib.stream_handle(ypre))
    lib.check(err, "resln_bwd_rows")
    return dz, dres_t, dyp, sums


def _splits(M, N, K, sms):
    """K slices of a product: enough blocks for two waves on the sms
    multiprocessors of the card, each slice at least 1024 deep."""
    tiles = -(-M // 128) * -(-N // 128)
    if tiles >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), K // 1024))


def _gemm(A, B, M, N, K, sa, sb, code, *, add=None, gate=None, act="gelu",
          pro_act=False):
    """(M, N) = epi(pro(A) @ B) in A's dtype (csrc/gemm.cu); sa = (sam,
    sak) and sb = (sbk, sbn) are the element strides of A(m, k), B(k, n)."""
    out = torch.empty(M, N, dtype=A.dtype, device=A.device)
    splits = _splits(M, N, K, _sm_count(A.device.index or 0))
    ws = (torch.empty(splits * M * N, device=A.device) if splits > 1
          else None)
    err = lib.library().idvs_gemm(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _ptr(add), _ptr(gate),
        _ptr(ws), M, N, K, *sa, *sb, splits,
        GEMM_ACTS[act] if pro_act else 0, GEMM_ACTS[act], 0, code,
        lib.stream_handle(A))
    lib.check(err, "gemm")
    return out


def fused_proj_resln_bwd(x2, w, g, ypre, dout, *, eps, drop, code):
    """Backward of the training edition: (dx, dres, dw, db, dgamma, dbeta);
    dw and db in the compute dtype, dgamma and dbeta float."""
    M, C = x2.shape
    dout = dout.reshape(M, C).to(x2.dtype).contiguous()
    lib.check_device(dout)
    lib.check_aligned(dout)
    dz, dres, _, sums = _rows_bwd(ypre, dout, g, eps, drop, code, dres=True)
    dw = _gemm(x2, dz, C, C, M, (1, C), (C, 1), code)           # xᵀ dz
    dx = _gemm(dz, w, M, C, C, (C, 1), (1, C), code)            # dz wᵀ
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
        _check_trainable(C, "fused_proj_resln")
        out = _ProjResLN.apply(x2, r2, w_, b_, g_, bt_, float(eps), drop,
                               code)
    else:
        out = _launch_proj(x2, r2, w_, b_, g_, bt_, None, eps, drop, code)
        fused_proj_resln.launches += 1
    return out.reshape(x.shape)


# -- the FFN tail -------------------------------------------------------------

def _launch_mlp(x2, w1, b1, w2, b2, g, bt, ypre, h, eps, act, drop, code):
    M, C = x2.shape
    F = w1.shape[1]
    out = torch.empty_like(x2)
    err = lib.library().idvs_mlp_resln_fwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), g.data_ptr(), bt.data_ptr(), out.data_ptr(),
        _ptr(ypre), _ptr(h), M, C, F, float(eps), ACTS[act], *drop, code,
        lib.stream_handle(x2))
    lib.check(err, "fused_mlp_resln")
    return out


def fused_mlp_resln_res(x2, w1, b1, w2, b2, g, bt, *, eps, act, drop,
                        code):
    """Training edition: (out, y_pre, h), y_pre the cast pre-LN sum and h
    the cast pre-activation x @ w1 + b1."""
    ypre = torch.empty_like(x2)
    h = torch.empty(x2.shape[0], w1.shape[1], dtype=x2.dtype,
                    device=x2.device)
    out = _launch_mlp(x2, w1, b1, w2, b2, g, bt, ypre, h, eps, act, drop,
                      code)
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
    dw2 = _gemm(h, dz, F, C, M, (1, F), (C, 1), code, act=act, pro_act=True)
    # dh = cast((dz w2ᵀ) * act'(h))
    dh = _gemm(dz, w2, M, F, C, (C, 1), (1, C), code, gate=h, act=act)
    # dw1 = xᵀ dh;  dx = dh w1ᵀ + dyp
    dw1 = _gemm(x2, dh, C, F, M, (1, C), (F, 1), code)
    dx = _gemm(dh, w1, M, C, F, (F, 1), (1, F), code, add=dyp)
    nb = max(1, min(M, 256))
    part = torch.empty(nb * F, device=x2.device)
    db1 = torch.empty(F, device=x2.device)
    err = lib.library().idvs_colsum(dh.data_ptr(), part.data_ptr(),
                                    db1.data_ptr(), nb, M, F, code,
                                    lib.stream_handle(x2))
    lib.check(err, "colsum")
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
    w1 (C, F) and w2 (F, C) in (in, out) layout; act is exact "gelu" or
    "relu"; drop_rate > 0 drops with the mask of ``seed``."""
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
        _check_trainable(C, "fused_mlp_resln")
        out = _MLPResLN.apply(x2, w1_, b1_, w2_, b2_, g_, bt_, float(eps),
                              act, drop, code)
    else:
        out = _launch_mlp(x2, w1_, b1_, w2_, b2_, g_, bt_, None, None, eps,
                          act, drop, code)
        fused_mlp_resln.launches += 1
    return out.reshape(x.shape)


# -- the pre-LN MLP sub-block (Swin) ------------------------------------------
#
# Kernel: ``csrc/premlp.cu``. It replaces the TPU kernels
# ``idvs/morec_tpu/ops/pallas/mlp.py`` ``fused_mlp`` and ``fused_mlp_res``
# (``_fwd_kernel``): the LayerNorm as a prologue, dense1, the activation and
# dense2 with the (M, F) intermediate never in device memory, and for
# ``fused_mlp_res`` the residual (and DropPath's per-row scale) on the
# accumulator. Bound by the card's float FMA rate; the .cu header has the
# design. The backward and the ``save_h`` residual are not ported: on the
# card a wrapper raises when a gradient is wanted.

PRE_ACTS = {"gelu": 0, "relu": 1, "quick_gelu": 2}
# C the kernel is instantiated for -> the chunk F must be a multiple of
PRE_F_CHUNK = {32: 32, 64: 64, 96: 96, 128: 128, 192: 192, 256: 256,
               384: 384, 512: 256, 768: 384, 1024: 256}


def _pre_mlp(x2, w1, b1, w2, b2, ln, eps, act):
    """float32 dense2(cast(act(dense1(cast(LN(x)))))) of (M, C) rows."""
    dt = x2.dtype
    xn = x2 if ln is None else layer_norm(x2, ln[0], ln[1], eps)
    h = xn.float() @ w1.to(dt).float() + b1.to(dt).float()
    if act == "quick_gelu":
        g = h * torch.sigmoid(1.702 * h)
    else:
        g = _act(h, act)
    return g.to(dt).float() @ w2.to(dt).float() + b2.to(dt).float()


def fused_mlp_plain(x, w1, b1, w2, b2, *, ln=None, eps=1e-5, act="gelu"):
    """The kernel's function in plain PyTorch, same rounding points."""
    y = _pre_mlp(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, ln, eps, act)
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


def _launch_premlp(name, x, scale, w1, b1, w2, b2, ln, eps, act, res):
    C, F = w1.shape
    if C not in PRE_F_CHUNK:
        raise ValueError(f"{name} kernel takes C in {sorted(PRE_F_CHUNK)}, "
                         f"got {C}")
    if F % PRE_F_CHUNK[C]:
        raise ValueError(f"{name} kernel takes F a multiple of "
                         f"{PRE_F_CHUNK[C]} at C={C}, got {F}")
    tensors = (x, w1, b1, w2, b2) + (tuple(ln) if ln is not None else ())
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"the backward of {name} is not ported: it comes with the "
            f"vision-training slice")
    dt = x.dtype
    code = lib.dtype_code(x)
    x2 = x.reshape(-1, C).contiguous()
    ops = [t.detach().to(dt).contiguous() for t in (w1, b1, w2, b2)]
    lnf = ([t.detach().float().contiguous() for t in ln] if ln is not None
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
    out = torch.empty_like(x2)
    if not x2.shape[0]:
        return out.reshape(x.shape)
    err = lib.library().idvs_premlp_fwd(
        x2.data_ptr(), *(t.data_ptr() for t in ops), _ptr(lnf[0]),
        _ptr(lnf[1]), _ptr(s), out.data_ptr(), x2.shape[0], C, F, float(eps),
        PRE_ACTS[act], res, code, lib.stream_handle(x2))
    lib.check(err, name)
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
              eps: float = 1e-5, act: str = "gelu") -> torch.Tensor:
    """(..., C) -> (..., C): dense2(act(dense1(maybe_LN(x)))); ln is None
    or the LayerNorm's (scale, bias), applied first; act is exact "gelu",
    "relu" or "quick_gelu" (x * sigmoid(1.702 x)). The residual add stays
    with the caller."""
    _check_premlp("fused_mlp", x, w1, b1, w2, b2, ln, act)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, ln=ln, eps=eps, act=act)
    out = _launch_premlp("fused_mlp", x, None, w1, b1, w2, b2, ln, eps, act,
                         0)
    fused_mlp.launches += 1
    return out


def fused_mlp_res(x: torch.Tensor, scale, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                  ln, eps: float = 1e-5, act: str = "gelu") -> torch.Tensor:
    """(..., C) -> (..., C): x + scale * dense2(act(dense1(LN(x)))), the
    pre-LN residual tail. scale is a float factor per row (DropPath's keep
    mask over the keep probability), or None for x + mlp(LN(x))."""
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
fused_mlp_res.launches = 0
fused_proj_resln.launches = 0
fused_proj_resln_res.launches = 0
fused_proj_resln_bwd.launches = 0
fused_mlp_resln.launches = 0
fused_mlp_resln_res.launches = 0
fused_mlp_resln_bwd.launches = 0
