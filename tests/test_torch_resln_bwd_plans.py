"""The post-LN tails' backward plan and the fused kernels' walks, on the
CPU.

``resln_bwd_plan`` (the route, and on the fused route the block plan
csrc/resln_bwd_wg.cu checks at launch) at every shape the main paths run
the tails' backward at (text BERT and SASRec, IDRec's SASRec, the vision
step's SASRec at D = 2048) and at every width the tails take, for both
tails in both dtypes: the route named, the shared memory within a
block's 227 KB, the accumulators within the consumers' register cap
(setmaxnreg's, which the producer's registers pay for), F walked in whole
chunks, the partial rows' groups covering the blocks, C = 2048 and
float32 on the products route. Then a plain-torch model of each fused
kernel's walk in its arithmetic order (row blocks of the plan's rows,
each warp's 8 rows of the LN backward with their column sums added in
row and then warp order, the FFN's F chunks with g and dh cast where the
kernel casts them and db1 from 16-row fragment sums, dx summed over the
chunks or K-blocks in float, the partial rows added in groups of ``per``
and then the groups, and gemm.cu's weight-gradient products), held
against ``jax.grad`` of the Pallas ``fused_mlp_resln`` and
``fused_proj_resln`` in interpret mode as tests/test_pallas_mlp.py runs
them (float32, dropout 0; rtol 2e-4, atol 1e-5) and against autograd of
the port's ``fused_mlp_resln_plain`` / ``fused_proj_resln_plain`` in bf16
at dropout 0 and 0.1 (chip_smoke.py's GRAD_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import BODIES, act_of
from idvs.morec_tpu_torch.ops.cuda.mlp import (KERNEL_WIDTHS,
                                               fused_mlp_resln_plain,
                                               fused_proj_resln_plain,
                                               resln_bwd_plan)

BF16, F32 = torch.bfloat16, torch.float32
EPS = 1e-5
GRAD_TOL = 3e-2
# the main paths' tails: (M, C, F) of text BERT and SASRec, IDRec's
# SASRec, the vision step's SASRec at D = 2048
SHAPES = ((768 * 30, 512, 2048), (128 * 20, 512, 2048),
          (256 * 20, 512, 2048), (64 * 10, 2048, 8192))
REGS = 65536              # registers of one SM
PRODUCER_REGS = 40        # the producer warpgroup's, after setmaxnreg


def _check_fused(k, tail, C, M, F):
    assert k["route"] == "fused"
    assert k["kernels"][0] == f"{tail}_resln_bwd_wg_kernel"
    assert BODIES[BF16] in k["kernels"]
    assert not {"ln_bwd_rows_kernel", "colsum_kernel",
                "act_cast_kernel"} & set(k["kernels"])
    rows, chunk = k["rows"], k["chunk"]
    mlp = tail == "mlp"
    # one wgmma M tile of rows; a chunk of F (the FFN) or K (the
    # projection) is one 128-byte swizzled line, each in one of two slots
    assert rows == 64 and chunk == 64 and k["stages"] == 2
    assert k["threads"] == 3 * 128      # producer + two consumer groups
    # the dz tile and the two weight slots, the FFN's dh and g tiles and
    # db1's warp sums, the rows' statistics, four mbarriers, 1024 bytes of
    # alignment
    smem = (2 * rows * C + 2 * 2 * chunk * C
            + (2 * 2 * rows * chunk + 4 * 4 * chunk if mlp else 0)
            + 16 * rows + 32 + 1024)
    assert k["smem"] == smem <= lib.MAX_SMEM
    # the prologue's column sums fit slot 1; the float dx tile the freed
    # dz tile and slots
    assert 8 * 3 * C * 4 <= 2 * chunk * C
    assert rows * (C + 8) * 4 <= 2 * rows * C + 2 * 2 * chunk * C
    # dx's C / 2 columns a consumer warpgroup (and the FFN's 32 of dg)
    assert k["acc_floats"] == C // 4 + (16 if mlp else 0)
    assert k["acc_floats"] + 64 <= k["reg_cap"] <= 255
    assert 256 * k["reg_cap"] + 128 * PRODUCER_REGS <= REGS
    if mlp:
        assert F % chunk == 0
    assert k["blocks"] == -(-M // rows)
    assert k["per"] * k["groups"] >= k["blocks"] > k["per"] * (
        k["groups"] - 1)


@pytest.mark.parametrize("M,C,F", SHAPES)
@pytest.mark.parametrize("tail", ("mlp", "proj"))
def test_plan_of_every_main_path_shape(tail, M, C, F):
    k = resln_bwd_plan(tail, C, M, BF16)
    if C == 2048:
        # the vision step's SASRec: gemm.cu's products around the row pass
        assert k["route"] == "products"
        assert k["kernels"][0] == "ln_bwd_rows_wide_kernel"
    else:
        _check_fused(k, tail, C, M, F)
    f32 = resln_bwd_plan(tail, C, M, F32)
    assert f32["route"] == "products" and BODIES[F32] in f32["kernels"]


@pytest.mark.parametrize("C", KERNEL_WIDTHS)
def test_plan_of_every_width(C):
    for tail in ("mlp", "proj"):
        for dtype in (BF16, F32):
            k = resln_bwd_plan(tail, C, 1000, dtype)
            if dtype == F32 or C in (768, 2048):
                assert k["route"] == "products"
                assert BODIES[dtype] in k["kernels"]
                assert ("act_cast_kernel" in k["kernels"]) == (
                    tail == "mlp" and dtype == BF16)
                continue
            _check_fused(k, tail, C, 1000, 4 * C)
    with pytest.raises(ValueError):
        resln_bwd_plan("attn", C, 1000, BF16)


def _erf_as(h):
    """erf(h / sqrt 2) as the kernel (and the TPU kernel's _erf) takes it:
    Abramowitz-Stegun 7.1.26 from exp(-h^2 / 2)."""
    t = 1.0 / (1.0 + 0.3275911 * 0.7071067811865476 * h.abs())
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(h) * (1.0 - poly * torch.exp(-0.5 * h * h))


def _act(h, act):
    if act == "gelu":
        return 0.5 * h * (1.0 + _erf_as(h))
    return act_of(h, act)


def _dact(h, act):
    if act == "relu":
        return (h > 0).float()
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        return s + h * 1.702 * s * (1.0 - s)
    cdf = 0.5 * (1.0 + _erf_as(h))
    return cdf + h * 0.3989422804014327 * torch.exp(-0.5 * h * h)


def _in_order(rows):
    """The rows of a (n, E) float tensor added one after another."""
    s = torch.zeros(rows.shape[1])
    for r in rows:
        s = s + r
    return s


def _padded(v, rows):
    return torch.cat([v, v.new_zeros(rows - v.shape[0], v.shape[1])])


def _warp_sums(v, rows):
    """A block's column sums of the prologue: each warp's 8 rows in order,
    then the 8 warps in order (rows past M are zeros)."""
    v = _padded(v, rows).view(8, rows // 8, -1)
    per_warp = torch.zeros(8, v.shape[2])
    for i in range(rows // 8):
        per_warp = per_warp + v[:, i]
    return _in_order(per_warp)


def _ln_bwd_rows(ypre, dout, gamma, drop, r0, r1):
    """The prologue's rows r0..r1: (xhat, dyp, dropout(dyp)), float."""
    y = ypre[r0:r1].float()
    C = y.shape[1]
    mu = y.sum(-1, keepdim=True) / C
    var = ((y * y).sum(-1, keepdim=True) / C - mu * mu).clamp_min(0)
    rstd = 1.0 / torch.sqrt(var + EPS)
    xhat = (y - mu) * rstd
    d = dout[r0:r1].float()
    dxh = d * gamma
    m1 = dxh.sum(-1, keepdim=True) / C
    m2 = (dxh * xhat).sum(-1, keepdim=True) / C
    dyp = rstd * (dxh - m1 - xhat * m2)
    # the dropout's index is the element's in the (M, C) view
    full = torch.zeros(ypre.shape)
    full[r0:r1] = dyp
    z = dropout.apply_args(full, drop)[r0:r1]
    return xhat, dyp, z


def kernel_walk(tail, x, w, gamma, ypre, h, dout, act, drop, plan, dt):
    """The fused route in plain torch, in the kernel's arithmetic order;
    cast() is the rounding to the compute dtype dt (none in float32). w is
    (w1, w2) for the FFN tail, (w,) for the projection. Returns the FFN's
    (dx, dw1, db1, dw2, db2, dgamma, dbeta) or the projection's (dx,
    dres, dw, db, dgamma, dbeta)."""
    M, C = x.shape
    mlp = tail == "mlp"
    F = w[0].shape[1] if mlp else 0
    rows, chunk = plan["rows"], plan["chunk"]
    cast = lambda t: t.to(dt).float()
    wc = [cast(t) for t in w]
    part = torch.zeros(plan["blocks"], 3 * C + F)
    dx, dres, dz_all = (torch.empty(M, C) for _ in range(3))
    g_all, dh_all = torch.empty(M, F), torch.empty(M, F)
    for b in range(plan["blocks"]):
        r0, r1 = b * rows, min(M, (b + 1) * rows)
        xhat, dyp, z = _ln_bwd_rows(ypre, dout, gamma, drop, r0, r1)
        d = dout[r0:r1].float()
        part[b, :C] = _warp_sums(d * xhat, rows)
        part[b, C:2 * C] = _warp_sums(d, rows)
        part[b, 2 * C:3 * C] = _warp_sums(z, rows)
        dz = cast(z)
        acc = torch.zeros(r1 - r0, C)
        if mlp:
            for f0 in range(0, F, chunk):
                dg = dz @ wc[1][f0:f0 + chunk].t()
                hc = h[r0:r1, f0:f0 + chunk].float()
                g, dh = cast(_act(hc, act)), cast(dg * _dact(hc, act))
                # db1: each warp's 16-row fragment sums, the 4 warps in
                # order
                frag = _padded(dh, rows).view(4, 16, -1).sum(1)
                part[b, 3 * C + f0:3 * C + f0 + chunk] = _in_order(frag)
                acc = acc + dh @ wc[0][:, f0:f0 + chunk].t()
                g_all[r0:r1, f0:f0 + chunk] = g
                dh_all[r0:r1, f0:f0 + chunk] = dh
            dx[r0:r1] = cast(acc + dyp)
        else:
            for k0 in range(0, C, chunk):
                acc = acc + dz[:, k0:k0 + chunk] @ wc[0][:, k0:k0 + chunk].t()
            dx[r0:r1] = cast(acc)
            dres[r0:r1] = cast(dyp)
        dz_all[r0:r1] = dz
    per = plan["per"]
    sums = _in_order(torch.stack([_in_order(part[i:i + per])
                                  for i in range(0, plan["blocks"], per)]))
    dgamma, dbeta, db2 = sums[:C], sums[C:2 * C], sums[2 * C:3 * C]
    xc = cast(x)
    if mlp:
        dw2 = cast(g_all.t() @ dz_all)
        dw1 = cast(xc.t() @ dh_all)
        return (dx, dw1, cast(sums[3 * C:]), dw2, cast(db2), dgamma, dbeta)
    return (dx, dres, cast(xc.t() @ dz_all), cast(db2), dgamma, dbeta)


def _case(seed, M, C, F):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    x, res, dout = r(M, C), r(M, C), r(M, C)
    mlp = (r(C, F, scale=C ** -0.5), r(F, scale=0.1), r(F, C, scale=F ** -0.5),
           r(C, scale=0.1))
    proj = (r(C, C, scale=C ** -0.5), r(C, scale=0.1))
    ln = (1.0 + r(C, scale=0.1), r(C, scale=0.1))
    return x, res, dout, mlp, proj, ln


def _saved(tail, x, res, ops, act, drop, dt):
    """The training forward's saved tensors as the plain versions compute
    them: (y_pre, h) of the FFN tail, (y_pre, None) of the projection."""
    cast = lambda t: t.to(dt).float()
    xf = cast(x)
    if tail == "mlp":
        hf = xf @ cast(ops[0]) + cast(ops[1])
        y = cast(act_of(hf, act)) @ cast(ops[2]) + cast(ops[3])
        return (dropout.apply_args(y, drop) + xf).to(dt), hf.to(dt)
    y = xf @ cast(ops[0]) + cast(ops[1])
    return (dropout.apply_args(y, drop) + cast(res)).to(dt), None


def _walk(tail, case, act, p, seed, dt):
    x, res, dout, mlp, proj, ln = case
    t = lambda a: torch.from_numpy(a).to(dt)
    ops = [torch.from_numpy(a) for a in (mlp if tail == "mlp" else proj)]
    drop = dropout.kernel_args(p, seed if p else None)
    ypre, h = _saved(tail, t(x), t(res), ops, act, drop, dt)
    w = (ops[0], ops[2]) if tail == "mlp" else (ops[0],)
    M, C = x.shape
    return kernel_walk(tail, t(x), w, torch.from_numpy(ln[0]), ypre, h,
                       t(dout), act, drop, resln_bwd_plan(tail, C, M, BF16),
                       dt)


@jax.jit
def _mlp_grads(x, w1, b1, w2, b2, gm, bt, ct):
    def f(*a):
        return jnp.sum(ct * pallas_mlp.fused_mlp_resln(
            a[0], *a[1:5], ln2=(a[5], a[6]), eps2=EPS, drop_rate=0.0,
            interpret=True))
    return jax.grad(f, argnums=tuple(range(7)))(x, w1, b1, w2, b2, gm, bt)


@jax.jit
def _proj_grads(x, res, w, b, gm, bt, ct):
    def f(*a):
        return jnp.sum(ct * pallas_mlp.fused_proj_resln(
            *a[:4], ln2=(a[4], a[5]), eps2=EPS, drop_rate=0.0,
            interpret=True))
    return jax.grad(f, argnums=tuple(range(6)))(x, res, w, b, gm, bt)


@pytest.mark.parametrize("C,M", [(128, 150), (256, 70)])
@pytest.mark.parametrize("tail", ("mlp", "proj"))
def test_walk_matches_the_pallas_kernel_in_float32(tail, C, M):
    """Several blocks (a ragged last one), several F chunks and K-blocks,
    groups of partial rows."""
    case = _case(C + M, M, C, 2 * C)
    x, res, dout, mlp, proj, ln = case
    if tail == "mlp":
        want = _mlp_grads(x, *mlp, *ln, dout)
    else:
        want = _proj_grads(x, res, *proj, *ln, dout)
    got = _walk(tail, case, "gelu", 0.0, None, F32)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5, err_msg=f"{tail} output {i}")


@pytest.mark.parametrize("p", (0.0, 0.1))
@pytest.mark.parametrize("tail", ("mlp", "proj"))
def test_walk_matches_the_plain_version_in_bf16(tail, p):
    C, M, seed = 128, 200, 17
    act = "relu" if p else "quick_gelu"
    case = _case(3, M, C, 4 * C)
    got = _walk(tail, case, act, p, seed, BF16)
    x, res, dout, mlp, proj, ln = case
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, *((res,) if tail == "proj" else ()),
                        *(mlp if tail == "mlp" else proj), *ln)]
    leaves[0] = leaves[0].detach().to(BF16).requires_grad_(True)
    if tail == "proj":
        leaves[1] = leaves[1].detach().to(BF16).requires_grad_(True)
    kw = dict(eps=EPS, drop_rate=p, seed=seed if p else None)
    if tail == "mlp":
        out = fused_mlp_resln_plain(*leaves[:5], ln=leaves[5:], act=act,
                                    **kw)
    else:
        out = fused_proj_resln_plain(*leaves[:4], ln=leaves[4:], **kw)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dout).to(BF16))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL * scale, (tail, i, err, scale)
