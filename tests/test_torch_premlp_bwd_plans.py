"""The pre-LN MLP backward's plan and the fused kernel's walk, on the CPU.

``premlp_bwd_plan`` (the route, and on the fused route the block plan
csrc/premlp_bwd.cu checks at launch) at every Swin-T stage the vision
train step runs (288 images, F = 4C) and at every width of
``PRE_F_CHUNK``, in both dtypes: the route named, the shared memory within
a block's 227 KB (two blocks' within the SM's 228 KB where the plan asks
for two an SM), the accumulators within the register cap, every F the
forward takes walked in whole chunks, the partial rows' groups covering
the blocks. Then a plain-torch model of premlp_bwd_mma_kernel's walk in
its arithmetic order (row tiles of the plan's rows, F chunks of its
f_chunk, the cast points of the TPU kernel and its GELU's erf, dxn summed
over the chunks in float, each block's partial row of (db2, dgamma, dbeta, db1) added in
groups of ``per`` in block order, then the groups in order, and the two
weight-gradient products), held against ``jax.grad`` of the JAX
``fused_mlp_res`` (scaled and unit) and ``fused_mlp`` (LN, no LN, save_h)
run in interpret mode as tests/test_pallas_mlp.py runs them, float32 at
that file's tolerances (rtol 2e-4, atol 1e-5), and against autograd of
the port's ``fused_mlp_res_plain`` / ``fused_mlp_plain`` in bf16 at
chip_smoke.py's GRAD_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import BODIES, act_of
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_F_CHUNK, _PRE_BWD_MMA,
                                               fused_mlp_plain,
                                               fused_mlp_res_plain,
                                               premlp_bwd_plan)

BF16, F32 = torch.bfloat16, torch.float32
EPS = 1e-5
GRAD_TOL = 3e-2
IMAGES = 288
# Swin-T's stages: (C, side of the token map)
SWIN_T = ((96, 56), (192, 28), (384, 14), (768, 7))
SM_SMEM = 233472          # shared memory of one SM, 1 KB of it a block's
EDITIONS = ("scaled", "unit", "LN", "no LN", "save_h")


def _check_fused(k, C, M, F):
    assert k["route"] == "fused"
    assert k["kernels"][0] == "premlp_bwd_mma_kernel"
    assert BODIES[BF16] in k["kernels"]
    assert not {"colsum_kernel", "act_cast_kernel"} & set(k["kernels"])
    RW, WN = k["row_warps"], k["col_warps"]
    assert k["rows"] == 16 * RW and k["threads"] == 32 * RW * WN <= 1024
    assert k["f_chunk"] == 32 * WN and F % k["f_chunk"] == 0
    assert (C // WN) % 16 == 0          # pairs of n8 tiles of dxn a warp
    # x and dy tiles, W1's [C][FC + 8] and W2's [FC][C + 8] slots, the dh
    # tile, the warps' [16][40] staging tiles of g (and dh with one column
    # warp), the rows' (mu, rstd) and db1's row-warp sums
    rows, FC = k["rows"], k["f_chunk"]
    stage = k["threads"] // 32 * 16 * 40 * (2 if WN == 1 else 1)
    tiles = 2 * (2 * rows * (C + 8) + C * (FC + 8) + FC * (C + 8)
                 + (rows * (FC + 8) if WN > 1 else 0) + stage)
    assert k["smem"] == tiles + 8 * rows + 4 * RW * FC <= lib.MAX_SMEM
    assert k["blocks_per_sm"] * (k["smem"] + 1024) <= SM_SMEM
    # the epilogue's reductions alias the weight slots
    assert 4 * 2 * RW * C <= 2 * C * (FC + 8)
    assert 4 * 2 * WN * rows <= 2 * FC * (C + 8)
    # dxn, h and dg a thread, with room for the fragments and addresses
    assert k["acc_floats"] == rows * C // k["threads"] + 32
    assert k["reg_cap"] == min(255, 65536 // (k["threads"]
                                              * k["blocks_per_sm"]))
    assert k["acc_floats"] + 32 <= k["reg_cap"]
    assert k["blocks"] == -(-M // rows)
    assert k["per"] * k["groups"] >= k["blocks"] > k["per"] * (
        k["groups"] - 1)


@pytest.mark.parametrize("stage", range(4))
def test_plan_of_every_swin_t_stage(stage):
    C, side = SWIN_T[stage]
    M, F = IMAGES * side * side, 4 * C
    k = premlp_bwd_plan(C, M, BF16)
    if C in _PRE_BWD_MMA:
        _check_fused(k, C, M, F)
    else:
        # stage 3: the row kernel's C-wide tiles exceed a block's shared
        # memory; premlp_bwd_wg.cu's tiles of rows x F
        # (tests/test_torch_premlp_bwd_wg.py checks the plan)
        assert k["route"] == "wg"
        assert k["kernels"][0] == "premlp_bwd_wg_kernel"
        assert F % k["f_tile"] == 0
    assert premlp_bwd_plan(C, M, F32)["route"] == "products"


@pytest.mark.parametrize("C", sorted(PRE_F_CHUNK))
def test_plan_of_every_width(C):
    for dtype in (BF16, F32):
        k = premlp_bwd_plan(C, 1000, dtype)
        assert k["route"] in ("fused", "wg", "products")
        if dtype == F32:
            assert k["route"] == "products"
            assert k["kernels"][0] == BODIES[dtype]
            continue
        if C not in _PRE_BWD_MMA:
            # C = 512, 768, 1024: every F the forward takes in whole tiles
            assert k["route"] == "wg"
            assert k["kernels"][0] == "premlp_bwd_wg_kernel"
            assert PRE_F_CHUNK[C] % k["f_tile"] == 0
            continue
        # every F the forward takes (a multiple of PRE_F_CHUNK[C])
        _check_fused(k, C, 1000, PRE_F_CHUNK[C])


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


def _fragment_sums(v, RW):
    """A block's column sums as the kernel takes them: 16-row fragment
    sums, then the row warps' in order (rows past M are zeros)."""
    v = torch.cat([v, v.new_zeros(16 * RW - v.shape[0], v.shape[1])])
    return _in_order(v.view(RW, 16, -1).sum(1))


def kernel_walk(x, dout, s, w1, b1, w2, ln, h, act, res, plan, dt):
    """premlp_bwd_mma_kernel and the fused route's sums and products in
    plain torch, in the kernel's arithmetic order; cast() is the rounding
    to the compute dtype dt (none in float32). Returns (dx, dw1, db1, dw2,
    db2, dgamma, dbeta), the last two None without a LayerNorm."""
    M, C = x.shape
    F = w1.shape[1]
    rows, FC, RW = plan["rows"], plan["f_chunk"], plan["row_warps"]
    cast = lambda t: t.to(dt).float()
    w1c, b1c, w2c = cast(w1), cast(b1), cast(w2)
    part = torch.zeros(plan["blocks"], 3 * C + F)
    dx = torch.empty(M, C)
    xn_all, dy_all = torch.empty(M, C), torch.empty(M, C)
    g_all, dh_all = torch.empty(M, F), torch.empty(M, F)
    for b in range(plan["blocks"]):
        r0, r1 = b * rows, min(M, (b + 1) * rows)
        xb = x[r0:r1].float()
        if ln is not None:
            # premlp.cu's forward LayerNorm: the fast variance clamped at 0
            mu = xb.mean(-1, keepdim=True)
            var = ((xb * xb).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
            rstd = 1.0 / torch.sqrt(var + EPS)
            xhat = (xb - mu) * rstd
            xn = cast(xhat * ln[0].float() + ln[1].float())
        else:
            xn = xb
        dy = dout[r0:r1].float()
        if s is not None:
            dy = cast(dy * s[r0:r1, None].float())
        dxn = torch.zeros(r1 - r0, C)
        for f0 in range(0, F, FC):
            dg = dy @ w2c[f0:f0 + FC].t()
            if h is None:
                hc = xn @ w1c[:, f0:f0 + FC] + b1c[f0:f0 + FC]
            else:
                hc = h[r0:r1, f0:f0 + FC].float()
            g = cast(_act(hc, act))
            dh = cast(dg * _dact(hc, act))
            part[b, 3 * C + f0:3 * C + f0 + FC] = _fragment_sums(dh, RW)
            dxn = dxn + dh @ w1c[:, f0:f0 + FC].t()
            g_all[r0:r1, f0:f0 + FC], dh_all[r0:r1, f0:f0 + FC] = g, dh
        if ln is not None:
            dxhat = dxn * ln[0].float()
            m1 = dxhat.sum(-1, keepdim=True) / C
            m2 = (dxhat * xhat).sum(-1, keepdim=True) / C
            v = rstd * (dxhat - m1 - xhat * m2)
            part[b, C:2 * C] = _fragment_sums(dxn * xhat, RW)
            part[b, 2 * C:3 * C] = _fragment_sums(dxn, RW)
        else:
            v = dxn
        if res:
            v = v + dout[r0:r1].float()
        dx[r0:r1] = cast(v)
        part[b, :C] = _in_order(dy)
        xn_all[r0:r1], dy_all[r0:r1] = xn, dy
    per = plan["per"]
    sums = _in_order(torch.stack([_in_order(part[i:i + per])
                                  for i in range(0, plan["blocks"], per)]))
    db2, dgamma, dbeta, db1 = sums.split((C, C, C, F))
    dw2 = cast(g_all.t() @ dy_all)
    dw1 = cast(xn_all.t() @ dh_all)
    if ln is None:
        dgamma = dbeta = None
    return (cast(dx), dw1, cast(db1), dw2, cast(db2), dgamma, dbeta)


def _case(seed, M, C, F):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    x, dout = 2.0 * r(M, C), r(M, C)
    mlp = (r(C, F, scale=C ** -0.5), r(F, scale=0.1), r(F, C, scale=F ** -0.5),
           r(C, scale=0.1))
    ln = (1.0 + r(C, scale=0.1), r(C, scale=0.1))
    s = ((rng.uniform(size=M) < 0.8) / 0.8).astype(np.float32)
    return x, dout, mlp, ln, s


def _plan(C, M):
    """The bf16 fused plan, whose walk the model follows in any dtype."""
    return premlp_bwd_plan(C, M, BF16)


def _walk(edition, x, dout, mlp, ln, s, act, dt):
    M, C = x.shape
    t = lambda a: torch.from_numpy(a).to(dt)
    with_ln = edition != "no LN"
    lnt = tuple(torch.from_numpy(a) for a in ln) if with_ln else None
    h = None
    if edition == "save_h":
        xn = kernel_walk_xn(t(x), lnt, dt)
        h = (xn @ t(mlp[0]).float() + t(mlp[1]).float()).to(dt)
    return kernel_walk(t(x), t(dout), torch.from_numpy(s)
                       if edition == "scaled" else None, *map(t, mlp[:3]),
                       lnt, h, act, edition in ("scaled", "unit"),
                       _plan(C, M), dt)


def kernel_walk_xn(x, ln, dt):
    """cast(LN(x)) as the kernel computes it (the save_h edition's h)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
    return ((xf - mu) / torch.sqrt(var + EPS) * ln[0] + ln[1]).to(dt).float()


def _jax_grads(edition, x, dout, mlp, ln, s, act):
    """jax.grad of <out, dout> through the Pallas kernels in interpret
    mode: (dx, dw1, db1, dw2, db2, dgamma, dbeta)."""
    with_ln = edition != "no LN"
    args = [jnp.asarray(a) for a in (x, *mlp, *(ln if with_ln else ()))]
    ct = jnp.asarray(dout)

    def f(*a):
        lnp = (a[5], a[6]) if with_ln else None
        if edition in ("scaled", "unit"):
            y = pallas_mlp.fused_mlp_res(
                a[0], jnp.asarray(s) if edition == "scaled" else None,
                *a[1:5], ln=lnp, eps=EPS, act=act, interpret=True)
        else:
            y = pallas_mlp.fused_mlp(a[0], *a[1:5], ln=lnp, eps=EPS, act=act,
                                     save_h=edition == "save_h",
                                     interpret=True)
        return jnp.sum(y * ct)

    grads = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    grads = [np.asarray(g) for g in grads]
    return grads + [None] * (7 - len(grads))


@pytest.mark.parametrize("C,M", [(32, 300), (96, 140)])
@pytest.mark.parametrize("edition", EDITIONS)
def test_walk_matches_the_pallas_kernel_in_float32(edition, C, M):
    """Several blocks (a ragged last one), several F chunks and groups."""
    x, dout, mlp, ln, s = _case(C + M, M, C, 4 * C)
    act = "relu" if edition == "unit" else "gelu"
    got = _walk(edition, x, dout, mlp, ln, s, act, F32)
    want = _jax_grads(edition, x, dout, mlp, ln, s, act)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, rtol=2e-4,
                                   atol=1e-5, err_msg=f"output {i}")


@pytest.mark.parametrize("edition", EDITIONS)
def test_walk_matches_the_plain_version_in_bf16(edition):
    C, M = 64, 300
    x, dout, mlp, ln, s = _case(7, M, C, 4 * C)
    act = "quick_gelu" if edition == "LN" else "gelu"
    got = _walk(edition, x, dout, mlp, ln, s, act, BF16)
    with_ln = edition != "no LN"
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, *mlp, *(ln if with_ln else ()))]
    leaves[0] = leaves[0].detach().to(BF16).requires_grad_(True)
    lnl = tuple(leaves[5:]) or None
    if edition in ("scaled", "unit"):
        out = fused_mlp_res_plain(
            leaves[0], torch.from_numpy(s) if edition == "scaled" else None,
            *leaves[1:5], ln=lnl, eps=EPS, act=act)
    else:
        out = fused_mlp_plain(leaves[0], *leaves[1:5], ln=lnl, eps=EPS,
                              act=act, save_h=edition == "save_h")
    want = torch.autograd.grad(out, leaves,
                               torch.from_numpy(dout).to(BF16))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a is not None and a.shape == b.shape, i
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL * scale, (i, err, scale)
