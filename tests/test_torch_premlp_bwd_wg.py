"""The pre-LN MLP backward's wg route on the CPU: its plan and its walk.

``premlp_bwd_plan`` at C = 512, 768 and 1024 in bf16 (the widths of
csrc/premlp_bwd_wg.cu's kernel) at Swin-T stage 3 and Swin-B stages 2 and
3 (288 images, F = 4C): the route named, the shared memory within a
block's 227 KB, the two accumulators within the consumers' setmaxnreg cap
(paid for by the producer's registers), F and C in whole tiles and
K-blocks, the partial rows' groups covering the row tiles, no
act_cast_kernel and no column sum of dh among the kernels; float32 keeps
the products route. Then a plain-torch model of the route in its
arithmetic order (the row pass; each 128 x 128 tile's h and dg as
K-blocks of 64 added in float, the casts where the kernel casts, db1 from
the cast dh as 16-row sums in order, db2 as each warpgroup's 64 rows in
order, rows past M left out, the row tiles' partial rows added in groups
of ``per``, then gemm.cu's three products and the LayerNorm's backward),
held against ``jax.grad`` of the JAX ``fused_mlp_res`` (scaled and unit)
and ``fused_mlp`` (LN, no LN, save_h) run in interpret mode as
tests/test_pallas_mlp.py runs them, float32 at that file's tolerances
(rtol 2e-4, atol 1e-5), and against autograd of the port's
``fused_mlp_res_plain`` / ``fused_mlp_plain`` in bf16 at chip_smoke.py's
GRAD_TOL; and the kernel's plain version ``premlp_bwd_gdh_plain`` against
the model's (g, dh, db1, db2). C = 768, M of two whole row tiles and a
ragged one, F of two tiles.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import BODIES
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_WG_WIDTHS,
                                               fused_mlp_plain,
                                               fused_mlp_res_plain,
                                               premlp_bwd_gdh,
                                               premlp_bwd_gdh_plain,
                                               premlp_bwd_plan)
from test_torch_premlp_bwd_plans import (EDITIONS, EPS, GRAD_TOL, _act, _case,
                                         _dact, _fragment_sums, _in_order,
                                         kernel_walk_xn)

BF16, F32 = torch.bfloat16, torch.float32
IMAGES = 288
# (C, side of the token map) of Swin-T stage 3 and Swin-B stages 2 and 3
STAGES = ((768, 7), (512, 14), (1024, 7))
REGS = 65536              # 32-bit registers of an SM
C_TEST, M_TEST, F_TEST = 768, 2 * 128 + 37, 256


@pytest.mark.parametrize("C,side", STAGES)
def test_plan_at_the_wide_stages(C, side):
    M, F = IMAGES * side * side, 4 * C
    k = premlp_bwd_plan(C, M, BF16)
    assert k["route"] == "wg"
    assert k["kernels"][0] == "premlp_bwd_wg_kernel"
    assert BODIES[BF16] in k["kernels"]
    assert not {"act_cast_kernel", "colsum_kernel"} & set(k["kernels"])
    rows, cols, depth, S = k["rows"], k["f_tile"], k["depth"], k["stages"]
    # two consumer warpgroups of one m64 tile each, and the producer's
    assert rows == 2 * 64 and k["threads"] == 3 * 128
    assert F % cols == 0 and C % depth == 0 and depth * 2 == 128
    # the ring's stages (xn, dy, W1, W2 K-blocks), db1's [8][cols] and
    # db2's [2][C] float sums, 2 S mbarriers, the base's alignment
    stage = 2 * (2 * rows * depth + 2 * depth * cols)
    assert k["smem"] == S * stage + 4 * (8 * cols + 2 * C) + 16 * S + 1024
    assert k["smem"] <= lib.MAX_SMEM
    # g and dh's bf16 tiles over the drained ring
    assert 2 * 2 * rows * cols <= S * stage
    # h and dg: 64 x cols floats each a consumer warpgroup's 128 threads,
    # with room for addresses and the epilogue, within the consumers' cap;
    # the producer's registers pay for the cap
    assert k["acc_floats"] == 2 * 64 * cols // 128
    assert k["acc_floats"] + 64 <= k["consumer_regs"] <= 255
    assert 128 * (k["producer_regs"] + 2 * k["consumer_regs"]) <= REGS
    assert k["consumer_regs"] % 8 == 0 and k["producer_regs"] % 8 == 0
    assert k["blocks"] == -(-M // rows)
    assert k["per"] == math.isqrt(k["blocks"] - 1) + 1
    assert k["per"] * k["groups"] >= k["blocks"] > k["per"] * (
        k["groups"] - 1)
    assert premlp_bwd_plan(C, M, F32)["route"] == "products"


@pytest.mark.parametrize("C", PRE_WG_WIDTHS)
def test_every_wide_width_takes_the_wg_route(C):
    for M in (1, 127, 128, 129, 1000):
        k = premlp_bwd_plan(C, M, BF16)
        assert k["route"] == "wg" and k["blocks"] == -(-M // 128)


def _seq(rows):
    """Column sums of (n, E) rows added one row after another."""
    return _in_order(rows) if rows.shape[0] else rows.new_zeros(rows.shape[1])


def gdh_walk(xn, dy, w1, b1, w2, h, act, plan, dt):
    """premlp_bwd_wg_kernel and the fixed-order sums of its partial rows in
    plain torch, in the kernel's arithmetic order; cast() rounds to the
    compute dtype dt (none in float32). xn and dy are float tensors of
    values in dt. Returns (g, dh, db1, db2) as floats."""
    M, C = xn.shape
    F = w1.shape[1]
    rows, cols, depth = plan["rows"], plan["f_tile"], plan["depth"]
    cast = lambda t: t.to(dt).float()
    w1c, b1c, w2c = cast(w1), cast(b1), cast(w2)
    g_all, dh_all = torch.empty(M, F), torch.empty(M, F)
    part = torch.zeros(plan["blocks"], C + F)
    for b in range(plan["blocks"]):
        r0, r1 = b * rows, min(M, (b + 1) * rows)
        for f0 in range(0, F, cols):
            fs = slice(f0, f0 + cols)
            hacc = torch.zeros(r1 - r0, cols)
            dacc = torch.zeros(r1 - r0, cols)
            for k0 in range(0, C, depth):
                ks = slice(k0, k0 + depth)
                hacc = hacc + xn[r0:r1, ks] @ w1c[ks, fs]
                dacc = dacc + dy[r0:r1, ks] @ w2c[fs, ks].t()
            hf = hacc + b1c[fs] if h is None else h[r0:r1, fs].float()
            g_all[r0:r1, fs] = cast(_act(hf, act))
            dh = cast(dacc * _dact(hf, act))
            dh_all[r0:r1, fs] = dh
            # db1: 16-row fragment sums, then the 8 warps' in order
            part[b, C + f0:C + f0 + cols] = _fragment_sums(dh, rows // 16)
        # db2: each warpgroup's 64 rows one after another, then the two
        part[b, :C] = (_seq(dy[r0:min(r1, r0 + 64)])
                       + _seq(dy[r0 + 64:r1]))
    per = plan["per"]
    sums = _in_order(torch.stack([_in_order(part[i:i + per])
                                  for i in range(0, plan["blocks"], per)]))
    db2, db1 = sums.split((C, F))
    return g_all, dh_all, db1, db2


def wg_walk(x, dout, s, w1, b1, w2, ln, h, act, res, plan, dt):
    """The wg route in plain torch (premlp_bwd_wg in ops/cuda/mlp.py): the
    row pass, ``gdh_walk``, gemm.cu's three products and the LayerNorm's
    backward. Returns (dx, dw1, db1, dw2, db2, dgamma, dbeta), the last two
    None without a LayerNorm."""
    M, C = x.shape
    cast = lambda t: t.to(dt).float()
    xf = x.float()
    if ln is not None:
        # premlp_bwd.cu's ln_rows_kernel: the fast variance clamped at 0
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        rstd = 1.0 / torch.sqrt(var + EPS)
        xhat = (xf - mu) * rstd
        xn = cast(xhat * ln[0].float() + ln[1].float())
    else:
        xn = xf
    dy = dout.float() if s is None else cast(dout.float() * s[:, None])
    g, dh, db1, db2 = gdh_walk(xn, dy, w1, b1, w2, h, act, plan, dt)
    dw2 = cast(g.t() @ dy)
    dw1 = cast(xn.t() @ dh)
    dxn = dh @ cast(w1).t()
    dgamma = dbeta = None
    if ln is not None:
        dxhat = dxn * ln[0].float()
        m1 = dxhat.sum(-1, keepdim=True) / C
        m2 = (dxhat * xhat).sum(-1, keepdim=True) / C
        v = rstd * (dxhat - m1 - xhat * m2)
        dgamma, dbeta = (dxn * xhat).sum(0), dxn.sum(0)
    else:
        v = dxn
    if res:
        v = v + dout.float()
    return (cast(v), dw1, cast(db1), dw2, cast(db2), dgamma, dbeta)


def _walk(edition, x, dout, mlp, ln, s, act, dt):
    M, C = x.shape
    t = lambda a: torch.from_numpy(a).to(dt)
    with_ln = edition != "no LN"
    lnt = tuple(torch.from_numpy(a) for a in ln) if with_ln else None
    h = None
    if edition == "save_h":
        xn = kernel_walk_xn(t(x), lnt, dt)
        h = (xn @ t(mlp[0]).float() + t(mlp[1]).float()).to(dt)
    return wg_walk(t(x), t(dout), torch.from_numpy(s)
                   if edition == "scaled" else None, *map(t, mlp[:3]), lnt,
                   h, act, edition in ("scaled", "unit"),
                   premlp_bwd_plan(C, M, BF16), dt)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(edition, act):
    """jax.jit of jax.grad of <out, dout> through the Pallas kernels in
    interpret mode: (dx, dw1, db1, dw2, db2[, dgamma, dbeta])."""
    with_ln = edition != "no LN"
    n = 7 if with_ln else 5

    def f(ct, s, *a):
        lnp = (a[5], a[6]) if with_ln else None
        if edition in ("scaled", "unit"):
            y = pallas_mlp.fused_mlp_res(
                a[0], s if edition == "scaled" else None, *a[1:5], ln=lnp,
                eps=EPS, act=act, interpret=True)
        else:
            y = pallas_mlp.fused_mlp(a[0], *a[1:5], ln=lnp, eps=EPS, act=act,
                                     save_h=edition == "save_h",
                                     interpret=True)
        return jnp.sum(y * ct)

    return jax.jit(jax.grad(f, argnums=tuple(range(2, 2 + n))))


def _jax_grads(edition, x, dout, mlp, ln, s, act):
    with_ln = edition != "no LN"
    args = [jnp.asarray(a) for a in (x, *mlp, *(ln if with_ln else ()))]
    grads = _jax_grad_fn(edition, act)(jnp.asarray(dout), jnp.asarray(s),
                                       *args)
    grads = [np.asarray(g) for g in grads]
    return grads + [None] * (7 - len(grads))


# the float32 test's cotangent scale: a unit-variance dout at C = 768 over
# 293 rows makes weight gradients of 60-125, whose float32 sums in two
# orders (the model's and the Pallas kernel's) each stand about 7e-5 from
# the float64 sum, above atol 1e-5 where an entry lies near 0; at 0.05 the
# gradients are O(1-6) and that rounding below the tolerance
DOUT_SCALE = 0.05


@pytest.mark.parametrize("edition", EDITIONS)
def test_walk_matches_the_pallas_kernel_in_float32(edition):
    """Two whole row tiles and a ragged one, two F tiles, 12 K-blocks."""
    x, dout, mlp, ln, s = _case(17, M_TEST, C_TEST, F_TEST)
    dout = dout * np.float32(DOUT_SCALE)
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
    x, dout, mlp, ln, s = _case(23, M_TEST, C_TEST, F_TEST)
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


@pytest.mark.parametrize("act", ("gelu", "relu", "quick_gelu"))
def test_the_kernels_plain_version_matches_the_walk(act):
    """premlp_bwd_gdh (on the CPU its plain version) against gdh_walk in
    bf16: g and dh within one bf16 rounding of the largest value, the
    column sums within float reassociation."""
    x, dout, mlp, _, _ = _case(29, M_TEST, C_TEST, F_TEST)
    xn, dy = (torch.from_numpy(a).to(BF16) for a in (x, dout))
    w1, b1, w2 = (torch.from_numpy(a).to(BF16) for a in mlp[:3])
    got = premlp_bwd_gdh(xn, dy, w1, b1, w2, None, act)
    assert isinstance(got, tuple) and len(got) == 4
    assert got[0].dtype == got[1].dtype == BF16
    want = gdh_walk(xn.float(), dy.float(), w1, b1, w2, None, act,
                    premlp_bwd_plan(C_TEST, M_TEST, BF16), BF16)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(1.0, b.abs().max().item())
        assert (a.float() - b).abs().max().item() <= GRAD_TOL * scale
