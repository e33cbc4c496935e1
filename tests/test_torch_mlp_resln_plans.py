"""The post-LN FFN tail's launch plans and its products route, on the CPU.

``mlp_resln_plan`` (the block plan csrc/mlp_resln.cu checks at launch, or
the products route) at every width and dtype the main paths run: the text
train step's BERT and SASRec tails (C = 512, bf16, block plans), the text
encode and ``recommend`` (C = 512, float32) and SASRec under the vision
tower (C = 2048, both dtypes), both through the products route (h through
device memory), and the widths it refuses. Then ``mlp_resln_products``,
the tail as the card composes it there (gemm.cu's two products and the row
pass), here with every piece's plain version: held against the Pallas
``fused_mlp_resln`` in interpret mode, its forward-only primal and its
training edition's (out, y_pre, h), at C = 2048 with F = 1024 and M = 1,
10 and 17, and at the float32 widths C = 512 (F = 2048, the text tails')
and 128 (F = 512) with GELU and ReLU, float32 tolerance 2e-5 as
tests/test_fused_attention.py:187. And the dropout of the row pass,
``ops/dropout.py`` ``apply_args``, against ``keep_mask``. Last, the rule
by which a check holds a float32 ReLU tail's gradient to its plain version
(``relu_kink``, ``fused_mlp_resln_plain``'s ``kink_from``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import BODIES
from idvs.morec_tpu_torch.ops.cuda.mlp import (F_CHUNK, KERNEL_WIDTHS,
                                               fused_mlp_resln_plain,
                                               mlp_resln_plan,
                                               mlp_resln_products, relu_kink)

BF16, F32 = torch.bfloat16, torch.float32
TOL = 2e-5
# (what, C, F, dtype) of every tail a main path runs
MAIN_PATHS = (("text train step, BERT and SASRec", 512, 2048, BF16),
              ("text encode and recommend", 512, 2048, F32),
              ("vision train step, SASRec", 2048, 8192, BF16),
              ("vision recommend, SASRec", 2048, 8192, F32))


@pytest.mark.parametrize("what,C,F,dtype", MAIN_PATHS)
def test_plan_of_every_main_path(what, C, F, dtype):
    k = mlp_resln_plan(C, dtype)
    assert F % k["f_chunk"] == 0 and F_CHUNK[C] % k["f_chunk"] == 0
    if C == 2048 or dtype == F32:
        # h through device memory between gemm.cu's products (float32 as
        # 3xTF32), then the row pass
        assert k["route"] == "products"
        assert k["kernels"] == (BODIES[dtype], "post_ln_rows_kernel")
        return
    assert k["route"] == "block"
    assert k["kernels"] == ("mlp_resln_mma_kernel",)
    assert k["smem"] <= lib.MAX_SMEM and k["threads"] <= 1024
    # mma.sync tiles: 16 rows a warp, the (rows, C) accumulators spread
    # over the block's threads, at most 96 floats a thread
    assert k["rows"] == 16 * k["row_warps"]
    assert k["threads"] == 32 * k["row_warps"] * k["col_warps"]
    assert k["acc_floats"] == k["rows"] * C // k["threads"] <= 96
    # the chain's bf16 tiles and ring, and the epilogue's row sums
    chain = 2 * (k["rows"] * (C + 8) + k["stages"] * 32 * (
        max(k["f_chunk"], C) + 8) + (k["rows"] * (k["f_chunk"] + 8)
                                     if k["col_warps"] > 1 else 0))
    assert k["smem"] == chain + 4 * 2 * k["col_warps"] * k["rows"]


@pytest.mark.parametrize("C", KERNEL_WIDTHS)
def test_plans_of_every_width(C):
    for dtype in (BF16, F32):
        k = mlp_resln_plan(C, dtype)
        assert k["route"] == ("products" if C == 2048 or dtype == F32
                              else "block")
        assert F_CHUNK[C] % k["f_chunk"] == 0


@pytest.mark.parametrize("C", [64, 96, 768, 1024, 4096])
def test_refuses_widths_without_a_kernel(C):
    with pytest.raises(ValueError, match="takes C in"):
        mlp_resln_plan(C, BF16)


def _pallas(x, w1, b1, w2, b2, g, bt, act, train):
    """The Pallas kernel in interpret mode: the forward-only primal, or the
    training edition's (out, y_pre, h) through its custom VJP's forward."""
    C, F = w1.shape
    M = x.shape[0]
    BMf, BMb = pallas_mlp._pick_block_post(C, F, 4)
    pad = (-M) % max(BMf, BMb)
    xp = np.pad(x, ((0, pad), (0, 0)))
    args = [jnp.asarray(a) for a in (xp, w1, b1.reshape(1, -1), w2,
                                     b2.reshape(1, -1), g.reshape(1, -1),
                                     bt.reshape(1, -1))]
    fn = pallas_mlp._build_post(1e-6, 0.0, True, BMf, BMb, act)
    seed = jnp.zeros((1,), jnp.int32)
    if not train:
        return [np.asarray(fn(seed, *args))[:M]]
    out, (_, _, _, _, _, ypre, h) = fn.fwd(seed, *args)
    return [np.asarray(a)[:M] for a in (out, ypre, h)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("M,act", [(1, "relu"), (10, "relu"), (17, "gelu")])
def test_the_2048_composition_matches_pallas(M, act, train):
    """SASRec's tail at D = 2048 as the card composes it, float32, at F =
    1024 (the Pallas kernel's weights fit its VMEM up to there)."""
    F = 1024
    rng = np.random.default_rng(M + F)
    C = 2048
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)
                                 ).astype(np.float32)
    x = f32(M, C, scale=2.0)
    w1, b1 = f32(C, F, scale=C ** -0.5), f32(F, scale=0.1)
    w2, b2 = f32(F, C, scale=F ** -0.5), f32(C, scale=0.1)
    g, bt = 1.0 + f32(C, scale=0.1), f32(C, scale=0.1)
    want = _pallas(x, w1, b1, w2, b2, g, bt, act, train)
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g, bt)]
    got = mlp_resln_products(*t[:5], (t[5], t[6]), eps=1e-6, act=act,
                             drop=dropout.kernel_args(0.0, None), train=train)
    assert len([a for a in got if a is not None]) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == F32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("M,C,F", [(10, 512, 2048), (33, 512, 2048),
                                   (17, 128, 512)])
def test_the_float32_products_route_matches_pallas(M, C, F, act, train):
    """The float32 tail at C <= 512 as the card composes it (text encode's
    BERT tail, GELU, and ``recommend``'s SASRec tail, ReLU, at C = 512),
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(M + C + F)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)
                                 ).astype(np.float32)
    x = f32(M, C, scale=2.0)
    w1, b1 = f32(C, F, scale=C ** -0.5), f32(F, scale=0.1)
    w2, b2 = f32(F, C, scale=F ** -0.5), f32(C, scale=0.1)
    g, bt = 1.0 + f32(C, scale=0.1), f32(C, scale=0.1)
    want = _pallas(x, w1, b1, w2, b2, g, bt, act, train)
    assert mlp_resln_plan(C, F32)["route"] == "products"
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g, bt)]
    got = mlp_resln_products(*t[:5], (t[5], t[6]), eps=1e-6, act=act,
                             drop=dropout.kernel_args(0.0, None), train=train)
    assert len([a for a in got if a is not None]) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == F32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_from_kernel_args_is_the_seeded_mask(p):
    x = torch.randn(37, 2048)
    keep = dropout.keep_mask(1234, x.shape, p)
    want = torch.where(keep, x * dropout.scale(p), torch.zeros_like(x))
    assert torch.equal(dropout.apply_args(x, dropout.kernel_args(p, 1234)),
                       want)
    assert torch.equal(dropout.apply_args(x, dropout.kernel_args(0.0, None)),
                       x)


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_kink_from_takes_the_other_branch_only_at_the_kink(drop):
    """fused_mlp_resln_plain with kink_from takes kink_from's sign for
    ReLU's branch exactly where relu_kink marks h (within float32's
    rounding of 0), its own elsewhere: given its own h it is the plain
    version to the bit, and given an h of the other sign everywhere only
    the db1 entries of marked units move by a row's step (the others
    within rounding)."""
    rng = np.random.default_rng(7)
    M, C, F = 9, 64, 32
    t = lambda *s, scale=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * scale)
    x, w1, w2 = t(M, C), t(C, F, scale=C ** -0.5), t(F, C, scale=F ** -0.5)
    b2, g, bt = t(C, scale=0.1), 1.0 + t(C, scale=0.1), t(C, scale=0.1)
    # units 0-3 of row 0 a few roundings from 0, units 4-7 0.01 away
    b1 = t(F, scale=0.1)
    s = (x[0].double() @ w1.double()).float()
    b1[:4] = -s[:4]
    b1[4:8] = -s[4:8] + 0.01
    h = x @ w1 + b1
    at_kink = relu_kink(h, x, w1, b1)
    assert at_kink[0, :4].all() and not at_kink[0, 4:8].any()
    assert at_kink.sum() == 4
    kw = dict(ln=(g, bt), eps=1e-6, act="relu", drop_rate=drop, seed=5)
    dout = t(M, C)

    def grads(**k):
        leaves = [v.clone().requires_grad_(True) for v in (x, w1, b1)]
        out = fused_mlp_resln_plain(*leaves, w2, b2, **kw, **k)
        return out, torch.autograd.grad(out, leaves, dout)

    out, want = grads()
    same, same_grads = grads(kink_from=h)
    assert torch.equal(out, same)
    assert all(torch.equal(a, b) for a, b in zip(want, same_grads))
    _, flipped = grads(kink_from=torch.where(h > 0, -1.0, 1.0))
    step = (flipped[2] - want[2]).abs()
    assert (step[:4] > 1e-3).all() and (step[4:] <= 1e-5).all()
