"""The post-LN FFN tail's launch plans and its C = 2048 composition, on the
CPU.

``mlp_resln_plan`` (the block plan csrc/mlp_resln.cu checks at launch) at
every width and dtype the main paths run: the text train step's BERT and
SASRec tails (C = 512, bf16), the text encode and ``recommend`` (C = 512,
float32) and SASRec under the vision tower (C = 2048, both dtypes, h
through device memory), and the widths it refuses. Then
``mlp_resln_products``, the C = 2048 tail as the card composes it (gemm.cu's
two products and the row pass), here with every piece's plain version:
held against the Pallas ``fused_mlp_resln`` in interpret mode, its
forward-only primal and its training edition's (out, y_pre, h), at C =
2048 with F = 1024 and M = 1, 10 and 17, float32 tolerance 2e-5
as tests/test_fused_attention.py:187. And the dropout of the row pass,
``ops/dropout.py`` ``apply_args``, against ``keep_mask``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (F_CHUNK, KERNEL_WIDTHS,
                                               mlp_resln_plan,
                                               mlp_resln_products)

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
    if C == 2048:       # h through device memory between gemm.cu's products
        assert k["route"] == "products"
        return
    assert k["route"] == "block"
    assert k["smem"] <= lib.MAX_SMEM and k["threads"] <= 1024
    if dtype == BF16:
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
    else:
        assert (k["rows"], k["threads"]) == (32, 256)


@pytest.mark.parametrize("C", KERNEL_WIDTHS)
def test_plans_of_every_width(C):
    for dtype in (BF16, F32):
        k = mlp_resln_plan(C, dtype)
        assert k["route"] == ("products" if C == 2048 else "block")
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


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_from_kernel_args_is_the_seeded_mask(p):
    x = torch.randn(37, 2048)
    keep = dropout.keep_mask(1234, x.shape, p)
    want = torch.where(keep, x * dropout.scale(p), torch.zeros_like(x))
    assert torch.equal(dropout.apply_args(x, dropout.kernel_args(p, 1234)),
                       want)
    assert torch.equal(dropout.apply_args(x, dropout.kernel_args(0.0, None)),
                       x)
