"""The post-LN projection tail's launch plans and its composition through
the product kernel and the row pass, on the CPU.

``proj_resln_plan`` (the block plan csrc/proj_resln.cu checks at launch,
or the "products" route) at every (C, M, dtype) the main paths run: the
text train step's BERT and SASRec tails and IDRec's SASRec (C = 512,
bf16, the tensor-core body), the text encode and ``recommend`` (C = 512,
float32), the two-stage text cache's BERT-base (C = 768, float32) and
SASRec under the vision tower (C = 2048, both dtypes), which go through
gemm.cu and the row pass; and the widths it refuses. Then
``proj_resln_products``, that route as the card composes it (gemm.cu's
product with a float output, then the row pass with res as its
residual), here with every piece's plain version (``gemm_plain``,
``post_ln_rows_plain``): held against the Pallas ``fused_proj_resln`` in
interpret mode, its forward-only primal and its training edition's (out,
y_pre), at C = 512 and 2048, M = 1, 10 and 17, dropout 0, float32
tolerance 2e-5 as tests/test_torch_mlp_resln_plans.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.ops.pallas import mlp as pallas_mlp
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import BODIES
from idvs.morec_tpu_torch.ops.cuda.mlp import (KERNEL_WIDTHS,
                                               proj_resln_plan,
                                               proj_resln_products)

BF16, F32 = torch.bfloat16, torch.float32
TOL = 2e-5
SMS = 132   # the H100's streaming multiprocessors
# (what, C, M, dtype) of every projection tail a main path runs
MAIN_PATHS = (("text train step, BERT", 512, 768 * 30, BF16),
              ("text train step, SASRec", 512, 128 * 20, BF16),
              ("IDRec train step, SASRec", 512, 256 * 20, BF16),
              ("text encode, BERT", 512, 512 * 30, F32),
              ("two-stage text cache, BERT-base", 768, 512 * 30, F32),
              ("text recommend at B = 1, SASRec", 512, 20, F32),
              ("text recommend at B = 64, SASRec", 512, 64 * 20, F32),
              ("vision train step, SASRec", 2048, 64 * 10, BF16),
              ("vision recommend at B = 64, SASRec", 2048, 64 * 10, F32),
              ("vision recommend at B = 1, SASRec", 2048, 10, F32))


def _check_block_plan(k, C, M):
    assert k["route"] == "block"
    assert k["smem"] <= lib.MAX_SMEM and k["threads"] <= 1024
    # mma.sync tiles: 16 rows a warp, the (rows, C) accumulators spread
    # over the block's threads, at most 64 floats a thread
    assert k["rows"] == 16 * k["row_warps"] in (16, 32, 64)
    assert k["threads"] == 32 * k["row_warps"] * k["col_warps"]
    assert k["acc_floats"] == k["rows"] * C // k["threads"] <= 64
    assert (C // k["col_warps"]) % 16 == 0       # pairs of n8 tiles
    # the x tile, the ring of W's [32][C] slices, the epilogue's row sums
    assert k["smem"] == (2 * (k["rows"] + k["stages"] * 32) * (C + 8)
                         + 4 * 2 * k["col_warps"] * k["rows"])
    # the widest tiles that give half the SMs a block, else the narrowest
    blocks = -(-M // k["rows"])
    assert blocks >= SMS // 2 or k["rows"] == 16
    if k["rows"] < 64:
        assert -(-M // 64) < SMS // 2


@pytest.mark.parametrize("what,C,M,dtype", MAIN_PATHS)
def test_plan_of_every_main_path(what, C, M, dtype):
    k = proj_resln_plan(C, dtype, M, SMS)
    if C == 2048 or dtype == F32:     # gemm.cu's product, then the rows
        assert k == dict(route="products",
                         kernels=(BODIES[dtype], "post_ln_rows_kernel"))
        return
    _check_block_plan(k, C, M)


@pytest.mark.parametrize("C", KERNEL_WIDTHS)
def test_plans_of_every_width(C):
    for M in (1, 10, 2560, 8448, 8449, 23040):
        assert proj_resln_plan(C, F32, M, SMS)["route"] == "products"
        k = proj_resln_plan(C, BF16, M, SMS)
        if C in (768, 2048):
            assert k["route"] == "products"
        else:
            _check_block_plan(k, C, M)


def test_small_m_takes_narrow_blocks():
    """SASRec's M = 2560 in 32-row blocks (80, not 40 of 64 rows), a text
    recommend's M = 1280 in 16-row ones, IDRec's M = 5120 in 64-row ones;
    a card of fewer SMs takes wider blocks."""
    rows = lambda M, sms=SMS: proj_resln_plan(512, BF16, M, sms)["rows"]
    assert (rows(2560), rows(1280), rows(5120), rows(23040)) == (32, 16, 64,
                                                                 64)
    assert rows(2560, 32) == 64


@pytest.mark.parametrize("C", [64, 96, 640, 1024, 4096])
def test_refuses_widths_without_a_kernel(C):
    for dtype in (BF16, F32):
        with pytest.raises(ValueError, match="takes C in"):
            proj_resln_plan(C, dtype, 640)


def _pallas(x, res, w, b, g, bt, train):
    """The Pallas kernel in interpret mode: the forward-only primal, or the
    training edition's (out, y_pre) through its custom VJP's forward."""
    C = w.shape[0]
    M = x.shape[0]
    BMf, BMb = pallas_mlp._pick_block_proj(C, 4)
    pad = (-M) % max(BMf, BMb)
    args = [jnp.asarray(a) for a in (
        np.pad(x, ((0, pad), (0, 0))), np.pad(res, ((0, pad), (0, 0))), w,
        b.reshape(1, -1), g.reshape(1, -1), bt.reshape(1, -1))]
    fn = pallas_mlp._build_proj(1e-6, 0.0, True, BMf, BMb)
    seed = jnp.zeros((1,), jnp.int32)
    if not train:
        return [np.asarray(fn(seed, *args))[:M]]
    out, (_, _, _, _, ypre) = fn.fwd(seed, *args)
    return [np.asarray(a)[:M] for a in (out, ypre)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("M", [1, 10, 17])
@pytest.mark.parametrize("C", [512, 2048])
def test_the_products_route_matches_pallas(C, M, train):
    """The projection tail as gemm.cu's product and the row pass, float32,
    against the Pallas kernel."""
    rng = np.random.default_rng(C + M)
    f32 = lambda *s, scale=1.0: (scale * rng.standard_normal(s)
                                 ).astype(np.float32)
    x, res = f32(M, C, scale=2.0), f32(M, C)
    w, b = f32(C, C, scale=C ** -0.5), f32(C, scale=0.1)
    g, bt = 1.0 + f32(C, scale=0.1), f32(C, scale=0.1)
    want = _pallas(x, res, w, b, g, bt, train)
    t = [torch.from_numpy(a) for a in (x, res, w, b, g, bt)]
    got = proj_resln_products(*t[:4], (t[4], t[5]), eps=1e-6,
                              drop=dropout.kernel_args(0.0, None),
                              train=train)
    assert (got[1] is not None) == train
    for a, b_ in zip([a for a in got if a is not None], want):
        assert a.dtype == F32 and tuple(a.shape) == b_.shape
        np.testing.assert_allclose(a.numpy(), b_, rtol=TOL, atol=TOL)
