"""The post-LN projection tail's forward (csrc/proj_resln.cu's tensor-core
body in bf16 at C <= 512; otherwise csrc/gemm.cu's product and the row pass
of csrc/mlp_resln.cu) against its plain version on the card. Every test
needs an NVIDIA GPU and skips without one. On the card (no jax there, so
without the repo's conftest):

    python -m pytest tests/test_torch_proj_resln_tiles.py -q --noconftest

bf16 at C = 128, 256 and 512, M on both sides of a 16-row fragment, of a
block's rows and of the row counts where the plan turns from 16-row to
32-row and 64-row blocks (1, 10, 16, 17, 64, 65, 2080, 2081, 2560, 4160,
4161, 8449 on a card of 132 SMs), the forward-only and
the training edition; C = 2048 in both dtypes and C <= 512 in float32
through the products at the same M; the training edition's y_pre against
the plain version's; the dropout's bits against ops/dropout.py's mask (a
dropped element of y_pre is res itself); the same bits on two runs; the
plans the kernel refuses. Tolerances: chip_smoke.py's TOL for the output
and for y_pre (bf16: a flipped rounding of the pre-LN sum moves the LN's
output by up to ~0.1; y_pre's values up to ~8, one unit 2^-5).
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (
    fused_proj_resln, fused_proj_resln_plain, fused_proj_resln_res,
    proj_resln_plan)
from idvs.morec_tpu_torch.ops.cuda.gemm import gemm, sm_count

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-4, BF16: 1e-1}
ROWS = (1, 10, 16, 17, 64, 65, 2080, 2081, 2560, 4160, 4161, 8449)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(seed, M, C, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    x, res = (2.0 * g(M, C)).to(dtype), g(M, C).to(dtype)
    w, b = g(C, C, scale=C ** -0.5), g(C, scale=0.1)
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    return x, res, w, b, ln


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


def _check(seed, M, C, dtype, rate=0.0):
    """Both editions against the plain version; (res, y_pre)."""
    x, res, w, b, ln = _inputs(seed, M, C, dtype)
    kw = dict(ln=ln, eps=1e-6, drop_rate=rate, seed=seed)
    before = fused_proj_resln.launches
    _close(fused_proj_resln(x, res, w, b, **kw),
           fused_proj_resln_plain(x, res, w, b, **kw), TOL[dtype])
    assert fused_proj_resln.launches == before + 1
    before = fused_proj_resln_res.launches
    out, ypre = fused_proj_resln_res(
        x, res, w.to(dtype), b.to(dtype), *(t.float() for t in ln),
        eps=1e-6, drop=dropout.kernel_args(rate, seed),
        code=lib.dtype_code(x))
    assert fused_proj_resln_res.launches == before + 1
    y = x.float() @ w.to(dtype).float() + b.to(dtype).float()
    want = (dropout.apply(y, rate, seed) + res.float()).to(dtype)
    _close(out, fused_proj_resln_plain(x, res, w, b, **kw), TOL[dtype])
    _close(ypre, want, TOL[dtype])
    return res, ypre


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("C", [128, 256, 512])
def test_tensor_core_body_at_the_block_edges(C, M):
    k = proj_resln_plan(C, BF16, M, sm_count(0))
    assert k["route"] == "block"
    before = gemm.launches
    _check(C + M, M, C, BF16)
    assert gemm.launches == before       # no product outside the kernel


PRODUCTS = ([(2048, dt, M) for dt in (BF16, F32)
             for M in ROWS[:4] + (640, 2560)]
            + [(C, F32, M) for C in (128, 256, 512)
               for M in ROWS[:4] + (2560, 15360)])


@pytest.mark.parametrize("C,dtype,M", PRODUCTS)
def test_the_products_route(C, dtype, M):
    """gemm.cu's product (3xTF32 in float32), then the row pass."""
    assert proj_resln_plan(C, dtype, M)["route"] == "products"
    before = gemm.launches
    _check(C + M, M, C, dtype)
    assert gemm.launches == before + 2   # one product an edition


@pytest.mark.parametrize("C,dtype,M", [(512, BF16, 2560), (512, BF16, 8449),
                                       (2048, BF16, 70), (2048, F32, 70),
                                       (512, F32, 70)])
def test_dropout_bits_are_the_plain_mask(C, dtype, M):
    """At rate 0.1: a dropped element of y_pre is res's own value (y = 0),
    exactly where ops/dropout.py's mask drops."""
    seed = 12345
    res, ypre = _check(seed, M, C, dtype, rate=0.1)
    keep = dropout.keep_mask(seed, (M, C), 0.1, "cuda")
    assert torch.equal(ypre[~keep], res[~keep])
    assert (ypre[keep] != res[keep]).float().mean().item() > 0.9


@pytest.mark.parametrize("C,dtype,M", [(512, BF16, 23040), (512, BF16, 2560),
                                       (2048, BF16, 640), (2048, F32, 640),
                                       (512, F32, 15360)])
def test_two_runs_give_the_same_bits(C, dtype, M):
    x, res, w, b, ln = _inputs(5, M, C, dtype)
    kw = dict(ln=ln, eps=1e-6, drop_rate=0.1, seed=9)
    a = fused_proj_resln(x, res, w, b, **kw)
    b_ = fused_proj_resln(x, res, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b_)


def test_refuses_a_plan_not_built_for_the_width():
    M, C = 640, 512
    x, res, w, b, ln = _inputs(2, M, C, BF16)
    out = torch.empty_like(x)
    ops = [w.to(BF16).contiguous(), b.to(BF16)] + [t.float() for t in ln]
    k = proj_resln_plan(C, BF16, M, sm_count(0))

    def launch(p, dtype=BF16, width=C):
        return lib.library().idvs_proj_resln_fwd(
            x.data_ptr(), res.data_ptr(), *(t.data_ptr() for t in ops),
            out.data_ptr(), None, M, width, 1e-6, 0, 0, 1.0, p["rows"],
            p["threads"], p["smem"], lib.DTYPE_CODES[dtype],
            lib.stream_handle(x))

    assert launch(k) == 0
    torch.cuda.synchronize()
    for bad in (dict(rows=32), dict(threads=k["threads"] // 2),
                dict(smem=k["smem"] + 16),
                proj_resln_plan(256, BF16, M, sm_count(0))):
        assert launch({**k, **bad}) == 1, bad    # cudaErrorInvalidValue
    assert launch(k, dtype=F32) == 1             # float32: the products
    assert launch(k, width=2048) == 1
