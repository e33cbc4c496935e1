"""The post-LN FFN tail's forward (csrc/mlp_resln.cu in bf16 at C <= 512,
and at C = 2048 and in float32 the products of csrc/gemm.cu around its
row pass) against its plain version on the card. Every test needs an NVIDIA GPU and skips without one. On the
card (no jax there, so without the repo's conftest):

    python -m pytest tests/test_torch_mlp_resln_tiles.py -q --noconftest

bf16 (the tensor-core body) at C = 128, 256 and 512, M on both sides of a
block's rows and of a 16-row fragment (1, 10, 17, 640, 2560), F of one
chunk and of several, each activation, the forward-only and the training
edition; C = 2048 (h through device memory) in bf16 and float32 at the
same M, F of one and of eight chunks; float32 at C <= 512 through the
same products (3xTF32) at a few shapes and at the main paths' rows at C =
512 (M = 1, 20 and 1280: a ``recommend`` at B = 1 and 64; 15360: a text
encode chunk) with GELU and ReLU. The training edition's y_pre and h against the plain
version's; the dropout's bits against ops/dropout.py's mask (a dropped
element of y_pre is x itself); the same bits on two runs; the plans the
kernel refuses. Tolerances: chip_smoke.py's TOL for the output (bf16: a
flipped rounding of the pre-LN sum moves the LN's output by up to ~0.1),
the same for y_pre (bf16 values up to ~8, one unit 2^-5), and for h
6.25e-2 in bf16 (values up to ~4, one unit 2^-6, sums in another order)
and 1e-4 in float32.
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import act_of, gemm, splits_of
from idvs.morec_tpu_torch.ops.cuda.mlp import (
    ACTS, DENSE1_DEPTH, F_CHUNK, fused_mlp_resln, fused_mlp_resln_plain,
    fused_mlp_resln_res, mlp_resln_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
TOL = {torch.float32: 1e-4, BF16: 1e-1}
H_TOL = {torch.float32: 1e-4, BF16: 6.25e-2}
ROWS = (1, 10, 17, 640, 2560)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(seed, M, C, F, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    x = (2.0 * g(M, C)).to(dtype)
    w = (g(C, F, scale=C ** -0.5), g(F, scale=0.1),
         g(F, C, scale=F ** -0.5), g(C, scale=0.1))
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    return x, w, ln


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


def _plain_saved(x, w, ln, act, rate, seed):
    """(out, y_pre, h) of the plain version's rounding points."""
    dt = x.dtype
    w1, b1, w2, b2 = (t.to(dt).float() for t in w)
    h = x.float() @ w1 + b1
    y = act_of(h, act).to(dt).float() @ w2 + b2
    ypre = (dropout.apply(y, rate, seed) + x.float()).to(dt)
    out = fused_mlp_resln_plain(x, *w, ln=ln, eps=1e-6, act=act,
                                drop_rate=rate, seed=seed)
    return out, ypre, h.to(dt)


def _check(seed, M, C, F, act, dtype, rate=0.0):
    """Both editions against the plain version."""
    x, w, ln = _inputs(seed, M, C, F, dtype)
    kw = dict(ln=ln, eps=1e-6, act=act, drop_rate=rate, seed=seed)
    before = fused_mlp_resln.launches
    _close(fused_mlp_resln(x, *w, **kw), fused_mlp_resln_plain(x, *w, **kw),
           TOL[dtype])
    assert fused_mlp_resln.launches == before + 1
    dt = x.dtype
    ops = [t.to(dt).contiguous() for t in w] + [t.float() for t in ln]
    out, ypre, h = fused_mlp_resln_res(
        x, *ops, eps=1e-6, act=act, drop=dropout.kernel_args(rate, seed),
        code=lib.dtype_code(x))
    want = _plain_saved(x, w, ln, act, rate, seed)
    _close(out, want[0], TOL[dtype])
    _close(ypre, want[1], TOL[dtype])
    _close(h, want[2], H_TOL[dtype])
    return x, ypre


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("C", [128, 256, 512])
def test_tensor_core_body_at_the_block_edges(C, M):
    """F of one bf16 chunk (the plan's) and F = 4C, every activation."""
    chunk = mlp_resln_plan(C, BF16)["f_chunk"]
    for F in sorted({F_CHUNK[C], 4 * C}):
        for i, act in enumerate(ACTS):
            _check(C + M + F + i, M, C, F, act, BF16)
    assert F_CHUNK[C] % chunk == 0


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_the_2048_tail_in_both_dtypes(dtype, M):
    """SASRec at D = 2048: F of one chunk and F = 4C (8192); every
    activation."""
    for F, act in ((1024, "gelu"), (8192, "relu"), (1024, "quick_gelu")):
        _check(M + F, M, 2048, F, act, dtype)


@pytest.mark.parametrize("C,M,act", [
    (128, 33, "gelu"), (256, 70, "relu"), (512, 1001, "quick_gelu"),
    (512, 1, "gelu"), (512, 1, "relu"), (512, 20, "gelu"), (512, 20, "relu"),
    (512, 1280, "gelu"), (512, 1280, "relu"), (512, 15360, "gelu"),
    (512, 15360, "relu")])
def test_float32_body(C, M, act):
    """Both editions (y_pre and h from the training one) through gemm.cu's
    3xTF32 products and the row pass."""
    before = gemm.launches
    _check(C + M, M, C, 4 * C, act, torch.float32)
    assert gemm.launches == before + 4
    assert mlp_resln_plan(C, torch.float32)["route"] == "products"


@pytest.mark.parametrize("C,dtype", [(512, BF16), (2048, BF16),
                                     (2048, torch.float32)])
def test_dropout_bits_are_the_plain_mask(C, dtype):
    """At rate 0.1: a dropped element of y_pre is x's own value (y = 0),
    exactly where ops/dropout.py's mask drops."""
    M, seed = 70, 12345
    x, ypre = _check(seed, M, C, 4 * C, "relu", dtype, rate=0.1)
    keep = dropout.keep_mask(seed, (M, C), 0.1, "cuda")
    assert torch.equal(ypre[~keep], x[~keep])
    assert (ypre[keep] != x[keep]).float().mean().item() > 0.9


@pytest.mark.parametrize("C,dtype", [(512, BF16), (2048, BF16),
                                     (2048, torch.float32)])
def test_two_runs_give_the_same_bits(C, dtype):
    x, w, ln = _inputs(5, 640, C, 4 * C, dtype)
    kw = dict(ln=ln, eps=1e-6, act="relu", drop_rate=0.1, seed=9)
    a, b = fused_mlp_resln(x, *w, **kw), fused_mlp_resln(x, *w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("M", ROWS)
def test_the_2048_dense1_bounds_its_tensor_core_depth(M):
    """The C = 2048 training edition's h = x w1 + b1 adds its K slices of
    at most DENSE1_DEPTH in float: its mean error against the float64 sum
    at most 2^-20 of mean |h|, as torch.matmul's float32 product (one
    2048-deep slice on the tensor cores was 2^-19 of it at M = 640,
    PERF.md), so that the backward's ReLU takes the plain version's
    branch."""
    C, F = 2048, 8192
    assert splits_of(M, F, C, lib.DTYPE_CODES[BF16],
                     DENSE1_DEPTH) >= C // DENSE1_DEPTH
    x, (w1, b1, _, _), _ = _inputs(M, M, C, F, BF16)
    w1, b1 = w1.to(BF16), b1.to(BF16)
    h = gemm(x, w1, M, F, C, (C, 1), (F, 1), lib.DTYPE_CODES[BF16], bias=b1,
             out_f32=True, max_depth=DENSE1_DEPTH)
    exact = x.double() @ w1.double() + b1.double()
    torch.cuda.synchronize()
    err = (h.double() - exact).abs().mean().item()
    assert err <= 2.0 ** -20 * exact.abs().mean().item(), err


def test_refuses_a_plan_not_built_for_the_width():
    x, w, ln = _inputs(2, 64, 512, 2048, BF16)
    out = torch.empty_like(x)
    ops = [t.to(BF16).contiguous() for t in w] + [t.float() for t in ln]
    k = mlp_resln_plan(512, BF16)
    # float32 has no block body: the entry refuses it whatever the plan
    for dtype, bad in ((BF16, dict(rows=32)), (BF16, dict(f_chunk=128)),
                       (BF16, dict(threads=256)),
                       (BF16, dict(smem=k["smem"] + 16)),
                       (torch.float32, {})):
        p = {**k, **bad}
        err = lib.library().idvs_mlp_resln_fwd(
            x.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
            None, None, 64, 512, 2048, 1e-6, 0, 0, 0, 1.0, p["rows"],
            p["f_chunk"], p["threads"], p["smem"], lib.DTYPE_CODES[dtype],
            lib.stream_handle(x))
        assert err == 1, bad    # cudaErrorInvalidValue
