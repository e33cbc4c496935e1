"""The port's CUDA kernels against their plain PyTorch versions on the card,
forward and backward (autograd of the plain version), with dropout off and
on, and the launches they refuse. Every test needs an NVIDIA GPU and skips
without one. On the card (no jax there, so without the repo's conftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import copy

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda.attention import (
    fused_mha, fused_mha_bwd, fused_mha_bwd_dbias, fused_mha_plain,
    fused_mha_proj,
    fused_mha_proj_band, fused_mha_proj_band_bwd, fused_mha_proj_band_plain,
    fused_mha_proj_bwd, fused_mha_proj_plain)
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import (
    embed_gather, scatter_add_rows, scatter_add_rows_plain)
from idvs.morec_tpu_torch.ops.cuda import inbatch_ce
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import (ce_plan, fused_ce,
                                                      fused_inbatch_ce,
                                                      fused_inbatch_ce_bwd)
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp, fused_mlp_bwd,
                                               fused_mlp_plain,
                                               fused_mlp_res,
                                               fused_mlp_res_bwd,
                                               fused_mlp_res_plain,
                                               fused_mlp_resln,
                                               fused_mlp_resln_bwd,
                                               fused_mlp_resln_plain,
                                               fused_mlp_resln_res,
                                               fused_proj_resln,
                                               fused_proj_resln_bwd,
                                               fused_proj_resln_plain,
                                               fused_proj_resln_res,
                                               premlp_bwd_h, premlp_bwd_plan,
                                               premlp_kink_census,
                                               PREMLP_BWD_ROUTES)
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.losses import (candidate_colmask,
                                             inbatch_ce_candidates)
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask

pytestmark = pytest.mark.cuda

# max abs error, kernel vs plain; the reasons are in chip_smoke.py (TOL)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
# gradients: max abs error over max(1, max |plain gradient|); the reasons
# are in chip_smoke.py (GRAD_TOL)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rand(rng, *shape, scale=1.0, dtype=torch.float32):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to("cuda", dtype)


def _assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[got.dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,nh,dh", [(512, 30, 8, 64), (3, 1, 2, 16),
                                       (4, 128, 4, 64), (5, 17, 3, 40)])
def test_mha_mask_mode(B, T, nh, dh, dtype):
    rng = np.random.default_rng(0)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    lens = rng.integers(0, T + 1, size=B)          # 0: every key masked
    mask = torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32)).cuda()
    before = fused_mha.launches
    got = fused_mha(qkv, mask, n_heads=nh)
    assert fused_mha.launches == before + 1
    _assert_close(got, fused_mha_plain(qkv, mask, n_heads=nh))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P,T,nh,dh,shared", [
    (64, 64, 20, 2, 256, True),       # SASRec: (B, 1, L, L) causal mask
    (8, 8, 20, 2, 256, False),
    (32, 4, 10, 4, 16, False),        # cyclic period
])
def test_mha_bias_mode(B, P, T, nh, dh, shared, dtype):
    rng = np.random.default_rng(1)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    if shared:
        lens = rng.integers(1, T + 1, size=P)
        log_mask = (np.arange(T)[None] >= T - lens[:, None]).astype(
            np.float32)
        bias = causal_additive_mask(torch.from_numpy(log_mask).cuda())
    else:
        bias = _rand(rng, P, nh, T, T, scale=3.0)
    got = fused_mha(qkv, bias=bias, n_heads=nh)
    _assert_close(got, fused_mha_plain(qkv, bias=bias, n_heads=nh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,eps", [(15360, 512, 1e-12), (45, 512, 1e-6),
                                     (33, 256, 1e-6), (7, 128, 1e-12),
                                     (3000, 768, 1e-12)])
def test_proj_resln(M, C, eps, dtype):
    rng = np.random.default_rng(2)
    x, res = _rand(rng, M, C, dtype=dtype), _rand(rng, M, C, dtype=dtype)
    w, b = _rand(rng, C, C, scale=C ** -0.5), _rand(rng, C, scale=0.1)
    ln = (1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1))
    before = fused_proj_resln.launches
    got = fused_proj_resln(x, res, w, b, ln=ln, eps=eps)
    assert fused_proj_resln.launches == before + 1
    _assert_close(got, fused_proj_resln_plain(x, res, w, b, ln=ln, eps=eps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,F,act", [(15360, 512, 2048, "gelu"),
                                       (20, 512, 2048, "relu"),
                                       (45, 256, 384, "gelu"),
                                       (100, 512, 256, "gelu"),
                                       (7, 128, 128, "relu"),
                                       (33, 512, 2048, "quick_gelu"),
                                       (640, 2048, 8192, "quick_gelu"),
                                       (1500, 768, 3072, "gelu")])
def test_mlp_resln(M, C, F, act, dtype):
    rng = np.random.default_rng(3)
    x = _rand(rng, M, C, dtype=dtype)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    ln = (1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1))
    before = fused_mlp_resln.launches
    got = fused_mlp_resln(x, w1, b1, w2, b2, ln=ln, eps=1e-6, act=act)
    assert fused_mlp_resln.launches == before + 1
    _assert_close(got, fused_mlp_resln_plain(x, w1, b1, w2, b2, ln=ln,
                                             eps=1e-6, act=act))


def _grads(fn, inputs, dout):
    """(output, gradients of <output, dout> w.r.t. every input)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout)


def _assert_grads_close(got, want, dtype):
    """Gradients of a run in the compute dtype ``dtype`` (a float32 master
    weight's gradient carries that dtype's roundings too)."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * scale, (err, scale)


def _uncontiguous(rng, rows, cols, dtype):
    """A (rows, cols) cotangent laid out column-major, as autograd may hand
    one over."""
    return _rand(rng, cols, rows, dtype=dtype).t()


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["mask", "bias", "bias_1024"])
def test_mha_backward(mode, dtype, drop):
    """dqkv of the backward kernel against autograd of the plain version,
    BERT's key mask and SASRec's shared causal bias (heads of 256, and the
    vision flagship's heads of 1024), the forward's mask of dropped
    probabilities reused."""
    rng = np.random.default_rng(4)
    if mode == "mask":
        B, T, nh, dh = 64, 30, 8, 64
        lens = rng.integers(0, T + 1, size=B)
        kw = dict(mask=torch.from_numpy(
            (np.arange(T)[None] < lens[:, None]).astype(np.float32)).cuda())
    else:
        B, T, nh, dh = (32, 20, 2, 256) if mode == "bias" else (64, 10, 2,
                                                                 1024)
        lens = rng.integers(1, T + 1, size=B)
        kw = dict(bias=causal_additive_mask(torch.from_numpy(
            (np.arange(T)[None] >= T - lens[:, None]).astype(
                np.float32)).cuda()))
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    dout = _rand(rng, B, nh * dh, T, dtype=dtype).transpose(1, 2)
    before = fused_mha_bwd.launches
    out_k, got = _grads(lambda q: fused_mha(q, n_heads=nh, drop_rate=drop,
                                            seed=11, **kw), [qkv], dout)
    assert fused_mha_bwd.launches == before + 1
    out_p, want = _grads(lambda q: fused_mha_plain(
        q, n_heads=nh, drop_rate=drop, seed=11, **kw), [qkv], dout)
    _assert_close(out_k, out_p)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P,nh,heads", [
    (288 * 4, 4, 12, 12),     # Swin-T stage 2 on 288 images, shifted: P = nW
    (64 * 64, 1, 3, 3),       # stage 0, unshifted: one bias for every row
    (64 * 64, 64, 3, 3),      # stage 0, shifted
    (30, 6, 24, 24),          # stage 3 geometry, a bias per 5 rows
    (40, 4, 3, 1)])           # one plane shared by the heads
def test_mha_backward_dbias(B, P, nh, heads, dtype, drop):
    """The dbias edition against autograd of the plain version: dqkv and
    the gradient of a trainable float32 bias (P, heads, T, T) at Swin's
    T = 49, dh = 32 (the -100 of a shift mask on some pairs), the
    forward's dropped probabilities reused; the same bits on a second
    run."""
    T, dh = 49, 32
    rng = np.random.default_rng(16)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    bias = _rand(rng, P, heads, T, T, scale=0.5) - 100.0 * torch.from_numpy(
        (rng.uniform(size=(P, 1, T, T)) < 0.2).astype(np.float32)).cuda()
    dout = _rand(rng, B, T, nh * dh, dtype=dtype)
    before = (fused_mha_bwd.launches, fused_mha_bwd_dbias.launches)
    kern = lambda q, b: fused_mha(q, bias=b, n_heads=nh, drop_rate=drop,
                                  seed=13)
    out_k, got = _grads(kern, [qkv, bias], dout)
    assert (fused_mha_bwd.launches, fused_mha_bwd_dbias.launches) == (
        before[0], before[1] + 1)
    out_p, want = _grads(lambda q, b: fused_mha_plain(
        q, bias=b, n_heads=nh, drop_rate=drop, seed=13), [qkv, bias], dout)
    _assert_close(out_k, out_p)
    assert got[1].shape == bias.shape and got[1].dtype == torch.float32
    _assert_grads_close(got, want, dtype)
    _assert_same_bits(got, _grads(kern, [qkv, bias], dout)[1])


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,eps", [(3000, 512, 1e-12), (45, 256, 1e-6),
                                     (7, 128, 1e-12), (300, 768, 1e-12)])
def test_proj_resln_backward(M, C, eps, dtype, drop):
    """The training edition and the backward kernels against autograd of
    the plain version: dx, dres, dw, db, dgamma, dbeta."""
    rng = np.random.default_rng(5)
    x, res = _rand(rng, M, C, dtype=dtype), _rand(rng, M, C, dtype=dtype)
    w, b = _rand(rng, C, C, scale=C ** -0.5), _rand(rng, C, scale=0.1)
    g, bt = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    dout = _uncontiguous(rng, M, C, dtype)
    before = (fused_proj_resln_res.launches, fused_proj_resln_bwd.launches)
    out_k, got = _grads(
        lambda *a: fused_proj_resln(*a[:4], ln=a[4:], eps=eps,
                                    drop_rate=drop, seed=3),
        [x, res, w, b, g, bt], dout)
    assert (fused_proj_resln_res.launches, fused_proj_resln_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    out_p, want = _grads(
        lambda *a: fused_proj_resln_plain(*a[:4], ln=a[4:], eps=eps,
                                          drop_rate=drop, seed=3),
        [x, res, w, b, g, bt], dout)
    _assert_close(out_k, out_p)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,F,act", [(3000, 512, 2048, "gelu"),
                                       (20, 512, 2048, "relu"),
                                       (45, 256, 384, "relu"),
                                       (7, 128, 128, "gelu"),
                                       (300, 512, 2048, "quick_gelu"),
                                       (10, 2048, 8192, "quick_gelu"),
                                       (300, 768, 3072, "gelu")])
def test_mlp_resln_backward(M, C, F, act, dtype, drop):
    """The training edition (y_pre and h saved) and the backward kernels
    against autograd of the plain version: dx, dw1, db1, dw2, db2, dgamma,
    dbeta."""
    rng = np.random.default_rng(6)
    x = _rand(rng, M, C, dtype=dtype)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    g, bt = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    dout = _uncontiguous(rng, M, C, dtype)
    before = (fused_mlp_resln_res.launches, fused_mlp_resln_bwd.launches)
    out_k, got = _grads(
        lambda *a: fused_mlp_resln(*a[:5], ln=a[5:], eps=1e-12, act=act,
                                   drop_rate=drop, seed=9),
        [x, w1, b1, w2, b2, g, bt], dout)
    assert (fused_mlp_resln_res.launches, fused_mlp_resln_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    out_p, want = _grads(
        lambda *a: fused_mlp_resln_plain(*a[:5], ln=a[5:], eps=1e-12,
                                         act=act, drop_rate=drop, seed=9),
        [x, w1, b1, w2, b2, g, bt], dout)
    _assert_close(out_k, out_p)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_only_editions_drop_like_the_plain_versions(dtype, drop):
    """Without a gradient the tails launch their forward-only editions,
    with the same dropout mask as the plain versions."""
    rng = np.random.default_rng(7)
    M, C, F = 100, 512, 2048
    x, res = _rand(rng, M, C, dtype=dtype), _rand(rng, M, C, dtype=dtype)
    w, b = _rand(rng, C, C, scale=C ** -0.5), _rand(rng, C, scale=0.1)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2 = _rand(rng, F, C, scale=F ** -0.5)
    ln = (1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1))
    kw = dict(ln=ln, eps=1e-6, drop_rate=drop, seed=21)
    before = (fused_proj_resln.launches, fused_mlp_resln.launches,
              fused_proj_resln_res.launches, fused_mlp_resln_res.launches)
    _assert_close(fused_proj_resln(x, res, w, b, **kw),
                  fused_proj_resln_plain(x, res, w, b, **kw))
    _assert_close(fused_mlp_resln(x, w1, b1, w2, b, **kw),
                  fused_mlp_resln_plain(x, w1, b1, w2, b, **kw))
    assert (fused_proj_resln.launches, fused_mlp_resln.launches,
            fused_proj_resln_res.launches, fused_mlp_resln_res.launches) \
        == (before[0] + 1, before[1] + 1, before[2], before[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_rows(dtype):
    """Zipf ids, so rows repeat hundreds of times: float atomics sum them in
    no fixed order, within float32 reassociation (float32: 1e-4 of the
    largest sum) or one bf16 rounding of the cast result (bfloat16: 1e-2);
    the kernel is also embed_gather's backward."""
    rng = np.random.default_rng(8)
    V, D, M = 30522, 512, 256 * 30
    ids = torch.from_numpy(np.minimum(rng.zipf(1.2, M), V) - 1).cuda()
    dx = _rand(rng, M, D, dtype=dtype)
    before = scatter_add_rows.launches
    got = scatter_add_rows(ids, dx, V)
    want = scatter_add_rows_plain(ids, dx, V)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    table = _rand(rng, V, D).requires_grad_(True)
    embed_gather(table.to(dtype), ids.view(256, 30)).backward(
        dx.view(256, 30, D))
    assert scatter_add_rows.launches == before + 2
    got = table.grad
    assert (got - want.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [50272, 50265])      # OPT-125M, DeBERTa-base
def test_scatter_add_rows_text_zoo_tables(V, dtype):
    """The word tables of the OPT and DeBERTa towers (D 768) under a train
    step's tokens (768 titles of 30), Zipf ids: against the plain version
    as test_scatter_add_rows holds it."""
    rng = np.random.default_rng(16)
    D, M = 768, 768 * 30
    ids = torch.from_numpy(np.minimum(rng.zipf(1.2, M), V) - 1).cuda()
    dx = _rand(rng, M, D, dtype=dtype)
    before = scatter_add_rows.launches
    got = scatter_add_rows(ids, dx, V)
    assert scatter_add_rows.launches == before + 1
    want = scatter_add_rows_plain(ids, dx, V)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (V, D) and got.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _mlp_args(C=128, F=256, dtype=torch.float32):
    z = lambda *s: torch.zeros(*s, device="cuda")
    return (z(4, C).to(dtype), z(C, F), z(F), z(F, C), z(C)), \
        dict(ln=(z(C) + 1, z(C)), eps=1e-6)


def _counts():
    return (fused_mha.launches, fused_mha_bwd.launches,
            fused_proj_resln.launches, fused_proj_resln_res.launches,
            fused_mlp_resln.launches, fused_mlp_resln_res.launches,
            scatter_add_rows.launches)


@pytest.mark.parametrize("case", [
    "mha_dropout", "proj_dropout", "mlp_dropout",
    "mha_long_t", "mha_smem", "mha_fp16",
    "proj_width", "mlp_width", "mlp_f_chunk", "mlp_fp16", "mlp_misaligned",
    "mha_bias_grad", "scatter_fp16", "scatter_shape",
])
def test_refuses_what_the_kernels_do_not_take(case):
    """No plain fallback on the card: a launch the kernel cannot make
    raises, and the launch counters do not move. Dropout runs in the
    kernels; a rate outside [0, 1) or a missing seed is refused."""
    counts = _counts()
    z = lambda *s: torch.zeros(*s, device="cuda")
    (x, w1, b1, w2, b2), kw = _mlp_args()
    calls = {
        "mha_dropout": (ValueError, lambda: fused_mha(
            z(2, 8, 96), z(2, 8) + 1, n_heads=2, drop_rate=1.0, seed=1)),
        "proj_dropout": (ValueError, lambda: fused_proj_resln(
            x, x, z(128, 128), b2, drop_rate=0.1, **kw)),
        "mlp_dropout": (ValueError, lambda: fused_mlp_resln(
            x, w1, b1, w2, b2, drop_rate=-0.1, seed=1, **kw)),
        "mha_long_t": (ValueError, lambda: fused_mha(
            z(1, 129, 96), z(1, 129) + 1, n_heads=2)),
        "mha_smem": (ValueError, lambda: fused_mha(
            z(1, 128, 3 * 256), z(1, 128) + 1, n_heads=1)),
        "mha_fp16": (TypeError, lambda: fused_mha(
            z(2, 8, 96).half(), z(2, 8) + 1, n_heads=2)),
        "proj_width": (ValueError, lambda: fused_proj_resln(
            z(4, 96), z(4, 96), z(96, 96), z(96),
            ln=(z(96) + 1, z(96)), eps=1e-6)),
        "mlp_width": (ValueError, lambda: fused_mlp_resln(
            *_mlp_args(C=192)[0], **_mlp_args(C=192)[1])),
        "mlp_f_chunk": (ValueError, lambda: fused_mlp_resln(
            *_mlp_args(F=200)[0], **_mlp_args(F=200)[1])),
        "mlp_fp16": (TypeError, lambda: fused_mlp_resln(
            *_mlp_args(dtype=torch.float16)[0], **kw)),
        "mlp_misaligned": (ValueError, lambda: fused_mlp_resln(
            z(4 * 128 + 1)[1:].view(4, 128), w1, b1, w2, b2, **kw)),
        "mha_bias_grad": (ValueError, lambda: fused_mha(   # 3 rows, B 2
            z(2, 8, 96), bias=z(3, 2, 8, 8).requires_grad_(True),
            n_heads=2)),
        "scatter_fp16": (TypeError, lambda: scatter_add_rows(
            z(4).long(), z(4, 8).half(), 10)),
        "scatter_shape": (ValueError, lambda: scatter_add_rows(
            z(5).long(), z(4, 8), 10)),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()
    assert counts == _counts()


def _attn_weights(rng, C, dtype):
    return (_rand(rng, C, 3 * C, scale=C ** -0.5), _rand(rng, 3 * C, scale=0.1),
            _rand(rng, C, C, scale=C ** -0.5), _rand(rng, C, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edition,M,act", [
    ("res_unit", 512 * 30, "relu"),        # OPT-125M's encode chunk
    ("save_h", 768 * 30 + 7, "relu"),      # OPT-125M's training, LN
    ("no_ln", 768 * 30 + 7, "gelu")])      # DeBERTa-base's, no LN
def test_text_zoo_mlp_editions(edition, M, act, dtype):
    """Rows 5-6 at the text towers' editions, C 768, F 3072: the forward
    against the plain version; the backward against autograd of the plain
    version through the route premlp_bwd_plan picks (wg in bf16, products
    in float32), a ReLU's plain version taking the kernel's branch at the
    kink (premlp_bwd_h, relu_kink: in bf16 also the roundings of xn, where
    the kernel's LayerNorm and the plain one may round apart), the marked
    share and the flips among them under premlp_kink_census' caps; in
    bf16 the wg and the products routes called alone, their gradients
    against each other."""
    rng = np.random.default_rng(15)
    C, F = 768, 3072
    x = _rand(rng, M, C, dtype=dtype)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    g, bt = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    dout = _rand(rng, M, C, dtype=dtype)
    ln = (g, bt) if edition != "no_ln" else None
    save_h = edition != "res_unit"
    inputs = [x, w1, b1, w2, b2] + list(ln or ())
    kw = dict(eps=1e-5, act=act)
    if edition == "res_unit":
        kern = lambda *a: fused_mlp_res(a[0], None, *a[1:5], ln=a[5:], **kw)
        plain = lambda *a, k=None: fused_mlp_res_plain(
            a[0], None, *a[1:5], ln=a[5:], kink_from=k, **kw)
        fwd, bwd = fused_mlp_res, fused_mlp_res_bwd
    else:
        kern = lambda *a: fused_mlp(*a[:5], ln=a[5:] or None, save_h=True,
                                    **kw)
        plain = lambda *a, k=None: fused_mlp_plain(
            *a[:5], ln=a[5:] or None, save_h=True, kink_from=k, **kw)
        fwd, bwd = fused_mlp, fused_mlp_bwd
    before = (fwd.launches, bwd.launches)
    out_k, got = _grads(kern, inputs, dout)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    kink = (premlp_bwd_h(x, w1, b1, w2, b2, ln=ln, eps=1e-5, act=act,
                         save_h=save_h) if act == "relu" else None)
    if kink is not None:    # raises past KINK_SHARE or KINK_FLIPS
        premlp_kink_census(x, w1, b1, kink, ln=ln, eps=1e-5)
    out_p, want = _grads(lambda *a: plain(*a, k=kink), inputs, dout)
    _assert_close(out_k, out_p)
    _assert_grads_close(got, want, dtype)
    plan = premlp_bwd_plan(C, M, dtype)
    assert plan["route"] == ("wg" if dtype == torch.bfloat16
                             else "products")
    if dtype == torch.float32:
        return
    h = (premlp_bwd_h(x, w1, b1, w2, b2, ln=ln, eps=1e-5, act=act,
                      save_h=True) if save_h else None)
    lnf = [t.float() for t in ln] if ln else [None, None]
    ops = (x, dout, None, w1.to(dtype), b1.to(dtype), w2.to(dtype), lnf, h,
           1e-5, act, edition == "res_unit", lib.dtype_code(x))
    routes = [PREMLP_BWD_ROUTES[r](*ops) for r in ("wg", "products")]
    _assert_grads_close([t for t in routes[0] if t is not None],
                        [t for t in routes[1] if t is not None], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hp,Wp,C,nh,w,shifted", [
    (2, 56, 56, 96, 3, 7, False),      # Swin-T stage 0
    (2, 56, 56, 96, 3, 7, True),
    (3, 28, 28, 192, 6, 7, True),
    (3, 14, 14, 384, 12, 7, True),
    (5, 7, 7, 768, 24, 7, False),      # one window an image
    (8, 28, 14, 64, 2, 7, True),
    (3, 8, 12, 32, 2, 4, True),        # three 16-token windows a block
    (2, 16, 16, 128, 4, 8, False),
])
def test_windowed_attention_band(N, Hp, Wp, C, nh, w, shifted, dtype):
    """The band kernel against its plain version, P = 1 and P = nW (with
    the -100 of a shift mask in the bias)."""
    rng = np.random.default_rng(10)
    x = _rand(rng, N, Hp, Wp, C, dtype=dtype)
    nW, T = (Hp // w) * (Wp // w), w * w
    bias = _rand(rng, nW if shifted else 1, nh, T, T, scale=0.5)
    if shifted:
        bias = bias - 100.0 * torch.from_numpy(
            (rng.uniform(size=(nW, 1, T, T)) < 0.3).astype(np.float32)).cuda()
    ws = _attn_weights(rng, C, dtype)
    before = fused_mha_proj_band.launches
    got = fused_mha_proj_band(x, bias, *ws, n_heads=nh, window=w)
    assert fused_mha_proj_band.launches == before + 1
    _assert_close(got, fused_mha_proj_band_plain(x, bias, *ws, n_heads=nh,
                                                 window=w))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P,T,C,nh", [(128, 64, 49, 96, 3),
                                        (7, 1, 49, 768, 24),
                                        (20, 4, 49, 192, 6),
                                        (10, 5, 16, 64, 4)])
def test_windowed_attention_windows(B, P, T, C, nh, dtype):
    """The window-layout kernel against its plain version, bias cyclic
    with period P."""
    rng = np.random.default_rng(11)
    x = _rand(rng, B, T, C, dtype=dtype)
    bias = _rand(rng, P, nh, T, T, scale=0.5)
    ws = _attn_weights(rng, C, dtype)
    before = fused_mha_proj.launches
    got = fused_mha_proj(x, bias, *ws, n_heads=nh)
    assert fused_mha_proj.launches == before + 1
    _assert_close(got, fused_mha_proj_plain(x, bias, *ws, n_heads=nh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,F,act,ln", [
    (3136 * 2, 96, 384, "gelu", True), (1000, 192, 768, "gelu", True),
    (196 * 3, 384, 1536, "gelu", False), (49 * 5, 768, 3072, "gelu", True),
    (33, 128, 512, "relu", True), (70, 256, 256, "quick_gelu", False),
    (5, 512, 512, "quick_gelu", True), (40, 1024, 1024, "gelu", True),
    (9, 32, 64, "relu", True), (130, 64, 128, "gelu", True)])
def test_pre_ln_mlp(M, C, F, act, ln, dtype):
    """fused_mlp (LN or none) and fused_mlp_res (unit and scaled) against
    their plain versions."""
    rng = np.random.default_rng(12)
    x = _rand(rng, M, C, dtype=dtype)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    lnp = (1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1))
    kw = dict(ln=lnp if ln else None, eps=1e-5, act=act)
    before = (fused_mlp.launches, fused_mlp_res.launches)
    _assert_close(fused_mlp(x, w1, b1, w2, b2, **kw),
                  fused_mlp_plain(x, w1, b1, w2, b2, **kw))
    kw["ln"] = lnp
    scale = torch.from_numpy(
        (rng.uniform(size=M) < 0.8).astype(np.float32) / 0.8).cuda()
    for s in (None, scale):
        _assert_close(fused_mlp_res(x, s, w1, b1, w2, b2, **kw),
                      fused_mlp_res_plain(x, s, w1, b1, w2, b2, **kw))
    assert (fused_mlp.launches, fused_mlp_res.launches) \
        == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [640, 10, 3])
def test_post_ln_tails_at_2048(M, dtype):
    """The forward-only editions at the vision flagship's SASRec width (the
    training editions: test_post_ln_tails_train_at_2048)."""
    rng = np.random.default_rng(13)
    C, F = 2048, 8192
    x, res = _rand(rng, M, C, dtype=dtype), _rand(rng, M, C, dtype=dtype)
    w = _rand(rng, C, C, scale=C ** -0.5)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    ln = (1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1))
    _assert_close(fused_proj_resln(x, res, w, b2, ln=ln, eps=1e-6),
                  fused_proj_resln_plain(x, res, w, b2, ln=ln, eps=1e-6))
    _assert_close(
        fused_mlp_resln(x, w1, b1, w2, b2, ln=ln, eps=1e-6, act="relu"),
        fused_mlp_resln_plain(x, w1, b1, w2, b2, ln=ln, eps=1e-6,
                              act="relu"))


@pytest.mark.parametrize("case", [
    "band_grad", "windows_grad", "mlp_grad", "mlp_res_grad", "tail_2048_grad",
    "band_width", "band_heads", "band_window", "band_period", "mlp_width",
    "mlp_f_chunk", "mlp_res_no_ln", "mlp_scale_rows", "windows_bwd_tiles",
])
def test_refuses_what_the_vision_kernels_do_not_take(case):
    """The kernels give a gradient where one is wanted (the backward's
    counter moves), and raise for geometries they are not built for (no
    counter moves)."""
    z = lambda *s: torch.zeros(*s, device="cuda")
    grad = lambda *s: z(*s).requires_grad_(True)
    attn = lambda C: (z(C, 3 * C), z(3 * C), z(C, C), z(C))
    mlp = lambda C, F: (z(C, F), z(F), z(F, C), z(C))
    ln = lambda C: dict(ln=(z(C) + 1, z(C)))
    counted = (fused_mha_proj, fused_mha_proj_band, fused_mlp, fused_mlp_res,
               fused_proj_resln, fused_mlp_resln, fused_mha_proj_bwd,
               fused_mha_proj_band_bwd, fused_mlp_bwd, fused_mlp_res_bwd,
               fused_proj_resln_bwd)
    counts = lambda: tuple(f.launches for f in counted)
    before = counts()
    gradients = {
        "band_grad": (fused_mha_proj_band_bwd, lambda: fused_mha_proj_band(
            grad(1, 7, 7, 96), z(1, 3, 49, 49), *attn(96), n_heads=3,
            window=7)),
        "windows_grad": (fused_mha_proj_bwd, lambda: fused_mha_proj(
            z(2, 49, 96), grad(1, 3, 49, 49), *attn(96), n_heads=3)),
        "mlp_grad": (fused_mlp_bwd, lambda: fused_mlp(
            grad(4, 96), *mlp(96, 384))),
        "mlp_res_grad": (fused_mlp_res_bwd, lambda: fused_mlp_res(
            z(4, 96), None, grad(96, 384), *mlp(96, 384)[1:], **ln(96))),
        "tail_2048_grad": (fused_proj_resln_bwd, lambda: fused_proj_resln(
            grad(4, 2048), z(4, 2048), z(2048, 2048), z(2048), eps=1e-6,
            **ln(2048))),
    }
    if case in gradients:
        bwd, call = gradients[case]
        n = bwd.launches
        call().sum().backward()
        torch.cuda.synchronize()
        assert bwd.launches == n + 1
        return
    calls = {
        "band_width": (ValueError, lambda: fused_mha_proj_band(
            z(1, 7, 7, 160), z(1, 5, 49, 49), *attn(160), n_heads=5,
            window=7)),
        "band_heads": (ValueError, lambda: fused_mha_proj_band(
            z(1, 7, 7, 256), z(1, 1, 49, 49), *attn(256), n_heads=1,
            window=7)),                    # a head of 256: above 128 columns
        "band_window": (ValueError, lambda: fused_mha_proj_band(
            z(1, 10, 7, 96), z(1, 3, 49, 49), *attn(96), n_heads=3,
            window=7)),
        "band_period": (ValueError, lambda: fused_mha_proj_band(
            z(1, 14, 14, 96), z(2, 3, 49, 49), *attn(96), n_heads=3,
            window=7)),
        "mlp_width": (ValueError, lambda: fused_mlp(
            z(4, 160), *mlp(160, 640))),
        "mlp_f_chunk": (ValueError, lambda: fused_mlp(
            z(4, 768), *mlp(768, 1024))),
        "mlp_res_no_ln": (ValueError, lambda: fused_mlp_res(
            z(4, 96), None, *mlp(96, 384), ln=None)),
        "mlp_scale_rows": (ValueError, lambda: fused_mlp_res(
            z(4, 96), z(3), *mlp(96, 384), **ln(96))),
        # 256-token windows of one 32-column head: the forward places them,
        # the backward core's planes (394 KB) do not fit a block's shared
        # memory, so the backward raises and counts nothing
        "windows_bwd_tiles": (ValueError, lambda: fused_mha_proj(
            grad(2, 256, 32), z(1, 1, 256, 256), *attn(32), n_heads=1
        ).sum().backward()),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()
    if case == "windows_bwd_tiles":     # its forward launched, once
        before = (before[0] + 1,) + before[1:]
    assert counts() == before


def _assert_same_bits(a, b):
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,F,act,edition", [
    (3136 * 2, 96, 384, "gelu", "res_scaled"),
    (3136 + 7, 96, 384, "gelu", "res_unit"),
    (1001, 192, 768, "gelu", "ln"), (196 * 3, 384, 1536, "gelu", "no_ln"),
    (49 * 5, 768, 3072, "gelu", "res_scaled"),
    (49 * 5, 768, 3072, "gelu", "save_h"),
    (33, 128, 512, "relu", "save_h"), (70, 256, 256, "quick_gelu", "no_ln"),
    (5, 512, 512, "quick_gelu", "res_unit"), (130, 64, 128, "relu", "ln")])
def test_pre_ln_mlp_backward(M, C, F, act, edition, dtype):
    """The backward of fused_mlp (LN, no LN, save_h) and fused_mlp_res (unit,
    scaled) against autograd of the plain version: dx, dw1, db1, dw2, db2,
    dgamma, dbeta; odd row counts; the same bits on a second run (every sum
    over rows is added in a fixed order)."""
    rng = np.random.default_rng(14)
    x = _rand(rng, M, C, dtype=dtype)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    g, bt = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    dout = _uncontiguous(rng, M, C, dtype)
    inputs = [x, w1, b1, w2, b2] + ([] if edition == "no_ln" else [g, bt])
    kw = dict(eps=1e-5, act=act)
    if edition.startswith("res"):
        scale = None
        if edition == "res_scaled":
            scale = torch.from_numpy(
                (rng.uniform(size=M) < 0.8).astype(np.float32) / 0.8).cuda()
        kern = lambda *a: fused_mlp_res(a[0], scale, *a[1:5], ln=a[5:], **kw)
        plain = lambda *a: fused_mlp_res_plain(a[0], scale, *a[1:5],
                                               ln=a[5:], **kw)
        fwd, bwd = fused_mlp_res, fused_mlp_res_bwd
    else:
        sh = edition == "save_h"
        kern = lambda *a: fused_mlp(*a[:5], ln=a[5:] or None, save_h=sh, **kw)
        plain = lambda *a: fused_mlp_plain(*a[:5], ln=a[5:] or None,
                                           save_h=sh, **kw)
        fwd, bwd = fused_mlp, fused_mlp_bwd
    before = (fwd.launches, bwd.launches)
    out_k, got = _grads(kern, inputs, dout)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    out_p, want = _grads(plain, inputs, dout)
    _assert_close(out_k, out_p)
    _assert_grads_close(got, want, dtype)
    _assert_same_bits(got, _grads(kern, inputs, dout)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hp,Wp,C,nh,w,shifted", [
    (3, 56, 56, 96, 3, 7, False),      # Swin-T stage 0
    (3, 56, 56, 96, 3, 7, True),
    (3, 28, 28, 192, 6, 7, True),
    (5, 14, 14, 384, 12, 7, True),
    (7, 7, 7, 768, 24, 7, False),      # one window an image
    (3, 8, 12, 32, 2, 4, True),
])
@pytest.mark.parametrize("layout", ["band", "windows"])
def test_windowed_attention_backward(layout, N, Hp, Wp, C, nh, w, shifted,
                                     dtype):
    """The backward of both layouts against autograd of the plain version:
    dx, dbias (P = 1 sums every window, P = nW folds window r into row
    r % nW), dwqkv, dbqkv, dwo, dbo; the same bits on a second run."""
    rng = np.random.default_rng(15)
    nW, T = (Hp // w) * (Wp // w), w * w
    bias = _rand(rng, nW if shifted else 1, nh, T, T, scale=0.5)
    if shifted:
        bias = bias - 100.0 * torch.from_numpy(
            (rng.uniform(size=(nW, 1, T, T)) < 0.3).astype(np.float32)).cuda()
    ws = _attn_weights(rng, C, dtype)
    if layout == "band":
        x = _rand(rng, N, Hp, Wp, C, dtype=dtype)
        dout = _rand(rng, N, Hp, C, Wp, dtype=dtype).transpose(2, 3)
        kern = lambda *a: fused_mha_proj_band(*a, n_heads=nh, window=w)
        plain = lambda *a: fused_mha_proj_band_plain(*a, n_heads=nh, window=w)
        fwd, bwd = fused_mha_proj_band, fused_mha_proj_band_bwd
    else:
        x = _rand(rng, N * nW, T, C, dtype=dtype)
        dout = _rand(rng, N * nW, C, T, dtype=dtype).transpose(1, 2)
        kern = lambda *a: fused_mha_proj(*a, n_heads=nh)
        plain = lambda *a: fused_mha_proj_plain(*a, n_heads=nh)
        fwd, bwd = fused_mha_proj, fused_mha_proj_bwd
    inputs = [x, bias, *ws]
    before = (fwd.launches, bwd.launches)
    out_k, got = _grads(kern, inputs, dout)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    out_p, want = _grads(plain, inputs, dout)
    _assert_close(out_k, out_p)
    assert got[1].shape == bias.shape and got[1].dtype == torch.float32
    assert got[3].shape == (3 * C,) and got[5].shape == (C,)
    _assert_grads_close(got, want, dtype)
    _assert_same_bits(got, _grads(kern, inputs, dout)[1])


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [640, 10, 3])
def test_post_ln_tails_train_at_2048(M, dtype, drop):
    """The training editions and the backward at the vision flagship's
    SASRec width against autograd of the plain versions. In float32 the
    ReLU tail's plain version takes ReLU's branch from the kernel's h where
    its own h lies within float32's rounding of 0 (``relu_kink``): the
    kernel's sum (3xTF32 on the tensor cores) and torch.matmul's round
    differently, either may put such a unit on the other side of 0, and
    that unit's dW1 column then differs by a row's contribution, a step no
    tolerance of rounding covers. A unit outside that bound on the other
    side still fails the check."""
    rng = np.random.default_rng(16)
    C, F = 2048, 8192
    x, res = _rand(rng, M, C, dtype=dtype), _rand(rng, M, C, dtype=dtype)
    w, b = _rand(rng, C, C, scale=C ** -0.5), _rand(rng, C, scale=0.1)
    w1, b1 = _rand(rng, C, F, scale=C ** -0.5), _rand(rng, F, scale=0.1)
    w2, b2 = _rand(rng, F, C, scale=F ** -0.5), _rand(rng, C, scale=0.1)
    g, bt = 1.0 + _rand(rng, C, scale=0.1), _rand(rng, C, scale=0.1)
    dout = _uncontiguous(rng, M, C, dtype)
    kw = dict(eps=1e-6, drop_rate=drop, seed=21)
    kink = {}
    if dtype == torch.float32:
        kink["kink_from"] = fused_mlp_resln_res(
            x, w1, b1, w2, b2, g, bt, eps=kw["eps"], act="relu",
            drop=dropout.kernel_args(drop, kw["seed"]),
            code=lib.dtype_code(x))[2]
    for kern, plain, inputs, counted in (
            (lambda *a: fused_proj_resln(*a[:4], ln=a[4:], **kw),
             lambda *a: fused_proj_resln_plain(*a[:4], ln=a[4:], **kw),
             [x, res, w, b, g, bt],
             (fused_proj_resln_res, fused_proj_resln_bwd)),
            (lambda *a: fused_mlp_resln(*a[:5], ln=a[5:], act="relu", **kw),
             lambda *a: fused_mlp_resln_plain(*a[:5], ln=a[5:], act="relu",
                                              **kink, **kw),
             [x, w1, b1, w2, b2, g, bt],
             (fused_mlp_resln_res, fused_mlp_resln_bwd))):
        before = tuple(f.launches for f in counted)
        out_k, got = _grads(kern, inputs, dout)
        assert tuple(f.launches for f in counted) == (before[0] + 1,
                                                      before[1] + 1)
        out_p, want = _grads(plain, inputs, dout)
        _assert_close(out_k, out_p)
        _assert_grads_close(got, want, dtype)
        _assert_same_bits(got, _grads(kern, inputs, dout)[1])


@pytest.mark.parametrize("kernels", ["band", "windows"])
@pytest.mark.parametrize("resolution,C,nh,shift", [((14, 14), 96, 3, True),
                                                   ((7, 7), 192, 6, False)])
def test_dropout_swin_block_matches_its_cpu_twin(resolution, C, nh, shift,
                                                 kernels):
    """A SwinBlock with attention-probability and hidden dropout 0.1 and
    DropPath 0.1 in training mode, float32: on the card (fused_mha and its
    dbias edition, fused_mlp) and on a CPU copy (the plain versions), the
    same seeds drawing the same masks; the output, the input's and every
    parameter's gradient agree (the relative position bias table's
    included)."""
    from idvs.morec_tpu_torch.models.layers import init_parameters
    from idvs.morec_tpu_torch.models.swin import SwinBlock, SwinConfig
    cfg = SwinConfig(hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    blk = SwinBlock(cfg, C, nh, resolution, shift, 0.1, kernels=kernels,
                    device="cuda")
    init_parameters(blk, torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        blk.relative_position_bias_table.normal_(0.0, 0.5)
    rng = np.random.default_rng(17)
    N, L = 6, resolution[0] * resolution[1]
    x, dout = _rand(rng, N, L, C), _rand(rng, N, L, C)
    runs = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(blk).to(dev).train()
        xx = x.detach().to(dev).requires_grad_(True)
        before = (fused_mha.launches, fused_mha_bwd_dbias.launches,
                  fused_mlp.launches, fused_mlp_bwd.launches)
        out = m(xx, torch.Generator().manual_seed(5))
        out.backward(dout.to(dev))
        if dev == "cuda":
            assert (fused_mha.launches, fused_mha_bwd_dbias.launches,
                    fused_mlp.launches, fused_mlp_bwd.launches) == tuple(
                        n + 1 for n in before)
        runs.append([out.detach().cpu(), xx.grad.cpu()]
                    + [p.grad.cpu() for p in m.parameters()])
    for got, want in zip(*runs):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


# -- the in-batch CE (csrc/inbatch_ce.cu) -------------------------------------
#
# Loss relative, gradients' max abs error over each gradient's largest
# magnitude; the reasons are in chip_smoke.py (CE_LOSS_TOL, CE_GRAD_TOL).
CE_LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
CE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _ce_inputs(rng, B, L, D, W=1, rank=0, dtype=torch.float32):
    """fused_ce's operands: W ranks' left-padded histories with a log mask
    of 0 inside them too and items repeated across users; rank `rank`'s
    users are the rows."""
    S = L + 1
    lens = rng.integers(1, S + 1, size=W * B)
    ids = rng.integers(1, 3 * S, size=(W * B, S)) * (
        np.arange(S)[None] >= S - lens[:, None])
    lm = ((np.arange(L)[None] >= S - lens[:, None])
          & (rng.uniform(size=(W * B, L)) < 0.9)).astype(np.float32)
    pop = rng.uniform(0.01, 1.0, 3 * S)
    pop[0] = 1.0
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    own = slice(rank * B, (rank + 1) * B)
    u = _rand(rng, B, L, D, scale=2 * D ** -0.25, dtype=dtype)
    cand = _rand(rng, W * B, S, D, scale=2 * D ** -0.25, dtype=dtype)
    lm_t = cuda(lm)
    return (u, cand, cuda(ids[own]), lm_t[own], cuda(ids),
            candidate_colmask(lm_t), cuda(np.log(pop).astype(np.float32)[ids]), rank * B * S)


def _ce_grads(fn, args):
    leaves = [a.detach().clone().requires_grad_() for a in args[:2]]
    loss = fn(*leaves, *args[2:])
    return loss, torch.autograd.grad(loss, leaves)


def _assert_ce_close(args, dtype):
    before = (fused_inbatch_ce.launches, fused_inbatch_ce_bwd.launches)
    loss_k, got = _ce_grads(fused_ce, args)
    torch.cuda.synchronize()
    assert (fused_inbatch_ce.launches,
            fused_inbatch_ce_bwd.launches) == (before[0] + 1, before[1] + 1)
    loss_p, want = _ce_grads(inbatch_ce_candidates, args)
    assert loss_k.dtype == torch.float32
    err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    assert err <= CE_LOSS_TOL[dtype], err
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        scale = b.float().abs().max().item()
        gerr = (a.float() - b.float()).abs().max().item()
        assert gerr <= CE_GRAD_TOL[dtype] * scale, (gerr, scale)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,D", [(3, 5, 16),      # N 18
                                   (8, 15, 32),     # N 128, one tile
                                   (16, 8, 48),     # N 144, M 128
                                   (7, 20, 512),    # the flagship's D
                                   (4, 10, 2048),   # 4 gradient chunks
                                   # M 65: a last row tile of one row
                                   (13, 5, 64),
                                   # M 135 and N 162 end in partial tiles
                                   (27, 5, 16),
                                   # D 2048 over two row and column tiles
                                   (9, 20, 2048),
                                   # the text step: both passes split
                                   (128, 20, 512)])
def test_inbatch_ce_kernels(B, L, D, dtype):
    args = _ce_inputs(np.random.default_rng(B * L + D), B, L, D,
                      dtype=dtype)
    got = _assert_ce_close(args, dtype)
    _assert_same_bits(got, _ce_grads(fused_ce, args)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,rank", [(3, 1), (4, 3), (8, 5)])
def test_inbatch_ce_gathered_candidates(W, rank, dtype):
    """Every rank's candidates on one card, the label offset rank * B * S
    > 0, as the gathered edition calls the kernels after its all-gather."""
    args = _ce_inputs(np.random.default_rng(W + rank), 6, 9, 64, W, rank,
                      dtype)
    assert args[-1] > 0
    got = _assert_ce_close(args, dtype)
    _assert_same_bits(got, _ce_grads(fused_ce, args)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inbatch_ce_masked_label_rows(dtype):
    """Rows that count (log mask 1) whose label column is masked (a log
    mask of 0 inside the history): a masked logit is a constant, so the
    kernels follow the composition's autograd there (C4)."""
    B, L = 40, 5
    args = _ce_inputs(np.random.default_rng(11), B, L, 32, dtype=dtype)
    lm, colmask = args[3].cpu().numpy(), args[5].cpu().numpy()
    assert any(lm[i, j] != 0 and colmask[i, j + 1] == 0
               for i in range(B) for j in range(L))
    got = _assert_ce_close(args, dtype)
    _assert_same_bits(got, _ce_grads(fused_ce, args)[1])


def test_inbatch_ce_entry_point_on_the_card():
    u, cand, ids, lm, _, _, lp, _ = _ce_inputs(np.random.default_rng(3), 5,
                                               6, 32)
    want = inbatch_ce_candidates(u, cand, ids, lm, ids,
                                 candidate_colmask(lm), lp)
    before = fused_inbatch_ce.launches
    with torch.no_grad():
        got = fused_inbatch_ce(u, cand, ids, lm, lp)
    assert fused_inbatch_ce.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_inbatch_ce_refusals():
    """Raises, and launches nothing, for what the kernels do not take."""
    rng = np.random.default_rng(4)
    args = _ce_inputs(rng, 4, 5, 32)
    u, cand, rest = args[0], args[1], args[2:]
    odd_d = _ce_inputs(rng, 4, 5, 24)
    shifted = torch.empty(u.numel() + 1, device="cuda")[1:].view(u.shape)
    shifted.copy_(u)
    cases = [
        ((u.half(), cand.half()), TypeError),                 # float16
        ((u, cand.bfloat16()), TypeError),                    # mixed dtypes
        ((shifted, cand), ValueError),                        # misaligned
        ((u.transpose(0, 1).contiguous().transpose(0, 1), cand),
         ValueError),                                         # strided
        (odd_d[:2], ValueError),                              # D = 24
    ]
    before = (fused_inbatch_ce.launches, fused_inbatch_ce_bwd.launches)
    for (uu, cc), err in cases:
        r = odd_d[2:] if uu.shape[-1] == 24 else rest
        with pytest.raises(err):
            fused_ce(uu, cc, *r)
    assert (fused_inbatch_ce.launches,
            fused_inbatch_ce_bwd.launches) == before


@pytest.mark.parametrize("what", ["fwd_smem", "fwd_split", "bwd_smem",
                                  "bwd_dc", "bwd_split"])
def test_inbatch_ce_entries_refuse_other_plans(what):
    """The C entries take only the plan ce_plan builds: another
    shared-memory size, a split that leaves a range empty, a gradient
    width the kernel has no edition for, or a split pass without its
    partials' buffer returns an error, and nothing is written."""
    args = _ce_inputs(np.random.default_rng(5), 16, 8, 48)   # N 144
    u, cand = args[0], args[1]
    (B, L, D, N, off, code), aux, w = inbatch_ce._operands(
        u, cand, *args[2:])
    M = B * L
    k = ce_plan(M, N, D, L, u.dtype)
    nan = lambda n: torch.full((n,), float("nan"), device="cuda")
    ptrs = lambda ts: [t.data_ptr() for t in ts]
    stream = lib.stream_handle(u)
    if what.startswith("fwd"):
        outs = [nan(M) for _ in range(3)]
        per, splits, smem = k["fwd_per"], k["fwd_splits"], k["fwd_smem"]
        if what == "fwd_smem":
            smem += 16
        else:
            per, splits = 1, -(-N // 128) + 1
        part = nan(3 * splits * M)
        err = lib.library().idvs_inbatch_ce_fwd(
            *ptrs([u, cand, *aux, part, *outs]), M, N, D, L, L + 1, off,
            per, splits, smem, code, stream)
    else:
        outs = [torch.full_like(u, float("nan")),
                torch.full_like(cand, float("nan"))]
        stats = [torch.ones(M, device="cuda") for _ in range(3)]
        dc, smem = k["dc"], k["bwd_smem"]
        per_u, splits_u = k["per_u"], k["splits_u"]
        # the partials' buffers the plan needs (none in "bwd_split")
        bufs = [nan(s * rows * D) if s > 1 else None
                for s, rows in ((splits_u, M), (k["splits_c"], N))]
        parts = [None if b is None else b.data_ptr() for b in bufs]
        if what == "bwd_smem":
            smem -= 16
        elif what == "bwd_dc":
            dc = 192
        else:
            per_u, splits_u = 1, -(-N // 128)   # two ranges
            parts[0] = None
        err = lib.library().idvs_inbatch_ce_bwd(
            *ptrs([u, cand, *aux, *stats, *outs]), *parts, M, N, D, L,
            L + 1, off, dc, per_u, splits_u, k["per_c"], k["splits_c"],
            smem, code, stream)
    torch.cuda.synchronize()
    assert err != 0
    assert all(t.isnan().all() for t in outs)


def test_idrec_runner_launches_the_kernels(tmp_path, monkeypatch):
    """One IDRec epoch through the runner on the card (bf16, use_pallas,
    SASRec at D 512, L 20), its evaluation in float32 and a test-mode
    reload: every kernel of the path launched, the train step's kernels
    once a step a block or more, and the reload's evaluation of the valid
    split the same bits as the run's."""
    from idvs.morec_tpu_torch import quickstart
    from idvs.morec_tpu_torch.config import parse_args
    from idvs.morec_tpu_torch.ops.cuda import gemm as gemm_mod
    from idvs.morec_tpu_torch.train.runner import Trainer
    monkeypatch.chdir(tmp_path)
    quickstart.make_dataset("SYNTH", n_users=512, n_items=400, n_groups=4,
                            lengths=(6, 24))
    flags = ["--root_data_dir", "./", "--dataset", "SYNTH", "--news",
             "news.tsv", "--behaviors", "behaviors.tsv", "--item_tower", "id",
             "--max_seq_len", "20", "--embedding_dim", "512",
             "--batch_size", "64", "--lr", "1e-3", "--use_pallas", "true",
             "--epoch", "1"]
    tr = Trainer(parse_args(flags))
    assert tr.device.type == "cuda"
    tr.load_data()
    tr.build_model()
    train_kernels = (fused_mha_bwd, fused_proj_resln_res, fused_proj_resln_bwd,
                     fused_mlp_resln_res, fused_mlp_resln_bwd,
                     fused_inbatch_ce, fused_inbatch_ce_bwd)
    eval_kernels = (fused_proj_resln, fused_mlp_resln)
    for w in (fused_mha, gemm_mod.gemm) + train_kernels + eval_kernels:
        w.launches = 0
    best, best_epoch = tr.train()
    steps = tr.train_stats["steps"]
    assert steps == tr.batcher.steps_per_epoch() and best_epoch == 1
    for w in train_kernels:
        assert w.launches >= steps, w.__name__
    assert fused_inbatch_ce.launches == steps
    for w in (fused_mha, gemm_mod.gemm) + eval_kernels:
        assert w.launches > 0, w.__name__
    te = Trainer(parse_args(flags + ["--mode", "test", "--load_ckpt_name",
                                     f"epoch-{best_epoch}.pt"]))
    te.load_data()
    te.build_model()
    te.test()
    assert te.run_eval("valid") == (best, tr.valid_results[1]["ndcg"])
    np.testing.assert_array_equal(te.last_eval["hits"],
                                  tr.valid_results[1]["hits"])


@pytest.mark.parametrize("name", ["swin_tiny", "resnet50"])
def test_pretrained_round_trip_on_the_card(tmp_path, name):
    """A tower drawn on the card and written as its checkpoint (Swin-T's
    published geometry in HF's layout, config.json and pytorch_model.bin;
    ResNet-50 as a torchvision .pth) comes back through load_encoder bit
    for bit, and the Swin-T loaded from it encodes 64 images (bf16, the
    fused_mha_proj_band and fused_mlp_res kernels) to the bits of the tower
    it came from."""
    import json

    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.convert import to_checkpoint
    from idvs.morec_tpu_torch.models.layers import init_parameters
    from idvs.morec_tpu_torch.models.resnet import resnet_param_order
    from idvs.morec_tpu_torch.models.swin import swin_param_order
    from idvs.morec_tpu_torch.train.evaluate import eval_mode
    from idvs.morec_tpu_torch.train.runner import (load_encoder,
                                                   load_net_state)

    (tmp_path / "swin_tiny").mkdir()
    (tmp_path / "swin_tiny" / "config.json").write_text(json.dumps(dict(
        model_type="swin", image_size=224, patch_size=4, embed_dim=96,
        depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], window_size=7)))
    cfg = Config(item_tower="modal", modality="vision", cv_model_load=name,
                 pretrained_models_dir=str(tmp_path), embedding_dim=64,
                 compute_dtype="bfloat16", freeze_paras_before=20)
    src = load_encoder(cfg, None)[0]
    init_parameters(src, torch.Generator(device="cuda").manual_seed(0))
    if name == "swin_tiny":
        torch.save(to_checkpoint(src.net, swin_param_order(src.net.cfg)),
                   str(tmp_path / "swin_tiny" / "pytorch_model.bin"))
    else:
        torch.save(to_checkpoint(src.net, resnet_param_order("resnet50")),
                   str(tmp_path / "resnet50.pth"))
    tower, state, frozen, _ = load_encoder(cfg, None)
    assert len(frozen) == 20
    init_parameters(tower, torch.Generator(device="cuda").manual_seed(1))
    load_net_state(tower.net, state)
    for k, v in src.net.state_dict().items():
        if not k.startswith("fc."):
            assert torch.equal(tower.net.state_dict()[k], v), k
    if name == "resnet50":
        return
    tower.classifier.load_state_dict(src.classifier.state_dict())
    images = torch.randint(0, 256, (64, 224, 224, 3), dtype=torch.uint8,
                           device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(2))
    launched = fused_mha_proj_band.launches, fused_mlp_res.launches
    with torch.no_grad(), eval_mode(src), eval_mode(tower):
        want, got = src(images), tower(images)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert fused_mha_proj_band.launches > launched[0]
    assert fused_mlp_res.launches > launched[1]
