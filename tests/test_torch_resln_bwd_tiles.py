"""The post-LN tails' backward (csrc/resln_bwd_wg.cu on the fused route,
csrc/resln_bwd.cu and csrc/gemm.cu on the products route) at the edges of
the fused kernels' block plan, both routes, against autograd of the plain
versions on the card. Every test needs an NVIDIA GPU and skips without
one. On the card (no jax there, so without the repo's conftest):

    python -m pytest tests/test_torch_resln_bwd_tiles.py -q --noconftest

bf16, each tail (the FFN tail's mlp_resln_bwd_wg_kernel, the projection
tail's proj_resln_bwd_wg_kernel) on both routes at every C the fused
kernels are built for (128, 256, 512): M on both sides of a block's 64
rows, which are one warpgroup product's rows (1, 63, 64, 65, 300), F of
the forward's one chunk (one 64-column chunk of the backward's walk at C =
128) and of several; each activation and dropout 0 and 0.1
through the wrappers' autograd; the same bits on two runs; the plans and
operands the kernels refuse. Tolerance: chip_smoke.py's GRAD_TOL, max abs
error over max(1, max |plain value|) of each gradient (bf16 rounds dz,
g, dh and the gradients once each, the plain version's float dz and dg
round elsewhere: a few units of bf16 on the largest value).
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (
    ACTS, fused_mlp_resln, fused_mlp_resln_bwd,
    fused_mlp_resln_plain, fused_mlp_resln_res, fused_proj_resln,
    fused_proj_resln_bwd, fused_proj_resln_plain, fused_proj_resln_res,
    mlp_resln_bwd_fused, mlp_resln_plan, proj_resln_bwd_fused,
    RESLN_BWD_ROUTES, resln_bwd_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
CODE = 1                 # lib.DTYPE_CODES[BF16]
GRAD_TOL = 3e-2
EPS = 1e-5
WIDTHS = (128, 256, 512)
ROWS = (1, 63, 64, 65, 300)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(tail, seed, M, C, F):
    """x (and res) bf16, the weights and biases float32 (w, b for the
    projection; w1, b1, w2, b2 for the FFN), the LayerNorm's (scale,
    bias), dout bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    x = (2.0 * g(M, C)).to(BF16)
    if tail == "mlp":
        ops = (g(C, F, scale=C ** -0.5), g(F, scale=0.1),
               g(F, C, scale=F ** -0.5), g(C, scale=0.1))
    else:
        ops = (g(M, C).to(BF16), g(C, C, scale=C ** -0.5), g(C, scale=0.1))
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    return x, ops, ln, g(M, C).to(BF16)


def _plain(tail, leaves, act, p, seed):
    kw = dict(eps=EPS, drop_rate=p, seed=seed if p else None)
    if tail == "mlp":
        return fused_mlp_resln_plain(*leaves[:5], ln=leaves[5:], act=act,
                                     **kw)
    return fused_proj_resln_plain(*leaves[:4], ln=leaves[4:], **kw)


def _want(tail, x, ops, ln, dout, act, p, seed):
    """Autograd of the plain version: the FFN's (dx, dw1, db1, dw2, db2,
    dgamma, dbeta), the projection's (dx, dres, dw, db, dgamma, dbeta)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, *ops, *ln)]
    out = _plain(tail, leaves, act, p, seed)
    return torch.autograd.grad(out, leaves, dout)


def _route(tail, route, x, ops, ln, dout, act, p, seed):
    """One route's backward on the saved tensors of the kernels' training
    forward, in the order of _want."""
    drop = dropout.kernel_args(p, seed if p else None)
    if tail == "mlp":
        w = [t.to(BF16).contiguous() for t in ops]
        _, ypre, h = fused_mlp_resln_res(x, *w, *ln, eps=EPS, act=act,
                                         drop=drop, code=CODE)
        return RESLN_BWD_ROUTES[tail][route](x, w[0], w[2], ln[0], ypre, h,
                                             dout, EPS, act, drop, CODE)
    res, w, b = ops[0], ops[1].to(BF16).contiguous(), ops[2].to(BF16)
    _, ypre = fused_proj_resln_res(x, res, w, b, *ln, eps=EPS, drop=drop,
                                   code=CODE)
    return RESLN_BWD_ROUTES[tail][route](x, w, ln[0], ypre, dout, EPS, drop,
                                         CODE)


def _check(got, want, what):
    torch.cuda.synchronize()
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL * scale, (what, i, err, scale)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("tail", ("mlp", "proj"))
def test_both_routes_at_the_block_edges(tail, C, M):
    i = ROWS.index(M)
    # the forward's F chunk (one 64-column chunk of the backward at C =
    # 128, two and four above), and several
    F = mlp_resln_plan(C, BF16)["f_chunk"] if i % 2 else 4 * C
    act = sorted(ACTS)[(i + C // 128) % 3]
    p, seed = (0.1, 11 + i) if i % 2 == 0 else (0.0, None)
    x, ops, ln, dout = _case(tail, 100 * C + M, M, C, F)
    want = _want(tail, x, ops, ln, dout, act, p, seed)
    for route in ("fused", "products"):
        got = _route(tail, route, x, ops, ln, dout, act, p, seed)
        _check(got, want, f"{tail} {route} C={C} M={M} F={F} {act} p={p}")


@pytest.mark.parametrize("p", (0.0, 0.1))
@pytest.mark.parametrize("act", sorted(ACTS))
def test_each_activation_through_the_wrappers(act, p):
    """fused_mlp_resln and fused_proj_resln with a gradient: the training
    forward, then the backward on the fused route, the wrappers' bodies
    naming its kernel."""
    M, C, F, seed = 200, 512, 2048, 5
    for tail in ("mlp", "proj"):
        x, ops, ln, dout = _case(tail, 3, M, C, F)
        want = _want(tail, x, ops, ln, dout, act, p, seed)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, *ops, *ln)]
        kw = dict(eps=EPS, drop_rate=p, seed=seed if p else None)
        wrapper = fused_mlp_resln_bwd if tail == "mlp" else \
            fused_proj_resln_bwd
        wrapper.bodies = set()
        if tail == "mlp":
            out = fused_mlp_resln(*leaves[:5], ln=leaves[5:], act=act, **kw)
        else:
            out = fused_proj_resln(*leaves[:4], ln=leaves[4:], **kw)
        got = torch.autograd.grad(out, leaves, dout)
        _check(got, want, f"{tail} {act} p={p}")
        assert wrapper.bodies == set(resln_bwd_plan(tail, C, M,
                                                    BF16)["kernels"])
        assert f"{tail}_resln_bwd_wg_kernel" in wrapper.bodies


@pytest.mark.parametrize("tail", ("mlp", "proj"))
def test_two_runs_give_the_same_bits(tail):
    M, C = 1000, 512
    x, ops, ln, dout = _case(tail, 9, M, C, 4 * C)
    one = _route(tail, "fused", x, ops, ln, dout, "gelu", 0.1, 4)
    two = _route(tail, "fused", x, ops, ln, dout, "gelu", 0.1, 4)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_the_plans_route_bf16_at_c_up_to_512_to_the_fused_kernels():
    for tail in ("mlp", "proj"):
        for C in WIDTHS:
            assert resln_bwd_plan(tail, C, 23040, BF16)["route"] == "fused"
            assert resln_bwd_plan(tail, C, 23040,
                                  torch.float32)["route"] == "products"
        assert resln_bwd_plan(tail, 2048, 640, BF16)["route"] == "products"


def test_refuses_what_the_fused_kernels_do_not_take():
    M, C, F = 100, 512, 2048
    x, ops, ln, dout = _case("mlp", 1, M, C, F)
    w = [t.to(BF16).contiguous() for t in ops]
    drop = dropout.kernel_args(0.0, None)
    _, ypre, h = fused_mlp_resln_res(x, *w, *ln, eps=EPS, act="gelu",
                                     drop=drop, code=CODE)
    args = (x, w[0], w[2], ln[0], ypre, h, dout, EPS, "gelu", drop, CODE)
    # float32 operands and C = 2048 have no fused kernel
    with pytest.raises(ValueError):
        mlp_resln_bwd_fused(x.float(), w[0].float(), w[2].float(), ln[0],
                            ypre.float(), h.float(), dout.float(), EPS,
                            "gelu", drop, 0)
    with pytest.raises(ValueError):
        proj_resln_bwd_fused(torch.zeros(M, 2048, dtype=BF16, device="cuda"),
                             torch.zeros(2048, 2048, dtype=BF16,
                                         device="cuda"),
                             torch.ones(2048, device="cuda"),
                             torch.zeros(M, 2048, dtype=BF16, device="cuda"),
                             torch.zeros(M, 2048, dtype=BF16, device="cuda"),
                             EPS, drop, CODE)
    # F not a whole number of chunks
    with pytest.raises(ValueError):
        mlp_resln_bwd_fused(x, w[0][:, :96].contiguous(),
                            w[2][:96].contiguous(), ln[0], ypre,
                            h[:, :96].contiguous(), dout, EPS, "gelu", drop,
                            CODE)
    # a block plan the kernel was not built with
    k = resln_bwd_plan("mlp", C, M, BF16)
    E = 3 * C + F
    scratch = [torch.empty(n, device="cuda")
               for n in (k["blocks"] * E, k["groups"] * E, E)]
    outs = [torch.empty_like(x), torch.empty_like(h), torch.empty_like(h),
            torch.empty_like(x)]
    for bad in (dict(rows=32), dict(chunk=128), dict(threads=256),
                dict(smem=k["smem"] - 16)):
        plan = dict(k, **bad)
        err = lib.library().idvs_mlp_resln_bwd_wg(
            ypre.data_ptr(), dout.data_ptr(), ln[0].data_ptr(),
            h.data_ptr(), w[0].data_ptr(), w[2].data_ptr(),
            *(t.data_ptr() for t in outs), *(t.data_ptr() for t in scratch),
            M, C, F, EPS, 0, *drop, k["per"], plan["rows"], plan["chunk"],
            plan["threads"], plan["smem"], CODE, lib.stream_handle(x))
        assert err != 0, bad
    # the good plan runs
    assert mlp_resln_bwd_fused(*args)[0].shape == x.shape
