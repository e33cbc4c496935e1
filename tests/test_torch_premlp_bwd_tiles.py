"""The pre-LN MLP's backward (csrc/premlp_bwd.cu) at the edges of its
block plan, both routes, against autograd of the plain version on the
card. Every test needs an NVIDIA GPU and skips without one. On the card
(no jax there, so without the repo's conftest):

    python -m pytest tests/test_torch_premlp_bwd_tiles.py -q --noconftest

bf16, the fused route (premlp_bwd_mma_kernel) at every C it is built for:
M on both sides of a block's rows and of a 16-row fragment, F of one
chunk and of several; each edition (fused_mlp_res unit and scaled,
fused_mlp with and without its LayerNorm and with the saved h) and each
activation on both routes (the fused kernel and gemm.cu's products); the
same bits on two runs; the plans and operands the kernel refuses.
Tolerance: chip_smoke.py's GRAD_TOL, max abs error over max(1, max |plain
value|) of each gradient (bf16 rounds dy, g, dh and the gradients once
each, the plain version's float dy and dg round elsewhere: a few units of
bf16 on the largest value).
"""

import pytest
import torch

from idvs.morec_tpu_torch.models.layers import layer_norm
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_ACTS, PREMLP_BWD_ROUTES,
                                               _PRE_BWD_MMA, fused_mlp_bwd,
                                               fused_mlp_plain,
                                               fused_mlp_res_bwd,
                                               fused_mlp_res_plain,
                                               premlp_bwd_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
CODE = 1                 # lib.DTYPE_CODES[BF16]
GRAD_TOL = 3e-2
EPS = 1e-5
WIDTHS = sorted(_PRE_BWD_MMA)
EDITIONS = ("unit", "scaled", "LN", "no LN", "save_h LN", "save_h no LN")


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed, M, C, F):
    """x, dout (M, C) bf16; w1, b1, w2, b2 and the LayerNorm's (scale,
    bias) float32; DropPath's row scale, kept rows 1 / 0.9."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    x, dout = (2.0 * g(M, C)).to(BF16), g(M, C).to(BF16)
    mlp = (g(C, F, scale=C ** -0.5), g(F, scale=0.1),
           g(F, C, scale=F ** -0.5), g(C, scale=0.1))
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    keep = torch.rand(M, generator=gen, device="cuda") < 0.9
    return x, dout, mlp, ln, keep.float() / 0.9


def _saved_h(x, mlp, ln, act):
    """The save_h edition's stored h: cast(dense1(maybe_LN(x))), as the
    plain version computes it."""
    xn = x if ln is None else layer_norm(x, ln[0], ln[1], EPS)
    return (xn.float() @ mlp[0].to(BF16).float()
            + mlp[1].to(BF16).float()).to(BF16)


def _want(edition, x, dout, mlp, ln, scale, act):
    """Autograd of the plain version: (dx, dw1, db1, dw2, db2, dgamma,
    dbeta), the last two None without the LayerNorm."""
    with_ln = "no LN" not in edition
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, *mlp, *(ln if with_ln else ()))]
    lnl = tuple(leaves[5:]) or None
    if edition in ("unit", "scaled"):
        out = fused_mlp_res_plain(leaves[0],
                                  scale if edition == "scaled" else None,
                                  *leaves[1:5], ln=lnl, eps=EPS, act=act)
    else:
        out = fused_mlp_plain(leaves[0], *leaves[1:5], ln=lnl, eps=EPS,
                              act=act, save_h=edition.startswith("save_h"))
    grads = list(torch.autograd.grad(out, leaves, dout))
    return grads + [None] * (7 - len(grads))


def _got(route, edition, x, dout, mlp, ln, scale, act):
    """The kernel's gradients through `route` ("fused", "products", or
    None: the plan's, through the counted wrappers)."""
    with_ln = "no LN" not in edition
    w1, b1, w2 = (t.to(BF16).contiguous() for t in mlp[:3])
    lnf = ([t.float().contiguous() for t in ln] if with_ln
           else [None, None])
    h = (_saved_h(x, mlp, ln if with_ln else None, act)
         if edition.startswith("save_h") else None)
    res = edition in ("unit", "scaled")
    s = scale if edition == "scaled" else None
    if route is not None:
        return PREMLP_BWD_ROUTES[route](x, dout, s, w1, b1, w2, lnf, h, EPS,
                                        act, res, CODE)
    if res:
        return fused_mlp_res_bwd(x, dout, s, w1, b1, w2, lnf, eps=EPS,
                                 act=act, code=CODE)
    return fused_mlp_bwd(x, dout, w1, b1, w2, lnf, h, eps=EPS, act=act,
                         code=CODE)


def _close(got, want):
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
            continue
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert torch.isfinite(a).all(), i
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= GRAD_TOL * scale, (i, err, scale)


def _edges(C):
    rows = premlp_bwd_plan(C, 1, BF16)["rows"]
    return sorted({1, 15, 16, 17, rows - 1, rows, rows + 1, 3 * rows + 5})


@pytest.mark.parametrize("C", WIDTHS)
def test_every_width_at_the_block_edges(C):
    """The plan's route at M on both sides of the block and of a fragment,
    F of one chunk and of several, each LayerNorm edition."""
    fc = premlp_bwd_plan(C, 1, BF16)["f_chunk"]
    fused_mlp_res_bwd.bodies.clear()
    for F in (fc, 4 * C):
        for M in _edges(C):
            x, dout, mlp, ln, scale = _case(M * 7 + C + F, M, C, F)
            for edition in ("scaled", "unit", "LN", "no LN"):
                res = edition in ("unit", "scaled")
                counter = fused_mlp_res_bwd if res else fused_mlp_bwd
                before = counter.launches
                _close(_got(None, edition, x, dout, mlp, ln, scale, "gelu"),
                       _want(edition, x, dout, mlp, ln, scale, "gelu"))
                assert counter.launches == before + 1
    assert "premlp_bwd_mma_kernel" in fused_mlp_res_bwd.bodies
    assert "colsum_kernel" not in fused_mlp_res_bwd.bodies


@pytest.mark.parametrize("route", ("fused", "products"))
@pytest.mark.parametrize("act", sorted(PRE_ACTS))
@pytest.mark.parametrize("C", WIDTHS)
def test_each_edition_and_activation_on_both_routes(C, act, route):
    M, F = 300, 2 * premlp_bwd_plan(C, 1, BF16)["f_chunk"]
    x, dout, mlp, ln, scale = _case(C + len(act), M, C, F)
    for edition in EDITIONS:
        _close(_got(route, edition, x, dout, mlp, ln, scale, act),
               _want(edition, x, dout, mlp, ln, scale, act))


@pytest.mark.parametrize("C,M", [(96, 4000), (192, 1000), (384, 300)])
def test_two_runs_give_the_same_bits(C, M):
    x, dout, mlp, ln, scale = _case(5, M, C, 4 * C)
    for edition in ("scaled", "no LN"):
        a = _got("fused", edition, x, dout, mlp, ln, scale, "gelu")
        b = _got("fused", edition, x, dout, mlp, ln, scale, "gelu")
        torch.cuda.synchronize()
        for u, v in zip(a, b):
            assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("C", (96, 384))
def test_swin_stage_rows_on_the_fused_route(C):
    """A Swin-T stage's widths at a few images' rows (F = 4C)."""
    M = 49 * 7 * (56 * 56 // 49 if C == 96 else 4)
    x, dout, mlp, ln, scale = _case(11, M, C, 4 * C)
    _close(_got(None, "scaled", x, dout, mlp, ln, scale, "gelu"),
           _want("scaled", x, dout, mlp, ln, scale, "gelu"))


def _entry(x, dout, w1, b1, w2, lnf, outs, M, C, F, k, dtype=CODE):
    """idvs_premlp_bwd with the plan k (fused_mlp with its LayerNorm)."""
    dx, xn, g, dh, part, part2, sums = outs
    return lib.library().idvs_premlp_bwd(
        x.data_ptr(), dout.data_ptr(), None, lnf[0].data_ptr(),
        lnf[1].data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), None,
        dx.data_ptr(), xn.data_ptr(), None, g.data_ptr(), dh.data_ptr(),
        part.data_ptr(), part2.data_ptr(), sums.data_ptr(), M, C, F, EPS, 0,
        0, k["per"], k["rows"], k["f_chunk"], k["threads"], k["smem"],
        dtype, lib.stream_handle(x))


def test_refuses_what_the_kernel_does_not_take():
    M, C, F = 64, 96, 384
    x, dout, mlp, ln, _ = _case(3, M, C, F)
    w1, b1, w2 = (t.to(BF16).contiguous() for t in mlp[:3])
    lnf = [t.float().contiguous() for t in ln]
    k = premlp_bwd_plan(C, M, BF16)
    E = 3 * C + F
    outs = (torch.empty_like(x), torch.empty_like(x),
            torch.empty(M, F, dtype=BF16, device="cuda"),
            torch.empty(M, F, dtype=BF16, device="cuda"),
            torch.empty(k["blocks"] * E, device="cuda"),
            torch.empty(k["groups"] * E, device="cuda"),
            torch.empty(E, device="cuda"))
    assert _entry(x, dout, w1, b1, w2, lnf, outs, M, C, F, k) == 0
    # a plan other than the one built for C
    for bad in (dict(rows=k["rows"] // 2), dict(f_chunk=64),
                dict(threads=512), dict(smem=k["smem"] + 16)):
        assert _entry(x, dout, w1, b1, w2, lnf, outs, M, C, F,
                      {**k, **bad}) == 1, bad       # cudaErrorInvalidValue
    # F not a multiple of the chunk, float32, a width with no kernel
    assert _entry(x, dout, w1, b1, w2, lnf, outs, M, C, F - 16, k) == 1
    assert _entry(x, dout, w1, b1, w2, lnf, outs, M, C, F, k, dtype=0) == 1
    assert _entry(x, dout, w1, b1, w2, lnf, outs, M, 160, F, k) == 1
    # the routes the plan does not name
    x32 = x.float()
    with pytest.raises(ValueError, match="no fused kernel"):
        PREMLP_BWD_ROUTES["fused"](x32, dout.float(), None, *mlp[:3], lnf,
                                   None, EPS, "gelu", False, 0)
    assert premlp_bwd_plan(512, M, BF16)["route"] == "wg"
    assert premlp_bwd_plan(C, M, torch.float32)["route"] == "products"
    # a dout whose rows are not 16-byte aligned
    buf = torch.empty(M * C + 1, dtype=BF16, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp_bwd(x, buf[1:].view(M, C), w1, b1, w2, lnf, None, eps=EPS,
                      act="gelu", code=CODE)
