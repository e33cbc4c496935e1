"""The pre-LN MLP's forward kernel (csrc/premlp.cu) at the edges of its
block plan, against its plain version on the card. Every test needs an
NVIDIA GPU and skips without one. On the card (no jax there, so without
the repo's conftest):

    python -m pytest tests/test_torch_premlp_tiles.py -q --noconftest

bf16 (the tensor-core body): every C of the dispatch list, M on both sides
of a block's rows and of a 16-row fragment, F of one chunk and of several;
with and without the LayerNorm, each activation, each residual edition
(none, unit, a per-row scale), the save_h buffer; the same bits on two
runs; the operands and plans the kernel refuses. float32 (the FMA body)
at a few of the same shapes. Tolerances: chip_smoke.py's TOL, max abs
error against the plain version (bf16: a flipped rounding of the
activation or of the output moves a few bf16 units of values up to ~5;
float32: sums in other orders).
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_ACTS, PRE_F_CHUNK,
                                               _premlp_fwd, fused_mlp,
                                               fused_mlp_plain,
                                               fused_mlp_res,
                                               fused_mlp_res_plain,
                                               premlp_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
TOL = {"fused_mlp": {torch.float32: 1e-4, BF16: 6.25e-2},
       "fused_mlp_res": {torch.float32: 1e-4, BF16: 1e-1}}
WIDTHS = sorted(PRE_F_CHUNK)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(seed, M, C, F, dtype=BF16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    x = (2.0 * g(M, C)).to(dtype)
    mlp = (g(C, F, scale=C ** -0.5), g(F, scale=0.1),
           g(F, C, scale=F ** -0.5), g(C, scale=0.1))
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    keep = torch.rand(M, generator=gen, device="cuda") < 0.9
    return x, mlp, ln, keep.float() / 0.9


def _close(name, got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[name][got.dtype], err


def _edges(C):
    rows = premlp_plan(C, BF16)["rows"]
    return sorted({1, 15, 16, 17, rows - 1, rows, rows + 1, 3 * rows + 5})


@pytest.mark.parametrize("C", WIDTHS)
def test_every_width_at_the_block_edges(C):
    """Each edition at M on both sides of the block and of a fragment."""
    F = 4 * C
    for M in _edges(C):
        x, mlp, ln, scale = _inputs(M * 7 + C, M, C, F)
        before = fused_mlp.launches, fused_mlp_res.launches
        _close("fused_mlp", fused_mlp(x, *mlp, ln=ln),
               fused_mlp_plain(x, *mlp, ln=ln))
        _close("fused_mlp", fused_mlp(x, *mlp, ln=None),
               fused_mlp_plain(x, *mlp, ln=None))
        for s in (None, scale):
            _close("fused_mlp_res", fused_mlp_res(x, s, *mlp, ln=ln),
                   fused_mlp_res_plain(x, s, *mlp, ln=ln))
        assert (fused_mlp.launches, fused_mlp_res.launches) == (
            before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("act", sorted(PRE_ACTS))
@pytest.mark.parametrize("C", WIDTHS)
def test_each_activation_and_chunk_count(C, act):
    """F of one chunk of the float32 body and of several."""
    for F in (PRE_F_CHUNK[C], 4 * C):
        x, mlp, ln, scale = _inputs(C + F, 300, C, F)
        _close("fused_mlp", fused_mlp(x, *mlp, ln=ln, act=act),
               fused_mlp_plain(x, *mlp, ln=ln, act=act))
        _close("fused_mlp_res", fused_mlp_res(x, scale, *mlp, ln=ln, act=act),
               fused_mlp_res_plain(x, scale, *mlp, ln=ln, act=act))


@pytest.mark.parametrize("C", WIDTHS)
def test_save_h_stores_the_cast_pre_activation(C):
    M, F = 131, 4 * C
    x, (w1, b1, w2, b2), ln, _ = _inputs(C, M, C, F)
    h = torch.empty(M, F, dtype=BF16, device="cuda")
    ops = [t.to(BF16).contiguous() for t in (w1, b1, w2, b2)]
    lnf = [t.float().contiguous() for t in ln]
    out = _premlp_fwd("fused_mlp", x, None, ops, lnf, 1e-5, "gelu", 0,
                      lib.DTYPE_CODES[BF16], h)
    _close("fused_mlp", out, fused_mlp_plain(x, w1, b1, w2, b2, ln=ln))
    xn = torch.nn.functional.layer_norm(x.float(), (C,), lnf[0], lnf[1],
                                        1e-5).to(BF16)
    want = (xn.float() @ ops[0].float() + ops[1].float()).to(BF16)
    torch.cuda.synchronize()
    assert (h.float() - want.float()).abs().max().item() <= \
        2 ** -7 * want.float().abs().max().item() + 1e-2


@pytest.mark.parametrize("C", (96, 768))
def test_two_runs_give_the_same_bits(C):
    x, mlp, ln, scale = _inputs(5, 1000, C, 4 * C)
    a = fused_mlp_res(x, scale, *mlp, ln=ln)
    b = fused_mlp_res(x, scale, *mlp, ln=ln)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("C", (96, 384))
def test_float32_edition(C):
    x, mlp, ln, scale = _inputs(9, 257, C, 4 * C, torch.float32)
    _close("fused_mlp", fused_mlp(x, *mlp, ln=ln),
           fused_mlp_plain(x, *mlp, ln=ln))
    _close("fused_mlp_res", fused_mlp_res(x, scale, *mlp, ln=ln),
           fused_mlp_res_plain(x, scale, *mlp, ln=ln))


def test_refuses_what_the_kernel_does_not_take():
    x, mlp, ln, _ = _inputs(3, 64, 96, 384)
    with pytest.raises(ValueError, match="takes C in"):
        fused_mlp(x[:, :80].contiguous(), mlp[0][:80], mlp[1],
                  mlp[2][:, :80], mlp[3][:80], ln=None)
    with pytest.raises(ValueError, match="multiple of 96"):
        fused_mlp(x, mlp[0][:, :200], mlp[1][:200], mlp[2][:200], mlp[3])
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.empty(64 * 96 + 1, dtype=BF16, device="cuda")
        fused_mlp(buf[1:].view(64, 96), *mlp, ln=ln)
    # a plan other than the one built for C and the dtype
    ops = [t.to(BF16).contiguous() for t in mlp]
    out = torch.empty_like(x)
    k = premlp_plan(96, BF16)
    for bad in (dict(rows=k["rows"] // 2), dict(f_chunk=32),
                dict(threads=512), dict(smem=k["smem"] + 16)):
        p = {**k, **bad}
        err = lib.library().idvs_premlp_fwd(
            x.data_ptr(), *(t.data_ptr() for t in ops), None, None, None,
            out.data_ptr(), None, 64, 96, 384, 1e-5, 0, 0, p["rows"],
            p["f_chunk"], p["threads"], p["smem"], lib.DTYPE_CODES[BF16],
            lib.stream_handle(x))
        assert err == 1, bad    # cudaErrorInvalidValue
