"""The pre-LN MLP's forward kernel (csrc/premlp.cu) at the edges of its
block plan, against its plain version on the card. Every test needs an
NVIDIA GPU and skips without one. On the card (no jax there, so without
the repo's conftest):

    python -m pytest tests/test_torch_premlp_tiles.py -q --noconftest

Both bodies (bf16 and float32 as 3xTF32, each on the tensor cores): every
C of the dispatch list, M on both sides of a block's rows and of a 16-row
fragment, F of one chunk and of several; with and without the LayerNorm,
each activation, each residual edition (none, unit, a per-row scale), the
save_h buffer; the same bits on two runs; the operands and plans the
kernel refuses; the device kernel each wrapper names in its ``bodies``.
Tolerances: chip_smoke.py's TOL, max abs error against the plain version
(bf16: a flipped rounding of the activation or of the output moves a few
bf16 units of values up to ~5; float32: sums in other orders, and
3xTF32's dropped small.small term, 2^-22 of a product).
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_ACTS, PRE_BODIES,
                                               PRE_F_CHUNK, _premlp_fwd,
                                               fused_mlp,
                                               fused_mlp_plain,
                                               fused_mlp_res,
                                               fused_mlp_res_plain,
                                               premlp_plan)

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = (BF16, F32)
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


def _edges(C, dtype):
    rows = premlp_plan(C, dtype)["rows"]
    return sorted({1, 15, 16, 17, rows - 1, rows, rows + 1, 3 * rows + 5})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", WIDTHS)
def test_every_width_at_the_block_edges(C, dtype):
    """Each edition at M on both sides of the block and of a fragment."""
    F = 4 * C
    fused_mlp.bodies.clear()
    fused_mlp_res.bodies.clear()
    for M in _edges(C, dtype):
        x, mlp, ln, scale = _inputs(M * 7 + C, M, C, F, dtype)
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
    assert fused_mlp.bodies == fused_mlp_res.bodies == {PRE_BODIES[dtype]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", sorted(PRE_ACTS))
@pytest.mark.parametrize("C", WIDTHS)
def test_each_activation_and_chunk_count(C, act, dtype):
    """F of one chunk of the body, of the wrappers' chunk and of several;
    a chunk of the body below the wrappers' through the launch itself."""
    for F in sorted({premlp_plan(C, dtype)["f_chunk"], PRE_F_CHUNK[C],
                     4 * C}):
        x, mlp, ln, scale = _inputs(C + F, 300, C, F, dtype)
        if F % PRE_F_CHUNK[C]:
            ops = [t.to(dtype).contiguous() for t in mlp]
            lnf = [t.float().contiguous() for t in ln]
            _close("fused_mlp", _premlp_fwd(
                "fused_mlp", x, None, ops, lnf, 1e-5, act, 0,
                lib.DTYPE_CODES[dtype]),
                fused_mlp_plain(x, *mlp, ln=ln, act=act))
            continue
        _close("fused_mlp", fused_mlp(x, *mlp, ln=ln, act=act),
               fused_mlp_plain(x, *mlp, ln=ln, act=act))
        _close("fused_mlp_res", fused_mlp_res(x, scale, *mlp, ln=ln, act=act),
               fused_mlp_res_plain(x, scale, *mlp, ln=ln, act=act))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", WIDTHS)
def test_save_h_stores_the_cast_pre_activation(C, dtype):
    M, F = 131, 4 * C
    x, (w1, b1, w2, b2), ln, _ = _inputs(C, M, C, F, dtype)
    h = torch.empty(M, F, dtype=dtype, device="cuda")
    ops = [t.to(dtype).contiguous() for t in (w1, b1, w2, b2)]
    lnf = [t.float().contiguous() for t in ln]
    out = _premlp_fwd("fused_mlp", x, None, ops, lnf, 1e-5, "gelu", 0,
                      lib.DTYPE_CODES[dtype], h)
    _close("fused_mlp", out, fused_mlp_plain(x, w1, b1, w2, b2, ln=ln))
    xn = torch.nn.functional.layer_norm(x.float(), (C,), lnf[0], lnf[1],
                                        1e-5).to(dtype)
    want = (xn.float() @ ops[0].float() + ops[1].float()).to(dtype)
    torch.cuda.synchronize()
    # bf16: a flipped rounding of h; float32: sums in other orders
    rel, floor = (2 ** -7, 1e-2) if dtype == BF16 else (1e-5, 1e-5)
    assert (h.float() - want.float()).abs().max().item() <= \
        rel * want.float().abs().max().item() + floor


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", (96, 768))
def test_two_runs_give_the_same_bits(C, dtype):
    x, mlp, ln, scale = _inputs(5, 1000, C, 4 * C, dtype)
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_refuses_what_the_kernel_does_not_take(dtype):
    x, mlp, ln, _ = _inputs(3, 64, 96, 384, dtype)
    with pytest.raises(ValueError, match="takes C in"):
        fused_mlp(x[:, :80].contiguous(), mlp[0][:80], mlp[1],
                  mlp[2][:, :80], mlp[3][:80], ln=None)
    with pytest.raises(ValueError, match="multiple of 96"):
        fused_mlp(x, mlp[0][:, :200], mlp[1][:200], mlp[2][:200], mlp[3])
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.empty(64 * 96 + 1, dtype=dtype, device="cuda")
        fused_mlp(buf[1:].view(64, 96), *mlp, ln=ln)
    # a plan other than the one built for C and the dtype, the other
    # dtype's among them
    ops = [t.to(dtype).contiguous() for t in mlp]
    out = torch.empty_like(x)
    k = premlp_plan(96, dtype)
    other = premlp_plan(96, F32 if dtype == BF16 else BF16)
    for bad in (dict(rows=k["rows"] // 2), dict(f_chunk=32),
                dict(threads=512), dict(smem=k["smem"] + 16),
                {n: other[n] for n in ("rows", "f_chunk", "threads",
                                       "smem")}):
        p = {**k, **bad}
        err = lib.library().idvs_premlp_fwd(
            x.data_ptr(), *(t.data_ptr() for t in ops), None, None, None,
            out.data_ptr(), None, 64, 96, 384, 1e-5, 0, 0, p["rows"],
            p["f_chunk"], p["threads"], p["smem"], lib.DTYPE_CODES[dtype],
            lib.stream_handle(x))
        assert err == 1, bad    # cudaErrorInvalidValue
