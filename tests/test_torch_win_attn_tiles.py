"""The windowed attention's forward kernel (csrc/win_attn.cu, with the
output projection through csrc/gemm.cu) at the edges of its block plan,
against its plain version on the card. Every test needs an NVIDIA GPU and
skips without one. On the card (no jax there, so without the repo's
conftest):

    python -m pytest tests/test_torch_win_attn_tiles.py -q --noconftest

bf16 (the tensor-core body): every C the kernel takes, numbers of windows
on both sides of a block's windows; the band layout with one bias and with
a bias per window under the shift mask, and the window layout; T = 49 and
other windows (T = 16, 64, 144, one token); heads whose dh the kernel
zero-fills to a multiple of 16 (dh = 4, 12, 24, 48); the same bits on two runs;
the geometries and plans the kernel refuses. float32 (the FMA body) at a
few of the same shapes. Tolerances: chip_smoke.py's TOL, max abs error
against the plain version (bf16: one or two units of 2^-7 relative after
the casts of qkv, the probabilities and the context; float32: sums in
other orders).
"""

import math

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.models.swin import _shift_mask
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.attention import (
    LINEAR_WIDTHS, fused_mha_proj, fused_mha_proj_band,
    fused_mha_proj_band_plain, fused_mha_proj_plain, win_attn_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
TOL = {torch.float32: 1e-4, BF16: 6.25e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _weights(gen, C):
    g = lambda *s, scale: torch.randn(*s, generator=gen,
                                      device="cuda") * scale
    return (g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
            g(C, C, scale=C ** -0.5), g(C, scale=0.1))


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[got.dtype], err


def _windows(seed, B, T, C, nh, P, dtype=BF16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, C, generator=gen, device="cuda").to(dtype)
    bias = 0.5 * torch.randn(P, nh, T, T, generator=gen, device="cuda")
    return x, bias, _weights(gen, C)


def _check_windows(seed, B, T, C, nh, P, dtype=BF16):
    x, bias, ws = _windows(seed, B, T, C, nh, P, dtype)
    before = fused_mha_proj.launches
    _close(fused_mha_proj(x, bias, *ws, n_heads=nh),
           fused_mha_proj_plain(x, bias, *ws, n_heads=nh))
    assert fused_mha_proj.launches == before + 1


@pytest.mark.parametrize("C", LINEAR_WIDTHS)
def test_every_width_at_the_block_edges(C):
    """Heads of 32 columns, windows on both sides of a block's G."""
    nh = max(1, C // 32)
    G = win_attn_plan(49, C, nh)["G"]
    for B in sorted({1, G - 1, G, G + 1, 5 * G + 1} - {0}):
        _check_windows(B * 31 + C, B, 49, C, nh, 1 if B % 2 else B)


@pytest.mark.parametrize("T,C,nh", [(16, 32, 2), (64, 64, 2), (144, 128, 4),
                                    (1, 32, 1), (49, 96, 24), (49, 96, 8),
                                    (49, 192, 8), (49, 96, 2), (49, 384, 3)])
def test_other_windows_and_padded_heads(T, C, nh):
    """T = 16 (one fragment of tokens), 64 (no padding), 144 (three key
    blocks, several projection passes), 1; dh = 4 and 12 (no whole 16-byte
    pieces), 24 (zero-filled to 32), 48, and 128 (a head
    group of one head, two output column blocks)."""
    for B in (1, 7):
        _check_windows(T + C + B, B, T, C, nh, B)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,nh,side", [(96, 3, 56), (192, 6, 28),
                                       (384, 12, 14), (768, 24, 7)])
def test_band_layout_at_the_swin_stages(C, nh, side, shifted):
    """Two images of each Swin-T stage's map, one bias or a bias per window
    with the shift mask's -100."""
    gen = torch.Generator(device="cuda").manual_seed(C)
    x = torch.randn(2, side, side, C, generator=gen, device="cuda").to(BF16)
    bias = 0.5 * torch.randn(1, nh, 49, 49, generator=gen, device="cuda")
    if shifted and side > 7:
        bias = bias + torch.from_numpy(
            _shift_mask(side, side, 7, 3)).to("cuda")[:, None]
    ws = _weights(gen, C)
    before = fused_mha_proj_band.launches
    _close(fused_mha_proj_band(x, bias, *ws, n_heads=nh, window=7),
           fused_mha_proj_band_plain(x, bias, *ws, n_heads=nh, window=7))
    assert fused_mha_proj_band.launches == before + 1


def test_two_runs_give_the_same_bits():
    x, bias, ws = _windows(3, 333, 49, 96, 3, 1)
    a = fused_mha_proj(x, bias, *ws, n_heads=3)
    b = fused_mha_proj(x, bias, *ws, n_heads=3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("C,nh", [(96, 3), (768, 24)])
def test_float32_edition(C, nh):
    _check_windows(C, 9, 49, C, nh, 3, torch.float32)


def test_refuses_what_the_kernel_does_not_take():
    x, bias, ws = _windows(1, 4, 49, 768, 3, 1)
    with pytest.raises(ValueError, match="no blocking"):   # dh = 256
        fused_mha_proj(x, bias, *ws, n_heads=3)
    x, bias, ws = _windows(1, 4, 49, 80, 2, 1)
    with pytest.raises(ValueError, match="takes C in"):
        fused_mha_proj(x, bias, *ws, n_heads=2)
    # a plan other than the one built for the geometry
    x, bias, ws = _windows(2, 4, 49, 96, 3, 1)
    ctx, out = torch.empty_like(x), torch.empty_like(x)
    ops = [t.to(BF16).contiguous() for t in ws]
    table = bias.float().contiguous()
    k = win_attn_plan(49, 96, 3)
    for bad in (dict(t_pad=48), dict(dh_pad=48), dict(HG=2),
                dict(warps_n=1), dict(passes=2), dict(smem=k["smem"] + 16)):
        p = {**k, **bad}
        err = lib.library().idvs_win_attn_fwd(
            x.data_ptr(), table.data_ptr(), *(t.data_ptr() for t in ops),
            ctx.data_ptr(), out.data_ptr(), 4, 49, 96, 3, 1,
            table.stride(0), table.stride(1), 0, 0, 0, 0,
            1.0 / math.sqrt(32), *(p[n] for n in (
                "G", "HG", "t_pad", "dh_pad", "warps_m", "warps_n", "passes",
                "smem")), lib.DTYPE_CODES[BF16], lib.stream_handle(x))
        assert err == 1, bad    # cudaErrorInvalidValue
