"""The windowed attention's forward kernel (csrc/win_attn.cu, with the
output projection through csrc/gemm.cu) at the edges of its block plan, and
its backward (the attention core csrc/win_attn_bwd.cu, with the products
of csrc/gemm.cu), against the plain version and its autograd on the card. Every test needs an NVIDIA GPU and
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

Backward (fused_mha.cu's tensor-core backward shared through
csrc/mha_mma.cuh, bf16 on m16n8k16 and float32 as 3xTF32): both layouts,
one bias (P = 1) and a bias per window (P = nW) under the shift mask, at
the four Swin-T stages' geometries for two images, and heads of 4 to 128
columns in both dtypes (float32 at dh = 4, which its forward takes in no
head group, through the backward's wrapper alone); dx, dbias and the
four weights' gradients against autograd of the plain version at
chip_smoke.py's GRAD_TOL (max abs error over max(1, the largest plain
value)); dbias and dx the same bits on two runs; and the band layout's
backward partitions and reverses nothing (window_partition and
window_reverse are not called).
"""

import math

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.models.swin import _shift_mask
from idvs.morec_tpu_torch.ops.cuda import attention, lib
from idvs.morec_tpu_torch.ops.cuda.attention import (
    BWD_BODIES, LINEAR_WIDTHS, fused_mha_proj, fused_mha_proj_band,
    fused_mha_proj_band_bwd, fused_mha_proj_band_plain, fused_mha_proj_bwd,
    fused_mha_proj_plain, win_attn_plan)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
TOL = {torch.float32: 1e-4, BF16: 6.25e-2}
GRAD_TOL = {torch.float32: 1e-4, BF16: 3e-2}
SWIN_T = ((96, 3, 56), (192, 6, 28), (384, 12, 14), (768, 24, 7))


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


def _grads(fn, inputs, dout):
    """(output, gradient of every input) of fn at fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, dout))


def _close_grads(got, want, dtype,
                 names=("out", "dx", "dbias", "dwqkv", "dbqkv", "dwo",
                        "dbo")):
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item())
        assert err <= GRAD_TOL[dtype] * scale, (name, err, scale)


def _band_inputs(seed, N, side, C, nh, shifted, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, side, side, C, generator=gen, device="cuda")
    bias = 0.5 * torch.randn(1, nh, 49, 49, generator=gen, device="cuda")
    if shifted:
        bias = bias + torch.from_numpy(
            _shift_mask(side, side, 7, 3)).to("cuda")[:, None]
    dout = torch.randn(N, side, side, C, generator=gen, device="cuda")
    return [x.to(dtype), bias, *_weights(gen, C)], dout.to(dtype)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,nh,side", SWIN_T)
def test_band_backward_at_the_swin_stages(C, nh, side, shifted, dtype):
    """Two images of each Swin-T stage's map, P = 1 or (shifted, where a
    stage has more than one window) P = nW, the map read in place."""
    shifted = shifted and side > 7
    inputs, dout = _band_inputs(C + side, 2, side, C, nh, shifted, dtype)
    kern = lambda *a: fused_mha_proj_band(*a, n_heads=nh, window=7)
    plain = lambda *a: fused_mha_proj_band_plain(*a, n_heads=nh, window=7)
    before = fused_mha_proj_band_bwd.launches
    _close_grads(_grads(kern, inputs, dout), _grads(plain, inputs, dout),
                 dtype)
    assert fused_mha_proj_band_bwd.launches == before + 1


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("C,nh", [(96, 24), (96, 8), (192, 8), (96, 3),
                                  (384, 8), (128, 2), (384, 3)])
def test_window_backward_at_every_head_width(C, nh, dtype):
    """The window layout with a bias per window (P = B / 2 of B = 2P
    windows), heads of dh = 4, 12, 24, 32, 48, 64 and 128 columns: no
    whole 16-byte pieces, zero-filled to 16s, one or more 16-column
    steps. The float32 forward takes head groups of 32 or more columns of
    at most 4 heads, none at dh = 4: there the backward's wrapper runs
    alone on the forward's operands."""
    gen = torch.Generator(device="cuda").manual_seed(C * nh)
    B, P = 10, 5
    x = torch.randn(B, 49, C, generator=gen, device="cuda").to(dtype)
    bias = 0.5 * torch.randn(P, nh, 49, 49, generator=gen, device="cuda")
    dout = torch.randn(B, 49, C, generator=gen, device="cuda").to(dtype)
    inputs = [x, bias, *_weights(gen, C)]
    kern = lambda *a: fused_mha_proj(*a, n_heads=nh)
    plain = lambda *a: fused_mha_proj_plain(*a, n_heads=nh)
    before = fused_mha_proj_bwd.launches
    want = _grads(plain, inputs, dout)
    if dtype == torch.float32 and 4 * (C // nh) < 32:
        ws = [t.to(dtype).contiguous() for t in inputs[2:5]]
        got = fused_mha_proj_bwd(x, bias.float().contiguous(), dout, *ws,
                                 n_heads=nh, code=lib.DTYPE_CODES[dtype])
        _close_grads(got, want[1:], dtype, names=(
            "dx", "dbias", "dwqkv", "dbqkv", "dwo", "dbo"))
    else:
        _close_grads(_grads(kern, inputs, dout), want, dtype)
    assert fused_mha_proj_bwd.launches == before + 1
    assert BWD_BODIES[dtype] in fused_mha_proj_bwd.bodies


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_backward_gives_the_same_bits_on_two_runs(dtype):
    inputs, dout = _band_inputs(7, 3, 28, 192, 6, True, dtype)
    kern = lambda *a: fused_mha_proj_band(*a, n_heads=6, window=7)
    first, second = _grads(kern, inputs, dout), _grads(kern, inputs, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_band_backward_copies_no_windows(monkeypatch):
    """The band layout's backward reads the map through the row index map:
    neither window_partition nor window_reverse runs."""
    inputs, dout = _band_inputs(3, 2, 14, 384, 12, True, BF16)
    out = fused_mha_proj_band(*[t.detach().requires_grad_(True)
                                for t in inputs], n_heads=12, window=7)

    def refuse(*args, **kwargs):
        raise AssertionError("the band backward copied windows")

    monkeypatch.setattr(attention, "window_partition", refuse)
    monkeypatch.setattr(attention, "window_reverse", refuse)
    out.backward(dout)
    torch.cuda.synchronize()
