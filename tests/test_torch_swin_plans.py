"""The block plans of the two Swin forward kernels (csrc/premlp.cu and
csrc/win_attn.cu), which the launch passes to the kernel, and the window
kernel's padding in plain PyTorch.

The plans: every Swin-T and Swin-B stage (C 96-1024, F = 4C, dh 32, T 49)
gets a bf16 plan within the 227 KB of shared memory a block may use, cut
into whole m16 / n8 / k16 fragments, and every width and head geometry the
kernels took before still gets one. The padding: the plain version at the
bf16 kernel's padded shapes (49 -> 64 tokens whose keys are at -inf, each
head's dh zero-filled to a multiple of 16) against the Pallas kernel in
interpret mode, at one window of C = 96 and of C = 768, with the float32
tolerance of tests/test_torch_swin.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas import attention as jattn
from idvs.morec_tpu_torch.ops.cuda.attention import (LINEAR_WIDTHS,
                                                     fused_mha_proj_padded,
                                                     fused_mha_proj_plain,
                                                     win_attn_plan)
from idvs.morec_tpu_torch.ops.cuda.lib import MAX_SMEM
from idvs.morec_tpu_torch.ops.cuda.mlp import PRE_F_CHUNK, premlp_plan

TOL = 2e-5
# (C, heads) of the four stages of Swin-T and of Swin-B
SWIN_T = ((96, 3), (192, 6), (384, 12), (768, 24))
SWIN_B = ((128, 4), (256, 8), (512, 16), (1024, 32))


@pytest.mark.parametrize("C", [c for c, _ in SWIN_T + SWIN_B])
def test_premlp_plan_fits_every_swin_stage(C):
    k = premlp_plan(C, torch.bfloat16)
    F, WN = 4 * C, k["col_warps"]
    assert k["smem"] <= MAX_SMEM
    assert k["rows"] == 16 * k["row_warps"]               # m16 fragments
    assert k["threads"] == 32 * k["row_warps"] * WN <= 512
    assert F % k["f_chunk"] == 0 and k["f_chunk"] % 32 == 0
    # each warp's h and output columns are pairs of n8 tiles, k16 deep
    assert (k["f_chunk"] // WN) % 16 == 0 and (C // WN) % 16 == 0
    assert k["acc_floats"] <= 96 and k["h_floats"] <= 48


# the widths and F chunks the kernel took before its bf16 body
TOOK = {32: 32, 64: 64, 96: 96, 128: 128, 192: 192, 256: 256, 384: 384,
        512: 256, 768: 384, 1024: 256}


@pytest.mark.parametrize("C", sorted(TOOK))
def test_premlp_plan_takes_every_width_and_chunk_it_took(C):
    """Every C of the dispatch list, in both dtypes; the wrappers' chunk is
    the one the kernel took before and each body's chunk divides it, so
    every F the kernel took before stays whole."""
    f32 = premlp_plan(C, torch.float32)
    bf16 = premlp_plan(C, torch.bfloat16)
    assert PRE_F_CHUNK[C] == TOOK[C]
    assert TOOK[C] % f32["f_chunk"] == 0
    assert f32["smem"] <= MAX_SMEM
    assert TOOK[C] % bf16["f_chunk"] == 0
    assert bf16["smem"] <= MAX_SMEM


@pytest.mark.parametrize("C,nh", SWIN_T + SWIN_B)
def test_win_attn_plan_fits_every_swin_stage(C, nh):
    k = win_attn_plan(49, C, nh)
    assert k is not None
    assert (k["t_pad"], k["dh_pad"]) == (64, 32)
    assert k["smem"] <= MAX_SMEM
    assert nh % k["HG"] == 0
    # warps of 32 x 48 projection tiles over the head group's 3 HG dh_pad
    # columns, passes of 32 warps_m rows over G t_pad rows
    assert 3 * k["HG"] * k["dh_pad"] == 48 * k["warps_n"]
    assert k["warps_m"] * k["warps_n"] <= 16
    rows = k["G"] * k["t_pad"]
    assert k["passes"] == math.ceil(rows / (32 * k["warps_m"]))


def _old_blocking(T, C, nh):
    """The scalar float32 window kernel's choose_blocking (csrc/win_attn.cu
    before its tensor-core redesign), which the bf16 edition used before:
    whether some head group fits."""
    dh = C // nh
    G = -(-45 // T)
    R4 = -(-G * T // 4) * 4
    for HG in (4, 3, 2, 1):
        NC, TX = 3 * HG * dh, HG * dh // 4
        smem = 4 * (R4 + 2 * 16 * (R4 + 4) + 2 * 16 * NC + R4 * (NC + 1)
                    + G * HG * T * (T + 1))
        if nh % HG == 0 and TX >= 8 and TX * R4 // 4 <= 512 \
                and smem <= MAX_SMEM:
            return True
    return False


@pytest.mark.parametrize("T", [1, 16, 49, 64, 144])
def test_win_attn_plan_takes_every_geometry_the_kernel_took(T):
    took = 0
    for C in LINEAR_WIDTHS:
        for nh in range(1, C + 1):
            if C % nh or (C // nh) % 4 or not _old_blocking(T, C, nh):
                continue
            took += 1
            k = win_attn_plan(T, C, nh)
            assert k is not None, (T, C, nh)
            assert k["smem"] <= MAX_SMEM and k["t_pad"] % 16 == 0
            assert k["dh_pad"] % 16 == 0 and k["dh_pad"] >= C // nh
    assert took


@pytest.mark.parametrize("C,nh", [(96, 3), (768, 24), (96, 24)])
def test_plain_version_at_padded_shapes_matches_pallas(C, nh):
    """One window of 49 tokens at Swin-T stage 0's and stage 3's widths,
    and heads of 4 columns that the kernel zero-fills to 16."""
    T = 49
    k = win_attn_plan(T, C, nh)
    assert (k["t_pad"], k["dh_pad"]) == (64, 32 if C // nh == 32 else 16)
    rng = np.random.default_rng(C + nh)
    args = [rng.standard_normal((1, T, C)),
            0.5 * rng.standard_normal((1, nh, T, T)),
            rng.standard_normal((C, 3 * C)) * C ** -0.5,
            rng.standard_normal(3 * C) * 0.1,
            rng.standard_normal((C, C)) * C ** -0.5,
            rng.standard_normal(C) * 0.1]
    args = [np.asarray(a, np.float32) for a in args]
    want = np.asarray(jattn.fused_mha_proj(
        *map(jnp.asarray, args), n_heads=nh, bias_grad=False,
        interpret=True))
    targs = list(map(torch.from_numpy, args))
    got = fused_mha_proj_padded(*targs, n_heads=nh, t_pad=k["t_pad"],
                                dh_pad=k["dh_pad"])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), fused_mha_proj_plain(*targs, n_heads=nh).numpy(),
        rtol=TOL, atol=TOL)
