"""The float32 block plans of the two Swin forward kernels' tensor-core
bodies (csrc/premlp.cu premlp_tf32_kernel, csrc/win_attn.cu
win_attn_tf32_kernel), which the launch passes to the kernel and the
kernel checks: on the CPU, no GPU needed.

premlp_plan(C, float32) at every width of the dispatch list fits the 227 KB
of shared memory a block may use, cuts the rows into 16-row fragments and
each warp's columns into n8 tiles, keeps its float accumulators within a
thread's registers, and its F chunk divides the one the float32 body took
before its redesign (``TOOK``), so every F taken before is still taken;
every (C, F) a tower of the port builds is taken in both dtypes.
win_attn_plan(T, C, nh, float32) places every geometry the scalar float32
body placed (its blocking, ``old_blocking`` below) at T in {1, 16, 49, 64,
144}, and every Swin-T and Swin-B stage, within the same bounds.
"""

import math

import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda.attention import (LINEAR_WIDTHS,
                                                     win_attn_plan)
from idvs.morec_tpu_torch.ops.cuda.lib import MAX_SMEM
from idvs.morec_tpu_torch.ops.cuda.mlp import PRE_F_CHUNK, premlp_plan

F32, BF16 = torch.float32, torch.bfloat16
# the F chunk of the scalar float32 body, by C
TOOK = {32: 32, 64: 64, 96: 96, 128: 128, 192: 192, 256: 256, 384: 384,
        512: 256, 768: 384, 1024: 256}
# (C, F) of the port's towers' pre-LN MLPs: Swin-T's and Swin-B's stages
# at F = 4C; ViT-MAE-B, BEiT-B and CLIP-B; OPT-125M and DeBERTa-base
TOWERS = {"swin-t": [(96, 384), (192, 768), (384, 1536), (768, 3072)],
          "swin-b": [(128, 512), (256, 1024), (512, 2048), (1024, 4096)],
          "vit": [(768, 3072)], "opt-125m": [(768, 3072)],
          "deberta-base": [(768, 3072)]}
# (C, heads) of the four stages of Swin-T and of Swin-B
SWIN = ((96, 3), (192, 6), (384, 12), (768, 24),
        (128, 4), (256, 8), (512, 16), (1024, 32))


@pytest.mark.parametrize("C", sorted(TOOK))
def test_premlp_f32_plan_fits_and_divides_the_old_chunk(C):
    k = premlp_plan(C, F32)
    assert k["smem"] <= MAX_SMEM
    assert k["rows"] == 16 * k["m_tiles"] * k["row_warps"]   # m16 tiles
    assert k["threads"] == 32 * k["row_warps"] * k["col_warps"] == 256
    assert TOOK[C] % k["f_chunk"] == 0 and PRE_F_CHUNK[C] == TOOK[C]
    # each warp's h and output columns are whole n8 tiles; the slices
    # whole 8-deep k-steps of C and of the chunk
    assert (k["f_chunk"] // k["col_warps"]) % 8 == 0
    assert (C // k["col_warps"]) % 8 == 0
    assert k["slice1"] % 8 == 0 and C % k["slice1"] == 0
    assert k["slice2"] % 8 == 0 and k["f_chunk"] % k["slice2"] == 0
    assert k["stages"] >= 2
    # the (rows, C) output and the chunk's h in a thread's registers
    assert k["acc_floats"] <= 128 and k["h_floats"] <= 48
    assert k["acc_floats"] + k["h_floats"] <= 144
    # shared memory: xn and act(h) as float rows, the ring's slots, each
    # as large as a W1 and as a W2 slice
    slot = max(k["slice1"] * (k["f_chunk"] + 4), k["slice2"] * (C + 4))
    assert k["smem"] == 4 * (k["rows"] * (C + 8) + k["rows"] *
                             (k["f_chunk"] + 8) + k["stages"] * slot)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_every_tower_width_is_taken_in_both_dtypes(tower):
    for C, F in TOWERS[tower]:
        assert F % PRE_F_CHUNK[C] == 0, (tower, C, F)
        for dt in (F32, BF16):
            assert F % premlp_plan(C, dt)["f_chunk"] == 0, (tower, C, F, dt)


def old_blocking(T, C, nh):
    """The scalar float32 window kernel's choose_blocking (csrc/win_attn.cu
    before its tensor-core redesign): whether some head group fits."""
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


def _check_f32_window_plan(k, T, C, nh):
    assert k is not None, (T, C, nh)
    dh = C // nh
    assert k["smem"] <= MAX_SMEM
    assert k["t_pad"] == -(-T // 16) * 16 and k["dh_pad"] == -(-dh // 16) * 16
    assert nh % k["HG"] == 0 and k["HG"] * k["dh_pad"] <= 128
    assert 3 * k["HG"] * k["dh_pad"] == 48 * k["warps_n"]
    assert k["warps_m"] * k["warps_n"] <= 8        # the float32 launch bound
    rows = k["G"] * k["t_pad"]
    assert k["passes"] == math.ceil(rows / (32 * k["warps_m"]))


@pytest.mark.parametrize("T", [1, 16, 49, 64, 144])
def test_win_attn_f32_plan_takes_every_geometry_the_scalar_body_took(T):
    took = 0
    for C in LINEAR_WIDTHS:
        for nh in range(1, C + 1):
            if C % nh or (C // nh) % 4 or not old_blocking(T, C, nh):
                continue
            took += 1
            _check_f32_window_plan(win_attn_plan(T, C, nh, F32), T, C, nh)
    assert took


@pytest.mark.parametrize("C,nh", SWIN)
def test_win_attn_f32_plan_fits_every_swin_stage(C, nh):
    k = win_attn_plan(49, C, nh, F32)
    _check_f32_window_plan(k, 49, C, nh)
    assert (k["t_pad"], k["dh_pad"]) == (64, 32)
    # a float32 block's q | k | v and ring take more room than bf16's
    assert k["smem"] > win_attn_plan(49, C, nh, BF16)["smem"]
