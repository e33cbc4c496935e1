"""The pre-LN MLP's backward on the wg route (csrc/premlp_bwd_wg.cu's
premlp_bwd_wg_kernel between premlp_bwd.cu's row passes and gemm.cu's
products) against autograd of the plain version on the card, and the
kernel alone against ``premlp_bwd_gdh_plain``. Every test needs an NVIDIA
GPU and skips without one. On the card (no jax there, so without the
repo's conftest):

    python -m pytest tests/test_torch_premlp_bwd_wg_tiles.py -q --noconftest

bf16 at every C the kernel is built for (512, 768, 1024): M on both sides
of a 128-row tile and of a warpgroup's 64 rows, F of one 128-column tile
and F = 4C; each edition (fused_mlp_res unit and scaled, fused_mlp with and
without its LayerNorm and with the saved h) and each activation on the wg
route and on the products route; the same bits on two runs; the plans and
operands the kernel refuses. Tolerance as test_torch_premlp_bwd_tiles.py:
GRAD_TOL, the max abs error over max(1, max |plain value|).
"""

import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (LN_KERNELS, PRE_ACTS,
                                               PRE_WG_WIDTHS,
                                               PREMLP_BWD_ROUTES,
                                               fused_mlp_bwd,
                                               fused_mlp_res_bwd,
                                               premlp_bwd_gdh,
                                               premlp_bwd_gdh_plain,
                                               premlp_bwd_plan)
from test_torch_premlp_bwd_tiles import (BF16, EDITIONS, _case, _close,
                                         _got, _saved_h, _want)

pytestmark = pytest.mark.cuda

ROWS = 128               # premlp_bwd_plan's rows on the wg route


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _edges():
    return sorted({1, 63, 64, 65, ROWS - 1, ROWS, ROWS + 1, 3 * ROWS + 5})


def test_the_plan_takes_the_wg_route():
    for C in PRE_WG_WIDTHS:
        k = premlp_bwd_plan(C, 288 * 49, BF16)
        assert k["route"] == "wg" and k["rows"] == ROWS
        assert k["kernels"][0] == "premlp_bwd_wg_kernel"


@pytest.mark.parametrize("C", PRE_WG_WIDTHS)
def test_every_width_at_the_tile_edges(C):
    """The plan's route, through the counted wrappers, at M on both sides
    of a row tile and of a warpgroup's rows, F of one tile (every dy
    K-block's column sums in one block) and F = 4C, each LayerNorm
    edition."""
    fused_mlp_res_bwd.bodies.clear()
    for F in (128, 4 * C):
        for M in _edges():
            x, dout, mlp, ln, scale = _case(M * 7 + C + F, M, C, F)
            for edition in ("scaled", "unit", "LN", "no LN"):
                res = edition in ("unit", "scaled")
                counter = fused_mlp_res_bwd if res else fused_mlp_bwd
                before = counter.launches, premlp_bwd_gdh.launches
                _close(_got(None, edition, x, dout, mlp, ln, scale, "gelu"),
                       _want(edition, x, dout, mlp, ln, scale, "gelu"))
                assert counter.launches == before[0] + 1
                assert premlp_bwd_gdh.launches == before[1] + 1
    bodies = fused_mlp_res_bwd.bodies
    assert "premlp_bwd_wg_kernel" in bodies
    assert not {"colsum_kernel", "act_cast_kernel"} & bodies


def test_bodies_name_no_layernorm_pass_without_the_layernorm():
    """fused_mlp without its LayerNorm launches none of the row passes
    the wg plan names, and its bodies say so."""
    M, C, F = 300, 768, 2 * ROWS
    x, dout, mlp, ln, scale = _case(13, M, C, F)
    earlier, fused_mlp_bwd.bodies = fused_mlp_bwd.bodies, set()
    try:
        _close(_got(None, "no LN", x, dout, mlp, ln, scale, "gelu"),
               _want("no LN", x, dout, mlp, ln, scale, "gelu"))
        bodies = fused_mlp_bwd.bodies
    finally:
        fused_mlp_bwd.bodies = earlier | fused_mlp_bwd.bodies
    assert "premlp_bwd_wg_kernel" in bodies
    assert not LN_KERNELS & bodies
    assert LN_KERNELS <= set(premlp_bwd_plan(C, M, BF16)["kernels"])


@pytest.mark.parametrize("route", ("wg", "products"))
@pytest.mark.parametrize("act", sorted(PRE_ACTS))
@pytest.mark.parametrize("C", PRE_WG_WIDTHS)
def test_each_edition_and_activation_on_both_routes(C, act, route):
    M, F = 300, 2 * ROWS
    x, dout, mlp, ln, scale = _case(C + len(act), M, C, F)
    for edition in EDITIONS:
        _close(_got(route, edition, x, dout, mlp, ln, scale, act),
               _want(edition, x, dout, mlp, ln, scale, act))


@pytest.mark.parametrize("saved", (False, True))
@pytest.mark.parametrize("act", sorted(PRE_ACTS))
@pytest.mark.parametrize("C", PRE_WG_WIDTHS)
def test_the_kernel_alone_against_its_plain_version(C, act, saved):
    """premlp_bwd_gdh's g, dh, db1 and db2 against premlp_bwd_gdh_plain on
    the same operands: g and dh differ where a float sum in another order
    flips a bf16 rounding, the sums by float reassociation."""
    M, F = 3 * ROWS + 5, 4 * C
    x, dout, mlp, _, _ = _case(C + 3, M, C, F)
    w1, b1, w2 = (t.to(BF16).contiguous() for t in mlp[:3])
    h = _saved_h(x, mlp, None, act) if saved else None
    before = premlp_bwd_gdh.launches
    got = premlp_bwd_gdh(x, dout, w1, b1, w2, h, act)
    assert premlp_bwd_gdh.launches == before + 1
    want = premlp_bwd_gdh_plain(x, dout, w1, b1, w2, h, act)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    _close(got, want)


@pytest.mark.parametrize("C,M", [(512, 4000), (768, 1000), (1024, 300)])
def test_two_runs_give_the_same_bits(C, M):
    x, dout, mlp, ln, scale = _case(5, M, C, 4 * C)
    for edition in ("scaled", "no LN", "save_h LN"):
        a = _got("wg", edition, x, dout, mlp, ln, scale, "gelu")
        b = _got("wg", edition, x, dout, mlp, ln, scale, "gelu")
        torch.cuda.synchronize()
        for u, v in zip(a, b):
            assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("C", PRE_WG_WIDTHS)
def test_db2_from_the_ring_is_the_same_on_every_run(C):
    """F of one tile, so one block of each row tile adds every dy K-block's
    column sums from the ring's stage while the products read it, and a
    ragged last row tile: many runs give the same bits, and db2 stands
    within float reassociation (1e-3 over 389 rows) of the plain column
    sums."""
    M, F = 3 * ROWS + 5, ROWS
    x, dout, mlp, _, _ = _case(C + 41, M, C, F)
    w1, b1, w2 = (t.to(BF16).contiguous() for t in mlp[:3])
    first = premlp_bwd_gdh(x, dout, w1, b1, w2, None, "gelu")
    plain = premlp_bwd_gdh_plain(x, dout, w1, b1, w2, None, "gelu")
    _close(first, plain)
    assert (first[3] - plain[3]).abs().max().item() <= 1e-3
    for _ in range(200):
        again = premlp_bwd_gdh(x, dout, w1, b1, w2, None, "gelu")
        torch.cuda.synchronize()
        for u, v in zip(first, again):
            assert torch.equal(u, v)


def test_swin_t_stage_3_rows():
    """Swin-T stage 3 (C = 768, F = 3072) at 8 images' rows."""
    M = 8 * 49
    x, dout, mlp, ln, scale = _case(11, M, 768, 3072)
    _close(_got(None, "scaled", x, dout, mlp, ln, scale, "gelu"),
           _want("scaled", x, dout, mlp, ln, scale, "gelu"))


def _entry(ops, M, C, F, k, dtype=1):
    """idvs_premlp_bwd_wg with the plan k."""
    xn, dy, w1, b1, w2, g, dh, part, part2, sums = ops
    return lib.library().idvs_premlp_bwd_wg(
        xn.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), None, g.data_ptr(), dh.data_ptr(), part.data_ptr(),
        part2.data_ptr(), sums.data_ptr(), M, C, F, 0, k["per"], k["rows"],
        k["f_tile"], k["stages"], k["threads"], k["producer_regs"],
        k["consumer_regs"], k["smem"], dtype, lib.stream_handle(xn))


def test_refuses_what_the_kernel_does_not_take():
    M, C, F = 200, 768, 3072
    x, dout, mlp, ln, _ = _case(3, M, C, F)
    w1, b1, w2 = (t.to(BF16).contiguous() for t in mlp[:3])
    k = premlp_bwd_plan(C, M, BF16)
    E = C + F
    ops = (x, dout, w1, b1, w2,
           torch.empty(M, F, dtype=BF16, device="cuda"),
           torch.empty(M, F, dtype=BF16, device="cuda"),
           torch.empty(k["blocks"] * E, device="cuda"),
           torch.empty(k["groups"] * E, device="cuda"),
           torch.empty(E, device="cuda"))
    assert _entry(ops, M, C, F, k) == 0
    torch.cuda.synchronize()
    # a plan other than the one built for C
    for bad in (dict(rows=64), dict(f_tile=64), dict(stages=2),
                dict(threads=256), dict(producer_regs=24),
                dict(consumer_regs=240), dict(smem=k["smem"] + 16)):
        assert _entry(ops, M, C, F, {**k, **bad}) == 1, bad
    # F not a multiple of the tile, float32, a width with no kernel
    assert _entry(ops, M, C, F - 64, k) == 1
    assert _entry(ops, M, C, F, k, dtype=0) == 1
    assert _entry(ops, M, 384, F, k) == 1
    # the wrappers at a width the plan gives another route
    small = premlp_bwd_plan(384, M, BF16)
    assert small["route"] == "fused"
    with pytest.raises(ValueError, match="no wg kernel"):
        premlp_bwd_gdh(x[:, :384].contiguous(), dout[:, :384].contiguous(),
                       w1[:384].contiguous(), b1, w2[:, :384].contiguous(),
                       None, "gelu")
    with pytest.raises(ValueError, match="no wg kernel"):
        PREMLP_BWD_ROUTES["wg"](x.float(), dout.float(), None, *mlp[:3],
                                [t.float() for t in ln], None, 1e-5, "gelu",
                                False, 0)
    with pytest.raises(ValueError, match="multiple of 128"):
        premlp_bwd_gdh(x, dout, w1[:, :F - 64].contiguous(), b1[:F - 64],
                       w2[:F - 64].contiguous(), None, "gelu")
