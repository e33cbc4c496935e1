"""The tensor-core editions of fused_mha (csrc/fused_mha.cu) at the edges
of their tiling, against the plain version on the card: every T the tiles
pad to a multiple of 16 (1 ... 128) against every dh they pad likewise (16
... 1024), the forward in bf16 and in float32 (3xTF32) with the key mask (a
row whose keys are all masked), a bias per row and head, a bias shared by
the heads and dropout, and the backward in both dtypes with the key mask
and with a bias shared by the heads under dropout; the dropout mask at a T
that is no multiple of 16 (the bits of ops/dropout.py, forward and
backward, in both dtypes); and the dbias edition in both dtypes, the same
bits on two runs, with its sum in registers (T <= 64) and in shared memory
(T > 64). A shape whose tiles do not fit a block's shared memory raises
and launches nothing; in float32 every (T, dh) the scalar bodies the
tensor-core ones replaced launched still launches (forward:
_scalar_fwd_fits; backward: SCALAR_BWD_SHAPES, with heads of odd widths
at T 16-33 whose planes fit only with dh padded to 8 columns). Every test needs an NVIDIA
GPU and skips without one. On the card (no jax there, so without the
repo's conftest):

    python -m pytest tests/test_torch_mha_tiles.py -q --noconftest

Tolerances are tests/test_torch_cuda.py's: 1e-1 on bf16 outputs and 1e-4
on float32 ones, and 3e-2 (bf16) and 1e-4 (float32) of max(1, the largest
plain gradient) on gradients.
"""

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.attention import (
    BWD, BWD_BODIES, DBIAS, FWD, SMEM, fused_mha, fused_mha_bwd,
    fused_mha_bwd_dbias, fused_mha_plain, mha_smem)

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
TOL, GRAD_TOL = 1e-1, 3e-2
FWD_TOL = {BF16: TOL, F32: 1e-4}
DTYPE_GRAD_TOL = {BF16: GRAD_TOL, F32: 1e-4}
TS = (1, 10, 16, 17, 30, 49, 64, 65, 128)
DHS = (16, 32, 40, 64, 256, 1024)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rand(rng, *shape, scale=1.0, dtype=BF16):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to("cuda", dtype)


def _key_mask(rng, B, T):
    """(B, T) key masks of random lengths; row 0 has every key masked."""
    lens = rng.integers(0, T + 1, size=B)
    lens[0] = 0
    return torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32)).cuda()


def _fits(T, dh, edition, dtype=BF16):
    return mha_smem(T, dh, edition, lib.DTYPE_CODES[dtype]) <= SMEM


def _scalar_fwd_fits(T, dh):
    """The float32 forward this body replaced held q, k, v at (dh + 1)
    floats a row and the (T, T + 1) scores in one block's shared memory."""
    return 4 * (3 * T * (dh + 1) + T * (T + 1)) <= SMEM


# The (T, dh) of the grid that the scalar float32 backward launched: it held
# q, k, v and dout at (dh + 1) floats a row and two (T, T + 1) planes in one
# block's shared memory (its dbias edition one (T, T) plane more).
# Beside the grid, heads of odd widths at T 16-33 whose four planes fit
# only with dh padded to 8 columns (mha_mma.cuh kBwdLayouts: rows 4 floats
# apart (33, 417), (17, 841), or 0 (16, 897), (19, 753)), and two that fit
# the main paths' layout.
ODD_BWD_SHAPES = [(33, 417), (24, 433), (16, 508), (17, 841), (16, 897),
                  (19, 753)]


def _scalar_bwd_fits(T, dh, dbias=False):
    return 4 * (4 * T * (dh + 1) + 2 * T * (T + 1)
                + (T * T if dbias else 0)) <= SMEM


SCALAR_BWD_SHAPES = [(T, dh) for T in TS for dh in DHS
                     if _scalar_bwd_fits(T, dh)] + ODD_BWD_SHAPES
SCALAR_DBIAS_SHAPES = [(T, dh) for T, dh in SCALAR_BWD_SHAPES
                       if _scalar_bwd_fits(T, dh, True)]


def _grads(fn, qkv, dout, *more):
    leaves = [t.detach().clone().requires_grad_(True) for t in (qkv, *more)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout)


def _assert_grads_close(got, want, tol=GRAD_TOL):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_forward_tiles(dtype, T, dh):
    """The key mask (row 0 all masked), a bias per row and head, one (T, T)
    plane shared by every row and head (with -100 on some pairs, as Swin's
    shift mask), and the key mask with dropout 0.1."""
    B, nh = 3, 2
    rng = np.random.default_rng(1000 * T + dh)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    mask = _key_mask(rng, B, T)
    before = fused_mha.launches
    if not _fits(T, dh, FWD, dtype):
        assert dtype == BF16 or not _scalar_fwd_fits(T, dh)
        with pytest.raises(ValueError):
            fused_mha(qkv, mask, n_heads=nh)
        assert fused_mha.launches == before
        return
    shared = _rand(rng, 1, 1, T, T, scale=0.5, dtype=F32) - 100.0 * (
        torch.from_numpy((rng.uniform(size=(1, 1, T, T)) < 0.2)
                         .astype(np.float32)).cuda())
    calls = (dict(mask=mask),
             dict(bias=_rand(rng, B, nh, T, T, scale=0.5, dtype=F32)),
             dict(bias=shared),
             dict(mask=mask, drop_rate=0.1, seed=T + dh))
    for kw in calls:
        got = fused_mha(qkv, n_heads=nh, **kw)
        want = fused_mha_plain(qkv, n_heads=nh, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= FWD_TOL[dtype], (kw.keys(), err)
    assert fused_mha.launches == before + len(calls)


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_backward_tiles(dtype, T, dh):
    """The key mask (row 0 all masked), then one (T, T) plane shared by
    every row and head under dropout 0.1."""
    B, nh = 3, 2
    rng = np.random.default_rng(2000 * T + dh)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    dout = _rand(rng, B, T, nh * dh, dtype=dtype)
    mask = _key_mask(rng, B, T)
    shared = _rand(rng, 1, 1, T, T, scale=0.5, dtype=F32)
    calls = (dict(mask=mask),
             dict(bias=shared, drop_rate=0.1, seed=T + dh))
    before = fused_mha_bwd.launches
    if not (_fits(T, dh, FWD, dtype) and _fits(T, dh, BWD, dtype)):
        assert dtype == BF16 or (T, dh) not in SCALAR_BWD_SHAPES
        with pytest.raises(ValueError):
            _grads(lambda q: fused_mha(q, mask, n_heads=nh), qkv, dout)
        assert fused_mha_bwd.launches == before
        return
    for kw in calls:
        out_k, got = _grads(lambda q: fused_mha(q, n_heads=nh, **kw), qkv,
                            dout)
        out_p, want = _grads(lambda q: fused_mha_plain(q, n_heads=nh, **kw),
                             qkv, dout)
        _assert_grads_close((out_k, *got), (out_p, *want),
                            DTYPE_GRAD_TOL[dtype])
    assert fused_mha_bwd.launches == before + len(calls)
    if dtype == F32:
        assert BWD_BODIES[F32] in fused_mha_bwd.bodies


@pytest.mark.parametrize("edition", [BWD, DBIAS])
def test_float32_backward_launches_where_the_scalar_body_did(edition):
    """Every (T, dh) of the grid that the scalar float32 backward (and its
    dbias edition) launched fits the tensor-core body, and so does every
    (T, dh) of T 1-128 and dh 1-1024 whose scalar layout fitted."""
    shapes = SCALAR_BWD_SHAPES if edition == BWD else SCALAR_DBIAS_SHAPES
    assert {(30, 64), (30, 256), (10, 1024), (49, 32)} <= set(shapes)
    assert edition == DBIAS or {(33, 417), (16, 897)} <= set(shapes)
    assert [s for s in shapes if not _fits(*s, edition, F32)] == []
    every = [(T, dh) for T in range(1, 129) for dh in range(1, 1025)
             if _scalar_bwd_fits(T, dh, edition == DBIAS)
             and not _fits(T, dh, edition, F32)]
    assert every == []


@pytest.mark.parametrize("T,dh", ODD_BWD_SHAPES)
@pytest.mark.parametrize("edition", [BWD, DBIAS])
def test_float32_backward_odd_heads(edition, T, dh):
    """The float32 backward at the odd-width heads: the key mask (row 0 all
    masked) and a bias shared by the heads under dropout 0.1, or the dbias
    edition with a bias per head, through mha_bwd_tf32_kernel against
    autograd of the plain version."""
    if edition == DBIAS and (T, dh) not in SCALAR_DBIAS_SHAPES:
        pytest.skip("the scalar dbias edition did not take this shape")
    B, nh = 2, 2
    rng = np.random.default_rng(3000 * T + dh)
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=F32)
    dout = _rand(rng, B, T, nh * dh, dtype=F32)
    kernel = fused_mha_bwd if edition == BWD else fused_mha_bwd_dbias
    before = kernel.launches
    if edition == BWD:
        mask = _key_mask(rng, B, T)
        shared = _rand(rng, 1, 1, T, T, scale=0.5, dtype=F32)
        calls = (dict(mask=mask),
                 dict(bias=shared, drop_rate=0.1, seed=T + dh))
        for kw in calls:
            out_k, got = _grads(lambda q: fused_mha(q, n_heads=nh, **kw),
                                qkv, dout)
            out_p, want = _grads(
                lambda q: fused_mha_plain(q, n_heads=nh, **kw), qkv, dout)
            _assert_grads_close((out_k, *got), (out_p, *want),
                                DTYPE_GRAD_TOL[F32])
    else:
        calls = (0,)
        _, bias, _ = _dbias_inputs(rng, B, 1, nh, nh, T, 8, F32)
        kern = lambda q, b: fused_mha(q, bias=b, n_heads=nh, drop_rate=0.1,
                                      seed=7)
        out_k, got = _grads(kern, qkv, dout, bias)
        out_p, want = _grads(lambda q, b: fused_mha_plain(
            q, bias=b, n_heads=nh, drop_rate=0.1, seed=7), qkv, dout, bias)
        _assert_grads_close((out_k, *got), (out_p, *want),
                            DTYPE_GRAD_TOL[F32])
    assert kernel.launches == before + len(calls)
    assert BWD_BODIES[F32] in kernel.bodies


@pytest.mark.parametrize("T", [10, 17, 49])
def test_fully_masked_row_is_uniform_over_the_real_keys(T):
    """Every key of every row masked: each probability is 1/T over the T
    real keys (the padded keys get none), so a row's output is
    bf16(1/T) times the sum of v over the real keys."""
    B, nh, dh = 2, 3, 32
    rng = np.random.default_rng(T)
    qkv = _rand(rng, B, T, 3 * nh * dh)
    mask = torch.zeros(B, T, device="cuda")
    got = fused_mha(qkv, mask, n_heads=nh)
    v = qkv[..., 2 * nh * dh:].float()
    p = torch.tensor(1.0 / T).to(BF16).float()
    want = (p * v.sum(1, keepdim=True)).expand(B, T, nh * dh).to(BF16)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL
    dout = _rand(rng, B, T, nh * dh)
    _, (dq,) = _grads(lambda q: fused_mha(q, mask, n_heads=nh), qkv, dout)
    torch.cuda.synchronize()
    assert torch.isfinite(dq).all()


@pytest.mark.parametrize("T", [17, 49])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_dropout_bits_match_the_plain_mask(dtype, T):
    """q = k = 0 makes every probability 1/T. With v the identity on the
    first T columns, out[b, i, h, j] is the forward's pd (b, h, i, j); with
    dout the identity, dv[b, j, h, i] is the backward's pd (b, h, i, j).
    Each is non-zero exactly where ops/dropout.py keeps the element."""
    B, nh, dh, p, seed = 4, 2, 64, 0.1, 21
    eye = np.zeros((T, dh), np.float32)
    eye[np.arange(T), np.arange(T)] = 1.0
    qkv = np.zeros((B, T, 3, nh, dh), np.float32)
    qkv[:, :, 2] = eye[None, :, None]
    qkv = torch.from_numpy(qkv.reshape(B, T, 3 * nh * dh)).to("cuda", dtype)
    dout = torch.from_numpy(np.broadcast_to(
        eye[None, :, None], (B, T, nh, dh)).reshape(B, T, nh * dh).copy()
    ).to("cuda", dtype)
    mask = torch.ones(B, T, device="cuda")
    keep = dropout.keep_mask(seed, (B, nh, T, T), p, device="cuda")
    kern = lambda q: fused_mha(q, mask, n_heads=nh, drop_rate=p, seed=seed)
    out, (dqkv,) = _grads(kern, qkv, dout)
    torch.cuda.synchronize()
    fwd = out.reshape(B, T, nh, dh)[..., :T].permute(0, 2, 1, 3)
    assert torch.equal(fwd != 0, keep)
    dv = dqkv.reshape(B, T, 3, nh, dh)[:, :, 2, :, :T].permute(0, 2, 3, 1)
    assert torch.equal(dv != 0, keep)
    out_p, want = _grads(lambda q: fused_mha_plain(
        q, mask, n_heads=nh, drop_rate=p, seed=seed), qkv, dout)
    _assert_grads_close((out, dqkv), (out_p, *want), DTYPE_GRAD_TOL[dtype])


def _dbias_inputs(rng, B, P, heads, nh, T, dh, dtype=BF16):
    qkv = _rand(rng, B, T, 3 * nh * dh, dtype=dtype)
    # Swin's relative-position table plus a shift mask's -100 on some pairs
    bias = _rand(rng, P, heads, T, T, scale=0.5, dtype=torch.float32) - (
        100.0 * torch.from_numpy((rng.uniform(size=(P, 1, T, T)) < 0.2)
                                 .astype(np.float32)).cuda())
    return qkv, bias, _rand(rng, B, T, nh * dh, dtype=dtype)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("B,P,heads,nh,T,dh", [
    (256, 1, 3, 3, 49, 32),     # Swin-T stage 0, unshifted: P = 1
    (256, 64, 3, 3, 49, 32),    # shifted: a bias per window, P = nW
    (40, 4, 1, 3, 49, 32),      # one plane shared by the heads
    (12, 3, 2, 2, 65, 32),      # above T = 64: the sum in shared memory
    (8, 2, 2, 2, 128, 16),      # float32: ds and pd staged in turn
    (6, 2, 2, 2, 30, 256)])     # wide heads: four warps a tile
def test_dbias_edition_same_bits_on_two_runs(B, P, heads, nh, T, dh, drop,
                                             dtype):
    """dqkv and dbias of the dbias edition against autograd of the plain
    version, and bit-equal on a second run (a fixed-order sum, no
    atomics)."""
    rng = np.random.default_rng(B + P + T)
    qkv, bias, dout = _dbias_inputs(rng, B, P, heads, nh, T, dh, dtype)
    kern = lambda q, b: fused_mha(q, bias=b, n_heads=nh, drop_rate=drop,
                                  seed=5)
    before = (fused_mha_bwd.launches, fused_mha_bwd_dbias.launches)
    out_k, got = _grads(kern, qkv, dout, bias)
    assert (fused_mha_bwd.launches, fused_mha_bwd_dbias.launches) == (
        before[0], before[1] + 1)
    assert got[1].shape == bias.shape and got[1].dtype == torch.float32
    out_p, want = _grads(lambda q, b: fused_mha_plain(
        q, bias=b, n_heads=nh, drop_rate=drop, seed=5), qkv, dout, bias)
    _assert_grads_close((out_k, *got), (out_p, *want), DTYPE_GRAD_TOL[dtype])
    assert BWD_BODIES[dtype] in fused_mha_bwd_dbias.bodies
    again = _grads(kern, qkv, dout, bias)[1]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_shapes_sharing_a_kernel_launch_in_any_order():
    """SASRec's heads of 256 and BERT's heads of 64 at T <= 32 run the same
    bf16 kernels with different shared memory: each launch, in the order
    a text train step makes them (wide, narrow, wide again), goes
    through."""
    rng = np.random.default_rng(3)
    shapes = [(16, 20, 2, 256), (16, 30, 8, 64), (16, 20, 2, 256)]
    before = (fused_mha.launches, fused_mha_bwd.launches)
    for B, T, nh, dh in shapes:
        qkv = _rand(rng, B, T, 3 * nh * dh)
        mask = torch.ones(B, T, device="cuda")
        _grads(lambda q: fused_mha(q, mask, n_heads=nh), qkv,
               _rand(rng, B, T, nh * dh))
    torch.cuda.synchronize()
    assert (fused_mha.launches, fused_mha_bwd.launches) == (
        before[0] + 3, before[1] + 3)
