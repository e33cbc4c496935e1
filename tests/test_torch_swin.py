"""The port's Swin kernels' plain versions and its SwinBlock against the JAX
package on the CPU: the same numpy inputs go through the Pallas kernel in
interpret mode (forward only) and through the port's plain version.

Tolerances: 2e-5 in float32, the JAX package's own for these kernels
(tests/test_fused_attention.py, tests/test_pallas_mlp.py: sums in other
orders, and the Pallas kernels' polynomial erf against torch's erf). In
bfloat16 both sides round at the same points, but a float32 sum in another
order can flip a rounding: one unit in the last place of the output
(2^-7 relative), so 2e-2 absolute at outputs of a few units at most.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.ops.pallas import attention as jattn
from idvs.morec_tpu.ops.pallas import mlp as jmlp
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.layers import init_parameters
from idvs.morec_tpu_torch.models.swin import (SwinBlock, SwinConfig,
                                              _rel_pos_index, _shift_mask,
                                              _window_partition,
                                              _window_reverse)
from idvs.morec_tpu_torch.ops.cuda.attention import (
    fused_mha_proj, fused_mha_proj_band, fused_mha_proj_band_plain,
    fused_mha_proj_plain)
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp, fused_mlp_plain,
                                               fused_mlp_res,
                                               fused_mlp_res_plain)

TOL = 2e-5
BF16_TOL = 2e-2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _attn_inputs(rng, lead, T, C, nh, P, shift_like=False):
    bias = rng.standard_normal((P, nh, T, T)) * 0.3
    if shift_like:      # the -100 of a shift mask on a third of the pairs
        bias = bias - 100.0 * (rng.uniform(size=(P, 1, T, T)) < 0.3)
    return (rng.standard_normal(lead + (C,)), bias,
            rng.standard_normal((C, 3 * C)) * 0.1,
            rng.standard_normal(3 * C) * 0.1,
            rng.standard_normal((C, C)) * 0.1, rng.standard_normal(C) * 0.1)


@pytest.mark.parametrize("N,Hp,Wp,C,nh,w,shifted", [
    (8, 28, 14, 64, 2, 7, False), (8, 28, 14, 64, 2, 7, True),
    (3, 8, 12, 32, 2, 4, False), (3, 8, 12, 32, 2, 4, True)])
def test_band_plain_matches_the_pallas_kernel(N, Hp, Wp, C, nh, w, shifted):
    rng = np.random.default_rng(11)
    nW = (Hp // w) * (Wp // w)
    args = _attn_inputs(rng, (N, Hp, Wp), w * w, C, nh,
                        nW if shifted else 1, shifted)
    want = jattn.fused_mha_proj_band(*map(_j, args), n_heads=nh, window=w,
                                     bias_grad=False, interpret=True)
    assert want is not None
    targs = list(map(_t, args))
    got = fused_mha_proj_band_plain(*targs, n_heads=nh, window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # on CPU tensors the wrapper takes the plain version, and counts nothing
    before = fused_mha_proj_band.launches
    torch.testing.assert_close(
        fused_mha_proj_band(*targs, n_heads=nh, window=w), got, rtol=0,
        atol=0)
    assert fused_mha_proj_band.launches == before


@pytest.mark.parametrize("B,T,C,nh,P", [(12, 7, 64, 2, 4), (8, 49, 32, 2, 1),
                                        (6, 16, 64, 4, 3)])
def test_windows_plain_matches_the_pallas_kernel(B, T, C, nh, P):
    rng = np.random.default_rng(5)
    args = _attn_inputs(rng, (B, T), T, C, nh, P, shift_like=(P > 1))
    want = jattn.fused_mha_proj(*map(_j, args), n_heads=nh, bias_grad=False,
                                interpret=True)
    targs = list(map(_t, args))
    got = fused_mha_proj_plain(*targs, n_heads=nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    before = fused_mha_proj.launches
    torch.testing.assert_close(fused_mha_proj(*targs, n_heads=nh), got,
                               rtol=0, atol=0)
    assert fused_mha_proj.launches == before


def test_band_plain_matches_the_pallas_kernel_in_bf16():
    """The rounding points: qkv, the bias, the probabilities, the context
    and the output are cast to bfloat16 on both sides."""
    rng = np.random.default_rng(12)
    N, Hp, Wp, C, nh, w = 4, 14, 14, 64, 2, 7
    args = _attn_inputs(rng, (N, Hp, Wp), 49, C, nh, 4, True)
    jargs = [_j(a, jnp.bfloat16) for a in args]
    jargs[1] = _j(args[1])                      # the bias arrives in float32
    want = jattn.fused_mha_proj_band(*jargs, n_heads=nh, window=w,
                                     bias_grad=False, interpret=True)
    targs = [_t(a, torch.bfloat16) for a in args]
    targs[1] = _t(args[1])
    got = fused_mha_proj_band_plain(*targs, n_heads=nh, window=w)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_TOL)


def _mlp_inputs(rng, M, C, F):
    return (rng.standard_normal((M, C)),
            rng.standard_normal((C, F)) * C ** -0.5,
            rng.standard_normal(F) * 0.1,
            rng.standard_normal((F, C)) * F ** -0.5,
            rng.standard_normal(C) * 0.1,
            1.0 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C))


@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
@pytest.mark.parametrize("ln", [True, False])
def test_mlp_plain_matches_the_pallas_kernel(ln, act):
    rng = np.random.default_rng(7)
    *args, g, b = _mlp_inputs(rng, 50, 32, 128)
    want = jmlp.fused_mlp(*map(_j, args), ln=(_j(g), _j(b)) if ln else None,
                          eps=1e-5, act=act, interpret=True)
    assert want is not None
    targs = list(map(_t, args))
    kw = dict(ln=(_t(g), _t(b)) if ln else None, eps=1e-5, act=act)
    got = fused_mlp_plain(*targs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    before = fused_mlp.launches
    torch.testing.assert_close(fused_mlp(*targs, **kw), got, rtol=0, atol=0)
    assert fused_mlp.launches == before


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_res_plain_matches_the_pallas_kernel(dtype, scaled):
    rng = np.random.default_rng(8)
    M = 3 * 16
    x, *ws, g, b = _mlp_inputs(rng, M, 32, 128)
    x = x.reshape(3, 16, 32)
    # DropPath's factor: one keep/drop an image over the keep probability
    scale = (np.repeat(np.array([1.25, 0.0, 1.25]), 16) if scaled else None)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmlp.fused_mlp_res(
        _j(x, jd), None if scale is None else _j(scale),
        *[_j(a, jd) for a in ws], ln=(_j(g), _j(b)), eps=1e-5,
        interpret=True)
    assert want is not None
    targs = [_t(x, td), None if scale is None else _t(scale),
             *[_t(a, td) for a in ws]]
    kw = dict(ln=(_t(g), _t(b)), eps=1e-5)
    got = fused_mlp_res_plain(*targs, **kw)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol if dtype == "float32" else 0,
                               atol=tol)
    before = fused_mlp_res.launches
    torch.testing.assert_close(fused_mlp_res(*targs, **kw), got, rtol=0,
                               atol=0)
    assert fused_mlp_res.launches == before


def test_window_helpers_match_jax():
    for w in (4, 7):
        np.testing.assert_array_equal(_rel_pos_index(w),
                                      jswin._rel_pos_index(w))
    np.testing.assert_array_equal(_shift_mask(14, 21, 7, 3),
                                  jswin._shift_mask(14, 21, 7, 3))
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(
        np.float32)
    wins = _window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(_window_reverse(wins, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("kernels", ["band", "windows"])
@pytest.mark.parametrize("resolution,shift", [((8, 8), False), ((8, 8), True),
                                              ((10, 6), True),   # pad path
                                              ((4, 4), True)])   # one window
def test_swin_block_matches_flax(resolution, shift, kernels):
    """SwinBlock against the Flax block's XLA composition (fused=False),
    with the Flax init tree loaded through convert.from_flax."""
    kw = dict(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4,
              drop_path_rate=0.0)
    H, W = resolution
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, H * W, 32)).astype(np.float32)
    jblk = jswin.SwinBlock(jswin.SwinConfig(**kw), 32, 2, resolution,
                           shift=shift, drop_path=0.0, fused=False)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    # biases and the table are zero or tiny at init: perturb every leaf
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), params)
    want = np.asarray(jax.jit(jblk.apply)(params, jnp.asarray(x)))
    blk = SwinBlock(SwinConfig(**kw), 32, 2, resolution, shift=shift,
                    drop_path=0.0, kernels=kernels, device="cpu").eval()
    blk.load_state_dict(convert.from_flax(params), strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_swin_block_refuses_what_is_not_ported():
    """An unknown kernel selection raises; a block built with both Swin
    dropouts serves in eval mode and trains with both in training mode,
    where they draw from the generator; DropPath's training draw runs and
    drops whole images."""
    cfg = SwinConfig(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4)
    with pytest.raises(ValueError):
        SwinBlock(cfg, 32, 2, (8, 8), False, 0.0, kernels="auto",
                  device="cpu")
    drops = SwinBlock(SwinConfig(hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1), 32, 2,
                      (8, 8), False, 0.0, device="cpu")
    init_parameters(drops, torch.Generator().manual_seed(0))
    x = torch.randn(1, 64, 32, generator=torch.Generator().manual_seed(4))
    assert torch.isfinite(drops.eval()(x)).all()
    drops.train()
    with pytest.raises(ValueError):               # no generator to draw from
        drops(x)
    out = drops(x, torch.Generator().manual_seed(3))
    assert torch.isfinite(out).all() and not torch.equal(out, drops.eval()(x))
    blk = SwinBlock(cfg, 32, 2, (8, 8), False, 0.5, device="cpu").train()
    init_parameters(blk, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):               # no generator to draw from
        blk(torch.zeros(1, 64, 32))
    x = torch.randn(16, 64, 32, generator=torch.Generator().manual_seed(1))
    out = blk(x, torch.Generator().manual_seed(2))
    # an image whose two branches were both dropped comes through unchanged
    same = (out == x).reshape(16, -1).all(dim=1)
    assert 0 < int(same.sum()) < 16
