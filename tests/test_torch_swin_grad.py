"""Gradients of the Swin kernels' plain versions (autograd) against
``jax.grad`` of the JAX package's XLA composition on the CPU: the pre-LN MLP
in every edition (LN / no LN, save_h, the residual tail unit and scaled, the
three activations), the windowed attention in both layouts with one bias
(P = 1) and a bias per window (P = nW), and a whole ``SwinBlock`` against
``SwinBlock(fused=False)`` with the table's gradient compared by name. The
fused JAX kernels' own VJPs are not the reference here: the XLA composition
is what the JAX package holds them against.

Tolerances, on each gradient's own scale max(1, max |reference|). float32:
2e-5, sums in other orders and the two packages' erf. bfloat16: the
composition rounds after every XLA op, the plain version at the kernel's
rounding points (float32 accumulation between them), so single roundings
differ on every element: 4e-2, a few bf16 units (2^-8) of the largest value
summed over tens of rows.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.layers import layer_norm as jax_layer_norm
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.swin import SwinBlock, SwinConfig
from idvs.morec_tpu_torch.ops.cuda.attention import (fused_mha_proj,
                                                     fused_mha_proj_band)
from idvs.morec_tpu_torch.ops.cuda.mlp import fused_mlp, fused_mlp_res

TOL = {"float32": 2e-5, "bfloat16": 4e-2}
EPS = 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _assert_grads(got, want, names, tol):
    for name, g, w in zip(names, got, want):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, name
        scale = max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= tol * scale, (name, np.abs(g - w).max(),
                                                    scale)


def _jax_act(h, act):
    if act == "relu":
        return jnp.maximum(h, 0.0)
    if act == "quick_gelu":
        return h * jax.nn.sigmoid(1.702 * h)
    return jax.nn.gelu(h, approximate=False)


def _jax_mlp(x, w1, b1, w2, b2, g=None, b=None, *, act, res, scale):
    """models/swin.py's XLA fallback of the MLP sub-block (:343-350)."""
    h = x if g is None else jax_layer_norm(x, g, b, EPS)
    h = _jax_act(jnp.dot(h, w1) + b1, act)
    y = jnp.dot(h, w2) + b2
    if scale is not None:
        y = y * scale[:, None].astype(y.dtype)
    return x + y if res else y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edition,act", [
    ("ln", "gelu"), ("no_ln", "gelu"), ("save_h", "gelu"),
    ("res_unit", "gelu"), ("res_scaled", "gelu"), ("ln", "relu"),
    ("save_h", "quick_gelu")])
def test_mlp_plain_gradients_match_the_xla_composition(edition, act, dtype):
    rng = np.random.default_rng(21)
    M, C, F = 3 * 16, 32, 128
    arrays = [rng.standard_normal((M, C)),
              rng.standard_normal((C, F)) * C ** -0.5,
              rng.standard_normal(F) * 0.1,
              rng.standard_normal((F, C)) * F ** -0.5,
              rng.standard_normal(C) * 0.1]
    names = ["x", "w1", "b1", "w2", "b2"]
    if edition != "no_ln":
        arrays += [1.0 + 0.1 * rng.standard_normal(C),
                   0.1 * rng.standard_normal(C)]
        names += ["gamma", "beta"]
    dout = rng.standard_normal((M, C))
    # DropPath's factor: one keep/drop an image over the keep probability
    scale = (np.repeat(np.array([1.25, 0.0, 1.25], np.float32), 16)
             if edition == "res_scaled" else None)
    res = edition.startswith("res")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # the LayerNorm's parameters stay float32 on both sides
    cast = lambda i, f32, low: f32 if i >= 5 else low

    jargs = [_j(a, cast(i, jnp.float32, jd)) for i, a in enumerate(arrays)]
    loss = lambda *a: jnp.sum(
        _jax_mlp(*a, act=act, res=res,
                 scale=None if scale is None else _j(scale)).astype(
                     jnp.float32) * _j(dout))
    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(jargs)))))(*jargs)

    targs = [_t(a, cast(i, torch.float32, td)).requires_grad_(True)
             for i, a in enumerate(arrays)]
    ln = tuple(targs[5:]) or None
    if res:
        out = fused_mlp_res(targs[0], None if scale is None else _t(scale),
                            *targs[1:5], ln=ln, eps=EPS, act=act)
    else:
        out = fused_mlp(*targs[:5], ln=ln, eps=EPS, act=act,
                        save_h=edition == "save_h")
    got = torch.autograd.grad(out, targs, _t(dout, td))
    _assert_grads(got, want, names, TOL[dtype])


def _jax_attention(x, bias, wqkv, bqkv, wo, bo, nh, window=None):
    """The XLA composition of models/swin.py SwinBlock (:228-255) on windows
    (B, T, C), or on a (N, Hp, Wp, C) map between the block's partition and
    reverse."""
    shape = x.shape
    if window is not None:
        x = jswin._window_partition(x, window)
    B, T, C = x.shape
    dh = C // nh
    qkv = jnp.dot(x, wqkv) + bqkv
    q, k, v = (t.reshape(B, T, nh, dh) for t in jnp.split(qkv, 3, axis=-1))
    attn = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                      preferred_element_type=jnp.float32) / math.sqrt(dh)
    attn = attn + jnp.tile(bias.astype(x.dtype).astype(jnp.float32),
                           (B // bias.shape[0], 1, 1, 1))
    p = jax.nn.softmax(attn, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, C)
    out = jnp.dot(out, wo) + bo
    if window is not None:
        out = jswin._window_reverse(out, window, shape[1], shape[2])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_window", [False, True])
@pytest.mark.parametrize("layout", ["band", "windows"])
def test_attention_plain_gradients_match_the_xla_composition(layout,
                                                             per_window,
                                                             dtype):
    rng = np.random.default_rng(22)
    N, Hp, Wp, C, nh, w = 3, 8, 12, 32, 2, 4
    nW, T = (Hp // w) * (Wp // w), w * w
    P = nW if per_window else 1
    bias = rng.standard_normal((P, nh, T, T)) * 0.3
    if per_window:      # the -100 of a shift mask on a third of the pairs
        bias = bias - 100.0 * (rng.uniform(size=(P, 1, T, T)) < 0.3)
    lead = (N, Hp, Wp) if layout == "band" else (N * nW, T)
    arrays = [rng.standard_normal(lead + (C,)), bias,
              rng.standard_normal((C, 3 * C)) * 0.1,
              rng.standard_normal(3 * C) * 0.1,
              rng.standard_normal((C, C)) * 0.1,
              rng.standard_normal(C) * 0.1]
    names = ["x", "dbias", "wqkv", "bqkv", "wo", "bo"]
    dout = rng.standard_normal(lead + (C,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # the bias arrives in float32 on both sides
    cast = lambda i, f32, low: f32 if i == 1 else low

    jargs = [_j(a, cast(i, jnp.float32, jd)) for i, a in enumerate(arrays)]
    window = w if layout == "band" else None
    loss = lambda *a: jnp.sum(_jax_attention(*a, nh, window).astype(
        jnp.float32) * _j(dout))
    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*jargs)

    targs = [_t(a, cast(i, torch.float32, td)).requires_grad_(True)
             for i, a in enumerate(arrays)]
    if layout == "band":
        out = fused_mha_proj_band(*targs, n_heads=nh, window=w)
    else:
        out = fused_mha_proj(*targs, n_heads=nh)
    got = torch.autograd.grad(out, targs, _t(dout, td))
    assert got[1].shape == (P, nh, T, T) and got[1].dtype == torch.float32
    assert got[3].shape == (3 * C,) and got[5].shape == (C,)
    _assert_grads(got, want, names, TOL[dtype])


@pytest.mark.parametrize("kernels", ["band", "windows"])
@pytest.mark.parametrize("resolution,shift", [((8, 8), False), ((8, 8), True),
                                              ((10, 6), True)])   # pad path
def test_swin_block_gradients_match_flax(resolution, shift, kernels):
    """Every parameter's gradient (the relative position bias table's by
    name) and the input's, SwinBlock against the Flax block's XLA
    composition, float32."""
    kw = dict(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4,
              drop_path_rate=0.0)
    H, W = resolution
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, H * W, 32)).astype(np.float32)
    dout = rng.standard_normal((3, H * W, 32)).astype(np.float32)
    jblk = jswin.SwinBlock(jswin.SwinConfig(**kw), 32, 2, resolution,
                           shift=shift, drop_path=0.0, fused=False)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), params)
    loss = lambda p, xx: jnp.sum(jblk.apply(p, xx) * jnp.asarray(dout))
    jg_params, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    want = convert.from_flax(jax.tree.map(np.asarray, jg_params))

    blk = SwinBlock(SwinConfig(**kw), 32, 2, resolution, shift=shift,
                    drop_path=0.0, kernels=kernels, device="cpu").train()
    blk.load_state_dict(convert.from_flax(params), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    blk(tx).backward(torch.from_numpy(dout))
    assert "relative_position_bias_table" in want
    tol = TOL["float32"]
    for name, p in blk.named_parameters():
        w_ = want[name].numpy()
        scale = max(1.0, np.abs(w_).max())
        assert np.abs(p.grad.numpy() - w_).max() <= tol * scale, name
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), rtol=0,
                               atol=tol * max(1.0, np.abs(jg_x).max()))
