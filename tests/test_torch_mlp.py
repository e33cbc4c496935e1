"""Port's post-LN epilogues (plain PyTorch versions, the CPU dispatch) and
layer_norm vs the JAX package: fused_proj_resln / fused_mlp_resln as the
Pallas kernels run in interpret mode (tests/test_pallas_mlp.py), layer_norm
as flax nn.LayerNorm. Same numpy inputs; float32 rtol 1e-5 as there, and
rtol 2e-4 / atol 2e-5 for gradients (test_pallas_mlp.py:192)."""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas.mlp import (fused_mlp_resln as jax_mlp_resln,
                                           fused_proj_resln as jax_proj_resln)
from idvs.morec_tpu_torch.models.layers import layer_norm
from idvs.morec_tpu_torch.ops.cuda.mlp import fused_mlp_resln, fused_proj_resln

RTOL, ATOL = 1e-5, 1e-5


def _ln_params(rng, C):
    return ((1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("eps,zero_bias", [(1e-12, False), (1e-6, True)])
def test_proj_resln_matches_pallas(eps, zero_bias):
    """BERT's attention tail (eps 1e-12) and SASRec's (eps 1e-6, zero
    bias); odd M exercises the JAX kernel's row padding."""
    rng = np.random.default_rng(13)
    C, M = 64, 41
    x = rng.standard_normal((M, C)).astype(np.float32)
    res = rng.standard_normal((M, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((C, C))).astype(np.float32)
    b = (np.zeros(C) if zero_bias else 0.1 * rng.standard_normal(C)
         ).astype(np.float32)
    g, bt = _ln_params(rng, C)
    want = jax_proj_resln(*map(jnp.asarray, (x, res, w, b)),
                          ln2=(jnp.asarray(g), jnp.asarray(bt)), eps2=eps,
                          drop_rate=0.0, interpret=True)
    x_, r_, w_, b_, g_, bt_ = _t(x, res, w, b, g, bt)
    got = fused_proj_resln(x_, r_, w_, b_, ln=(g_, bt_), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act,eps", [("gelu", 1e-12), ("gelu", 1e-6),
                                     ("relu", 1e-12), ("relu", 1e-6),
                                     ("quick_gelu", 1e-5)])
def test_mlp_resln_matches_pallas(act, eps):
    """BERT's FFN tail (exact GELU), SASRec's (ReLU), both epsilons, and the
    entry point's quick_gelu, which no main path takes. The Pallas kernel's
    GELU uses an A&S erf (5e-7 from exact), inside RTOL."""
    rng = np.random.default_rng(11)
    C, F, M = 64, 256, 40
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(F)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g, bt = _ln_params(rng, C)
    want = jax_mlp_resln(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                         ln2=(jnp.asarray(g), jnp.asarray(bt)), eps2=eps,
                         drop_rate=0.0, act=act, interpret=True)
    x_, w1_, b1_, w2_, b2_, g_, bt_ = _t(x, w1, b1, w2, b2, g, bt)
    got = fused_mlp_resln(x_, w1_, b1_, w2_, b2_, ln=(g_, bt_), eps=eps,
                          act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_epilogues_keep_leading_dims_and_bf16():
    """(B, T, C) in -> (B, T, C) out; bf16 in -> bf16 out, with the pre-LN
    sum rounded to bf16 before the statistics, as the JAX kernel."""
    rng = np.random.default_rng(5)
    B, T, C, F = 3, 7, 32, 128
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32)
    b1, b2 = np.zeros(F, np.float32), np.zeros(C, np.float32)
    g, bt = _ln_params(rng, C)
    want = jax_mlp_resln(jnp.asarray(x, jnp.bfloat16),
                         *(jnp.asarray(a, jnp.bfloat16)
                           for a in (w1, b1, w2, b2)),
                         ln2=(jnp.asarray(g), jnp.asarray(bt)), eps2=1e-12,
                         interpret=True)
    x_, w1_, b1_, w2_, b2_, g_, bt_ = _t(x, w1, b1, w2, b2, g, bt)
    got = fused_mlp_resln(x_.bfloat16(), w1_, b1_, w2_, b2_, ln=(g_, bt_),
                          eps=1e-12)
    assert got.shape == (B, T, C) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=4e-2)


@pytest.mark.parametrize("call", ["proj_drop", "mlp_drop", "mlp_act",
                                  "mlp_shape"])
def test_epilogues_reject_bad_arguments(call):
    C, F = 32, 128
    x = torch.zeros(4, C)
    ln = (torch.ones(C), torch.zeros(C))
    w1, b1, w2, b2 = (torch.zeros(C, F), torch.zeros(F), torch.zeros(F, C),
                      torch.zeros(C))
    if call == "proj_drop":           # dropout needs a seed
        with pytest.raises(ValueError):
            fused_proj_resln(x, x, torch.zeros(C, C), b2, ln=ln, eps=1e-6,
                             drop_rate=0.1)
    elif call == "mlp_drop":          # and a rate below 1
        with pytest.raises(ValueError):
            fused_mlp_resln(x, w1, b1, w2, b2, ln=ln, eps=1e-6,
                            drop_rate=1.0, seed=0)
    elif call == "mlp_act":           # an activation no kernel has
        with pytest.raises(ValueError):
            fused_mlp_resln(x, w1, b1, w2, b2, ln=ln, eps=1e-6,
                            act="swish")
    else:
        with pytest.raises(ValueError):
            fused_mlp_resln(x, w1, b1, w2[:, :C - 1], b2, ln=ln, eps=1e-6)


@pytest.mark.parametrize("eps", [1e-12, 1e-6])
def test_layer_norm_matches_flax(eps):
    """Fast-variance float32 statistics, as flax nn.LayerNorm."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 9, 48)) + 0.5).astype(np.float32)
    g, bt = _ln_params(rng, 48)
    ln = nn.LayerNorm(epsilon=eps)
    want = ln.apply({"params": {"scale": jnp.asarray(g),
                                "bias": jnp.asarray(bt)}}, jnp.asarray(x))
    got = layer_norm(*_t(x, g, bt), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _cot(rng, M, C):
    return rng.standard_normal((M, C)).astype(np.float32)


def _check_grads(jax_fn, port_fn, args):
    """jax.grad vs autograd of sum(out * cot) over every argument."""
    want = jax.grad(jax_fn, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    port_fn(*ts).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("eps,zero_bias", [(1e-12, False), (1e-6, True)])
def test_proj_resln_gradients_match_pallas(eps, zero_bias):
    """dx, dres, dw, db, dgamma, dbeta against jax.grad through the Pallas
    _bwd_proj_kernel (interpret mode)."""
    rng = np.random.default_rng(17)
    C, M = 64, 41
    x, res = _cot(rng, M, C), _cot(rng, M, C)
    w = (0.1 * rng.standard_normal((C, C))).astype(np.float32)
    b = (np.zeros(C) if zero_bias else 0.1 * rng.standard_normal(C)
         ).astype(np.float32)
    g, bt = _ln_params(rng, C)
    cot = _cot(rng, M, C)
    _check_grads(
        lambda *a: jnp.sum(jax_proj_resln(
            *a[:4], ln2=(a[4], a[5]), eps2=eps, drop_rate=0.0,
            interpret=True) * cot),
        lambda *a: (fused_proj_resln(*a[:4], ln=(a[4], a[5]), eps=eps)
                    * torch.from_numpy(cot)).sum(),
        (x, res, w, b, g, bt))


@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
def test_mlp_resln_gradients_match_pallas(act):
    """dx, dw1, db1, dw2, db2, dgamma, dbeta against jax.grad through the
    Pallas _bwd_post_kernel (interpret mode)."""
    rng = np.random.default_rng(19)
    C, F, M = 64, 256, 40
    x = _cot(rng, M, C)
    w1 = (rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(F)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g, bt = _ln_params(rng, C)
    cot = _cot(rng, M, C)
    _check_grads(
        lambda *a: jnp.sum(jax_mlp_resln(
            *a[:5], ln2=(a[5], a[6]), eps2=1e-12, drop_rate=0.0, act=act,
            interpret=True) * cot),
        lambda *a: (fused_mlp_resln(*a[:5], ln=(a[5], a[6]), eps=1e-12,
                                    act=act) * torch.from_numpy(cot)).sum(),
        (x, w1, b1, w2, b2, g, bt))


def test_tail_dropout_is_the_masked_branch():
    """drop_rate > 0 drops the matmul branch (bias included) with the mask
    of ops/dropout.py over the (M, C) view, before the residual add."""
    from idvs.morec_tpu_torch.ops import dropout
    rng = np.random.default_rng(23)
    C, M, p = 32, 6, 0.25
    x, res = map(torch.from_numpy, (_cot(rng, M, C), _cot(rng, M, C)))
    w = torch.from_numpy(_cot(rng, C, C))
    b = torch.from_numpy(0.1 * _cot(rng, 1, C)[0])
    ln = (torch.ones(C), torch.zeros(C))
    got = fused_proj_resln(x, res, w, b, ln=ln, eps=1e-6, drop_rate=p,
                           seed=5)
    keep = dropout.keep_mask(5, (M, C), p)
    y = torch.where(keep, (x @ w + b) * dropout.scale(p), 0.0)
    torch.testing.assert_close(got, layer_norm(y + res, *ln, 1e-6),
                               rtol=1e-5, atol=1e-5)
