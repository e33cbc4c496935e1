"""Port's fused_mha (plain PyTorch version, the CPU dispatch) vs the JAX
Pallas kernel run in interpret mode, as tests/test_fused_attention.py runs
it. Same numpy inputs on both sides; float32 tolerance 2e-5 as there, and
rtol 2e-4 / atol 2e-5 for gradients (test_fused_attention.py:192)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.masking import causal_additive_mask as jax_causal
from idvs.morec_tpu.ops.pallas.attention import fused_mha as jax_fused_mha
from idvs.morec_tpu_torch.ops.cuda.attention import fused_mha
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask

TOL = 2e-5


def _qkv(rng, B, T, H):
    return rng.standard_normal((B, T, 3 * H)).astype(np.float32)


@pytest.mark.parametrize("B,T,H,nh", [(8, 30, 64, 4), (6, 12, 48, 2)])
def test_mask_mode_matches_pallas(B, T, H, nh):
    rng = np.random.default_rng(0)
    qkv = _qkv(rng, B, T, H)
    mask = (rng.uniform(size=(B, T)) < 0.8).astype(np.float32)
    want = jax_fused_mha(jnp.asarray(qkv), jnp.asarray(mask), n_heads=nh,
                         interpret=True)
    got = fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask),
                    n_heads=nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_fully_masked_rows_are_uniform_and_finite():
    B, T, H, nh = 4, 10, 32, 2
    rng = np.random.default_rng(2)
    qkv = _qkv(rng, B, T, H)
    mask = np.zeros((B, T), np.float32)
    mask[1, :3] = 1.0          # one row keeps some keys
    want = jax_fused_mha(jnp.asarray(qkv), jnp.asarray(mask), n_heads=nh,
                         interpret=True)
    got = fused_mha(torch.from_numpy(qkv), torch.from_numpy(mask),
                    n_heads=nh).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # all keys masked -> uniform probabilities -> the mean of v over keys
    v = qkv[0, :, 2 * H:]
    np.testing.assert_allclose(got[0], np.broadcast_to(v.mean(0), (T, H)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,P,nh,dh,shared_heads", [
    (8, 8, 4, 16, False),    # P == B, per-head bias
    (8, 8, 2, 16, True),     # P == B, one (T, T) plane for every head
    (32, 4, 4, 16, False),   # cyclic: row r takes bias[r % P]
    (24, 3, 2, 16, False),   # cyclic, period indivisible by the JAX block
])
def test_bias_mode_matches_pallas(B, P, nh, dh, shared_heads):
    T, H = 10, nh * dh
    rng = np.random.default_rng(6)
    qkv = _qkv(rng, B, T, H)
    bias = (rng.standard_normal((P, 1 if shared_heads else nh, T, T))
            * 3.0).astype(np.float32)
    want = jax_fused_mha(jnp.asarray(qkv),
                         bias=jnp.broadcast_to(jnp.asarray(bias),
                                               (P, nh, T, T)),
                         n_heads=nh, interpret=True)
    got = fused_mha(torch.from_numpy(qkv), bias=torch.from_numpy(bias),
                    n_heads=nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_sasrec_causal_bias_matches_pallas():
    """SASRec's left-padded causal mask, shared by both heads: the leading
    padded query rows see no valid key."""
    B, L, D, nh = 6, 8, 32, 2
    rng = np.random.default_rng(7)
    lens = rng.integers(1, L + 1, size=B)
    log_mask = (np.arange(L)[None] >= L - lens[:, None]).astype(np.float32)
    bias_t = causal_additive_mask(torch.from_numpy(log_mask))
    bias_j = jax_causal(jnp.asarray(log_mask))
    np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    qkv = _qkv(rng, B, L, D)
    want = jax_fused_mha(jnp.asarray(qkv),
                         bias=jnp.broadcast_to(bias_j, (B, nh, L, L)),
                         n_heads=nh, interpret=True)
    got = fused_mha(torch.from_numpy(qkv), bias=bias_t, n_heads=nh)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_bf16_casts_like_pallas():
    """bf16: the mask is cast to bf16, probabilities are cast to bf16
    before P.V, and the output is bf16 (tolerance 2e-2 as the JAX test)."""
    B, T, H, nh = 8, 30, 64, 4
    rng = np.random.default_rng(0)
    qkv = _qkv(rng, B, T, H)
    mask = (rng.uniform(size=(B, T)) < 0.8).astype(np.float32)
    want = jax_fused_mha(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask),
                         n_heads=nh, interpret=True)
    got = fused_mha(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(mask),
                    n_heads=nh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(mask=None, bias=None), ValueError),
    (dict(mask=np.ones((4, 10)), bias=np.zeros((4, 2, 10, 10))), ValueError),
    (dict(mask=np.ones((4, 9))), ValueError),
    (dict(bias=np.zeros((3, 2, 10, 10))), ValueError),   # 3 does not divide 4
    (dict(bias=np.zeros((4, 3, 10, 10))), ValueError),   # head dim 3 != 2
    (dict(bias=torch.zeros(4, 2, 10, 9, requires_grad=True)),
     ValueError),                             # a trainable bias not (T, T)
    (dict(mask=np.ones((4, 10)), drop_rate=0.1), ValueError),   # no seed
    (dict(mask=np.ones((4, 10)), drop_rate=1.0, seed=3), ValueError),
])
def test_rejects_bad_arguments(kwargs, exc):
    qkv = torch.zeros(4, 10, 3 * 32)
    kw = {k: (torch.from_numpy(np.asarray(v, np.float32))
              if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    with pytest.raises(exc):
        fused_mha(qkv, n_heads=2, **kw)


def _grads(B, T, H, nh, bias, seed):
    """(port dqkv, JAX dqkv) of sum(sin(fused_mha(qkv))): BERT's key mask
    with fully masked rows (bias None), SASRec's causal bias shared by all
    heads ("causal"), or a per-head bias of period 2 that cycles over the
    rows ("cyclic")."""
    rng = np.random.default_rng(seed)
    qkv = _qkv(rng, B, T, H)
    if bias == "causal":
        lens = rng.integers(1, T + 1, size=B)
        log_mask = (np.arange(T)[None] >= T - lens[:, None]).astype(
            np.float32)
        bias_j = jax_causal(jnp.asarray(log_mask))
        kw_t = dict(bias=causal_additive_mask(torch.from_numpy(log_mask)))
        kw_j = dict(bias=jnp.broadcast_to(bias_j, (B, nh, T, T)))
    elif bias == "cyclic":
        table = (2.0 * rng.standard_normal((2, nh, T, T))).astype(np.float32)
        kw_t, kw_j = dict(bias=torch.from_numpy(table)), dict(
            bias=jnp.asarray(table))
    else:
        lens = rng.integers(0, T + 1, size=B)          # 0: every key masked
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        kw_t = dict(mask=torch.from_numpy(mask))
        kw_j = dict(mask=jnp.asarray(mask))
    want = jax.grad(lambda q: jnp.sum(jnp.sin(jax_fused_mha(
        q, n_heads=nh, interpret=True, **kw_j))))(jnp.asarray(qkv))
    q = torch.from_numpy(qkv).requires_grad_()
    torch.sin(fused_mha(q, n_heads=nh, **kw_t)).sum().backward()
    return q.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("B,T,H,nh,bias", [(8, 30, 64, 4, None),
                                          (6, 20, 64, 2, "causal"),
                                          (6, 10, 32, 2, "cyclic")])
def test_gradients_match_pallas(B, T, H, nh, bias):
    """dqkv of BERT's key-mask mode and of the bias mode (SASRec's causal
    bias, a cyclic per-head bias) against jax.grad through the Pallas
    backward kernel (interpret mode)."""
    got, want = _grads(B, T, H, nh, bias, seed=B)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_dropout_drops_the_cast_probabilities():
    """drop_rate > 0: the plain version equals a by-hand attention whose
    (B, nh, T, T) probabilities carry the mask of ops/dropout.py; the same
    seed repeats the output, another seed changes it."""
    from idvs.morec_tpu_torch.ops import dropout
    B, T, H, nh, p = 3, 7, 16, 2, 0.3
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(_qkv(rng, B, T, H))
    mask = torch.ones(B, T)
    got = fused_mha(qkv, mask, n_heads=nh, drop_rate=p, seed=11)
    q, k, v = (t.reshape(B, T, nh, H // nh).transpose(1, 2)
               for t in qkv.split(H, dim=-1))
    probs = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(H // nh), -1)
    keep = dropout.keep_mask(11, probs.shape, p)
    probs = torch.where(keep, probs * dropout.scale(p), 0.0)
    want = (probs @ v).transpose(1, 2).reshape(B, T, H)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, fused_mha(qkv, mask, n_heads=nh, drop_rate=p,
                                      seed=11))
    assert not torch.equal(got, fused_mha(qkv, mask, n_heads=nh,
                                          drop_rate=p, seed=12))
