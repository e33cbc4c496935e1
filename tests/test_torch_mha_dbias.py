"""The gradient of fused_mha's trainable additive bias (Swin's relative-
position table under attention dropout): the port's plain version (the CPU
dispatch, autograd) against the JAX Pallas kernel's dbias
(``fused_mha(..., bias_grad=True, interpret=True)``) at Swin's T = 49 and
dh = 32, for a bias of period P = 1, P dividing B and P = B.

Tolerances: rtol 1e-4 / atol 1e-5, those of the JAX package's own dbias
test (tests/test_fused_attention.py:150-160: sums over the rows that share a
bias row, in other orders). bfloat16: the dbias both sides return is
rounded to bf16 before the cast's VJP, so it must hold bf16 values exactly;
against JAX 2e-2 of the largest value (a flipped rounding of the
probabilities or of the output moves a few bf16 units)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas.attention import fused_mha as jax_fused_mha
from idvs.morec_tpu_torch.ops.cuda.attention import fused_mha

T, DH = 49, 32


def _inputs(B, P, nh, heads, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, T, 3 * nh * DH)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((P, heads, T, T))).astype(np.float32)
    # a shift mask's -100 on a fifth of the pairs
    bias -= 100.0 * (rng.uniform(size=(P, 1, T, T)) < 0.2)
    g = rng.standard_normal((B, T, nh * DH)).astype(np.float32)
    return qkv, bias.astype(np.float32), g


def _port_grads(qkv, bias, g, nh, dtype=torch.float32):
    q = torch.from_numpy(qkv).to(dtype).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    out = fused_mha(q, bias=b, n_heads=nh)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return q.grad.float().numpy(), b.grad


def _jax_grads(qkv, bias, g, nh, dtype=jnp.float32):
    def loss(q, b):
        out = jax_fused_mha(q, bias=b, bias_grad=True, n_heads=nh,
                            interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))
    dq, db = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(qkv, dtype), jnp.asarray(bias))
    return np.asarray(dq, np.float32), np.asarray(db)


@pytest.mark.parametrize("B,P,nh", [(8, 1, 2),    # every row, one bias
                                    (8, 4, 3),    # Swin's shifted: P = nW
                                    (6, 6, 2)])   # a bias per row
def test_dbias_matches_pallas(B, P, nh):
    """dqkv and dbias (P, nh, T, T) of sum(fused_mha(qkv) * g)."""
    qkv, bias, g = _inputs(B, P, nh, nh, seed=B + P)
    got_q, got_b = _port_grads(qkv, bias, g, nh)
    want_q, want_b = _jax_grads(qkv, bias, g, nh)
    assert got_b.shape == (P, nh, T, T) and got_b.dtype == torch.float32
    np.testing.assert_allclose(got_q, want_q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-4, atol=1e-5)


def test_shared_bias_sums_the_heads():
    """A (P, 1, T, T) bias shared by the heads (a port-only layout; the JAX
    kernel takes per-head planes): its gradient is the per-head gradient of
    the same bias broadcast to every head, summed over the heads."""
    B, P, nh = 8, 2, 3
    qkv, bias, g = _inputs(B, P, nh, 1, seed=3)
    _, got = _port_grads(qkv, bias, g, nh)
    _, per_head = _port_grads(qkv, np.repeat(bias, nh, axis=1), g, nh)
    assert got.shape == (P, 1, T, T)
    torch.testing.assert_close(got, per_head.sum(1, keepdim=True),
                               rtol=1e-5, atol=1e-6)


def test_bf16_dbias_is_rounded_to_bf16():
    """bf16 qkv: dbias comes back to the float32 bias through its bf16
    cast, as the JAX kernel's ``dbias.astype(mask.dtype)``."""
    B, P, nh = 8, 4, 2
    qkv, bias, g = _inputs(B, P, nh, nh, seed=5)
    _, got = _port_grads(qkv, bias, g, nh, torch.bfloat16)
    _, want = _jax_grads(qkv, bias, g, nh, jnp.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def _pinned_case(case):
    """(qkv, bias, g, nh) of a shape where the card's bf16 tiles pad T and
    where a row's keys all sit at -1e9."""
    rng = np.random.default_rng(7)
    if case == "swin_shift":
        # two 14 x 14 maps in 7 x 7 windows, shifted by 3: P = nW = 4
        from idvs.morec_tpu_torch.models.swin import _shift_mask
        B, P, nh, T_, dh = 8, 4, 3, 49, 32
        bias = (0.5 * rng.standard_normal((1, nh, T_, T_))
                + _shift_mask(14, 14, 7, 3)[:, None]).astype(np.float32)
    elif case == "t1":
        B, P, nh, T_, dh = 6, 3, 2, 1, 16
        bias = rng.standard_normal((P, nh, T_, T_)).astype(np.float32)
    else:   # "masked_row": query row 5 of bias row 1 sees every key at -1e9
        B, P, nh, T_, dh = 4, 2, 2, 17, 16
        bias = rng.standard_normal((P, nh, T_, T_)).astype(np.float32)
        bias[1, :, 5, :] = -1e9
    qkv = rng.standard_normal((B, T_, 3 * nh * dh)).astype(np.float32)
    g = rng.standard_normal((B, T_, nh * dh)).astype(np.float32)
    return qkv, bias, g, nh


@pytest.mark.parametrize("case", ["swin_shift", "t1", "masked_row"])
def test_plain_version_at_padded_shapes_matches_pallas(case):
    """The plain version and its autograd (dqkv and dbias) against the
    Pallas kernel in interpret mode at the shapes whose T the card's bf16
    kernels pad to a multiple of 16: Swin's T = 49, dh = 32 under the real
    shift mask of -100 (P = nW), T = 1, and T = 17 with a query row whose
    keys are all at -1e9 (uniform over the 17 real keys, finite)."""
    qkv, bias, g, nh = _pinned_case(case)
    out = fused_mha(torch.from_numpy(qkv), bias=torch.from_numpy(bias),
                    n_heads=nh).numpy()
    want = np.asarray(jax_fused_mha(jnp.asarray(qkv), bias=jnp.asarray(bias),
                                    n_heads=nh, interpret=True))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    got_q, got_b = _port_grads(qkv, bias, g, nh)
    want_q, want_b = _jax_grads(qkv, bias, g, nh)
    assert np.isfinite(got_q).all() and torch.isfinite(got_b).all()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-4, atol=1e-5)
    if case == "masked_row":
        H = qkv.shape[-1] // 3
        v = qkv[1, :, 2 * H:]               # row 1 takes bias row 1
        np.testing.assert_allclose(out[1, 5], v.mean(0), rtol=1e-5,
                                   atol=1e-5)


def test_plain_version_fully_masked_row_gradient_matches_pallas():
    """BERT's key mask with a row whose keys are all masked, at T = 30 (the
    card pads it to 32): dqkv against the Pallas backward in interpret
    mode, finite."""
    B, T_, nh, dh = 4, 30, 2, 16
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((B, T_, 3 * nh * dh)).astype(np.float32)
    mask = (np.arange(T_)[None] < np.array([0, 30, 7, 1])[:, None]).astype(
        np.float32)
    g = rng.standard_normal((B, T_, nh * dh)).astype(np.float32)
    want = jax.grad(lambda q: jnp.sum(jax_fused_mha(
        q, jnp.asarray(mask), n_heads=nh, interpret=True) * jnp.asarray(g)))(
            jnp.asarray(qkv))
    q = torch.from_numpy(qkv).requires_grad_()
    (fused_mha(q, torch.from_numpy(mask), n_heads=nh)
     * torch.from_numpy(g)).sum().backward()
    assert torch.isfinite(q.grad).all()
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
