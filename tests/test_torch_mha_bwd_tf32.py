"""The arithmetic of fused_mha's float32 backward on the tensor cores
(csrc/mha_mma.cuh mha_bwd_tf32_kernel), modelled in plain PyTorch on the
CPU and held against the JAX package's Pallas backward (interpret mode, as
its own tests run it) and against autograd of the port's plain version.

The model computes what the kernel computes, in its order: every product
is 3xTF32 over 8-deep k-steps (each float split into big = tf32_rna(x) and
small = tf32_rna(x - big); a step sums small.big + big.small + big.big into
zeroed sums, which a float add takes to the running sum); the scores and dp
of wide heads (dh 256: four splits of each 16-row group at T = 20) are KS
partial sums over the head's columns added in order 0..KS-1; the softmax
backward is float; dbias sums each chunk's rows in order and then the
chunks in order. The kernel on the card is held against the plain version
in tests/test_torch_mha_tiles.py and chip_smoke.py.

Tolerances: dqkv rtol 2e-4 / atol 2e-5 (tests/test_torch_attention.py's
float32 gradients), dbias rtol 1e-4 / atol 1e-5 (tests/test_torch_mha_dbias.py).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.masking import causal_additive_mask as jax_causal
from idvs.morec_tpu.ops.pallas.attention import fused_mha as jax_fused_mha
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda.attention import fused_mha_plain
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DBIAS_TOL = dict(rtol=1e-4, atol=1e-5)
STEP = 8          # the depth of an m16n8k8 k-step
MAX_WARPS = 8     # of a float32 block (csrc/mha_mma.cuh kF32Warps)


def _up(n, m):
    return -(-n // m) * m


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, splits: int = 1):
    """a @ b over the last dim of a (zero-padded to a multiple of 16) as
    3xTF32 k-steps; with splits > 1 the k-steps are cut into that many
    shares, each summed alone, and the shares added in order."""
    K = a.shape[-1]
    Kp = _up(K, 16)
    a = torch.nn.functional.pad(a, (0, Kp - K))
    b = torch.nn.functional.pad(b, (0, 0, 0, Kp - K))
    steps = Kp // STEP
    total = None
    for ks in range(splits):
        c = torch.zeros(*a.shape[:-1], b.shape[-1])
        for s in range(ks * steps // splits, (ks + 1) * steps // splits):
            ab, as_ = split(a[..., s * STEP:(s + 1) * STEP])
            bb, bs = split(b[..., s * STEP:(s + 1) * STEP, :])
            d = (as_.double() @ bb.double()).float()
            d = (d.double() + ab.double() @ bs.double()).float()
            d = (d.double() + ab.double() @ bb.double()).float()
            c = c + d
        total = c if total is None else total + c
    return total


def splits_of(T: int, dh: int) -> int:
    """KS of csrc/mha_mma.cuh choose_f32: fewer than eight row groups of
    heads of 128 or more columns split each row group, up to eight warps,
    each at least 32 columns (the test shapes all fit)."""
    RG, Dp = _up(T, 16) // 16, _up(dh, 16)
    return min(MAX_WARPS // RG, Dp // 32) if RG < MAX_WARPS and Dp >= 128 \
        else 1


def model_backward(qkv, dout, nh, *, mask=None, bias=None, drop=0.0,
                   seed=None, chunks=1):
    """(dqkv, dbias) of fused_mha's float32 backward as the kernel computes
    them; dbias (P, heads, T, T) sums the unscaled ds of rows r % P = p,
    each of `chunks` shares of the rows in order, then the shares in order
    (and, for a bias shared by the heads, each share's heads in order)."""
    B, T, H3 = qkv.shape
    H = H3 // 3
    dh = H // nh
    scale = 1.0 / math.sqrt(dh)
    q, k, v = (t.reshape(B, T, nh, dh).transpose(1, 2)
               for t in qkv.split(H, dim=-1))
    o = dout.reshape(B, T, nh, dh).transpose(1, 2)
    KS = splits_of(T, dh)
    s = product(q, k.transpose(-1, -2), KS) * scale
    if mask is not None:
        s = s + ((1.0 - mask) * -1e9)[:, None, None, :]
    else:
        s = s + bias.repeat(B // bias.shape[0], 1, 1, 1)
    p = torch.softmax(s, dim=-1)
    dp = product(o, v.transpose(-1, -2), KS)
    if drop:
        keep = dropout.keep_mask(seed, (B, nh, T, T), drop)
        factor = dropout.scale(drop)
        dp = torch.where(keep, dp * factor, 0.0)
        pd = torch.where(keep, p * factor, 0.0)
    else:
        pd = p
    dot = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - dot)
    dsc = ds * scale
    dq = product(dsc, k)
    dk = product(dsc.transpose(-1, -2), q)
    dv = product(pd.transpose(-1, -2), o)
    packed = torch.cat([t.transpose(1, 2).reshape(B, T, H)
                        for t in (dq, dk, dv)], dim=-1)
    if bias is None:
        return packed, None
    P, heads = bias.shape[:2]
    rows = B // P
    per = -(-rows // chunks)
    parts = []
    for c in range(chunks):
        acc = torch.zeros(P, nh, T, T)
        for i in range(c * per, min(rows, (c + 1) * per)):
            acc = acc + ds[i * P:(i + 1) * P]
        parts.append(acc)
    dbias = torch.zeros(P, heads, T, T)
    for acc in parts:
        if heads == nh:
            dbias = dbias + acc
        else:
            for h in range(nh):
                dbias = dbias + acc[:, h:h + 1]
    return packed, dbias


def _jax_grads(qkv, g, nh, **kw):
    """dqkv (and dbias when a bias is given with bias_grad) of
    sum(fused_mha(qkv) * g) through the Pallas kernel in interpret mode."""
    dbias = "bias" in kw and kw.pop("bias_grad", False)

    def loss(q, *b):
        extra = dict(bias=b[0], bias_grad=True) if b else {}
        out = jax_fused_mha(q, n_heads=nh, interpret=True, **kw, **extra)
        return jnp.sum(out * jnp.asarray(g))

    if dbias:
        table = kw.pop("bias")
        dq, db = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(qkv), jnp.asarray(table))
        return np.asarray(dq), np.asarray(db)
    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(qkv))), None


def _plain_grads(qkv, g, nh, bias=None, **kw):
    q = torch.from_numpy(qkv).requires_grad_()
    b = None if bias is None else torch.from_numpy(bias).requires_grad_()
    (fused_mha_plain(q, n_heads=nh, bias=b, **kw)
     * torch.from_numpy(g)).sum().backward()
    return q.grad.numpy(), None if b is None else b.grad.numpy()


def _inputs(rng, B, T, nh, dh):
    qkv = rng.standard_normal((B, T, 3 * nh * dh)).astype(np.float32)
    g = rng.standard_normal((B, T, nh * dh)).astype(np.float32)
    return qkv, g


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """big + small rebuilds a float to about 2^-22 of it; tf32_rna keeps 10
    stored mantissa bits, rounding half away from zero."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    big, small = split(x)
    assert (big.view(torch.int32) & 0x1fff).eq(0).all()
    assert (small.view(torch.int32) & 0x1fff).eq(0).all()
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(one).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_mask_mode_with_a_fully_masked_row():
    """BERT's key mask at T 30, heads of 64: row 0 has every key masked and
    comes out uniform over its 30 keys."""
    B, T, nh, dh = 4, 30, 2, 64
    rng = np.random.default_rng(30)
    qkv, g = _inputs(rng, B, T, nh, dh)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = 0
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    got, _ = model_backward(torch.from_numpy(qkv), torch.from_numpy(g), nh,
                            mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    want, _ = _jax_grads(qkv, g, nh, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    plain, _ = _plain_grads(qkv, g, nh, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), plain, **GRAD_TOL)


def test_sasrec_causal_bias_with_split_heads():
    """SASRec's left-padded causal bias shared by 2 heads of 256 at T 20:
    each row group's scores and dp are four partial sums added in order."""
    B, T, nh, dh = 4, 20, 2, 256
    assert splits_of(T, dh) == 4
    rng = np.random.default_rng(20)
    qkv, g = _inputs(rng, B, T, nh, dh)
    lens = rng.integers(1, T + 1, size=B)
    log_mask = (np.arange(T)[None] >= T - lens[:, None]).astype(np.float32)
    bias = causal_additive_mask(torch.from_numpy(log_mask))
    got, _ = model_backward(torch.from_numpy(qkv), torch.from_numpy(g), nh,
                            bias=bias)
    want, _ = _jax_grads(qkv, g, nh, bias=jnp.broadcast_to(
        jax_causal(jnp.asarray(log_mask)), (B, nh, T, T)))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    plain, _ = _plain_grads(qkv, g, nh, bias=bias.numpy())
    np.testing.assert_allclose(got.numpy(), plain, **GRAD_TOL)


@pytest.mark.parametrize("P,heads,chunks", [(4, 3, 2),    # P = nW, per head
                                            (1, 1, 3)])   # shared by heads
def test_window_bias_and_its_gradient(P, heads, chunks):
    """Swin's T 49, heads of 32, the relative-position table plus a shift
    mask's -100 on a fifth of the pairs: dqkv and dbias, the rows of each
    bias row summed in chunks of the kernel's order."""
    B, T, nh, dh = 8, 49, 3, 32
    rng = np.random.default_rng(P + heads)
    qkv, g = _inputs(rng, B, T, nh, dh)
    bias = (0.5 * rng.standard_normal((P, heads, T, T))
            - 100.0 * (rng.uniform(size=(P, 1, T, T)) < 0.2)
            ).astype(np.float32)
    got, dbias = model_backward(torch.from_numpy(qkv), torch.from_numpy(g),
                                nh, bias=torch.from_numpy(bias),
                                chunks=chunks)
    plain, plain_db = _plain_grads(qkv, g, nh, bias=bias)
    np.testing.assert_allclose(got.numpy(), plain, **GRAD_TOL)
    np.testing.assert_allclose(dbias.numpy(), plain_db, **DBIAS_TOL)
    if heads == nh:   # the Pallas kernel's dbias takes a bias per head
        want, want_db = _jax_grads(qkv, g, nh, bias=bias, bias_grad=True)
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
        np.testing.assert_allclose(dbias.numpy(), want_db, **DBIAS_TOL)


def test_dropout_against_the_plain_version():
    """dp dropped with the forward's mask and pd the dropped probabilities
    (ops/dropout.py's bits, which the kernel hashes the same way)."""
    B, T, nh, dh = 4, 20, 2, 32
    rng = np.random.default_rng(1)
    qkv, g = _inputs(rng, B, T, nh, dh)
    mask = np.ones((B, T), np.float32)
    got, _ = model_backward(torch.from_numpy(qkv), torch.from_numpy(g), nh,
                            mask=torch.from_numpy(mask), drop=0.1, seed=9)
    plain, _ = _plain_grads(qkv, g, nh, mask=torch.from_numpy(mask),
                            drop_rate=0.1, seed=9)
    np.testing.assert_allclose(got.numpy(), plain, **GRAD_TOL)
