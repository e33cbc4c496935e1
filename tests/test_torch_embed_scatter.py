"""Port's scatter_add_rows / embed_gather (plain PyTorch version, the CPU
dispatch) vs the JAX Pallas kernel in interpret mode, as
tests/test_embed_scatter.py runs it: duplicate ids add up, bf16 dX
accumulates in float32 and comes back in bf16."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas.embed_scatter import (
    embed_gather as jax_embed_gather, scatter_add_rows as jax_scatter)
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import (embed_gather,
                                                         scatter_add_rows)

ATOL = 1e-6


def test_scatter_add_rows_matches_pallas_with_duplicates():
    rng = np.random.default_rng(0)
    M, D, V = 300, 65, 50                 # ~6 rows per id
    ids = rng.integers(0, V, size=(M,))
    dx = rng.normal(size=(M, D)).astype(np.float32)
    want = jax_scatter(jnp.asarray(ids, jnp.int32), jnp.asarray(dx), V,
                       bm=128, bd=128, interpret=True)
    got = scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(dx), V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_scatter_add_rows_bf16_accumulates_in_f32():
    """bf16 dX: the sum is taken in float32 (the Pallas kernel) and then
    cast to bf16 once (embed_gather's backward), not accumulated in bf16."""
    rng = np.random.default_rng(1)
    M, D, V = 257, 130, 20
    ids = rng.integers(0, V, size=(M,))
    dxb = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)
                           ).bfloat16()
    want = jax_scatter(jnp.asarray(ids, jnp.int32),
                       jnp.asarray(dxb.float().numpy()).astype(jnp.bfloat16),
                       V, bm=128, bd=128, interpret=True)
    got = scatter_add_rows(torch.from_numpy(ids), dxb, V)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


def test_embed_gather_gradient_matches_pallas():
    rng = np.random.default_rng(2)
    V, D = 40, 33
    ids = rng.integers(0, V, size=(6, 11))
    cot = rng.normal(size=(6, 11, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    want = jax.grad(lambda t: (jax_embed_gather(
        t, jnp.asarray(ids, jnp.int32), interpret=True)
        * jnp.asarray(cot)).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = embed_gather(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL)
