"""Port's in-batch debiased CE (ops/losses.py) vs the JAX package's, value
and gradients, with items repeated across users and padded positions;
float32, rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.losses import inbatch_debiased_ce as jax_ce
from idvs.morec_tpu.ops.masking import label_columns as jax_label_columns
from idvs.morec_tpu_torch.ops.losses import inbatch_debiased_ce
from idvs.morec_tpu_torch.ops.masking import label_columns

RTOL, ATOL = 1e-5, 1e-7


def _batch(seed, B=5, L=6, D=16, items=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, items, size=(B, L + 1))     # repeats across users
    ids[1, 3] = ids[1, 5]                             # and within one
    lm = np.ones((B, L), np.float32)
    for b, pad in enumerate(rng.integers(0, L, size=B)):
        lm[b, :pad] = 0.0                             # left padding
        ids[b, :pad] = 0
    uv = rng.normal(size=(B, L, D)).astype(np.float32)
    embs = rng.normal(size=(B, L + 1, D)).astype(np.float32)
    pop = rng.uniform(0.01, 1.0, size=items)
    pop[0] = 1.0
    log_pop = np.log(pop).astype(np.float32)[ids]
    return uv, embs, ids, lm, log_pop


@pytest.mark.parametrize("seed", [0, 1])
def test_inbatch_ce_value_and_gradients_match_jax(seed):
    uv, embs, ids, lm, lp = _batch(seed)
    args_j = [jnp.asarray(a) for a in (uv, embs, ids, lm, lp)]
    want, (gu, ge) = jax.value_and_grad(
        lambda u, e: jax_ce(u, e, *args_j[2:]), argnums=(0, 1))(*args_j[:2])
    u, e = (torch.from_numpy(a).requires_grad_() for a in (uv, embs))
    got = inbatch_debiased_ce(u, e, *map(torch.from_numpy, (ids, lm, lp)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(gu), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=RTOL,
                               atol=ATOL)


def test_label_columns_and_unported_options():
    """The gathered composition without a process group says what it
    needs (tests/test_torch_dp.py runs it under one)."""
    np.testing.assert_array_equal(label_columns(3, 4).numpy(),
                                  np.asarray(jax_label_columns(3, 4)))
    uv, embs, ids, lm, lp = map(torch.from_numpy, _batch(2))
    with pytest.raises(RuntimeError, match="needs a process group"):
        inbatch_debiased_ce(uv, embs, ids, lm, lp, gather_negatives=True)
