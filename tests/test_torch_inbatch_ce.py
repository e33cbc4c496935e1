"""The port's in-batch CE kernel edition (ops/cuda/inbatch_ce.py) on the
CPU, where its wrappers run the plain composition over explicit candidates
(ops/losses.py inbatch_ce_candidates), against the JAX package's Pallas
kernel in interpret mode and its XLA composition: value rtol 1e-5,
gradients rtol 2e-4 / atol 1e-6 (tests/test_pallas_ce.py's tolerances).

- the local edition on left-padded histories (rows with log mask 0) at N
  below, at and above one 128-column tile and not a multiple of it;
- a log mask of 0 inside histories: a valid row whose label column is
  masked. The JAX kernel lets -onehot * w through that masked column into
  du and dcand; the composition (JAX's and the port's) and the port's CUDA
  kernel treat a masked logit as a constant. The test names those rows and
  holds the port against the composition;
- the gathered edition's explicit-candidates function over 4 simulated
  ranks (W * B * S candidates, label offset r * B * S) against JAX's
  4-shard fused_inbatch_ce_gathered: the mean loss and the gradients of
  the users and of the candidates, summed over every rank's use.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from idvs.morec_tpu.ops.losses import inbatch_debiased_ce as jax_ce
from idvs.morec_tpu.ops.pallas.inbatch_ce import (
    fused_inbatch_ce as jax_fused, fused_inbatch_ce_gathered as jax_gathered)
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import (
    fused_ce, fused_inbatch_ce, fused_inbatch_ce_bwd,
    fused_inbatch_ce_gathered)
from idvs.morec_tpu_torch.ops.losses import (candidate_colmask,
                                             inbatch_debiased_ce)

VAL_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 1e-6


def _batch(seed, B, L, D, items=50, inner_zeros=False):
    """Left-padded histories (ids 0 and log mask 0 on the padding), a
    duplicate across users; with inner_zeros a log mask of 0 inside the
    histories too, as bench.py draws it."""
    rng = np.random.default_rng(seed)
    S = L + 1
    lens = rng.integers(2, S + 1, size=B)
    ids = np.zeros((B, S), np.int32)
    lm = np.zeros((B, L), np.float32)
    for b in range(B):
        ids[b, S - lens[b]:] = rng.integers(1, items + 1, size=lens[b])
        lm[b, S - lens[b]:] = 1.0
    ids[0, -1] = ids[1, -1] = 7
    if inner_zeros:
        lm *= rng.uniform(size=lm.shape) < 0.8
        lm[:, -1] = 1.0
    uv = rng.normal(size=(B, L, D)).astype(np.float32)
    embs = rng.normal(size=(B, S, D)).astype(np.float32)
    pop = rng.uniform(0.01, 1.0, size=items + 1)
    pop[0] = 1.0
    return uv, embs, ids, lm, np.log(pop[ids]).astype(np.float32)


def _jax_grads(fn, args):
    """fn's value and gradients in the users and the candidates, one jitted
    program (an interpret-mode kernel runs op by op otherwise)."""
    a = [jnp.asarray(x) for x in args]
    val, (gu, ge) = jax.jit(jax.value_and_grad(
        lambda u, e: fn(u, e, *a[2:]), argnums=(0, 1)))(a[0], a[1])
    return float(val), np.asarray(gu), np.asarray(ge)


def _port_grads(fn, args):
    u, e = (torch.from_numpy(x).requires_grad_() for x in args[:2])
    loss = fn(u, e, *map(torch.from_numpy, args[2:]))
    loss.backward()
    return loss.item(), u.grad.numpy(), e.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("B,L,D", [(4, 8, 32),     # N 36
                                   (8, 15, 16),    # N 128, one tile
                                   (16, 8, 16)])   # N 144, not a multiple
def test_local_edition_matches_jax_kernel_and_composition(B, L, D):
    args = _batch(B * L, B, L, D)
    assert (args[3] == 0).any()
    before = (fused_inbatch_ce.launches, fused_inbatch_ce_bwd.launches)
    got = _port_grads(fused_inbatch_ce, args)
    assert (fused_inbatch_ce.launches,
            fused_inbatch_ce_bwd.launches) == before    # the CPU path
    _close(got, _jax_grads(jax_ce, args))
    _close(got, _jax_grads(
        lambda *a: jax_fused(*a, interpret=True), args))
    _close(_port_grads(inbatch_debiased_ce, args), got)


def test_masked_label_rows_follow_the_composition():
    B, L, D = 6, 8, 16
    S = L + 1
    args = _batch(11, B, L, D, inner_zeros=True)
    lm = args[3]
    colmask = np.concatenate([lm, np.ones((B, 1), np.float32)], axis=1)
    # rows (i, j) that count (lm[i, j] != 0) whose label column (i, j + 1)
    # is masked
    rows = [(i, j) for i in range(B) for j in range(L)
            if lm[i, j] != 0 and colmask[i, j + 1] == 0]
    assert rows, "the batch must hold a valid row with a masked label"
    got = _port_grads(fused_inbatch_ce, args)
    _close(got, _jax_grads(jax_ce, args))
    kernel = _jax_grads(lambda *a: jax_fused(*a, interpret=True), args)
    np.testing.assert_allclose(got[0], kernel[0], rtol=VAL_RTOL)
    # the JAX kernel's du differs on exactly those rows and agrees on the
    # others
    differ = [(i, j) for i in range(B) for j in range(L)
              if not np.allclose(got[1][i, j], kernel[1][i, j],
                                 rtol=GRAD_RTOL, atol=GRAD_ATOL)]
    assert differ == rows
    assert S * B == got[2].shape[0] * got[2].shape[1]


def test_gathered_candidates_over_four_ranks_match_jax():
    """Rank r's loss is fused_ce over the W * B * S gathered candidates
    with label offset r * B * S; the mean over ranks and its gradients
    against JAX's 4-shard gathered kernel and composition."""
    W, B, L, D = 4, 2, 4, 16
    S = L + 1
    uv, embs, ids, lm, lp = _batch(5, W * B, L, D, items=12)

    def jax_loss(fn):
        def f(u, e):
            per = jax.shard_map(
                lambda u, e, i, m, p: jax.lax.pmean(fn(u, e, i, m, p),
                                                    "data"),
                mesh=Mesh(np.array(jax.devices("cpu")[:W]), ("data",)),
                in_specs=(P("data"),) * 5, out_specs=P(), check_vma=False)
            return per(u, e, jnp.asarray(ids), jnp.asarray(lm),
                       jnp.asarray(lp))
        val, (gu, ge) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            jnp.asarray(uv), jnp.asarray(embs))
        return float(val), np.asarray(gu), np.asarray(ge)

    want_kernel = jax_loss(lambda *a: jax_gathered(
        *a, "data", bm=8, bn=128, interpret=True))
    want_xla = jax_loss(lambda *a: jax_ce(*a, axis_name="data",
                                          gather_negatives=True))

    u = torch.from_numpy(uv).requires_grad_()
    cand = torch.from_numpy(embs).requires_grad_()
    t = torch.from_numpy
    colmask = candidate_colmask(t(lm))
    losses = [fused_ce(u[r * B:(r + 1) * B], cand,
                       t(ids[r * B:(r + 1) * B]), t(lm[r * B:(r + 1) * B]),
                       t(ids), colmask, t(lp), r * B * S) for r in range(W)]
    loss = torch.stack(losses).mean()
    loss.backward()
    got = (loss.item(), u.grad.numpy(), cand.grad.numpy())
    _close(got, want_kernel)
    _close(got, want_xla)


def test_gathered_edition_needs_a_process_group():
    uv, embs, ids, lm, lp = map(torch.from_numpy, _batch(3, 3, 4, 16))
    with pytest.raises(RuntimeError, match="process group"):
        fused_inbatch_ce_gathered(uv, embs, ids, lm, lp, None)
    with pytest.raises(ValueError, match="cand_embs"):
        fused_ce(uv, embs[:, :-1], ids, lm, ids, candidate_colmask(lm), lp)
