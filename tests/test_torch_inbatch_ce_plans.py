"""The CE kernels' block plan (ops/cuda/inbatch_ce.py ``ce_plan``) and a
plain-torch model of csrc/inbatch_ce.cu's tile walk, on the CPU.

- ``ce_plan`` at every CE shape a main path runs (the smoke's text, IDRec,
  vision, gathered text W = 4 and gathered IDRec W = 8 cases) in both
  dtypes: every tile of each walk covered once, no split empty, shared
  memory within a block's 227 KB; D not a multiple of 16 refused.
- ``walk``: the kernels' arithmetic in their order. The forward's online
  softmax over each split's 128-column tiles, merged in split order; the
  same-user rejection as one bit per (user, column) of the users a tile's
  rows span, once a tile; the label exempt by its column index; the
  backward's two passes, each owning its output (du over the candidate
  tiles, dcand over the row tiles, cand . u^T), with dlogit 0 at a masked
  logit, D cut into the plan's chunks and the splits' partials added in
  split order. Held against the Pallas kernel (``_fused_ce``, explicit
  candidates) in interpret mode and against the port's composition
  ``inbatch_ce_candidates``, float32, at tests/test_torch_inbatch_ce.py's
  tolerances: ragged M and N, L = 5 (a row tile spans 13 users), labels
  across a column-tile edge, the gathered edition's W = 4 candidates with a
  label offset, and rows whose label column is masked (against the
  composition only: the TPU kernel lets -onehot through there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas.inbatch_ce import _fused_ce as jax_fused_ce
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import OTHER, OWN, ce_plan
from idvs.morec_tpu_torch.ops.losses import MASK_VAL, inbatch_ce_candidates

VAL_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 1e-6

# (M, N, D, L) of the smoke's CE cases (chip_smoke.py CE_CASES, CE_WIDE)
MAIN_SHAPES = {"text": (2560, 2688, 512, 20),
               "IDRec": (5120, 5376, 512, 20),
               "vision": (640, 704, 2048, 10),
               "gathered text W=4": (2560, 10752, 512, 20),
               "gathered IDRec W=8": (5120, 43008, 512, 20)}


def _ranges(tiles, per, splits):
    return [range(y * per, min(tiles, (y + 1) * per)) for y in range(splits)]


def _assert_covers(tiles, per, splits):
    walked = [t for r in _ranges(tiles, per, splits) for t in r]
    assert walked == list(range(tiles))
    assert all(len(r) > 0 for r in _ranges(tiles, per, splits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MAIN_SHAPES))
def test_plan_at_every_main_path_shape(case, dtype):
    M, N, D, L = MAIN_SHAPES[case]
    k = ce_plan(M, N, D, L, dtype)
    assert (k["own"], k["other"]) == (OWN, OTHER)
    _assert_covers(-(-N // OTHER), k["fwd_per"], k["fwd_splits"])
    _assert_covers(-(-N // OTHER), k["per_u"], k["splits_u"])
    _assert_covers(-(-M // OTHER), k["per_c"], k["splits_c"])
    assert k["dc"] in (128, 256, 512) and k["chunks"] * k["dc"] >= D
    assert (k["chunks"] - 1) * k["dc"] < D
    assert 0 < k["fwd_smem"] <= lib.MAX_SMEM
    assert 0 < k["bwd_smem"] <= lib.MAX_SMEM
    # D = 512 keeps each backward pass at one logit product
    assert k["chunks"] == (4 if D == 2048 else 1)
    # the wide case adds no partial sums to its memory
    if case == "gathered IDRec W=8":
        assert k["splits_u"] == k["splits_c"] == 1


@pytest.mark.parametrize("D", [8, 24, 520])
def test_plan_refuses_d_not_a_multiple_of_16(D):
    with pytest.raises(ValueError, match="multiple of 16"):
        ce_plan(40, 48, D, 5, torch.float32)


def test_plan_fills_the_card_where_row_tiles_are_few():
    """The text step's 40 row tiles split their column tiles so that the
    forward's blocks fill two blocks an SM, and so do both backward passes
    (40 and 42 own tiles for 132 SMs)."""
    k = ce_plan(2560, 2688, 512, 20, torch.bfloat16)
    assert 40 * k["fwd_splits"] > 132
    assert 40 * k["splits_u"] + 42 * k["splits_c"] > 132


# -- the tile walk --------------------------------------------------------


def _tile_mask(ids, cand_ids, colmask, label_off, L, r0, rows, c0, cols):
    """(rows, cols) masked logits of a tile: the rejection of the users the
    rows span, once a tile, then the label exemption by column index."""
    S = L + 1
    r = torch.arange(r0, r0 + rows)
    c = torch.arange(c0, c0 + cols)
    u0 = r0 // L
    users = (r0 + rows - 1) // L - u0 + 1
    sids = ids[u0:u0 + users]                                  # (users, S)
    bits = (sids[:, :, None] == cand_ids[c][None, None]).any(1)
    lab = label_off + r // L * S + r % L + 1
    rej = bits[r // L - u0] & (c[None] != lab[:, None])
    return (colmask[c] == 0)[None] | rej, lab, c, users


def _logits(own, other, lp, mask):
    return torch.where(mask, torch.tensor(MASK_VAL), own @ other.T - lp)


def walk(u, cand, ids, lm, cand_ids, colmask, logpop, label_off, plan):
    """The kernels' forward and backward on (M, D) u and (N, D) cand:
    (loss, du, dcand), float32."""
    M, D = u.shape
    N = cand.shape[0]
    L = lm.shape[1]
    w = (lm.reshape(-1) != 0).float()
    n_valid = w.sum().clamp_min(1.0)
    tiles = -(-N // OTHER)
    per, splits = plan["fwd_per"], plan["fwd_splits"]
    part = torch.zeros(3, splits, M)
    for r0 in range(0, M, OWN):
        rows = min(OWN, M - r0)
        for y, walked in enumerate(_ranges(tiles, per, splits)):
            m = torch.full((rows,), -1e9)
            l = torch.zeros(rows)
            t = torch.zeros(rows)
            for ti in walked:
                c0 = ti * OTHER
                cols = min(OTHER, N - c0)
                mask, lab, c, users = _tile_mask(ids, cand_ids, colmask,
                                                 label_off, L, r0, rows, c0,
                                                 cols)
                assert users <= OWN // L + 2
                v = _logits(u[r0:r0 + rows], cand[c0:c0 + cols],
                            logpop[c0:c0 + cols], mask)
                m_new = torch.maximum(m, v.max(1).values)
                l = l * torch.exp(m - m_new) + torch.exp(
                    v - m_new[:, None]).sum(1)
                t = t + torch.where(c[None] == lab[:, None], v, 0.).sum(1)
                m = m_new
            part[:, y, r0:r0 + rows] = torch.stack([m, l, t])
    m = part[0].max(0).values
    l = torch.zeros(M)
    t = torch.zeros(M)
    for y in range(splits):                     # in split order
        l = l + part[1, y] * torch.exp(part[0, y] - m)
        t = t + part[2, y]
    ce = torch.log(l) + m - t
    loss = (ce * w).sum() / n_valid
    ws = w / n_valid

    def ds_tile(r0, rows, c0, cols):
        """dlogit (rows, cols) of a tile, 0 at a masked logit."""
        mask, lab, c, _ = _tile_mask(ids, cand_ids, colmask, label_off, L,
                                     r0, rows, c0, cols)
        v = _logits(u[r0:r0 + rows], cand[c0:c0 + cols],
                    logpop[c0:c0 + cols], mask)
        p = torch.exp(v - m[r0:r0 + rows, None]) / l[r0:r0 + rows, None]
        d = (p - (c[None] == lab[:, None]).float()) * ws[r0:r0 + rows, None]
        return torch.where(mask, 0., d)

    def grad_pass(n_own, n_other, per, splits, block):
        """Blocks own OWN rows and dc columns, walk their split's OTHER-row
        tiles; the splits' partials added in order."""
        dc = plan["dc"]
        parts = torch.zeros(splits, n_own, D)
        for d0 in range(0, D, dc):
            for y, walked in enumerate(_ranges(-(-n_other // OTHER), per,
                                               splits)):
                for o0 in range(0, n_own, OWN):
                    acc = torch.zeros(min(OWN, n_own - o0), dc)
                    for ti in walked:
                        acc += block(o0, ti * OTHER, d0, dc)
                    parts[y, o0:o0 + OWN, d0:d0 + dc] = acc[:, :D - d0]
        out = parts[0]
        for y in range(1, splits):
            out = out + parts[y]
        return out

    def du_block(o0, x0, d0, dc):
        rows, cols = min(OWN, M - o0), min(OTHER, N - x0)
        pad = torch.zeros(cols, dc)
        pad[:, :min(dc, D - d0)] = cand[x0:x0 + cols, d0:d0 + dc]
        return ds_tile(o0, rows, x0, cols) @ pad

    def dcand_block(o0, x0, d0, dc):
        cols, rows = min(OWN, N - o0), min(OTHER, M - x0)
        pad = torch.zeros(rows, dc)
        pad[:, :min(dc, D - d0)] = u[x0:x0 + rows, d0:d0 + dc]
        # the transposed tile, cand . u^T: dlogit^T in the own rows
        return ds_tile(x0, rows, o0, cols).T @ pad

    du = grad_pass(M, N, plan["per_u"], plan["splits_u"], du_block)
    dcand = grad_pass(N, M, plan["per_c"], plan["splits_c"], dcand_block)
    return loss, du, dcand


def _histories(rng, B, L, items, inner_zeros=False):
    """Left-padded histories, ids repeated across users; inner_zeros: a log
    mask of 0 inside the histories too, as bench.py draws it."""
    S = L + 1
    lens = rng.integers(2, S + 1, size=B)
    ids = np.zeros((B, S), np.int32)
    lm = np.zeros((B, L), np.float32)
    for b in range(B):
        ids[b, S - lens[b]:] = rng.integers(1, items + 1, size=lens[b])
        lm[b, S - lens[b]:] = 1.0
    if inner_zeros:
        lm *= rng.uniform(size=lm.shape) < 0.8
        lm[:, -1] = 1.0
    return ids, lm


def _problem(seed, B, L, D, W=1, rank=0, inner_zeros=False, items=40):
    """fused_ce's operands as numpy arrays: rank `rank`'s rows against W
    ranks' candidates."""
    rng = np.random.default_rng(seed)
    S = L + 1
    ids, lm = _histories(rng, W * B, L, items, inner_zeros)
    pop = rng.uniform(0.01, 1.0, size=items + 1)
    pop[0] = 1.0
    own = slice(rank * B, (rank + 1) * B)
    colmask = np.concatenate([lm, np.ones((W * B, 1), np.float32)], axis=1)
    return (rng.normal(size=(B, L, D)).astype(np.float32) * D ** -0.25,
            rng.normal(size=(W * B, S, D)).astype(np.float32) * D ** -0.25,
            ids[own], lm[own], ids, colmask,
            np.log(pop[ids]).astype(np.float32), rank * B * S)


def _walk_grads(args, plan):
    u, cand, ids, lm, cids, cm, lp, off = args
    B, L, D = u.shape
    loss, du, dcand = walk(
        torch.from_numpy(u).reshape(-1, D), torch.from_numpy(cand).reshape(
            -1, D), torch.from_numpy(ids), torch.from_numpy(lm),
        torch.from_numpy(cids).reshape(-1), torch.from_numpy(cm).reshape(-1),
        torch.from_numpy(lp).reshape(-1), off, plan)
    return loss.item(), du.reshape(u.shape).numpy(), \
        dcand.reshape(cand.shape).numpy()


def _composition_grads(args):
    u, cand = (torch.from_numpy(a).requires_grad_() for a in args[:2])
    loss = inbatch_ce_candidates(u, cand, *map(torch.from_numpy, args[2:7]),
                                 args[7])
    loss.backward()
    return loss.item(), u.grad.numpy(), cand.grad.numpy()


def _pallas_grads(args):
    L = args[0].shape[1]
    a = [jnp.asarray(x) for x in args[:7]]
    off = jnp.asarray(args[7], jnp.int32)
    val, (gu, ge) = jax.value_and_grad(
        lambda u, e: jax_fused_ce(u, e, *a[2:], off, L, OWN, OTHER, True),
        argnums=(0, 1))(a[0], a[1])
    return float(val), np.asarray(gu), np.asarray(ge)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _plans(M, N, D, L):
    """The plan of a 132-SM card and of a 2-SM one (fewer splits)."""
    return [ce_plan(M, N, D, L, torch.float32, sms) for sms in (132, 2)]


@pytest.mark.parametrize("B,L,D,W,rank", [
    (24, 5, 32, 1, 0),      # M 120, N 144: both ragged, two tiles each
    (6, 5, 16, 4, 3),       # the gathered edition: N 144, label_off 108
    (3, 5, 528, 4, 3),      # D in two gradient chunks, label_off 54
])
def test_walk_matches_pallas_kernel_and_composition(B, L, D, W, rank):
    args = _problem(B * D + W, B, L, D, W, rank)
    M, N, S = B * L, W * B * (L + 1), L + 1
    assert M % OWN and N % OTHER
    # a row tile spans 3+ users; where there are two column tiles, some
    # user's label columns straddle their edge and the forward is split
    assert min(M, OWN) // L >= 3
    plans = _plans(M, N, D, L)
    if N > OTHER:
        firsts = [args[7] + i * S + 1 for i in range(B)]
        assert any(f // OTHER != (f + L - 1) // OTHER for f in firsts)
        assert any(k["fwd_splits"] > 1 for k in plans)
    want_kernel = _pallas_grads(args)
    want_composition = _composition_grads(args)
    for plan in plans:
        got = _walk_grads(args, plan)
        _close(got, want_kernel)
        _close(got, want_composition)


def test_walk_straddles_a_column_tile_with_labels():
    """L = 5 over 24 users: user 21's label columns 127..131 cross the
    128-column edge; the walk still matches the composition."""
    B, L, D = 24, 5, 16
    S = L + 1
    assert (21 * S + 1) // OTHER != (21 * S + L) // OTHER
    args = _problem(3, B, L, D)
    for plan in _plans(B * L, B * S, D, L):
        _close(_walk_grads(args, plan), _composition_grads(args))


def test_walk_masked_label_rows_follow_the_composition():
    """A log mask of 0 inside histories: valid rows whose label column is
    masked. The walk gives dlogit 0 at every masked logit, as the
    composition's autograd does."""
    B, L, D = 24, 5, 16
    args = _problem(7, B, L, D, W=4, rank=1, inner_zeros=True)
    lm, colmask = args[3], args[5][B:2 * B]
    rows = [(i, j) for i in range(B) for j in range(L)
            if lm[i, j] != 0 and colmask[i, j + 1] == 0]
    assert rows, "the batch must hold a valid row with a masked label"
    for plan in _plans(B * L, 4 * B * (L + 1), D, L):
        _close(_walk_grads(args, plan), _composition_grads(args))

