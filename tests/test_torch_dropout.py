"""The port's dropout mask (ops/dropout.py), the plain twin of
csrc/dropout.cuh: the hash against a uint32 reference, the keep rate, the
seeding, and a backward that zeroes exactly what the forward dropped."""

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.models.layers import Dropout, drop_call
from idvs.morec_tpu_torch.ops import dropout


def _lowbias32(x: np.ndarray) -> np.ndarray:
    """lowbias32 in wrapping uint32 arithmetic, as the CUDA device code."""
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def test_hash_matches_uint32_arithmetic():
    """The int64 twin of mix32 is bit-identical to wrapping uint32 math,
    over small, large and random indices and seeds."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([np.arange(1000), 2 ** 32 - 1 - np.arange(1000),
                         rng.integers(0, 2 ** 32, size=10_000)])
    got = dropout.mix32(torch.from_numpy(xs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, _lowbias32(xs).astype(np.int64))
    for seed in (0, 1, 12345, 2 ** 31 - 2):
        assert dropout.mix32(seed) == int(_lowbias32(np.array([seed]))[0])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_four_sigma(p):
    n = 200_000
    keep = dropout.keep_mask(7, (n,), p).double().mean().item()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(keep - (1 - p)) < 4 * sigma


def test_same_seed_same_mask_other_seed_other_mask():
    a = dropout.keep_mask(3, (64, 96), 0.1)
    assert torch.equal(a, dropout.keep_mask(3, (64, 96), 0.1))
    other = dropout.keep_mask(4, (64, 96), 0.1)
    assert not torch.equal(a, other)
    # the two masks are about as independent as two draws
    assert (a != other).double().mean().item() > 0.1


def test_backward_zeroes_exactly_the_dropped():
    p = 0.3
    x = torch.randn(40, 50, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()
    y = dropout.apply(x, p, seed=9)
    y.backward(torch.ones_like(y))
    keep = dropout.keep_mask(9, x.shape, p)
    assert torch.equal(y.detach() == 0, ~keep | (x.detach() == 0))
    assert torch.equal(x.grad == 0, ~keep)
    torch.testing.assert_close(x.grad[keep],
                               torch.full_like(x.grad[keep],
                                               dropout.scale(p)))


def test_dropout_module_trains_and_evaluates():
    gen = torch.Generator().manual_seed(1)
    m = Dropout(0.5)
    x = torch.ones(8, 16)
    assert torch.equal(m.eval()(x), x)            # eval: identity
    y = m.train()(x, gen)
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    with pytest.raises(ValueError):
        m(x)                                      # training needs a seed
    assert drop_call(True, 0.0, None) == (0.0, None)
    rate, seed = drop_call(True, 0.1, gen)
    assert rate == 0.1 and 0 <= seed < 2 ** 31
