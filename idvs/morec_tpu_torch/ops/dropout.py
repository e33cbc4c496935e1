"""The dropout mask of the port, bit for bit the one of ``csrc/dropout.cuh``.

The bits of element ``index`` (its flat row-major index) in a dropout call
with seed ``seed`` are ``mix32(index ^ mix32(seed))``, with ``mix32`` the
"lowbias32" integer hash; the element is kept when its bits are at least
``threshold(p) = min(floor(p * 2^32), 2^32 - 1)``, as the Pallas kernels'
``_dropout_keep`` compares them, and a kept element is scaled by
``float32(1 / (1 - p))``. Because the mask is a function of the index alone,
a backward kernel finds the forward's mask whatever its grid.

Here the hash runs in int64 arithmetic masked to 32 bits (each product is
split so that no intermediate leaves int64). Per-call seeds come from a
``torch.Generator`` on the host (``draw_seed``), so drawing one never waits
for the card.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32, without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    """lowbias32 on a Python int or an int64 tensor of values < 2^32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def threshold(p: float) -> int:
    return min(int(p * 2.0 ** 32), M32)


def check_rate(p: float) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")


def kernel_args(p: float, seed) -> tuple:
    """(key, thresh, scale) of a dropout call, as the kernels take them;
    (0, 0, 1.0) when p == 0."""
    check_rate(p)
    if p == 0.0:
        return 0, 0, 1.0
    if seed is None:
        raise ValueError("dropout with p > 0 needs a seed")
    return mix32(int(seed) & M32), threshold(p), scale(p)


def scale(p: float) -> float:
    """float32(1 / (1 - p)), the factor on kept elements."""
    return float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))


def keep_mask(seed: int, shape, p: float, device=None) -> torch.Tensor:
    """Bool keep-mask of a dropout call over a tensor of ``shape``."""
    n = 1
    for s in shape:
        n *= int(s)
    if n > M32:
        raise ValueError("dropout index must fit 32 bits")
    key = mix32(int(seed) & M32)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (mix32(idx ^ key) >= threshold(p)).reshape(shape)


def apply(x: torch.Tensor, p: float, seed) -> torch.Tensor:
    """Dropout of x in float32: kept elements scaled, dropped ones zero (x
    itself when p == 0). The result is float32; callers cast it."""
    check_rate(p)
    xf = x.float()
    if p == 0.0:
        return xf
    if seed is None:
        raise ValueError("dropout with p > 0 needs a seed")
    keep = keep_mask(seed, x.shape, p, x.device)
    return torch.where(keep, xf * scale(p), torch.zeros_like(xf))


def draw_seed(generator: torch.Generator) -> int:
    """A fresh 31-bit seed from a host (CPU) generator."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
