"""Shared building blocks: flax-semantics LayerNorm, dropout, parameter
leaves, init.

The leaves keep the Flax layouts so weights cross between the packages by
one renaming rule (``convert.py``): a ``Dense`` stores its weight as the
Flax ``kernel`` in (in, out) layout, which is also what the fused kernels
read; ``LayerNorm.weight`` is the Flax ``scale``; ``Embed.weight`` is the
Flax ``embedding``. A module may also own a bare parameter, the twin of a
Flax ``self.param`` (Swin's ``relative_position_bias_table``): it keeps the
Flax name and layout and the module draws it in its own
``reset_parameters``.

Initialisation draws from an explicit ``torch.Generator``
(``init_parameters``) with the distributions the JAX package uses: Xavier
normal for the reference's Linear/Embedding weights, LeCun truncated normal
for the Flax ``Dense`` default, N(0, 1/D) for the Flax ``Embed`` default,
zero biases and unit scales.

Dropout runs in training mode only (``module.train()``). Every dropout
site draws its seed from a host ``torch.Generator`` passed down the forward
calls (``drop_call``), and the mask is the kernels' (``ops/dropout.py``), so
a site that runs inside a kernel and one that runs here use the same mask
function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dropout


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm``: float32 statistics with the fast variance
    E[x^2] - E[x]^2 clamped at 0, scale and bias applied in float32, the
    result cast back to x's dtype (``F.layer_norm`` uses the two-pass
    variance and would differ in the last bits)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def drop_call(training: bool, rate: float,
              generator: Optional[torch.Generator]) -> tuple:
    """(drop_rate, seed) of one dropout site: (0.0, None) in eval mode or
    at rate 0, else the rate and a fresh seed from ``generator``."""
    if not training or rate == 0.0:
        return 0.0, None
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    return rate, dropout.draw_seed(generator)


class Dropout(nn.Module):
    """Dropout outside the kernels (flax ``nn.Dropout``'s place), with the
    kernels' mask; the result keeps x's dtype."""

    def __init__(self, rate: float):
        super().__init__()
        dropout.check_rate(rate)
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate, seed = drop_call(self.training, self.rate, generator)
        if rate == 0.0:
            return x
        return dropout.apply(x, rate, seed).to(x.dtype)


# -- initialisers: fn(tensor, generator) fills the tensor in place ----------

def xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in, fan_out = w.shape[-2], w.shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)


def padded_xavier_normal_(w: torch.Tensor,
                          generator: torch.Generator) -> None:
    """Xavier normal with row 0 zeroed (the padding item, torch
    padding_idx=0 semantics; JAX models/model.py:30-34)."""
    xavier_normal_(w, generator)
    with torch.no_grad():
        w[0].zero_()


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated at two standard deviations, then
    rescaled so the standard deviation is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / w.shape[-2]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


def embed_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``nn.Embed`` default: N(0, 1 / features)."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(1.0 / w.shape[-1]), generator=generator)


Init = Callable[[torch.Tensor, torch.Generator], None]


def on_device(device=None) -> torch.device:
    """The device a module is built on: the one the caller names, else the
    GPU. Nothing moves to the CPU on its own: with no GPU visible and no
    device named this raises, and a caller that wants the CPU says so."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible and no device was named: pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda")


class Dense(nn.Module):
    """y = x @ weight + bias with weight in the Flax (in, out) layout."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: Init = lecun_normal_, device=None):
        super().__init__()
        device = on_device(device)
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)
        self._init = init

    def reset_parameters(self, generator: torch.Generator) -> None:
        self._init(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (see ``layer_norm``)."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        device = on_device(device)
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.eps = eps

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Embed(nn.Module):
    """Row lookup in a (num_embeddings, features) table."""

    def __init__(self, num_embeddings: int, features: int,
                 init: Init = embed_normal_, device=None):
        super().__init__()
        device = on_device(device)
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))
        self._init = init

    def reset_parameters(self, generator: torch.Generator) -> None:
        self._init(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class MLPLayers(nn.Module):
    """[Dropout -> Dense -> exact GELU] x (len(layers) - 1), Xavier-normal
    kernels and zero biases (JAX models/layers.py ``MLPLayers``; reference
    bce_text/main-end2end(DSSM)/model/encoders.py:6-18). The Denses keep
    the Flax names ``Dense_0``, ``Dense_1``, ... (the Dropouts hold no
    parameters and take no number)."""

    def __init__(self, layers, drop_rate: float, device=None):
        super().__init__()
        self.drop = Dropout(drop_rate)
        self.n_layers = len(layers) - 1
        for i, (n_in, n_out) in enumerate(zip(layers[:-1], layers[1:])):
            setattr(self, f"Dense_{i}",
                    Dense(n_in, n_out, init=xavier_normal_, device=device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = self.drop(x, generator)
            x = F.gelu(getattr(self, f"Dense_{i}")(x))
        return x


class FCLayers(nn.Module):
    """``fc`` (word_embedding_dim -> item_embedding_dim), exact GELU, then
    ``MLPLayers`` named ``mlp`` dnn_layers deep when dnn_layers > 0 (JAX
    models/layers.py ``FCLayers``; reference bce_text/main-2stage(SASRec)/
    model/encoders.py:7-31): the fused two-stage tower's ``turn_dim``."""

    def __init__(self, word_embedding_dim: int, item_embedding_dim: int,
                 dnn_layers: int, drop_rate: float, device=None):
        super().__init__()
        self.fc = Dense(word_embedding_dim, item_embedding_dim,
                        init=xavier_normal_, device=device)
        self.mlp = (MLPLayers([item_embedding_dim] * (dnn_layers + 1),
                              drop_rate, device=device)
                    if dnn_layers > 0 else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.gelu(self.fc(x))
        return x if self.mlp is None else self.mlp(x, generator)


def _promoted(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """x and y in their promoted dtype, as jnp promotes a bf16 and a
    float32 operand to float32."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


class AddFusion(nn.Module):
    """ID (+) modality: id + modal, in the promoted dtype (JAX
    models/layers.py ``AddFusion``; reference bce_text/id_plus_mo-end2end/
    model/encoders.py:8-13)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, y = _promoted(x, y)
        return x + y


class CatFusion(nn.Module):
    """concat(id, modal) -> ``MLPLayers([2D] + [D] * n_layers)`` named
    ``mlp`` (JAX models/layers.py ``CatFusion``; reference
    id_plus_mo-end2end/model/encoders.py:17-39): n_layers 1 for item tower
    'modal_cat', 3 for 'modal_cat_3'."""

    def __init__(self, embedding_dim: int, drop_rate: float,
                 n_layers: int = 1, device=None):
        super().__init__()
        self.mlp = MLPLayers([2 * embedding_dim]
                             + [embedding_dim] * n_layers, drop_rate,
                             device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.mlp(torch.cat(_promoted(x, y), dim=-1), generator)


def drop_path_scale(seed: int, n: int, rate: float, device=None
                    ) -> torch.Tensor:
    """(n,) float32 DropPath factors of one call: row i is kept with
    probability 1 - rate and then scaled by 1 / (1 - rate), else 0. A pure
    function of (seed, i), the dropout mask's hash (``ops/dropout.py``), so
    a recomputation that is handed the seed finds the same rows."""
    keep = dropout.keep_mask(seed, (n,), rate, device)
    return keep.float() / (1.0 - rate)


class DropPath(nn.Module):
    """Stochastic depth (JAX models/swin.py DropPath): identity in eval mode
    and at rate 0; in training mode one Bernoulli(1 - rate) per leading row
    (per image), kept rows scaled by 1 / (1 - rate). The seed of a call
    comes from the host generator, like every dropout site's."""

    def __init__(self, rate: float):
        super().__init__()
        dropout.check_rate(rate)
        self.rate = rate

    def scale(self, n: int, generator: Optional[torch.Generator],
              device=None) -> Optional[torch.Tensor]:
        """The (n,) float32 factors of one training call (a fresh seed from
        ``generator``), or None where DropPath is the identity."""
        rate, seed = drop_call(self.training, self.rate, generator)
        if rate == 0.0:
            return None
        return drop_path_scale(seed, n, rate, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = self.scale(x.shape[0], generator, x.device)
        if s is None:
            return x
        # x times the float32 factor, cast once: the product the scaled
        # fused_mlp_res forms
        return (x * s.reshape((-1,) + (1,) * (x.dim() - 1))).to(x.dtype)


def pre_ln_mlp(x: torch.Tensor, ln: LayerNorm, fc1: Dense, fc2: Dense, *,
               act: str = "gelu", residual: bool = False,
               save_h: bool = True) -> torch.Tensor:
    """The pre-LN ViT MLP sub-block, fc2(act(fc1(ln(x)))) (JAX
    models/layers.py ``pre_ln_mlp``): the caller owns the three leaves, so
    their names are the Flax tree's (``<ln_name>.weight`` / ``.bias``,
    ``<fc1>.weight`` / ``.bias``, ``<fc2>.weight`` / ``.bias``). It runs
    ``ops/cuda/mlp.py``'s kernels: with ``residual`` x + mlp(ln(x)) through
    ``fused_mlp_res``' unit edition (the JAX callers take it on their
    deterministic path only), else ``fused_mlp``, storing h for the backward
    with ``save_h``, and the caller adds the residual. act: "gelu" (exact),
    "relu" or "quick_gelu"."""
    from ..ops.cuda.mlp import fused_mlp, fused_mlp_res
    ops = (fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    lnp = (ln.weight, ln.bias)
    if residual:
        return fused_mlp_res(x, None, *ops, ln=lnp, eps=ln.eps, act=act)
    return fused_mlp(x, *ops, ln=lnp, eps=ln.eps, act=act, save_h=save_h)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_heads: int, *, scaled: bool = False,
              bias: Optional[torch.Tensor] = None,
              drop: Optional["Dropout"] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Plain multi-head attention of the ViT encoders, as the JAX modules
    write it: (B, T, H) q, k, v; float32 logits (the products accumulate
    in float32 whatever the dtype), divided by sqrt(head dim) unless q comes
    ``scaled`` (CLIP scales q before the product), plus the float32
    ``bias`` (heads, T, T) if given; a float32 softmax cast back to v's
    dtype, dropout of the probabilities, then P . V in v's dtype -> (B, T,
    H)."""
    B, T, H = q.shape
    dh = H // n_heads
    split = lambda t: t.reshape(B, T, n_heads, dh).transpose(1, 2)
    logits = split(q).float() @ split(k).float().transpose(-1, -2)
    if not scaled:
        logits = logits / (dh ** 0.5)
    if bias is not None:
        logits = logits + bias.float()
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    if drop is not None:
        p = drop(p, generator)
    return (p @ split(v)).transpose(1, 2).reshape(B, T, H)


def normal_(std: float) -> "Init":
    """N(0, std^2) (flax ``nn.initializers.normal``)."""
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        with torch.no_grad():
            w.normal_(0.0, std, generator=generator)
    return init


def init_parameters(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Draws every parameter, in ``module.modules()`` order, from
    ``generator`` (which must live on the parameters' device): each module
    that owns parameters (a leaf above, or a module with a bare parameter)
    fills them in its ``reset_parameters(generator)``."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


def hf_config(cls, hf: dict, defaults: dict, built: dict):
    """The dataclass ``cls`` from an HF ``config.json`` read as a dict, the
    twin of the JAX package's ``from_hf`` over ``AutoConfig``: each field
    from its key, and a key the file lacks takes HF's class default
    (``defaults``, which holds every key read), as ``AutoConfig`` fills
    it. ``built`` names the keys the model (as the JAX package's) does not
    follow, each with the value it builds or a test of the value: another
    value would make HF build a model this one is not, so it is refused,
    naming the key (ROADMAP C15)."""
    get = lambda k: hf.get(k, defaults[k])
    bad = [f"{k}={get(k)!r}" for k, ok in built.items()
           if not (ok(get(k)) if callable(ok) else get(k) == ok)]
    if bad:
        raise NotImplementedError(
            f"{cls.__name__}: {', '.join(bad)}: HF builds another model "
            f"there, which neither this package nor the JAX package builds "
            f"(ROADMAP C15)")
    fields = (f.name for f in dataclasses.fields(cls))
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in ((k, get(k)) for k in fields)})
