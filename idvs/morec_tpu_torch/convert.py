"""Weight bridge between Flax variable trees and the port's state_dicts.

One rule, no per-model table, because the port names its modules after the
Flax tree and keeps the Flax layouts (``models/layers.py``):

- the Flax path's ``/`` becomes ``.``;
- the leaf ``kernel`` (a Dense, (in, out)), ``scale`` (a LayerNorm) or
  ``embedding`` (an Embed) becomes ``weight``, array unchanged; ``bias``
  stays ``bias``, and so does any other leaf (a bare parameter such as
  Swin's ``relative_position_bias_table``). The patch projection's
  (p, p, C, D) ``kernel`` is a ``weight`` like a Dense's.

So any Flax ``RecModel.init`` tree of the ported towers loads with
``model.load_state_dict(from_flax(variables))``. The inverse needs the
model, because ``weight`` alone does not say which Flax leaf it was.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .models.layers import Dense, Embed, LayerNorm
from .models.swin import PatchProject

_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_WEIGHT_LEAF = {Dense: "kernel", LayerNorm: "scale", Embed: "embedding",
                PatchProject: "kernel"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flax variables (``{"params": ...}`` or the params tree itself, leaves
    as numpy arrays) -> a state_dict for the port's model."""
    params = variables.get("params", variables)
    out = OrderedDict()
    for path, value in _flatten(params):
        *mods, leaf = path
        key = ".".join(mods + [_TO_TORCH.get(leaf, leaf)])
        out[key] = torch.from_numpy(np.array(value, copy=True))
    return out


def to_flax(model: nn.Module) -> dict:
    """The inverse of ``from_flax``: ``{"params": nested numpy tree}`` from
    ``model``'s state_dict."""
    leaf_of = {}
    for name, module in model.named_modules():
        for cls, flax_leaf in _WEIGHT_LEAF.items():
            if isinstance(module, cls):
                leaf_of[f"{name}.weight" if name else "weight"] = flax_leaf
    params: dict = {}
    for key, value in model.state_dict().items():
        *mods, leaf = key.split(".")
        leaf = leaf_of.get(key, leaf)
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value.detach().cpu().numpy()
    return {"params": params}
