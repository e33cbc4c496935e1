"""Weight bridge between Flax variable trees and the port's state_dicts.

One rule, no per-model table, because the port names its modules after the
Flax tree and keeps the Flax layouts (``models/layers.py``):

- the Flax path's ``/`` becomes ``.``;
- the leaf ``kernel`` (a Dense, (in, out)), ``scale`` (a LayerNorm) or
  ``embedding`` (an Embed) becomes ``weight``, array unchanged; ``bias``
  stays ``bias``, and so does any other leaf (a bare parameter such as
  Swin's ``relative_position_bias_table``). The patch projection's
  (p, p, C, D) ``kernel`` and a ResNet convolution's (kh, kw, in, out)
  ``kernel`` are a ``weight`` like a Dense's, in the Flax HWIO layout,
  and a BatchNorm's ``scale`` is its ``weight``;
- the ``batch_stats`` collection (a ResNet's BatchNorm running averages,
  ``mean`` and ``var``) goes into the BatchNorm buffers of those names
  beside the parameters.

So any Flax ``RecModel.init`` tree of the ported towers loads with
``model.load_state_dict(from_flax(variables))`` (``load_flax``: a JAX
``Trainer``'s ``state.params`` into a port ``Trainer``'s model). The inverse
needs the model, because ``weight`` alone does not say which Flax leaf it
was.

The reference freezes a text encoder's parameters by their index in HF's
``named_parameters()`` order (run.py:73-75); ``bert_param_order`` lists that
order with the port's names, and ``bert_frozen_names`` the names frozen
under ``freeze_paras_before`` (JAX twin: models/convert_text.py
``bert_frozen_paths``, the same set through ``flax_name``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import Dense, Embed, LayerNorm
from .models.resnet import BatchNorm, Conv
from .models.swin import PatchProject

_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_WEIGHT_LEAF = {Dense: "kernel", LayerNorm: "scale", Embed: "embedding",
                PatchProject: "kernel", Conv: "kernel", BatchNorm: "scale"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_name(path: Iterable[str]) -> str:
    """The port's parameter name of a Flax param path (from the params
    root), by the one renaming rule."""
    *mods, leaf = (str(k) for k in path)
    return ".".join(mods + [_TO_TORCH.get(leaf, leaf)])


def frozen_names(paths: Iterable[tuple]) -> Set[str]:
    """The port's parameter names of Flax param paths (a JAX
    ``*_frozen_paths`` set, or the port's copies in ``models/``)."""
    return {flax_name(p) for p in paths}


def from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Flax variables (``{"params": ..., "batch_stats": ...}`` or the
    params tree itself, leaves as numpy or jax arrays) -> a state_dict for
    the port's model."""
    collections = "params" in variables or "batch_stats" in variables
    params = variables.get("params", {}) if collections else variables
    out = OrderedDict()
    for path, value in _flatten(params):
        out[flax_name(path)] = torch.from_numpy(np.array(value, copy=True))
    for path, value in _flatten(variables.get("batch_stats", {})):
        out[".".join(path)] = torch.from_numpy(np.array(value, copy=True))
    return out


def load_flax(model: nn.Module, variables: Mapping) -> None:
    """Loads Flax variables (e.g. a JAX ``Trainer``'s ``state.params``) into
    ``model`` in place, every parameter and BatchNorm running average, onto
    the model's device."""
    model.load_state_dict(from_flax(variables))


def bert_param_order(num_layers: int, prefix: str = ""
                     ) -> List[Tuple[str, Optional[str]]]:
    """[(HF name, port name)] in HF ``BertModel.named_parameters()`` order;
    the pooler, which the port does not build, maps to None."""
    P = prefix
    order: List[Tuple[str, Optional[str]]] = [
        ("embeddings.word_embeddings.weight", P + "word_embeddings.weight"),
        ("embeddings.position_embeddings.weight",
         P + "position_embeddings.weight"),
        ("embeddings.token_type_embeddings.weight",
         P + "token_type_embeddings.weight"),
        ("embeddings.LayerNorm.weight", P + "embeddings_ln.weight"),
        ("embeddings.LayerNorm.bias", P + "embeddings_ln.bias"),
    ]
    leaves = (("attention.self.query", "attention_self.query"),
              ("attention.self.key", "attention_self.key"),
              ("attention.self.value", "attention_self.value"),
              ("attention.output.dense", "attention_output"),
              ("attention.output.LayerNorm", "attention_ln"),
              ("intermediate.dense", "intermediate"),
              ("output.dense", "output"),
              ("output.LayerNorm", "output_ln"))
    for i in range(num_layers):
        for hf, port in leaves:
            for w in ("weight", "bias"):
                order.append((f"encoder.layer.{i}.{hf}.{w}",
                              f"{P}layer_{i}.{port}.{w}"))
    order += [("pooler.dense.weight", None), ("pooler.dense.bias", None)]
    return order


def bert_frozen_names(num_layers: int, freeze_before: int,
                      prefix: str = "encoder.net.") -> Set[str]:
    """The port's names of the BERT parameters the reference freezes: index
    < freeze_before in HF's order (the pooler is not built)."""
    return {name for idx, (_, name) in
            enumerate(bert_param_order(num_layers, prefix))
            if idx < freeze_before and name is not None}


def to_flax(model: nn.Module) -> dict:
    """The inverse of ``from_flax``: ``{"params": nested numpy tree}`` from
    ``model``'s state_dict, plus ``"batch_stats"`` when the model holds
    BatchNorm running averages."""
    leaf_of = {}
    for name, module in model.named_modules():
        for cls, flax_leaf in _WEIGHT_LEAF.items():
            if isinstance(module, cls):
                leaf_of[f"{name}.weight" if name else "weight"] = flax_leaf
    buffers = {name for name, _ in model.named_buffers()}
    out: dict = {"params": {}}
    for key, value in model.state_dict().items():
        *mods, leaf = key.split(".")
        leaf = leaf_of.get(key, leaf)
        node = out.setdefault("batch_stats" if key in buffers else "params",
                              {})
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value.detach().cpu().numpy()
    return out
