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

HF text checkpoints (JAX twins: models/convert_text.py, opt.py:184-244,
deberta.py:236-310): ``load_torch_state_dict`` reads a model directory's
``model.safetensors`` (by its format: an 8-byte little-endian header
length, a JSON header of dtype, shape and byte offsets, then the raw
bytes) or ``pytorch_model.bin``, and ``convert_{bert,distilbert,opt,
deberta}_state_dict`` turn HF's tensors into the port's state_dict of the
language model (``TextTower.net``): each HF name mapped through the
family's ``named_parameters()`` order onto a Flax path and so onto the
port's name, a torch Linear's (out, in) weight transposed to (in, out),
DeBERTa's ``in_proj`` rows repacked from [head][qkv][dh] to
[qkv][head][dh]; a name may carry the task model's prefix (``bert.``,
``roberta.``, ``distilbert.``, ``model.``, ``deberta.``).

The reference freezes a text encoder's parameters by their index in HF's
``named_parameters()`` order (run.py:73-75); ``*_frozen_names`` give the
port's names of those with index < ``freeze_paras_before`` (JAX twins:
``bert_frozen_paths``, ``distilbert_frozen_paths``, ``opt_frozen_paths``,
``deberta_frozen_paths``, the same sets through ``flax_name``).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from .models.deberta import deberta_param_order
from .models.layers import Dense, Embed, LayerNorm
from .models.opt import opt_param_order
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


Order = List[Tuple[str, Optional[Tuple[str, ...]]]]


def bert_flax_order(num_layers: int) -> Order:
    """[(HF name, Flax path)] in HF ``BertModel.named_parameters()`` order
    (JAX convert_text.py ``bert_torch_param_order``); the pooler, which
    neither package builds, maps to None."""
    order: Order = [
        ("embeddings.word_embeddings.weight", ("word_embeddings",
                                               "embedding")),
        ("embeddings.position_embeddings.weight",
         ("position_embeddings", "embedding")),
        ("embeddings.token_type_embeddings.weight",
         ("token_type_embeddings", "embedding")),
        ("embeddings.LayerNorm.weight", ("embeddings_ln", "scale")),
        ("embeddings.LayerNorm.bias", ("embeddings_ln", "bias")),
    ]
    leaves = (("attention.self.query", ("attention_self", "query")),
              ("attention.self.key", ("attention_self", "key")),
              ("attention.self.value", ("attention_self", "value")),
              ("attention.output.dense", ("attention_output",)),
              ("attention.output.LayerNorm", ("attention_ln",)),
              ("intermediate.dense", ("intermediate",)),
              ("output.dense", ("output",)),
              ("output.LayerNorm", ("output_ln",)))
    for i in range(num_layers):
        for hf, path in leaves:
            w = "scale" if path[-1].endswith("_ln") else "kernel"
            order += [(f"encoder.layer.{i}.{hf}.weight",
                       (f"layer_{i}", *path, w)),
                      (f"encoder.layer.{i}.{hf}.bias",
                       (f"layer_{i}", *path, "bias"))]
    return order + [("pooler.dense.weight", None),
                    ("pooler.dense.bias", None)]


def distilbert_flax_order(num_layers: int) -> Order:
    """[(HF name, Flax path)] in HF ``DistilBertModel.named_parameters()``
    order (JAX convert_text.py ``distilbert_torch_param_order``): the word
    and position tables and the LayerNorm (no token-type table), then the
    layers onto ``BertModel``'s tree."""
    order: Order = [
        ("embeddings.word_embeddings.weight", ("word_embeddings",
                                               "embedding")),
        ("embeddings.position_embeddings.weight",
         ("position_embeddings", "embedding")),
        ("embeddings.LayerNorm.weight", ("embeddings_ln", "scale")),
        ("embeddings.LayerNorm.bias", ("embeddings_ln", "bias")),
    ]
    leaves = (("attention.q_lin", ("attention_self", "query"), "kernel"),
              ("attention.k_lin", ("attention_self", "key"), "kernel"),
              ("attention.v_lin", ("attention_self", "value"), "kernel"),
              ("attention.out_lin", ("attention_output",), "kernel"),
              ("sa_layer_norm", ("attention_ln",), "scale"),
              ("ffn.lin1", ("intermediate",), "kernel"),
              ("ffn.lin2", ("output",), "kernel"),
              ("output_layer_norm", ("output_ln",), "scale"))
    for i in range(num_layers):
        t, L = f"transformer.layer.{i}.", f"layer_{i}"
        for hf, path, w in leaves:
            order += [(f"{t}{hf}.weight", (L, *path, w)),
                      (f"{t}{hf}.bias", (L, *path, "bias"))]
    return order


def bert_param_order(num_layers: int, prefix: str = ""
                     ) -> List[Tuple[str, Optional[str]]]:
    """[(HF name, port name)] in HF ``BertModel.named_parameters()`` order;
    the pooler, which the port does not build, maps to None."""
    return [(hf, None if path is None else prefix + flax_name(path))
            for hf, path in bert_flax_order(num_layers)]


def _frozen(order: Order, freeze_before: int, prefix: str) -> Set[str]:
    """The port's names of the parameters with index < freeze_before in
    HF's order (an entry the port does not build counts, unnamed)."""
    return {prefix + flax_name(path) for idx, (_, path) in enumerate(order)
            if idx < freeze_before and path is not None}


def bert_frozen_names(num_layers: int, freeze_before: int,
                      prefix: str = "encoder.net.") -> Set[str]:
    """The port's names of the BERT parameters the reference freezes: index
    < freeze_before in HF's order (the pooler is not built)."""
    return _frozen(bert_flax_order(num_layers), freeze_before, prefix)


def distilbert_frozen_names(num_layers: int, freeze_before: int,
                            prefix: str = "encoder.net.") -> Set[str]:
    return _frozen(distilbert_flax_order(num_layers), freeze_before, prefix)


def opt_frozen_names(num_layers: int, freeze_before: int,
                     prefix: str = "encoder.net.") -> Set[str]:
    return _frozen(opt_param_order(num_layers), freeze_before, prefix)


def deberta_frozen_names(num_layers: int, freeze_before: int,
                         prefix: str = "encoder.net.") -> Set[str]:
    return _frozen(deberta_param_order(num_layers), freeze_before, prefix)


# safetensors' dtype names -> numpy (BF16 widened to float32 below)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "BF16": np.uint16}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file's tensors as numpy arrays (bfloat16 ones as
    float32), read by the format itself: an 8-byte little-endian header
    length, the JSON header ({name: {dtype, shape, data_offsets}}, and an
    optional ``__metadata__``), then the tensors' bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dt = _ST_DTYPES[info["dtype"]]
        a = np.frombuffer(data, dtype=dt, count=(end - begin)
                          // np.dtype(dt).itemsize, offset=begin)
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.reshape(info["shape"]).copy()
    return out


def load_torch_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """An HF model directory's weights as numpy arrays (JAX
    convert_text.py ``load_torch_state_dict``): ``model.safetensors`` when
    it is there, else ``pytorch_model.bin`` (``torch.load``, weights only);
    FileNotFoundError when neither is."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if v.dtype == torch.bfloat16
            else v.numpy() for k, v in sd.items()}


# the Flax leaves of a torch Linear's weight: (out, in) in HF's tensors
_LINEAR_LEAVES = ("kernel", "in_proj", "pos_proj")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _convert(state_dict: Mapping, order: Order, prefixes: Tuple[str, ...],
             repack=None) -> "OrderedDict[str, torch.Tensor]":
    """HF tensors (numpy or torch) -> the port's float32 state_dict of the
    language model, through ``order``'s Flax paths; repack(path, array)
    rearranges a tensor before the transpose."""
    out = OrderedDict()
    for hf, path in order:
        if path is None:
            continue
        name = next((p + hf for p in ("",) + prefixes
                     if p + hf in state_dict), None)
        if name is None:
            raise KeyError(f"missing checkpoint tensor: {hf}")
        v = _to_numpy(state_dict[name])
        if repack is not None:
            v = repack(path, v)
        if path[-1] in _LINEAR_LEAVES:
            v = v.T
        out[flax_name(path)] = torch.from_numpy(
            np.ascontiguousarray(v, np.float32))
    return out


def convert_bert_state_dict(state_dict: Mapping, num_layers: int
                            ) -> "OrderedDict[str, torch.Tensor]":
    """HF BERT or RoBERTa -> the port's ``BertModel`` (pooler dropped)."""
    return _convert(state_dict, bert_flax_order(num_layers),
                    ("bert.", "roberta."))


def convert_distilbert_state_dict(state_dict: Mapping, num_layers: int
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """HF DistilBERT -> the port's ``BertModel`` (type_vocab_size 0)."""
    return _convert(state_dict, distilbert_flax_order(num_layers),
                    ("distilbert.",))


def convert_opt_state_dict(state_dict: Mapping, num_layers: int
                           ) -> "OrderedDict[str, torch.Tensor]":
    """HF OPTModel (or a task model's ``model.``) -> the port's
    ``OPTModel``."""
    return _convert(state_dict, opt_param_order(num_layers), ("model.",))


def convert_deberta_state_dict(state_dict: Mapping, num_layers: int,
                               num_heads: int
                               ) -> "OrderedDict[str, torch.Tensor]":
    """HF DebertaModel -> the port's ``DebertaModel``. HF splits in_proj's
    output after its head transpose, so its rows interleave q, k and v by
    head ([head][qkv][dh]); the port splits [q | k | v] ([qkv][head][dh])."""
    def repack(path, v):
        if path[-1] != "in_proj":
            return v
        H3, H = v.shape
        return (v.reshape(num_heads, 3, H // num_heads, H)
                .transpose(1, 0, 2, 3).reshape(H3, H))
    return _convert(state_dict, deberta_param_order(num_layers),
                    ("deberta.",), repack)


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
