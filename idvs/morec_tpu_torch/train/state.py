"""Train state and optimizer assembly (JAX twin: idvs/morec_tpu/train/
state.py).

Reference semantics (inbatch_sasrec_e2e_text/run.py:150-191): two AdamW
parameter groups, the pretrained text encoder at (fine_tune_lr,
fine_tune_l2_weight) and everything else, the item tower's projection fc
included, at (lr, l2_weight); one group for IDRec. torch AdamW defaults:
betas (0.9, 0.999), eps 1e-8, decoupled weight decay. Frozen encoder layers
are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..parallel import mesh

ENCODER_LABEL = "encoder"
RECSYS_LABEL = "recsys"


def default_encoder_predicate(keys: tuple) -> bool:
    """The reference splits on 'bert_model' in the parameter name: only the
    pretrained net (``encoder.net.*``) is in the fine-tune group; the fc
    over it counts as recsys."""
    return ("encoder" in keys and "net" in keys
            and "fc" not in keys and "classifier" not in keys)


def param_labels(model: nn.Module,
                 is_encoder_path: Callable[[tuple], bool]
                 = default_encoder_predicate) -> Dict[str, str]:
    """Parameter name -> ENCODER_LABEL or RECSYS_LABEL, by the predicate on
    the name's dotted keys."""
    return {name: (ENCODER_LABEL if is_encoder_path(tuple(name.split(".")))
                   else RECSYS_LABEL)
            for name, _ in model.named_parameters()}


def make_optimizer(cfg, model: nn.Module,
                   labels: Optional[Dict[str, str]] = None
                   ) -> torch.optim.AdamW:
    """AdamW over the model's parameters: one group (IDRec, labels None) or
    the encoder and recsys groups of ``labels``."""
    hyper = {RECSYS_LABEL: (cfg.lr, cfg.l2_weight),
             ENCODER_LABEL: (cfg.fine_tune_lr, cfg.fine_tune_l2_weight)}
    named = list(model.named_parameters())
    if labels is None:
        labels = {name: RECSYS_LABEL for name, _ in named}
    groups = []
    for label, (lr, wd) in hyper.items():
        params = [p for name, p in named if labels[name] == label]
        if params:
            groups.append({"params": params, "lr": lr, "weight_decay": wd})
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The model (f32 masters, in training mode), its optimizer, the host
    generator every dropout seed is drawn from, and the step count."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


def make_train_state(model: nn.Module, cfg,
                     labels: Optional[Dict[str, str]] = None,
                     seed: int = 1) -> TrainState:
    """Switches ``model`` to training mode and builds its TrainState; the
    dropout generator lives on the host and is seeded with ``seed``. Under
    a process group every rank starts from rank 0's parameters and
    buffers."""
    model.train()
    pg = mesh.group()
    if pg is not None:
        with torch.no_grad():
            mesh.broadcast_([*model.parameters(), *model.buffers()], pg)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model, labels),
                      generator=torch.Generator().manual_seed(seed))
