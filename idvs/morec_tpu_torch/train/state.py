"""Train state and optimizer assembly (JAX twin: idvs/morec_tpu/train/
state.py).

Reference semantics (inbatch_sasrec_e2e_text/run.py:150-191): two AdamW
parameter groups, the pretrained text encoder at (fine_tune_lr,
fine_tune_l2_weight) and everything else, the item tower's projection fc
and an ID+modality fusion's ID table and MLP included, at (lr, l2_weight);
one group for IDRec and the two-stage heads (labels None, as the JAX
runner builds them, runner.py:353-365). torch AdamW defaults:
betas (0.9, 0.999), eps 1e-8, decoupled weight decay.

Frozen parameters (the encoder's first ``freeze_paras_before`` parameters in
the reference's ``named_parameters()`` order, ``convert.py``
``bert_frozen_names``) carry FROZEN_LABEL: ``make_train_state`` sets their
``requires_grad`` to False and no optimizer group holds them, so they get
no update and no weight decay (the JAX package's ``optax.set_to_zero``
group; torch never decays a parameter without a gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..parallel import mesh

ENCODER_LABEL = "encoder"
RECSYS_LABEL = "recsys"
FROZEN_LABEL = "frozen"


def default_encoder_predicate(keys: tuple) -> bool:
    """The reference splits on 'bert_model' in the parameter name: only the
    pretrained net (``encoder.net.*``) is in the fine-tune group; the fc
    over it counts as recsys."""
    return ("encoder" in keys and "net" in keys
            and "fc" not in keys and "classifier" not in keys)


def param_labels(model: nn.Module,
                 is_encoder_path: Callable[[tuple], bool]
                 = default_encoder_predicate,
                 frozen: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Parameter name -> ENCODER_LABEL or RECSYS_LABEL, by the predicate on
    the name's dotted keys; FROZEN_LABEL for the names in ``frozen``."""
    frozen = set(frozen or ())
    names = [name for name, _ in model.named_parameters()]
    unknown = frozen.difference(names)
    if unknown:
        raise KeyError(f"frozen names that are no parameter of the model: "
                       f"{sorted(unknown)[:5]}")
    return {name: (FROZEN_LABEL if name in frozen else
                   ENCODER_LABEL if is_encoder_path(tuple(name.split(".")))
                   else RECSYS_LABEL)
            for name in names}


def count_params(model: nn.Module,
                 labels: Optional[Dict[str, str]] = None) -> Dict[str, int]:
    """{"total", "trainable"}: the parameters' element counts (buffers are
    no parameters), trainable without the frozen ones (JAX runner.py:350-364,
    the reference's utils.py:92-96 audit)."""
    labels = labels or {}
    total = trainable = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if labels.get(name) != FROZEN_LABEL:
            trainable += p.numel()
    return {"total": total, "trainable": trainable}


def make_optimizer(cfg, model: nn.Module,
                   labels: Optional[Dict[str, str]] = None
                   ) -> torch.optim.AdamW:
    """AdamW over the model's parameters: one group (IDRec and the two-stage
    heads, labels None) or the encoder and recsys groups of ``labels``;
    frozen parameters are in no group."""
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
    generator every dropout seed is drawn from, and the step count (of
    micro-steps under gradient accumulation). With ``accumulation_step``
    k > 1, ``grad_mean`` holds the running mean of this window's gradients
    by parameter name and ``micro_step`` the micro-steps taken in it, 0 to
    k - 1 (optax.MultiSteps' acc_grads and mini_step)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    grad_mean: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    micro_step: int = 0


def accumulate(state: TrainState, k: int) -> bool:
    """Takes this micro-step's gradients (the parameters' ``grad``; frozen
    parameters have none) into ``state.grad_mean`` as optax.MultiSteps
    does, mean += (grad - mean) / (n + 1) with n the micro-steps before
    it. On the k-th it puts the mean into ``grad``, empties the window and
    returns True (the optimizer steps); else it clears ``grad`` and
    returns False."""
    n = state.micro_step
    mean = state.grad_mean
    for name, p in state.model.named_parameters():
        g = p.grad
        if g is None:
            continue
        if n == 0:
            mean[name] = g
        else:
            mean[name].add_((g - mean[name]).div_(n + 1))
        p.grad = None
    state.micro_step = (n + 1) % k
    if state.micro_step:
        return False
    for name, p in state.model.named_parameters():
        p.grad = mean.pop(name, None)
    return True


def make_train_state(model: nn.Module, cfg,
                     labels: Optional[Dict[str, str]] = None,
                     seed: int = 1) -> TrainState:
    """Switches ``model`` to training mode and builds its TrainState; the
    dropout generator lives on the host and is seeded with ``seed``. The
    parameters ``labels`` freezes stop requiring a gradient. Under a process
    group every rank starts from rank 0's parameters and buffers."""
    model.train()
    for name, p in model.named_parameters():
        p.requires_grad_((labels or {}).get(name) != FROZEN_LABEL)
    pg = mesh.group()
    if pg is not None:
        with torch.no_grad():
            mesh.broadcast_([*model.parameters(), *model.buffers()], pg)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model, labels),
                      generator=torch.Generator().manual_seed(seed))
