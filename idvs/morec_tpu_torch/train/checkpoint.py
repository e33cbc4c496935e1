"""Checkpoint save/restore (JAX twin: idvs/morec_tpu/train/checkpoint.py).

Reference semantics (data_utils/utils.py:107-114, run.py:130-145):
- file ``epoch-{N}.pt`` inside ``checkpoint_<label>/cpt_<hparams>/``
  (``Config.model_dir``);
- payload: model parameters, optimizer state, the RNG stream, scaler state;
- saved only on a new best valid Hit@10 (run.py:265-267), by rank 0;
- resume: the epoch parsed from the filename, the RNG restored.

The payload is one ``torch.save`` of a dict: ``model`` (the model's
state_dict), ``optimizer`` (the AdamW state_dict), ``generator`` (the host
generator every dropout seed is drawn from, ``train/state.py``), ``step``,
``grad_mean`` and ``micro_step`` (a gradient-accumulation window in
progress), ``epoch``, ``scaler_state`` (empty: bf16 needs no GradScaler)
and ``extra``.
No sampler state is stored: the batchers are keyed by (seed, epoch), so a
resumed epoch N regenerates the same batches. The layout is the port's
own; the JAX package's ``.ckpt`` files and the reference's
``named_parameters()`` layout are not read.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional

import torch

from ..parallel import mesh
from .state import TrainState


def save_checkpoint(model_dir: str, epoch: int, state: TrainState,
                    extra: Optional[Dict] = None, log=None) -> str:
    """Writes ``epoch-{epoch}.pt`` under model_dir and returns its path.
    Under a process group only rank 0 writes (every rank holds the same
    weights), and every rank returns only once the file is there (a
    barrier after rank 0's rename), so any rank may load it next."""
    path = os.path.join(model_dir, f"epoch-{epoch}.pt")
    if mesh.process_index() == 0:
        _write(path, model_dir, {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "step": int(state.step),
            "grad_mean": state.grad_mean,
            "micro_step": int(state.micro_step),
            "epoch": int(epoch),
            "scaler_state": {},
            "extra": dict(extra or {}),
        })
        if log:
            log.info(f"Model saved to {path}")
    if mesh.group() is not None:
        torch.distributed.barrier()
    return path


def _write(path: str, model_dir: str, payload: Dict) -> None:
    os.makedirs(model_dir, exist_ok=True)
    # a temporary file and a rename: a reader never sees half a checkpoint
    fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=model_dir)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, state: TrainState):
    """Restores the model, optimizer, generator, step and accumulation
    window of ``state`` in place from ``path`` (read with
    ``weights_only=True``, tensors onto the model's device); returns
    (state, payload)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    state.grad_mean = payload["grad_mean"]
    state.micro_step = int(payload["micro_step"])
    return state, payload


def epoch_from_name(ckpt_name: str) -> int:
    # reference run.py:137: int(re.split(r'[._-]', name)[1])
    return int(re.split(r"[._-]", os.path.basename(ckpt_name))[1])


def get_checkpoint(directory: str, ckpt_name: str) -> Optional[str]:
    path = os.path.join(directory, ckpt_name)
    return path if os.path.exists(path) else None


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``epoch-N.pt`` of the largest N in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    cands = {}
    for x in os.listdir(directory):
        m = re.match(r"epoch-(\d+)\.pt$", x)
        if m:
            cands[int(m.group(1))] = x
    if not cands:
        return None
    return os.path.join(directory, cands[max(cands)])
