"""The train step (JAX twin: idvs/morec_tpu/train/step.py
``make_train_step``) of the three loss families: the in-batch CE and BCE
with sampled negatives under SASRec, and DSSM's BCE over (1 + neg_num)
candidates.

One in-batch CE step, as the JAX ``single_step`` (:155-245, :264-272):

1. the f32 master parameters are cast to the compute dtype (bf16 or f32,
   ``cfg.compute_dtype``) and the model's towers (``RecModel.item_embs``,
   ``user_states``, ``user_vec``) run on the cast copies through
   ``torch.func.functional_call``, so the gradients land on the masters;
2. the item tower encodes the batch's item slots: the catalog rows
   (device-resident, gathered by id: token rows, or a two-stage tower's
   float32 cache of the frozen encoder's outputs) of every slot, or, with
   host-side
   dedup (``dedup_pack``: ``uniq_ids`` + ``inverse`` in the batch), of each
   unique item once, gathered back by ``inverse``. The tower takes the ids
   with the content (ID+modality fusion reads both). A bf16 parameter copy
   meets the float32 cache in float32, as Flax promotes (JAX step.py:80-85
   casts the parameters, not the cache). Content shipped with the
   batch takes the catalog's place: ``content`` (every slot) or
   ``uniq_content`` (the unique items), e.g. uint8 NHWC images, whose
   padding slots (id 0) the tower sees as zero images;
3. the SASRec tower runs on ``embs[:, :-1]``, the in-batch debiased CE
   scores every position against the batch's items;
4. backward, then the AdamW update of ``state.optimizer``; with
   ``cfg.accumulation_step`` k > 1 (optax.MultiSteps in the JAX runner,
   runner.py:366-370), the update of every k-th micro-step, on the mean of
   the k micro-steps' gradients (``state.accumulate``); the parameters do
   not change in between, and the window carries over an epoch's end.

The loss is the composition of ``ops/losses.py`` or, with
``cfg.use_pallas``, the kernel edition (``ops/cuda/inbatch_ce.py``, JAX
step.py:219-227).

``cfg.loss == "bce"`` with SASRec (JAX step.py:193-211): the batch adds
``neg_ids`` (B, L + 1), one sampled negative at each valid transition's
slot (``data/loader.py`` ``BCETrainBatcher``). The item tower encodes the
positive and the negative slots together, [ids, neg_ids] flattened (with
dedup, one ``dedup_pack`` over both; with images, ``content`` and
``neg_content`` or ``uniq_content``); SASRec runs on the positives'
``[:, :-1]``, and ``bce_sasrec_loss`` scores its states against the next
positives and the negatives. ``cfg.user_tower == "dssm"`` (JAX
step.py:162-171): the batch is ``users`` (B,), ``items`` (B, 1 + neg_num)
and ``labels`` (plus ``content`` when the items' content travels with the
batch); the item tower encodes the items, ``user_vec`` the users, and
``bce_dssm_loss`` scores them. ``use_pallas`` and ``gather_negatives`` are
options of the in-batch CE only, as in the JAX package.

Under a process group (``parallel/mesh.py`` ``init_distributed``) the step
is data-parallel (JAX step.py:274-291): each rank runs its local batch,
the gradients are averaged over the ranks after ``backward`` (``pmean``,
every micro-step, as the JAX step averages before ``tx.update``) and the
returned loss is the ranks' mean. With ``cfg.gather_negatives``
the candidates of the CE are every rank's items (the gathered composition,
or the gathered kernel edition under ``use_pallas``); on one process, as
on the JAX package's one-device mesh, the flag changes nothing.

Dropout and DropPath run in the model's training mode. Each step draws one
seed from ``state.generator``, which so advances alike on every rank, and
seeds the step's own generator with it and the rank (JAX folds the step
and ``axis_index`` into its key): the masks differ between ranks, and rank
0's are the single-process step's.

``cfg.encoder_chunk`` (when it divides the number of encoded items) runs
the item tower over chunks of that many items, each under
``torch.utils.checkpoint``: the backward recomputes a chunk's activations,
so the tower's memory is one chunk's (JAX step.py:99-134; XLA's unrolled
scan and its saved-attention policy are not carried over).
``cfg.remat_encoder`` checkpoints the whole encode as one chunk. A chunk's
dropout and DropPath seeds come from a generator seeded with one value
drawn from the step's generator before the chunk runs, so the
recomputation draws the very same masks.

Several steps per dispatch raise ``NotImplementedError`` (the runner's
``steps_per_dispatch`` runs single steps back to back).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import dropout
from ..ops.cuda.inbatch_ce import fused_inbatch_ce, fused_inbatch_ce_gathered
from ..ops.losses import bce_dssm_loss, bce_sasrec_loss, inbatch_debiased_ce
from ..parallel import mesh
from .state import TrainState, accumulate

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dedup_pack(ids: np.ndarray, cap: int = 0
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host-side unique-item packing of one batch on one device (JAX
    train/runner.py ``_dedup_pack``): (uniq_ids (cap,) padded with id 0,
    inverse (ids.size,)) so that ``uniq_ids[inverse] == ids.ravel()``, or
    None when the batch holds more than ``cap`` unique items (the step then
    encodes every slot). cap 0 (``cfg.dedup_cap``'s default) is 3/4 of the
    batch's item slots rounded up to 256, at least 256."""
    flat = np.asarray(ids).reshape(-1)
    cap = cap or max(256, int(0.75 * flat.size + 255) // 256 * 256)
    uniq, inv = np.unique(flat, return_inverse=True)
    if len(uniq) > cap:
        return None
    padded = np.zeros(cap, dtype=np.int64)
    padded[:len(uniq)] = uniq
    return padded, inv.reshape(-1).astype(np.int64)


def _check(n_steps: int) -> None:
    if n_steps != 1:
        raise NotImplementedError(
            "the port's train step runs one step a call; not ported: "
            "n_steps")


def _step_generator(generator: torch.Generator,
                    rank: int) -> torch.Generator:
    """A step's dropout generator: one seed drawn from the state's
    generator, and the rank."""
    return torch.Generator().manual_seed(
        (rank << 32) | dropout.draw_seed(generator))


def make_train_step(cfg, *, item_content: Optional[torch.Tensor] = None,
                    log_pop: Optional[torch.Tensor] = None,
                    n_steps: int = 1
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  torch.Tensor]:
    """step(state, batch) -> the loss (a detached 0-d tensor; reading it
    waits for the card), updating ``state`` in place.

    item_content: the device-resident (item_num + 1, W) catalog rows of a
    modal item tower (None for IDRec). log_pop: (item_num + 1,) log
    popularity on the device (the in-batch CE's only). batch: ``ids``
    (B, L + 1) and ``log_mask`` (B, L) on the device, plus ``uniq_ids``
    and ``inverse`` from ``dedup_pack`` when dedup is on, plus ``content``
    (one row or image per slot) or ``uniq_content`` (one per ``uniq_ids``
    entry) when the content travels with the batch; BCE adds ``neg_ids``
    (and ``neg_content``); DSSM's batch is ``users``, ``items``,
    ``labels`` (and ``content``).
    """
    _check(n_steps)
    dt = COMPUTE_DTYPES[cfg.compute_dtype]
    chunk = getattr(cfg, "encoder_chunk", 0)
    remat = getattr(cfg, "remat_encoder", False)
    pallas = getattr(cfg, "use_pallas", False)
    pg = mesh.group()
    rank = mesh.process_index()
    gather = pg is not None and getattr(cfg, "gather_negatives", False)
    accum = getattr(cfg, "accumulation_step", 1)

    def loss_of(uv, embs, ids, lm, lp):
        if pallas and gather:
            return fused_inbatch_ce_gathered(uv, embs, ids, lm, lp, pg)
        if pallas:
            return fused_inbatch_ce(uv, embs, ids, lm, lp)
        return inbatch_debiased_ce(uv, embs, ids, lm, lp,
                                   gather_negatives=gather, pg=pg)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        gen = _step_generator(state.generator, rank)
        # bf16 compute on cast copies, f32 masters (JAX step.py:74-85)
        params = {k: p.to(dt) if p.dtype == torch.float32 else p
                  for k, p in model.named_parameters()}

        towers = {name: {k: v for k, v in params.items()
                         if k.split(".", 1)[0] in mods}
                  for name, mods in model.TOWERS.items()}

        def tower(name, *args):
            # RecModel's own composition, on the tower's cast copies
            return functional_call(model, towers[name], (name, *args),
                                   tie_weights=False)

        def encode_remat(item_ids, content):
            # the chunk's own generator, seeded before the chunk runs: the
            # backward's recomputation draws the same seeds again
            seed = dropout.draw_seed(gen)
            return checkpoint(
                lambda i, c: tower("item_embs", i, c,
                                   torch.Generator().manual_seed(seed)),
                item_ids, content, use_reentrant=False,
                preserve_rng_state=False)

        def item_embs(item_ids, content):
            if model.item_tower == "id":
                return tower("item_embs", item_ids, None, gen)
            if content is None:
                content = item_content[item_ids]
            n = item_ids.shape[0]
            if chunk and n % chunk == 0:
                return torch.cat([
                    encode_remat(item_ids[i:i + chunk], content[i:i + chunk])
                    for i in range(0, n, chunk)])
            if remat:
                return encode_remat(item_ids, content)
            return tower("item_embs", item_ids, content, gen)

        if model.user_tower == "dssm":
            items = batch["items"]
            B, N = items.shape
            ivec = item_embs(items.reshape(-1),
                             batch.get("content")).reshape(B, N, -1)
            uvec = tower("user_vec", batch["users"], gen)
            loss = bce_dssm_loss(uvec, ivec, batch["labels"])
        else:
            ids, lm = batch["ids"], batch["log_mask"]
            B, S = ids.shape
            bce = cfg.loss == "bce"
            if "uniq_ids" in batch:
                # with BCE, one dedup_pack over [ids, neg_ids] (JAX
                # runner.py:441-449)
                embs = item_embs(batch["uniq_ids"],
                                 batch.get("uniq_content"))[batch["inverse"]]
            else:
                slots, content = ids.reshape(-1), batch.get("content")
                if bce:
                    slots = torch.cat([slots, batch["neg_ids"].reshape(-1)])
                    if content is not None:
                        content = torch.cat([content, batch["neg_content"]])
                embs = item_embs(slots, content)
            pos = embs[:B * S].reshape(B, S, -1)
            # the CE casts SASRec's input to the compute dtype, BCE does not
            # (JAX step.py:207, 217): a two-stage head's float32
            # embeddings run SASRec in float32 on the bf16 copies
            uv = tower("user_states", pos[:, :-1] if bce
                       else pos[:, :-1].to(dt), lm, gen)
            if bce:
                # targets: the next positives; the negatives sit at the
                # transitions' slots (bce_text/main-end2end/model/
                # model.py:39-41)
                neg = embs[B * S:].reshape(B, S, -1)
                loss = bce_sasrec_loss(uv, pos[:, 1:], neg[:, :-1], lm)
            else:
                loss = loss_of(uv, pos, ids, lm, log_pop[ids])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if pg is not None:
            mesh.mean_([p.grad for p in model.parameters()
                        if p.grad is not None] + [loss.reshape(1)], pg)
        if accum == 1 or accumulate(state, accum):
            state.optimizer.step()
        state.step += 1
        return loss

    return step
