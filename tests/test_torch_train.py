"""The training slice end to end: the port's train step (train/step.py) vs
the JAX package's make_train_step on a one-device CPU mesh, for IDRec and a
tiny text MoRec (BERT 2 layers, hidden 64), with and without host-side
dedup. The same Flax-initialised weights go through convert.from_flax and
both sides take the same three batches, float32, dropout 0:

- each loss within 1e-5 relative;
- the first step's gradients within rtol 2e-4 / atol 2e-5 (the JAX kernel
  tests' gradient tolerance);
- the parameters after three steps within 3 * lr absolute, the bound on
  AdamW's moves in three steps, in case a near-zero gradient flips sign.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

ITEMS, B, L, D, T, STEPS = 30, 4, 6, 32, 8, 3
LR, FT_LR = 1e-3, 5e-4
BERT = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _keep_grads(tx):
    """tx behind an optax transform that passes the gradients on unchanged
    and keeps them as its state, so each JAX step's state holds them."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _data(dedup):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    content = np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att,
                              att], axis=1)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(1, 12, size=(B, L + 1))    # items repeat
        lm = np.ones((B, L), np.float32)
        for b, pad in enumerate(rng.integers(0, L, size=B)):
            lm[b, :pad] = 0.0
            ids[b, :pad] = 0
        batch = {"ids": ids, "log_mask": lm}
        if dedup:
            packed = dedup_pack(ids, 32)
            assert packed is not None
            batch["uniq_ids"], batch["inverse"] = packed
        batches.append(batch)
    return content, np.log(pop).astype(np.float32), batches


_PARAMS = {}


def _init_params(item_tower, jm, content, batch):
    """The Flax initialisation of item_tower's model, made once: dedup
    changes no parameter."""
    if item_tower not in _PARAMS:
        ids0 = jnp.asarray(batch["ids"][:2], jnp.int32)
        items = (jnp.asarray(content[batch["ids"][:2].ravel()])
                 if item_tower == "modal" else None)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids0, items,
                                  jnp.asarray(batch["log_mask"][:2]))
        _PARAMS[item_tower] = jax.tree.map(np.asarray, params)
    return _PARAMS[item_tower]


def _setup(item_tower, dedup):
    cfg = Config(item_tower=item_tower, loss="inbatch_ce", max_seq_len=L,
                 embedding_dim=D, batch_size=B, num_attention_heads=2,
                 transformer_block=2, compute_dtype="float32", drop_rate=0.0,
                 lr=LR, fine_tune_lr=FT_LR, num_words_title=T,
                 dedup_items=dedup, dedup_cap=32 if dedup else 0)
    content, log_pop, batches = _data(dedup)
    modal = item_tower == "modal"
    jenc = tenc = None
    if modal:
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=64)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 64,
                         attr_lengths=(T,), device="cpu")
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    params = _init_params(item_tower, jm, content, batches[0])
    tm = make_model(cfg, ITEMS, tenc, device="cpu")
    tm.load_state_dict(convert.from_flax(params))
    return cfg, content, log_pop, batches, jm, params, tm


def _jax_run(cfg, content, log_pop, batches, jm, params, tx):
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    # the whole state replicated as the step returns it: the later steps
    # reuse the first one's compilation
    state = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    step = jax_train_step(jm, cfg, tx, mesh,
                          item_content=(jnp.asarray(content, jnp.int32)
                                        if cfg.item_tower == "modal"
                                        else None),
                          log_pop=jnp.asarray(log_pop))
    states, losses = [], []
    for raw in batches:
        batch = shard_batch(mesh, {"ids": jnp.asarray(raw["ids"], jnp.int32),
                                   "log_mask": jnp.asarray(raw["log_mask"])})
        if "uniq_ids" in raw:
            batch["uniq_ids"] = jnp.asarray(raw["uniq_ids"], jnp.int32)
            batch["inverse"] = jnp.asarray(raw["inverse"], jnp.int32)
        state, loss = step(state, batch)
        losses.append(float(loss))
        states.append(state)
    return states, losses


def _state_dict(tree):
    return convert.from_flax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("item_tower,dedup", [("id", False), ("id", True),
                                              ("modal", False),
                                              ("modal", True)])
def test_train_step_matches_jax(item_tower, dedup):
    cfg, content, log_pop, batches, jm, params, tm = _setup(item_tower,
                                                            dedup)
    modal = item_tower == "modal"
    labels = (jstate.param_labels(params["params"],
                                  jstate.default_encoder_predicate, set())
              if modal else None)
    j_states, j_losses = _jax_run(cfg, content, log_pop, batches, jm,
                                  params,
                                  _keep_grads(jstate.make_optimizer(cfg,
                                                                    labels)))
    j_grads = _state_dict(j_states[0].opt_state[0])

    state = make_train_state(tm, cfg, param_labels(tm) if modal else None)
    step = make_train_step(cfg, item_content=torch.from_numpy(content),
                           log_pop=torch.from_numpy(log_pop))
    for i, raw in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in raw.items()}
        loss = step(state, batch).item()
        np.testing.assert_allclose(loss, j_losses[i], rtol=1e-5)
        if i == 0:
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), j_grads[name].numpy(), rtol=2e-4,
                    atol=2e-5, err_msg=name)
    assert state.step == STEPS
    final = _state_dict(j_states[-1].params)
    bound = 3 * max(LR, FT_LR)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=bound, err_msg=name)


def test_optimizer_groups_and_dedup_pack():
    """Two AdamW groups for modal MoRec (encoder.net.* at fine_tune_lr, the
    tower's fc with the recsys group), one for IDRec; dedup_pack's inverse
    restores the slots and it declines over capacity."""
    _, _, _, _, _, _, tm = _setup("modal", False)
    cfg = Config(lr=LR, fine_tune_lr=FT_LR)
    labels = param_labels(tm)
    assert labels["encoder.fc.weight"] == "recsys"
    assert labels["encoder.net.layer_0.output.weight"] == "encoder"
    opt = make_train_state(tm, cfg, labels).optimizer
    lrs = sorted(g["lr"] for g in opt.param_groups)
    assert lrs == [FT_LR, LR] and opt.defaults["eps"] == 1e-8
    n_enc = sum(1 for v in labels.values() if v == "encoder")
    assert {len(g["params"]) for g in opt.param_groups} == {
        n_enc, len(labels) - n_enc}
    assert len(make_train_state(tm, cfg).optimizer.param_groups) == 1
    ids = np.array([[3, 5, 3], [0, 5, 9]])
    uniq, inv = dedup_pack(ids, 8)
    np.testing.assert_array_equal(uniq[inv].reshape(ids.shape), ids)
    assert uniq.shape == (8,) and dedup_pack(ids, 3) is None
    slots = np.arange(128 * 21).reshape(128, 21)
    assert dedup_pack(slots % 2048)[0].shape == (2048,)   # cap 0: 3/4 of
    assert dedup_pack(slots % 2049) is None               # 2688, to 256
    make_train_step(Config(loss="bce"))          # BCE and DSSM are ported
    make_train_step(Config(user_tower="dssm", loss="bce"))
    with pytest.raises(NotImplementedError, match="n_steps"):
        make_train_step(Config(), n_steps=2)
