"""Text MoRec over the OPT and DeBERTa towers in training, on the CPU:

- the port's train step against the JAX package's make_train_step on a
  one-device CPU mesh, tiny text MoRec (the tower 2 layers, hidden 32, 4
  heads, under 1 SASRec block), float32, dropout 0, host-side dedup, the
  same Flax-initialised weights through convert.from_flax and the same
  three batches: each loss within 1e-5 relative, the first step's
  gradients within rtol 2e-4 / atol 2e-5, the parameters after three
  steps within 3 * lr;
- one ``Trainer`` epoch and its evaluation with ``runner.load_encoder``'s
  OPT bundle (an HF directory with a byte-level BPE tokenizer, read by the
  HF tokenizer the caller passes), the converted weights loaded over the
  drawn ones.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.models import deberta as jdeberta
from idvs.morec_tpu.models import opt as jopt
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.deberta import DebertaConfig, DebertaModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.opt import OPTConfig, OPTModel
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.train.runner import Trainer, load_encoder
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

from tests.test_train_integration import quiet_log, synth_dataset

ITEMS, B, L, D, T, STEPS, V, H = 30, 4, 6, 16, 8, 3, 97, 32
LR, FT_LR = 1e-3, 5e-4
NETS = {
    "opt": (jopt.OPTConfig, jopt.OPTModel, OPTConfig, OPTModel, "mean",
            dict(vocab_size=V, hidden_size=H, num_hidden_layers=2,
                 num_attention_heads=4, ffn_dim=64,
                 max_position_embeddings=16, dropout=0.0,
                 attention_dropout=0.0)),
    "deberta": (jdeberta.DebertaConfig, jdeberta.DebertaModel,
                DebertaConfig, DebertaModel, "cls",
                dict(vocab_size=V, hidden_size=H, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=16,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0))}


def _keep_grads(tx):
    """tx behind an optax transform that passes the gradients on unchanged
    and keeps them as its state."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _data():
    """Token rows (row 0 the all-padding item), log popularity and three
    deduplicated batches whose items repeat."""
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    att[0] = 0
    content = np.concatenate([rng.integers(2, V, (ITEMS + 1, T)) * att, att],
                             axis=1)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(1, 12, size=(B, L + 1))
        lm = np.ones((B, L), np.float32)
        for b, pad in enumerate(rng.integers(0, L, size=B)):
            lm[b, :pad] = 0.0
            ids[b, :pad] = 0
        uniq, inv = dedup_pack(ids, 32)
        batches.append({"ids": ids, "log_mask": lm, "uniq_ids": uniq,
                        "inverse": inv})
    return content, np.log(pop).astype(np.float32), batches


def _jax_run(cfg, content, log_pop, batches, jm, params, tx):
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    # the whole state replicated as the step returns it: one compilation
    state = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    step = jax_train_step(jm, cfg, tx, mesh,
                          item_content=jnp.asarray(content, jnp.int32),
                          log_pop=jnp.asarray(log_pop))
    states, losses = [], []
    for raw in batches:
        batch = shard_batch(mesh, {k: jnp.asarray(v) if k == "log_mask"
                                   else jnp.asarray(v, jnp.int32)
                                   for k, v in raw.items()})
        state, loss = step(state, batch)
        losses.append(float(loss))
        states.append(state)
    return states, losses


def _state_dict(tree):
    return convert.from_flax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("family", list(NETS))
def test_train_step_matches_jax(family):
    jcfg_cls, jnet_cls, cfg_cls, net_cls, pooling, net_kw = NETS[family]
    cfg = Config(item_tower="modal", loss="inbatch_ce", max_seq_len=L,
                 embedding_dim=D, batch_size=B, num_attention_heads=2,
                 transformer_block=1, compute_dtype="float32",
                 drop_rate=0.0, lr=LR, fine_tune_lr=FT_LR,
                 num_words_title=T, dedup_items=True, dedup_cap=32)
    content, log_pop, batches = _data()
    jenc = JaxTextTower(net=jnet_cls(jcfg_cls(**net_kw)), embedding_dim=D,
                        word_embedding_dim=H, pooling=pooling)
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    ids0 = jnp.asarray(batches[0]["ids"][:2], jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids0,
        jnp.asarray(content[batches[0]["ids"][:2].ravel()]),
        jnp.asarray(batches[0]["log_mask"][:2])))
    labels = jstate.param_labels(params["params"],
                                 jstate.default_encoder_predicate, set())
    j_states, j_losses = _jax_run(
        cfg, content, log_pop, batches, jm, params,
        _keep_grads(jstate.make_optimizer(cfg, labels)))
    j_grads = _state_dict(j_states[0].opt_state[0])

    tenc = TextTower(net_cls(cfg_cls(**net_kw), device="cpu"), D, H,
                     pooling=pooling, attr_lengths=(T,), device="cpu")
    tm = make_model(cfg, ITEMS, tenc, device="cpu")
    tm.load_state_dict(convert.from_flax(params))
    state = make_train_state(tm, cfg, param_labels(tm))
    step = make_train_step(cfg, item_content=torch.from_numpy(content),
                           log_pop=torch.from_numpy(log_pop))
    for i, raw in enumerate(batches):
        loss = step(state, {k: torch.from_numpy(v)
                            for k, v in raw.items()}).item()
        np.testing.assert_allclose(loss, j_losses[i], rtol=1e-5)
        if i == 0:
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), j_grads[name].numpy(), rtol=2e-4,
                    atol=2e-5, err_msg=name)
    assert state.step == STEPS
    final = _state_dict(j_states[-1].params)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=3 * max(LR, FT_LR),
                                   err_msg=name)


def test_trainer_epoch_with_the_opt_bundle(tmp_path, monkeypatch):
    """runner.load_encoder's bundle of an OPT directory (weights and a BPE
    tokenizer written by HF) through one Trainer epoch and its
    evaluation on the CPU."""
    transformers = pytest.importorskip("transformers")
    from idvs.morec_tpu.models.encoders_zoo import load_tokenizer
    from tests.test_opt_roberta_zoo import _write_bpe_tokenizer
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=64, n_items=40)
    d = tmp_path / "pm" / "opt-tiny"
    d.mkdir(parents=True)
    vocab = _write_bpe_tokenizer(d)
    torch.manual_seed(0)
    transformers.OPTModel(transformers.OPTConfig(
        vocab_size=max(vocab, 300), hidden_size=24, num_hidden_layers=1,
        num_attention_heads=2, ffn_dim=48, max_position_embeddings=64,
        dropout=0.0, attention_dropout=0.0, word_embed_proj_dim=24)
    ).save_pretrained(str(d))
    kw = dict(item_tower="modal", modality="text", bert_model_load="opt-tiny",
              pretrained_models_dir=str(tmp_path / "pm"), num_words_title=T,
              embedding_dim=16, freeze_paras_before=4)
    cfg = Config(root_data_dir=root, dataset="TINY", news="news.tsv",
                 behaviors="behaviors.tsv", max_seq_len=8, min_seq_len=3,
                 batch_size=8, num_attention_heads=2, transformer_block=1,
                 epoch=1, lr=1e-3, fine_tune_lr=5e-4, eval_batch_size=32,
                 compute_dtype="float32", **kw)
    bundle = load_encoder(cfg, "cpu")
    tower, state, frozen, width = bundle
    assert width == 24 and tower.pooling == "mean" and len(frozen) == 4
    tr = Trainer(cfg, quiet_log(), quiet_log(), device="cpu",
                 encoder_bundle=bundle,
                 tokenizer=load_tokenizer(JConfig(**kw)))
    tr.load_data()
    tr.build_model()
    net = tr.model.encoder.net.state_dict()
    assert all(torch.equal(net[k], v) for k, v in state.items())
    labels = param_labels(tr.model, frozen=frozen)
    assert sum(v == "frozen" for v in labels.values()) == 4
    best, best_epoch = tr.train()
    assert best_epoch == 1 and 0 <= best <= 1
    assert tr.train_stats["steps"] > 0
    # the frozen embeddings never moved
    for name in frozen:
        key = name[len("encoder.net."):]
        assert torch.equal(tr.model.encoder.net.state_dict()[key],
                           state[key]), name
