"""BCE with sampled negatives under SASRec (reference bce_text/main-end2end)
in the port, against the JAX package on the CPU:

- ``bce_sasrec_loss`` and its gradients, float32 and bf16 inputs (rtol
  1e-6, and 1e-6 of the largest gradient where a gradient's two terms
  cancel; a bf16 input's gradient, rounded to bf16 on both sides, within
  one bf16 unit);
- ``sample_negatives`` and ``BCETrainBatcher``: the same seed gives the
  same batches, bit for bit; every negative sits at a valid transition's
  slot and is none of the user's items;
- the train step (train/step.py's BCE branch) against the JAX
  ``make_train_step`` on a one-device mesh over three batches, float32,
  dropout 0, SASRec 1 block, for IDRec and a tiny text MoRec (BERT 1
  layer, hidden 32), with and without host-side dedup over the positives
  and negatives together: the losses within 1e-5 relative, the first
  step's gradients within rtol 2e-4 / atol 2e-5, the weights after three
  steps within 3 * lr (tests/test_torch_train.py's tolerances);
- a ``Trainer`` epoch with ``loss="bce"``: the per-step losses against the
  JAX ``Trainer``'s, valid HR@10 / nDCG@10 within 2 / n_users, and the
  best checkpoint reloaded in test mode to the same evaluation bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data import loader as jloader
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.ops import losses as jlosses
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data import loader as tloader
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.ops.losses import bce_sasrec_loss
from idvs.morec_tpu_torch.train.runner import Trainer
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

from tests.test_torch_train import _keep_grads, _state_dict
from tests.test_torch_runner import jit_jax_init
from tests.test_train_integration import quiet_log, synth_dataset

ITEMS, B, L, D, T, STEPS = 30, 4, 6, 32, 8, 3
LR, FT_LR = 1e-3, 5e-4
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    jit_jax_init(monkeypatch)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_bce_sasrec_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    u, p, n = (rng.normal(size=(5, 7, 16)).astype(np.float32) * 2
               for _ in range(3))
    lm = (rng.uniform(size=(5, 7)) < 0.7).astype(np.float32)
    u, p, n = (np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
               for x in (u, p, n))
    jf = lambda u, p, n: jlosses.bce_sasrec_loss(
        u.astype(dtype), p.astype(dtype), n.astype(dtype), lm)
    jloss, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(u, p, n)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    ts = [torch.tensor(x, requires_grad=True) for x in (u, p, n)]
    loss = bce_sasrec_loss(*(t.to(tdt) for t in ts), torch.from_numpy(lm))
    assert loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    # the gradient reaches a bf16 input rounded to bf16 on both sides: one
    # unit (2^-8 relative) apart where the float32 values round apart
    rtol = 1e-6 if dtype == np.float32 else 2.0 ** -8
    for t, g in zip(ts, jgrads):
        g = np.asarray(g, np.float32)
        # an element is the positive's and the negative's terms summed, which
        # may cancel: its error is held to rtol of the largest element too
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=rtol,
                                   atol=rtol * np.abs(g).max())
    # no valid position: both means over max(#valid, 1) = 1, i.e. 0
    zero = bce_sasrec_loss(*ts, torch.zeros(5, 7))
    assert zero.item() == 0.0


def test_sample_negatives_and_bce_batcher_bit_equal():
    rng = np.random.default_rng(1)
    lens = rng.integers(2, 12, size=23).astype(np.int32)
    seqs = np.zeros((23, 12), np.int32)
    for r, n in enumerate(lens):
        seqs[r, 12 - n:] = rng.choice(np.arange(1, 16), n, replace=False)
    for k in (1, 3):
        a = tloader.sample_negatives(np.random.default_rng(5), seqs, 15,
                                     neg_per_pos=k)
        b = jloader.sample_negatives(np.random.default_rng(5), seqs, lens,
                                     15, neg_per_pos=k)
        assert a.dtype == b.dtype and a.shape == (23, 11, k)
        np.testing.assert_array_equal(a, b)
        for row, draws in zip(seqs, a):
            assert not set(draws.ravel()) & set(row.tolist())
    tb = tloader.BCETrainBatcher(seqs, lens, 11, 8, 15, seed=7)
    jb = jloader.BCETrainBatcher(seqs, lens, 11, 8, 15, seed=7)
    assert tb.steps_per_epoch() == jb.steps_per_epoch() == 3
    for epoch in (1, 2):
        got, want = list(tb.epoch(epoch)), list(jb.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            pos, neg, lm = g
            assert (neg[:, -1] == 0).all()
            np.testing.assert_array_equal(neg[:, :-1] != 0, lm != 0)
            for p, n in zip(pos, neg):
                assert not set(n[n != 0].tolist()) & set(p.tolist())


def _data(dedup):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    content = np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att,
                              att], axis=1)
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(1, 12, size=(B, L + 1))    # items repeat
        lm = np.ones((B, L), np.float32)
        for b, pad in enumerate(rng.integers(0, L, size=B)):
            lm[b, :pad] = 0.0
            ids[b, :pad] = 0
        neg = np.zeros_like(ids)
        neg[:, :-1] = np.where(lm != 0, rng.integers(1, ITEMS + 1, (B, L)), 0)
        batch = {"ids": ids, "neg_ids": neg, "log_mask": lm}
        if dedup:
            packed = dedup_pack(np.concatenate([ids.ravel(), neg.ravel()]),
                                64)
            assert packed is not None
            batch["uniq_ids"], batch["inverse"] = packed
        batches.append(batch)
    return content, batches


_PARAMS = {}


def _setup(item_tower, dedup):
    cfg = Config(item_tower=item_tower, loss="bce", max_seq_len=L,
                 embedding_dim=D, batch_size=B, num_attention_heads=2,
                 transformer_block=1, compute_dtype="float32", drop_rate=0.0,
                 lr=LR, fine_tune_lr=FT_LR, num_words_title=T,
                 dedup_items=dedup, dedup_cap=64 if dedup else 0)
    content, batches = _data(dedup)
    jenc = tenc = None
    if item_tower == "modal":
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=32)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 32,
                         attr_lengths=(T,), device="cpu")
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    if item_tower not in _PARAMS:       # dedup changes no parameter
        ids0 = jnp.asarray(batches[0]["ids"][:2], jnp.int32)
        items = (jnp.asarray(content[batches[0]["ids"][:2].ravel()])
                 if item_tower == "modal" else None)
        _PARAMS[item_tower] = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0), ids0, items,
            jnp.asarray(batches[0]["log_mask"][:2])))
    params = _PARAMS[item_tower]
    tm = make_model(cfg, ITEMS, tenc, device="cpu")
    convert.load_flax(tm, params)
    return cfg, content, batches, jm, params, tm


@pytest.mark.parametrize("item_tower,dedup", [("id", False), ("id", True),
                                              ("modal", False),
                                              ("modal", True)])
def test_bce_train_step_matches_jax(item_tower, dedup):
    cfg, content, batches, jm, params, tm = _setup(item_tower, dedup)
    modal = item_tower == "modal"
    labels = (jstate.param_labels(params["params"],
                                  jstate.default_encoder_predicate, set())
              if modal else None)
    tx = _keep_grads(jstate.make_optimizer(cfg, labels))
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    # the whole state placed as the step returns it: one compilation
    jst = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    jstep = jax_train_step(jm, cfg, tx, mesh,
                           item_content=(jnp.asarray(content, jnp.int32)
                                         if modal else None))
    state = make_train_state(tm, cfg, param_labels(tm) if modal else None)
    step = make_train_step(cfg, item_content=torch.from_numpy(content))
    for i, raw in enumerate(batches):
        jst, jloss = jstep(jst, {k: jnp.asarray(v) for k, v in raw.items()})
        loss = step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        if i == 0:
            grads = _state_dict(jst.opt_state[0])
            for name, q in tm.named_parameters():
                np.testing.assert_allclose(
                    q.grad.numpy(), grads[name].numpy(), rtol=2e-4,
                    atol=2e-5, err_msg=name)
    assert state.step == STEPS
    final = _state_dict(jst.params)
    for name, q in tm.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=3 * max(LR, FT_LR),
                                   err_msg=name)


BASE = dict(dataset="TINY", news="news.tsv", behaviors="behaviors.tsv",
            max_seq_len=8, min_seq_len=3, batch_size=16, embedding_dim=16,
            num_attention_heads=2, transformer_block=1, epoch=1, lr=1e-3,
            eval_batch_size=32, loss="bce", compute_dtype="float32")


def test_bce_trainer_matches_jax_and_reloads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=96, n_items=40)
    jtr = JTrainer(JConfig(root_data_dir=root, drop_rate=0.0, **BASE),
                   quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]))
    jtr.load_data()
    jtr.build_model()

    def port(**kw):
        tr = Trainer(Config(root_data_dir=root, **{**BASE, **kw}),
                     quiet_log(), quiet_log(), device="cpu")
        tr.load_data()
        tr.build_model()
        return tr

    tr = port(drop_rate=0.0)
    assert isinstance(tr.batcher, tloader.BCETrainBatcher)
    convert.load_flax(tr.model, jtr.state.params)
    jl = []
    for raw in jtr.batcher.epoch(1):
        jtr.state, loss = jtr.train_step(jtr.state, jtr.make_batch(raw))
        jl.append(float(loss))
    got = [tr.train_step(tr.state, tr.make_batch(raw)).item()
           for raw in tr.batcher.epoch(1)]
    np.testing.assert_allclose(got, jl, rtol=1e-5)
    hit, ndcg = tr.run_eval("valid")
    jhit, jndcg = jtr.run_eval("valid")
    n = tr.last_eval["users"]
    assert abs(hit - jhit) <= 2 / n and abs(ndcg - jndcg) <= 2 / n

    # one epoch with dropout, the best checkpoint reloaded in test mode
    tr = port(drop_rate=0.1)
    best, best_epoch = tr.train()
    assert best_epoch == 1 and tr.train_stats["steps"] == 6
    te = port(drop_rate=0.1, mode="test", load_ckpt_name="epoch-1.pt")
    te.test()
    assert te.run_eval("valid") == (best, tr.valid_results[1]["ndcg"])
    np.testing.assert_array_equal(te.last_eval["hits"],
                                  tr.valid_results[1]["hits"])
    np.testing.assert_array_equal(te.last_eval["ndcgs"],
                                  tr.valid_results[1]["ndcgs"])
