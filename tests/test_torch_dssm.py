"""The DSSM two-tower (reference bce_text/main-end2end(DSSM)) in the port,
against the JAX package on the CPU:

- ``bce_dssm_loss`` and its gradients (rtol 1e-6);
- ``read_behaviors_pairs`` and ``DSSMTrainBatcher``: the same files and
  seed give the same pairs and batches, bit for bit;
- ``MLPLayers`` / ``MLPEncoder`` at dnn_layers 2, and the DSSM
  ``RecModel``'s ``user_vec`` and ``item_embs`` for the ``id`` tower (with
  its ``id_encoder``) and a tiny BERT tower, on the Flax weights through
  ``convert.load_flax``: forward within 2e-5;
- the train step's DSSM branch against the JAX ``make_train_step`` over
  three batches, float32, dropout 0, id (dnn_layers 2) and tiny BERT:
  losses within 1e-5 relative, the first step's gradients within rtol 2e-4
  / atol 2e-5, the weights after three steps within 3 * lr;
- DSSM evaluation (user ids in the id slot) per user against the JAX
  ``make_eval_step(user_tower="dssm")``, and ``recommend_users`` against
  the JAX ``Retriever``; the guards of ``recommend`` and
  ``recommend_users``;
- a ``Trainer`` epoch with ``user_tower="dssm"``: per-step losses against
  the JAX ``Trainer``'s, the best checkpoint reloaded in test mode to the
  same evaluation bits; ``check_supported`` taking the two-stage, fusion
  and accumulation items, and the cold-item evaluation refusing DSSM.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data import loader as jloader
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.dssm import MLPEncoder as JaxMLPEncoder
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.ops import losses as jlosses
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate
from idvs.morec_tpu.serve import Retriever as JaxRetriever
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.evaluate import (
    compute_item_embeddings as jax_item_embeddings,
    make_eval_step as jax_eval_step)
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu.train.runner import _dssm_eval_batches
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data import loader as tloader
from idvs.morec_tpu_torch.data import preprocess as tpre
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.dssm import MLPEncoder
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.ops.losses import bce_dssm_loss
from idvs.morec_tpu_torch.serve import Retriever
from idvs.morec_tpu_torch.train.evaluate import (compute_item_embeddings,
                                                 make_eval_step)
from idvs.morec_tpu_torch.train.runner import (Trainer, _DSSMEvalBatches,
                                               check_supported)
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import make_train_step

from tests.test_torch_train import _keep_grads, _state_dict
from tests.test_torch_runner import jit_jax_init
from tests.test_train_integration import quiet_log, synth_dataset

ITEMS, USERS, B, NEG, D, T, STEPS = 30, 20, 6, 2, 32, 8, 3
LR, FT_LR = 1e-3, 5e-4
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    jit_jax_init(monkeypatch)


def test_bce_dssm_loss_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(6, 16)).astype(np.float32)
    v = rng.normal(size=(6, 3, 16)).astype(np.float32)
    labels = np.zeros((6, 3), np.float32)
    labels[:, 0] = 1.0
    jloss, jgrads = jax.value_and_grad(
        lambda u, v: jlosses.bce_dssm_loss(u, v, labels), argnums=(0, 1))(
            u, v)
    tu, tv = (torch.tensor(x, requires_grad=True) for x in (u, v))
    loss = bce_dssm_loss(tu, tv, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for t, g in zip((tu, tv), jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-6,
                                   atol=1e-6 * np.abs(g).max())


def _pairs(tmp_path):
    root = synth_dataset(tmp_path, n_users=40, n_items=24)
    base = root + "TINY/"
    out = []
    for pre in (tpre, jpre):
        dic, n2i, _ = pre.read_items_text(base + "news.tsv")
        out.append(pre.read_behaviors_pairs(base + "behaviors.tsv", dic, n2i,
                                            3, 6))
    return out


def test_pair_reader_and_dssm_batcher_bit_equal(tmp_path):
    tp, jp = _pairs(tmp_path)
    assert (tp.user_num, tp.item_num) == (jp.user_num, jp.item_num) == (40,
                                                                         24)
    assert min(tp.users_train) == 1
    for f in ("train_pairs", "valid_pairs", "test_pairs"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    for f in ("users_train", "users_valid", "users_history_for_valid",
              "users_history_for_test"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert tp.item_id_to_content == jp.item_id_to_content
    tb = tloader.DSSMTrainBatcher(tp.train_pairs, tp.users_valid, 24, 3, 32,
                                  seed=9)
    jb = jloader.DSSMTrainBatcher(jp.train_pairs, jp.users_valid, 24, 3, 32,
                                  seed=9)
    assert tb.steps_per_epoch() == jb.steps_per_epoch()
    for epoch in (1, 2):
        for g, w in zip(tb.epoch(epoch), jb.epoch(epoch), strict=True):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            users, items, labels = g
            assert items.shape == (32, 4) and (labels[:, 0] == 1).all()
            for u, row in zip(users, items):
                assert not set(row[1:].tolist()) & set(tp.users_valid[u])


def test_mlp_encoder_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, D)).astype(np.float32)
    jm = JaxMLPEncoder(D, 2, 0.1)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    assert set(params["params"]["mlp"]) == {"Dense_0", "Dense_1"}
    tm = MLPEncoder(D, 2, 0.1, device="cpu").eval()
    convert.load_flax(tm, params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ident = MLPEncoder(D, 0, 0.1, device="cpu")     # dnn_layers 0
    assert not list(ident.parameters())
    tx = torch.from_numpy(x)
    assert ident(tx) is tx


def _content():
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    content = np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att,
                              att], axis=1)
    content[0] = 0
    return content


def _models(item_tower, dnn_layers, content):
    cfg = Config(item_tower=item_tower, user_tower="dssm", loss="bce",
                 embedding_dim=D, dnn_layers=dnn_layers, batch_size=B,
                 neg_num=NEG, compute_dtype="float32", drop_rate=0.0, lr=LR,
                 fine_tune_lr=FT_LR, num_words_title=T)
    jenc = tenc = None
    if item_tower == "modal":
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=32)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 32,
                         attr_lengths=(T,), device="cpu")
    jm = jax_make_model(cfg, ITEMS, USERS, jenc)
    ids0 = jnp.ones((2, 3), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids0,
        jnp.asarray(content[np.ones(6, int)]) if jenc else None,
        jnp.ones((2, 2), jnp.float32)))
    tm = make_model(cfg, ITEMS, tenc, user_num=USERS, device="cpu")
    convert.load_flax(tm, params)
    return cfg, jm, params, tm


@pytest.mark.parametrize("item_tower,dnn_layers", [("id", 2), ("modal", 1)])
def test_dssm_towers_match_jax(item_tower, dnn_layers):
    content = _content()
    _, jm, params, tm = _models(item_tower, dnn_layers, content)
    names = dict(tm.named_parameters())
    assert names["user_embedding.weight"].shape == (USERS + 1, D)
    assert not names["user_embedding.weight"][0].any()
    assert ("id_encoder.mlp.Dense_1.weight" in names) == (item_tower == "id")
    assert param_labels(tm)["user_embedding.weight"] == "recsys"
    users = np.arange(USERS + 1)
    items = np.arange(ITEMS + 1)
    modal = item_tower == "modal"
    want_u = np.asarray(jax.jit(lambda u: jm.apply(
        params, u, method="user_vec"))(jnp.asarray(users)))
    want_i = np.asarray(jax.jit(lambda i: jm.apply(
        params, i, jnp.asarray(content)[i] if modal else None,
        method="item_embs"))(jnp.asarray(items)))
    with torch.no_grad():
        got_u = tm.user_vec(torch.from_numpy(users)).numpy()
        got_i = tm.item_embs(torch.from_numpy(items),
                             torch.from_numpy(content) if modal
                             else None).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_i, want_i, rtol=2e-5, atol=2e-5)


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        items = rng.integers(1, ITEMS + 1, size=(B, 1 + NEG))
        labels = np.zeros(items.shape, np.float32)
        labels[:, 0] = 1.0
        out.append({"users": rng.integers(1, USERS + 1, size=B),
                    "items": items, "labels": labels})
    return out


@pytest.mark.parametrize("item_tower,dnn_layers", [("id", 2), ("modal", 0)])
def test_dssm_train_step_matches_jax(item_tower, dnn_layers):
    content = _content()
    cfg, jm, params, tm = _models(item_tower, dnn_layers, content)
    modal = item_tower == "modal"
    labels = (jstate.param_labels(params["params"],
                                  jstate.default_encoder_predicate, set())
              if modal else None)
    tx = _keep_grads(jstate.make_optimizer(cfg, labels))
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    jst = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    jstep = jax_train_step(jm, cfg, tx, mesh,
                           item_content=(jnp.asarray(content, jnp.int32)
                                         if modal else None))
    state = make_train_state(tm, cfg, param_labels(tm) if modal else None)
    step = make_train_step(cfg, item_content=torch.from_numpy(content))
    for i, raw in enumerate(_batches()):
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


def test_dssm_eval_and_recommend_users_match_jax():
    rng = np.random.default_rng(5)
    content = _content()
    _, jm, params, tm = _models("id", 2, content)
    hist = np.zeros((USERS, 5), np.int64)
    for r in range(USERS):
        hist[r, :3] = rng.choice(np.arange(1, ITEMS + 1), 3, replace=False)
    pairs = np.stack([rng.permutation(np.arange(1, USERS + 1))[:17],
                      rng.integers(1, ITEMS + 1, 17)], axis=1)
    jtable = jax_item_embeddings(jm, params, ITEMS, None, D, batch_size=16)
    table = compute_item_embeddings(tm, ITEMS, None, D, batch_size=16)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=2e-5,
                               atol=2e-5)
    jstep, step = jax_eval_step(jm, "dssm"), make_eval_step(tm)
    for got, want in zip(_DSSMEvalBatches(pairs, hist, 8),
                         _dssm_eval_batches(pairs, hist, 8), strict=True):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        jh, jn, jv = (np.asarray(a) for a in jstep(
            params, jtable, *(jnp.asarray(a) for a in want)))
        h, n, v = (a.numpy() for a in step(table, *(
            torch.from_numpy(np.asarray(a)).to(dt) for a, dt in zip(
                got, (torch.long, torch.float32, torch.long, torch.long,
                      torch.bool)))))
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(h, jh)
        np.testing.assert_allclose(n, jn, rtol=1e-6)

    engine = Retriever(tm, table, batch_sizes=(1, 8))
    jengine = JaxRetriever(jm, params, jtable, user_tower="dssm",
                           batch_sizes=(1, 8))
    for users in ([3], [1, 7, 20, 4, 4]):
        ids, vals = engine.recommend_users(users, top_k=6)
        jids, jvals = jengine.recommend_users(users, top_k=6)
        assert ids.shape == (len(users), 6) and 0 not in ids
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(vals, np.asarray(jvals), rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="recommend_users"):
        engine.recommend([[1, 2]])
    sasrec = make_model(Config(embedding_dim=D, max_seq_len=4), ITEMS,
                        device="cpu")
    with pytest.raises(ValueError, match="DSSM"):
        Retriever(sasrec, table).recommend_users([1])


BASE = dict(dataset="TINY", news="news.tsv", behaviors="behaviors.tsv",
            max_seq_len=8, min_seq_len=3, batch_size=32, embedding_dim=16,
            epoch=1, lr=1e-3, eval_batch_size=32, loss="bce",
            user_tower="dssm", neg_num=2, dnn_layers=1,
            compute_dtype="float32")


def test_dssm_trainer_matches_jax_and_reloads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=48, n_items=30)
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
    assert (tr.item_num, tr.user_num) == (jtr.item_num, jtr.user_num)
    assert tr.batcher.n == jtr.batcher.n
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
    assert n == 48
    assert abs(hit - jhit) <= 2 / n and abs(ndcg - jndcg) <= 2 / n

    tr = port(drop_rate=0.1)
    best, best_epoch = tr.train()
    assert best_epoch == 1
    te = port(drop_rate=0.1, mode="test", load_ckpt_name="epoch-1.pt")
    te.test()
    assert te.last_eval["split"] == "test"
    assert te.run_eval("valid") == (best, tr.valid_results[1]["ndcg"])
    np.testing.assert_array_equal(te.last_eval["hits"],
                                  tr.valid_results[1]["hits"])
    np.testing.assert_array_equal(te.last_eval["ndcgs"],
                                  tr.valid_results[1]["ndcgs"])


@pytest.mark.parametrize("kw,item", [
    (dict(stage="two_stage"), None), (dict(item_tower="modal_id_add"), None),
    (dict(accumulation_step=2), "A1")])
def test_check_supported_names_what_is_left(kw, item):
    """Each was refused by its ROADMAP item (``item`` where the refusal
    named one) and is ported: two-stage and fusion (A4), accumulation
    (A1)."""
    check_supported(Config(loss="bce", user_tower="dssm"))
    check_supported(Config(loss="bce"))
    check_supported(Config(loss="bce", user_tower="dssm", **kw))


def test_dssm_cold_item_eval_names_a5(tmp_path, monkeypatch):
    """Cold/new-item evaluation (ROADMAP A5) scores SASRec users, as the
    JAX package's does: DSSM with a cold file is refused, naming why."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=24, n_items=20)
    tr = Trainer(Config(root_data_dir=root, **{**BASE, "mode": "test",
                                                "cold_behaviors": "c.tsv"}),
                 quiet_log(), quiet_log(), device="cpu")
    tr.load_data()
    tr.build_model()
    with pytest.raises(NotImplementedError, match="DSSM"):
        tr.test()
