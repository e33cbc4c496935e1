"""The two-stage cached-embedding towers (reference bce_text/
main-2stage(SASRec) and bce_*/id_plus_mo-2stage) in the port, against the
JAX package on the CPU:

- ``TextTower(project=False)`` (a tiny BERT, two attributes averaged) and
  ``VisionTower(project=False)`` (a tiny Swin whose num_features 32 is not
  its embedding_dim 16) against their Flax twins within 2e-5;
- ``RecModel.item_embs`` two-stage for ``modal`` (dnn_layers 0 and 2),
  ``modal_id_add`` and ``modal_id_cat`` (mo_dnn_layers 2), on a float32
  cache, against ``RecModel.apply(..., method="item_embs")`` within 2e-5;
  ``to_flax`` gives back the Flax tree;
- five float32 BCE train steps at dropout 0 against the JAX
  ``make_train_step`` for two-stage text, fused add and fused cat, at
  tests/test_torch_train.py's tolerances; one bf16 step of the plain
  two-stage head against JAX's, where the bf16 parameter copies meet the
  float32 cache in float32 and SASRec runs on float32 embeddings, as in
  JAX: the loss within 2e-6 relative and every gradient within two bf16
  units of the largest;
- ``Trainer._encode_catalog``: text through ``Trainer(cfg,
  encoder_bundle=..., tokenizer=...)`` against the JAX runner's cache (and
  the epoch's losses within 1e-5 relative, valid HR@10 / nDCG@10 within 2
  / n_users, the one optimizer group); vision against ``module.apply`` of
  the JAX tower chunk by chunk, the cache as wide as the tower's output
  (embedding_dim, not the bundle's feature width: ROADMAP C9); a vision
  two-stage epoch over an MKV store with its checkpoint reloaded to the
  same evaluation bits; DSSM over a two-stage tower refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data.imagestore import write_mkv
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.train.runner import Trainer, check_supported
from idvs.morec_tpu_torch.train.state import make_train_state
from idvs.morec_tpu_torch.train.step import make_train_step

from tests.test_torch_config_data import _tokenizer
from tests.test_torch_fusion import (_numpy, _same_tree, bce_batches,
                                     steps_against_jax)
from tests.test_torch_train import _keep_grads, _state_dict
from tests.test_torch_runner import jit_jax_init
from tests.test_train_integration import quiet_log, synth_dataset

TOL = 2e-5
ITEMS, L, D, W, T = 30, 6, 32, 24, 8
VD = 16       # the vision towers' embedding_dim, half their num_features
BERT = dict(vocab_size=97, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SWIN = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4)
# the heads: item tower, dnn_layers, mo_dnn_layers
HEADS = {"modal": ("modal", 2, 0), "modal_dnn0": ("modal", 0, 0),
         "add": ("modal_id_add", 2, 2), "cat": ("modal_id_cat", 0, 2)}


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    jit_jax_init(monkeypatch)


def test_text_tower_without_projection_matches_flax():
    rng = np.random.default_rng(0)
    jt = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                      embedding_dim=D, word_embedding_dim=24,
                      attr_lengths=(T, 5), project=False)
    lens = rng.integers(1, 6, size=(7, 2))
    rows = []
    for n, k in zip((T, 5), (0, 1)):
        att = (np.arange(n)[None] < lens[:, k:k + 1]).astype(np.int32)
        rows += [rng.integers(1, 97, (7, n)).astype(np.int32) * att, att]
    content = np.concatenate(rows, axis=1)
    v = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(content))
    v = {"params": _numpy(v["params"], rng, 0.02)}
    assert "fc" not in v["params"]
    want = jax.jit(jt.apply)(v, jnp.asarray(content))
    tt = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 24,
                   attr_lengths=(T, 5), project=False, device="cpu").eval()
    tt.load_state_dict(convert.from_flax(v), strict=True)
    _same_tree(convert.to_flax(tt)["params"], v["params"])
    with torch.no_grad():
        got = tt(torch.from_numpy(content).long())
    assert tuple(got.shape) == (7, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


_JAX_APPLY = {}


def _jax_apply(jt):
    """The jitted apply of the JAX vision tower, compiled once a file."""
    if "swin" not in _JAX_APPLY:
        _JAX_APPLY["swin"] = jax.jit(jt.apply)
    return _JAX_APPLY["swin"]


def _swin_towers():
    jc = jswin.SwinConfig(**SWIN)
    sc = SwinConfig(**SWIN)
    assert jc.num_features == sc.num_features == 2 * VD
    return (JaxVisionTower(net=jswin.SwinModel(jc), kind="swin",
                           embedding_dim=VD, feature_dim=jc.num_features,
                           project=False),
            VisionTower(SwinModel(sc, device="cpu"), "swin", VD,
                        sc.num_features, project=False, device="cpu"))


def test_vision_tower_without_projection_matches_flax():
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    jt, tt = _swin_towers()
    v = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    v = {"params": _numpy(v["params"], rng, 0.02)}
    want = _jax_apply(jt)(v, jnp.asarray(images))
    tt.load_state_dict(convert.from_flax(v), strict=True)
    with torch.no_grad():
        got = tt.eval()(torch.from_numpy(images))
    # the classifier's output before the GELU: embedding_dim wide
    assert tuple(got.shape) == want.shape == (8, VD)
    assert float(np.asarray(want).min()) < 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _cache(rng):
    cache = rng.normal(size=(ITEMS + 1, W)).astype(np.float32)
    cache[0] = 0.0
    return cache


_INIT = {}


def _head_models(head, compute_dtype="float32"):
    """(cfg, the float32 cache, JAX model, its perturbed init tree, port
    model with that tree loaded) of a two-stage head."""
    tower, dnn, mo = HEADS[head]
    cfg = Config(item_tower=tower, stage="two_stage", loss="bce",
                 max_seq_len=L, embedding_dim=D, word_embedding_dim=W,
                 dnn_layers=dnn, mo_dnn_layers=mo, batch_size=4,
                 num_attention_heads=2, transformer_block=1,
                 compute_dtype=compute_dtype, drop_rate=0.0, lr=1e-3,
                 fine_tune_lr=5e-4)
    rng = np.random.default_rng(2)
    cache = _cache(rng)
    jm = jax_make_model(cfg, item_num=ITEMS)
    if head not in _INIT:
        ids = jnp.asarray(rng.integers(1, ITEMS + 1, (2, L + 1)), jnp.int32)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), ids,
                             jnp.asarray(cache[np.asarray(ids).ravel()]),
                             jnp.ones((2, L)))
        _INIT[head] = {"params": _numpy(v["params"], rng, 0.02)}
    params = _INIT[head]
    tm = make_model(cfg, ITEMS, device="cpu")
    convert.load_flax(tm, params)
    return cfg, cache, jm, params, tm


@pytest.mark.parametrize("head", list(HEADS))
def test_two_stage_item_embs_match_flax(head):
    _, cache, jm, params, tm = _head_models(head)
    names = {"modal": {"modal_proj", "modal_mlp", "user_encoder"},
             "modal_dnn0": {"modal_proj", "user_encoder"},
             "add": {"id_embedding", "turn_dim", "post_mlp", "user_encoder"},
             "cat": {"id_embedding", "turn_dim", "fusion", "user_encoder"}}
    assert set(params["params"]) == names[head]
    ids = np.array([0, 3, 7, 7, 30, 12])
    want = jax.jit(lambda p, i, c: jm.apply(p, i, c, True,
                                            method="item_embs"))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(cache[ids]))
    with torch.no_grad():
        got = tm.item_embs(torch.from_numpy(ids),
                           torch.from_numpy(cache[ids]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _same_tree(convert.to_flax(tm)["params"], params["params"])


@pytest.mark.parametrize("head,dedup", [("modal", True), ("add", False),
                                        ("cat", True)])
def test_two_stage_bce_steps_match_jax(head, dedup):
    cfg, cache, jm, params, tm = _head_models(head)
    cfg.dedup_items = dedup
    steps_against_jax(cfg, jm, params, tm, cache,
                      bce_batches(np.random.default_rng(4), dedup), None)


def test_two_stage_bf16_step_matches_jax():
    """bf16 compute: JAX casts the parameters, not the cache, so the head
    meets the cache in float32 and its embeddings stay float32 into SASRec
    (the BCE branch casts nothing); the port's step holds the same rounding
    points. A step that rounded the embeddings to bf16 before SASRec would
    move the loss by about 2e-4 relative."""
    cfg, cache, jm, params, tm = _head_models("modal", "bfloat16")
    batch = bce_batches(np.random.default_rng(5), True, steps=1)[0]
    tx = _keep_grads(jstate.make_optimizer(cfg, None))
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    jst = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    jstep = jax_train_step(jm, cfg, tx, mesh, item_content=jnp.asarray(cache))
    jst, jloss = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    state = make_train_state(tm, cfg, None)
    step = make_train_step(cfg, item_content=torch.from_numpy(cache))
    loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-6)
    grads = _state_dict(jst.opt_state[0])
    for name, q in tm.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(q.grad.numpy(), g, rtol=0,
                                   atol=2 * 2.0 ** -8 * np.abs(g).max(),
                                   err_msg=name)


def test_vision_encode_catalog_matches_flax_chunks():
    jt, tt = _swin_towers()
    rng = np.random.default_rng(6)
    n = 12
    images = rng.integers(0, 256, (n + 1, 32, 32, 3), dtype=np.uint8)
    cfg = Config(item_tower="modal", modality="vision", stage="two_stage",
                 embedding_dim=VD, item_emb_batch_size=8,
                 compute_dtype="float32")
    tr = Trainer(cfg, quiet_log(), quiet_log(), device="cpu")
    bundle = (tt, None, set(), 2 * VD)
    cache = tr._encode_catalog(bundle, images.__getitem__, n)
    assert cache.dtype == torch.float32 and tuple(cache.shape) == (n + 1, VD)
    assert cfg.word_embedding_dim == VD
    assert not cache[0].any()
    # the JAX tower over the same chunks with the weights the port drew
    # from the seed
    v = convert.to_flax(tt)
    apply = _jax_apply(jt)
    for start in range(0, n + 1, 8):
        ids = np.minimum(np.arange(start, start + 8), n)
        want = np.asarray(apply(v, jnp.asarray(images[ids])))
        k = min(8, n + 1 - start)
        rows = slice(max(start, 1), start + k)
        np.testing.assert_allclose(cache[rows].numpy(),
                                   want[rows.start - start:k], rtol=TOL,
                                   atol=TOL)


BASE = dict(dataset="TINY", news="news.tsv", behaviors="behaviors.tsv",
            max_seq_len=8, min_seq_len=3, batch_size=8, embedding_dim=16,
            num_attention_heads=2, transformer_block=1, epoch=1, lr=1e-3,
            fine_tune_lr=5e-4, eval_batch_size=32, num_words_title=T,
            item_tower="modal", stage="two_stage", loss="bce", dnn_layers=2,
            compute_dtype="float32", drop_rate=0.0)


def test_text_two_stage_trainer_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=96, n_items=40)
    jnet = jbert.BertModel(jbert.BertConfig(**BERT))
    ids = jnp.ones((2, T), jnp.int32)
    net = jax.jit(jnet.init)(jax.random.PRNGKey(3), ids, ids, True)
    net = {"params": _numpy(net["params"], np.random.default_rng(7), 0.02)}
    jbundle = (JaxTextTower(net=jnet, embedding_dim=16, word_embedding_dim=24,
                            attr_lengths=(T,), project=False),
               net, set(), 24)
    jtr = JTrainer(JConfig(root_data_dir=root, **BASE), quiet_log(),
                   quiet_log(), mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    # the JAX runner's _load_two_stage reads its tokenizer from files
    base = root + "TINY/"
    items = jpre.read_items_tokenized(base + "news.tsv", jtr.cfg, _tokenizer)
    bd = jpre.read_behaviors(base + "behaviors.tsv", *items, 8, 3)
    doc = jpre.build_doc_matrix(bd.item_id_to_dic, jtr.cfg)
    jcache = jtr._encode_catalog(jbundle, doc.__getitem__, bd.item_num, 24)
    jtr.cfg.word_embedding_dim = 24
    jtr.encoder_bundle = None
    jtr.set_data(bd, jcache)
    jtr.build_model()

    tower = TextTower(BertModel(BertConfig(**BERT), device="cpu"), 16, 24,
                      attr_lengths=(T,), project=False, device="cpu")
    tr = Trainer(Config(root_data_dir=root, **BASE), quiet_log(),
                 quiet_log(), device="cpu", tokenizer=_tokenizer,
                 encoder_bundle=(tower, convert.from_flax(net), set(), 24))
    tr.load_data()
    assert tr.encoder_bundle is None and tr.cfg.word_embedding_dim == 24
    assert tr.item_content.dtype == torch.float32
    np.testing.assert_allclose(tr.item_content.numpy(), jcache, rtol=TOL,
                               atol=TOL)
    tr.build_model()
    # the two-stage head trains in one group, as the JAX runner's (no
    # labels): (lr, l2_weight)
    assert [(g["lr"], g["weight_decay"])
            for g in tr.state.optimizer.param_groups] == [
        (tr.cfg.lr, tr.cfg.l2_weight)]
    assert not hasattr(tr.model, "encoder")
    convert.load_flax(tr.model, jtr.state.params)
    assert (tr.n_total, tr.n_trainable) == (jtr.n_total, jtr.n_trainable)
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


def test_vision_two_stage_runner(tmp_path, monkeypatch):
    """Vision two-stage over an MKV store through a tiny Swin: the cache
    from the store, an epoch on the head, the eval over the cache, the best
    checkpoint reloaded by a fresh Trainer to the same evaluation bits."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8)
    root = synth_dataset(tmp_path, n_users=40, n_items=24)
    base = tmp_path / "TINY"
    (base / "images.tsv").write_text(
        "".join(f"v{k}\tx\n" for k in range(1, 25)))
    beh = (base / "behaviors.tsv").read_text().replace("\ti", "\tv")
    (base / "behaviors.tsv").write_text(beh.replace(" i", " v"))
    write_mkv(str(base / "imgs.mkv"), [
        (str(k).encode(), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
        for k in range(1, 25)])

    def trainer(**kw):
        _, tower = _swin_towers()
        tr = Trainer(Config(root_data_dir=root, **{
            **BASE, "modality": "vision", "item_tower": "modal_id_add",
            "news": "images.tsv", "image_store": "imgs.mkv",
            "image_resize": 32, "embedding_dim": VD, "mo_dnn_layers": 1,
            "dedup_items": True, **kw}),
            quiet_log(), quiet_log(), device="cpu",
            encoder_bundle=(tower, None, set(), 2 * VD))
        tr.load_data()
        tr.build_model()
        return tr

    tr = trainer()
    assert tr.cfg.word_embedding_dim == VD
    assert tuple(tr.item_content.shape) == (25, VD)
    assert tr.vision_pipe is None and "uniq_ids" in tr.make_batch(
        next(tr.batcher.epoch(1)))
    best, best_epoch = tr.train()
    assert best_epoch == 1
    te = trainer(mode="test", load_ckpt_name="epoch-1.pt")
    torch.testing.assert_close(te.item_content, tr.item_content, rtol=0,
                               atol=0)
    te.test()
    assert te.run_eval("valid") == (best, tr.valid_results[1]["ndcg"])
    np.testing.assert_array_equal(te.last_eval["hits"],
                                  tr.valid_results[1]["hits"])


def test_dssm_over_a_two_stage_tower_is_refused():
    check_supported(Config(loss="bce", user_tower="dssm",
                           item_tower="modal_id_add"))
    check_supported(Config(loss="bce", item_tower="modal_id_cat",
                           stage="two_stage"))
    with pytest.raises(NotImplementedError, match="no reference variant"):
        check_supported(Config(loss="bce", user_tower="dssm",
                               item_tower="modal", stage="two_stage"))
