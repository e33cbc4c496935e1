"""Cold-start and new-item evaluation (train/special_eval.py and
``Trainer.run_special_eval``) against the JAX package's on the CPU:

- ``read_behaviors_special``: the same files give the same sequences,
  histories, new ids and new content;
- ``eval_cold`` and ``eval_new`` on the same weights (Flax init, perturbed,
  through ``convert.load_flax``) and the same tables, for the ID, text
  (BERT 1 layer, width 32), ID+text fusion (``modal_id_add``) and vision
  (Swin 2 stages, width 16) towers, one catalog table for both: the new
  items' embeddings within 2e-5 (the port encodes them in chunks), HR@10
  and nDCG@10 within 1e-6, and the same per-user hits and nDCGs. The
  fusion tower pins the new items' zero ids: ID row 0 with each new item's
  content, as the JAX runner encodes them. The JAX runner marks every new
  image as the padding item's (its ids are all 0, ROADMAP C13); the port
  marks only row 0, and the JAX tower is held to that here;
- ``Trainer.test()`` against the JAX ``Trainer.run_special_eval`` for the
  ID, text and fusion towers through both runners, float32, dropout 0, the
  JAX weights loaded into the port: cold and new HR@10 and nDCG@10 within
  2 / n_users; a vision ``Trainer.test()`` with the new items in their own
  MKV store (``new_image_store``);
- the refusals: DSSM with a cold file, and new items of a two-stage tower
  (after the cold users, where the JAX runner fails too).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data.loader import EvalBatches as JEvalBatches
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.parallel.mesh import make_mesh
from idvs.morec_tpu.train import special_eval as jspecial
from idvs.morec_tpu.train.evaluate import evaluate as jax_evaluate
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data.imagestore import write_mkv
from idvs.morec_tpu_torch.data.loader import pad_histories, pad_user_sequences
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.train import special_eval
from idvs.morec_tpu_torch.train.evaluate import (compute_item_embeddings,
                                                 eval_mode)
from idvs.morec_tpu_torch.train.runner import Trainer

from tests.test_torch_config_data import _tokenizer
from tests.test_torch_runner import BERT as RUNNER_BERT
from tests.test_torch_runner import _cfg, _port, _text_bundle
from tests.test_train_integration import quiet_log, synth_dataset

ITEMS, NEW, L, D, T, EVAL_B = 40, 7, 6, 16, 8, 8
TOL = 2e-5
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SWIN = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4)
TOWERS = {"id": ("id", None), "text": ("modal", "text"),
          "text_add": ("modal_id_add", "text"),
          "vision": ("modal", "vision")}


def test_read_behaviors_special_matches_jax(tmp_path):
    cold, new = tmp_path / "cold.tsv", tmp_path / "new.tsv"
    cold.write_text("u0\ti1 i2 i3\nu1\ti2 i3 i1\nu2\ti3 i3 i2 i1\n")
    new.write_text("u0\ti1 i2 i9\nu1\ti3 i1 i9\nu2\ti2 i1 i8\n"
                   "u3\ti1 i7\n")
    n2i = {f"i{k}": k for k in range(1, 4)}
    before_n2i = {f"i{k}": 10 - k for k in range(1, 10)}
    before_dic = {10 - k: f"content{k}" for k in range(1, 10)}
    args = (str(cold), str(new), n2i, before_dic, before_n2i)
    want = jspecial.read_behaviors_special(*args, True)
    got = special_eval.read_behaviors_special(*args, True)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[4] == {1: "content9", 2: "content8", 3: "content7"}
    assert special_eval.read_behaviors_special(*args, False)[2:] == (
        None, None, None)
    assert special_eval.read_behaviors_special(
        str(cold), None, n2i, before_dic, before_n2i, True)[2:] == (
        None, None, None)


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), tree)


def _content(rng, modality, n):
    """Row 0 (the padding item) zero, the rest drawn: token rows and their
    attention masks, or uint8 images."""
    if modality == "vision":
        out = rng.integers(0, 256, (n + 1, 32, 32, 3), dtype=np.uint8)
    else:
        lens = rng.integers(1, T + 1, size=n + 1)
        att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
        out = np.concatenate([rng.integers(1, 97, (n + 1, T)) * att, att], 1)
    out[0] = 0
    return out


def _models(tower, rng, content):
    item_tower, modality = TOWERS[tower]
    cfg = JConfig(item_tower=item_tower, modality=modality or "text",
                  max_seq_len=L, embedding_dim=D, num_attention_heads=2,
                  transformer_block=1, drop_rate=0.0)
    jenc = tenc = None
    if modality == "text":
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=32)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 32,
                         attr_lengths=(T,), device="cpu")
    elif modality == "vision":
        jc, sc = jswin.SwinConfig(**SWIN), SwinConfig(**SWIN)
        jenc = JaxVisionTower(net=jswin.SwinModel(jc), kind="swin",
                              embedding_dim=D, feature_dim=jc.num_features)
        tenc = VisionTower(SwinModel(sc, device="cpu"), "swin", D,
                           sc.num_features, device="cpu")
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    ids = jnp.asarray(rng.integers(1, ITEMS + 1, (2, L + 1)), jnp.int32)
    v = jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids,
        None if modality is None else jnp.asarray(
            content[np.asarray(ids).ravel()]), jnp.ones((2, L)))
    params = {"params": _perturbed(v["params"], rng)}
    tm = make_model(cfg, ITEMS, tenc, device="cpu")
    convert.load_flax(tm, params)
    # device arrays: the jitted Swin indexes its bias tables with them
    return jm, jax.tree.map(jnp.asarray, params), tm


def _users(rng, n, new_ids=False):
    """{uid: sequence} of inputs over the catalog and a last item (a
    catalog id, or with new_ids one of 1..NEW), and {uid: history}."""
    seqs, hist = {}, {}
    for u in range(n):
        inputs = list(rng.integers(1, ITEMS + 1, int(rng.integers(2, L + 1))))
        last = int(rng.integers(1, (NEW if new_ids else ITEMS) + 1))
        seqs[u] = inputs + [last]
        hist[u] = np.asarray(inputs, np.int64)
    return seqs, hist


def _same_users(got, want, hits, jhits, ndcgs, jndcgs):
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(hits, jhits)
    np.testing.assert_allclose(ndcgs, jndcgs, atol=1e-6)


def _jax_new_per_user(jm, params, jtable, new_embs, sn, hn):
    """The JAX new-item step (eval_new's), one user a call: each user's
    (hit, ndcg)."""
    step = jspecial.make_new_item_eval_step(jm)
    seqs, lens = pad_user_sequences({u: s[:-1] for u, s in sn.items()}, L)
    hist = pad_histories(hn, L + 2)
    out = []
    for u in sorted(sn):
        lm = (np.arange(L) >= L - lens[u]).astype(np.float32)[None]
        h, nd, _ = step(params, jtable, new_embs,
                        jnp.asarray(seqs[u:u + 1], jnp.int32),
                        jnp.asarray(lm), jnp.asarray([sn[u][-1]], jnp.int32),
                        jnp.asarray(hist[u:u + 1]), jnp.asarray([True]))
        out.append((float(h), float(nd)))
    return np.asarray(out)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_special_eval_matches_jax(tower):
    rng = np.random.default_rng(11)
    modality = TOWERS[tower][1]
    content = None if modality is None else _content(rng, modality, ITEMS)
    jm, params, tm = _models(tower, rng, content)
    # one table for both (the catalog encode's parity is
    # test_torch_evaluate's and test_torch_vision's)
    fn = (lambda ids: content[ids]) if modality == "vision" else None
    dense = None if modality in (None, "vision") else content
    table = compute_item_embeddings(
        tm, ITEMS, None if dense is None else torch.from_numpy(dense), D,
        batch_size=16, content_fn=fn)
    jtable = jnp.asarray(table.numpy())

    sc, hc = _users(rng, 21)
    *cold, hits, ndcgs = special_eval.eval_cold(tm, table, sc, hc, L, EVAL_B,
                                                per_user=True)
    seqs, lens = pad_user_sequences(sc, L + 1)
    batches = JEvalBatches(seqs, lens, L, EVAL_B, pad_histories(hc, L + 2))
    *jcold, jhits, jndcgs = jax_evaluate(jm, params, jtable, batches,
                                         per_user=True)
    # JAX's eval_cold is this evaluate over these batches
    _same_users(cold, jcold, hits, jhits, ndcgs, jndcgs)
    if modality is None:
        return

    new_content = _content(rng, modality, NEW)
    # the port pads image row 0 only; the JAX runner's zero ids pad every
    # image (C13), so its tower takes ids 0..NEW here, which a pure image
    # tower reads only as that mask
    jids = np.arange(NEW + 1) if modality == "vision" else np.zeros(NEW + 1)
    jnew = jm.apply(params, jnp.asarray(jids, jnp.int32),
                    jnp.asarray(new_content), True, method="item_embs")
    new_embs = special_eval.encode_new_items(tm, new_content, 3,
                                             images=modality == "vision")
    np.testing.assert_allclose(new_embs.numpy(), np.asarray(jnew), atol=TOL,
                               rtol=TOL)
    if tower == "text_add":
        # the zero ids: ID row 0, never a catalog row, beside the content
        moved = tm.item_embs(torch.arange(NEW + 1),
                             torch.from_numpy(new_content))
        assert not torch.allclose(moved[1:], new_embs[1:], atol=1e-3)

    sn, hn = _users(rng, 19, new_ids=True)
    *new, hits, ndcgs = special_eval.eval_new(tm, table, new_embs, sn, hn, L,
                                              EVAL_B, per_user=True)
    per_user = _jax_new_per_user(jm, params, jtable, jnew, sn, hn)
    _same_users(new, per_user.mean(0), hits, per_user[:, 0], ndcgs,
                per_user[:, 1])
    assert 0 < hits.sum() < len(hits) or tower == "vision"


def _special_files(root, n_new):
    """cold.tsv over the behaviours' items and new.tsv whose targets are
    items of news.tsv that no behaviour holds (i41 ...)."""
    base = root + "TINY/"
    lines = open(base + "behaviors.tsv").read().split("\n")[:24]
    news = open(base + "news.tsv").read()
    with open(base + "news.tsv", "w") as f:
        f.write(news + "".join(f"i{k}\ttitle {k} new\tabstract {k}\n"
                               for k in range(41, 41 + n_new)))
    with open(base + "cold.tsv", "w") as f:
        f.write("".join(f"c{u}\t{ln.split(chr(9))[1]}\n"
                        for u, ln in enumerate(lines[:16])))
    with open(base + "new.tsv", "w") as f:
        for u, ln in enumerate(lines[8:]):
            items = ln.split("\t")[1].split(" ")[:5]
            f.write(f"n{u}\t{' '.join(items)} i{41 + u % n_new}\n")


@pytest.mark.parametrize("item_tower", ["id", "modal", "modal_id_add"])
def test_trainer_special_eval_matches_jax(tmp_path, monkeypatch, item_tower):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=48, n_items=40)
    _special_files(root, 5)
    kw = dict(item_tower=item_tower, compute_dtype="float32", drop_rate=0.0,
              mode="test", cold_behaviors="cold.tsv",
              new_behaviors="new.tsv")
    modal = item_tower != "id"
    jbundle = None
    if modal:
        jbundle = (JaxTextTower(
            net=jbert.BertModel(jbert.BertConfig(**RUNNER_BERT)),
            embedding_dim=16, word_embedding_dim=24), None, set(), 24)
        # the JAX runner's special eval reads its tokenizer from files
        monkeypatch.setattr("idvs.morec_tpu.models.encoders_zoo."
                            "load_tokenizer", lambda cfg: _tokenizer)
    jtr = JTrainer(_cfg(JConfig, root, **kw), quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    if modal:
        base = root + "TINY/"
        items = jpre.read_items_tokenized(base + "news.tsv", jtr.cfg,
                                          _tokenizer)
        bd = jpre.read_behaviors(base + "behaviors.tsv", *items, 8, 3)
        jtr.set_data(bd, jpre.build_doc_matrix(bd.item_id_to_dic, jtr.cfg))
    else:
        jtr.load_data()
    jtr.build_model()
    want = jtr.run_special_eval()

    tr = _port(root, _text_bundle() if modal else None, **kw)
    convert.load_flax(tr.model, jtr.state.params)
    tr.test()
    assert tr.last_eval["split"] == "test"
    got = tr.special_results
    assert (got.keys() == {"cold", "new"}) == modal
    assert got["cold"]["users"] == 16
    for what, w in zip(("cold", "new"), want):
        if w is None:
            assert not modal
            continue
        n = got[what]["users"]
        assert abs(got[what]["hit"] - w[0]) <= 2 / n
        assert abs(got[what]["ndcg"] - w[1]) <= 2 / n
    if modal:
        assert got["new"]["items"] == 5 and got["new"]["users"] == 16


def _vision_data(tmp_path, rng):
    root = synth_dataset(tmp_path, n_users=40, n_items=24)
    base = tmp_path / "TINY"
    (base / "images.tsv").write_text(
        "".join(f"v{k}\tx\n" for k in range(1, 25)))
    (base / "all_images.tsv").write_text(
        "".join(f"v{k}\tx\n" for k in range(1, 30)))
    beh = (base / "behaviors.tsv").read_text().replace("\ti", "\tv")
    (base / "behaviors.tsv").write_text(beh.replace(" i", " v"))
    image = lambda: rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    write_mkv(str(base / "imgs.mkv"),
              [(str(k).encode(), image()) for k in range(1, 25)])
    write_mkv(str(base / "new.mkv"),
              [(str(k).encode(), image()) for k in range(25, 30)])
    lines = beh.split("\n")[:12]
    (base / "cold.tsv").write_text("".join(
        f"c{u}\t{ln.split(chr(9))[1].replace('i', 'v')}\n"
        for u, ln in enumerate(lines)))
    (base / "new.tsv").write_text("".join(
        f"n{u}\t{' '.join(ln.split(chr(9))[1].replace('i', 'v').split()[:4])}"
        f" v{25 + u % 5}\n" for u, ln in enumerate(lines)))
    return root


def _vision_trainer(root, **kw):
    sc = SwinConfig(**SWIN)
    tower = VisionTower(SwinModel(sc, device="cpu"), "swin", 16,
                        sc.num_features, device="cpu")
    tr = Trainer(Config(root_data_dir=root, **{
        **dict(dataset="TINY", news="images.tsv", behaviors="behaviors.tsv",
               max_seq_len=8, min_seq_len=3, batch_size=8, embedding_dim=16,
               num_attention_heads=2, transformer_block=1,
               eval_batch_size=8, modality="vision", item_tower="modal",
               image_store="imgs.mkv", image_resize=32, mode="test",
               cold_behaviors="cold.tsv", new_behaviors="new.tsv",
               new_items="all_images.tsv"), **kw}),
        quiet_log(), quiet_log(), device="cpu",
        encoder_bundle=(tower, None, set(), sc.num_features))
    tr.load_data()
    tr.build_model()
    return tr


def test_vision_special_eval_through_trainer(tmp_path, monkeypatch):
    """New items' images from their own MKV store (new_image_store), each
    encoded as itself (only row 0 is the padding image), and the cold and
    new evaluations on those embeddings."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    tr = _vision_trainer(_vision_data(tmp_path, rng),
                         new_image_store="new.mkv")
    tr.test()
    got = tr.special_results
    assert got["cold"]["users"] == 12 and got["new"]["users"] == 12
    assert got["new"]["items"] == 5
    embs = got["new"]["embeddings"]
    assert embs.shape == (6, 16) and torch.isfinite(embs).all()
    # five distinct images: five distinct rows, none the padding image's
    assert torch.cdist(embs, embs)[~torch.eye(6, dtype=bool)].min() > 1e-4
    from idvs.morec_tpu_torch.data.imagestore import open_store
    store = open_store(str(tmp_path / "TINY" / "new.mkv"))
    imgs = tr.vision_pipe.transform([store.get(str(k).encode())
                                     for k in range(25, 30)])
    with torch.no_grad(), eval_mode(tr.model):
        want = tr.model.item_embs(torch.zeros(5, dtype=torch.long),
                                  torch.from_numpy(imgs),
                                  pad_mask=torch.zeros(5, dtype=bool))
    torch.testing.assert_close(embs[1:], want, rtol=1e-5, atol=1e-5)
    again = special_eval.eval_new(
        tr.model, compute_item_embeddings(
            tr.model, tr.item_num, None, 16, 512,
            content_fn=tr.vision_pipe.images_for),
        embs, *special_eval.read_behaviors_special(
            str(tmp_path / "TINY" / "cold.tsv"),
            str(tmp_path / "TINY" / "new.tsv"), tr.bd.item_name_to_id,
            *tr._before_catalog(str(tmp_path / "TINY")), True)[2:4], 8, 8)
    assert again == (got["new"]["hit"], got["new"]["ndcg"])


def test_special_eval_refusals(tmp_path, monkeypatch):
    """DSSM with a cold file, and the new items of a two-stage tower (the
    cold users evaluated first, as the JAX runner does before it fails)."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=24, n_items=20)
    tr = _port(root, loss="bce", user_tower="dssm", mode="test",
               cold_behaviors="c.tsv")
    with pytest.raises(NotImplementedError, match="DSSM"):
        tr.test()
    rng = np.random.default_rng(5)
    vroot = _vision_data(tmp_path / "v", rng)
    sc = SwinConfig(**SWIN)
    tower = VisionTower(SwinModel(sc, device="cpu"), "swin", 16,
                        sc.num_features, project=False, device="cpu")
    tr = Trainer(Config(root_data_dir=vroot, **dict(
        dataset="TINY", news="images.tsv", behaviors="behaviors.tsv",
        max_seq_len=8, min_seq_len=3, batch_size=8, embedding_dim=16,
        num_attention_heads=2, transformer_block=1, eval_batch_size=8,
        modality="vision", item_tower="modal", stage="two_stage",
        loss="bce", image_store="imgs.mkv", image_resize=32, mode="test",
        cold_behaviors="cold.tsv", new_behaviors="new.tsv",
        new_items="all_images.tsv")), quiet_log(), quiet_log(),
        device="cpu", encoder_bundle=(tower, None, set(), sc.num_features))
    tr.load_data()
    tr.build_model()
    with pytest.raises(NotImplementedError, match="two-stage"):
        tr.test()
    assert tr.special_results["cold"]["users"] == 12
