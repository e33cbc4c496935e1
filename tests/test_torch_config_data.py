"""The port's config, data layer, metrics and image store against the JAX
package's (idvs/morec_tpu_torch/{config.py, data/, ops/metrics.py} vs
idvs/morec_tpu/...): the same argv parses to the same fields and labels,
the same TSVs read to the same arrays and batches, seeded scores (ties
included) rank alike, and an MKV store written by one package reads in the
other, through bit-equal batch transforms.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from idvs.morec_tpu import config as jconfig
from idvs.morec_tpu.data import imagestore as jstore
from idvs.morec_tpu.data import loader as jloader
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.ops import metrics as jmetrics
from idvs.morec_tpu.utils import logging as jlogging
from idvs.morec_tpu_torch import config as tconfig
from idvs.morec_tpu_torch.data import imagestore as tstore
from idvs.morec_tpu_torch.data import loader as tloader
from idvs.morec_tpu_torch.data import preprocess as tpre
from idvs.morec_tpu_torch.data.vision_loader import (Prefetcher,
                                                     VisionBatchPipe)
from idvs.morec_tpu_torch.ops import metrics as tmetrics
from idvs.morec_tpu_torch.utils import logging as tlogging

from tests.test_train_integration import quiet_log, synth_dataset

ARGVS = {
    "defaults": [],
    "idrec": ["--item_tower", "id", "--embedding_dim", "64", "--lr", "1e-3",
              "--batch_size", "32", "--epoch", "3", "--mode", "test",
              "--load_ckpt_name", "epoch-2.pt", "--dedup_items", "true"],
    "text": ["--item_tower", "modal", "--bert_model_load", "bert_small",
             "--freeze_paras_before", "21", "--news_attributes",
             "title,abstract", "--use_pallas", "yes", "--drop_rate", "0"],
    # the reference's own flag names and values
    "reference vision": ["--modality", "vision", "--item_tower", "modal",
                         "--images", "hm_images.tsv", "--lmdb_data", "x.mkv",
                         "--CV_resize", "192", "--CV_model_load",
                         "swin_tiny", "--cold_seqs", "None", "--new_seqs",
                         "new.tsv", "--local_rank", "3"],
    "reference fusion": ["--item_tower", "modal_cat_3", "--dnn_layer", "2",
                         "--cold_file", "cold.tsv", "--new_file", "None",
                         "--loss", "bce"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_args_matches_jax(name):
    argv = ARGVS[name]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dir_label() == j.dir_label()
    for world in (1, 4):
        assert t.log_paras(world) == j.log_paras(world)
        assert t.model_dir(world) == j.model_dir(world)
    assert (t.use_modal, t.use_fusion, t.seq_len_total) == (
        j.use_modal, j.use_fusion, j.seq_len_total)
    assert tconfig.REF_FLAG_ALIASES == jconfig.REF_FLAG_ALIASES


def test_config_defaults_match_jax():
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    assert tf == jf
    assert tconfig.Config(modality="vision").early_stop_gap == 6
    assert tconfig.Config().early_stop_gap == 10
    with pytest.raises(AssertionError):
        tconfig.Config(item_tower="bogus")
    assert tconfig.str2bool("t") and not tconfig.str2bool("0")


def _tokenizer(text, max_length, padding, truncation):
    """A stand-in with the HF call signature: word hashes, 0-padded."""
    assert padding == "max_length" and truncation
    ids = [1 + sum(map(ord, w)) % 97 for w in text.split()][:max_length]
    n = len(ids)
    return {"input_ids": ids + [0] * (max_length - n),
            "attention_mask": [1] * n + [0] * (max_length - n)}


def _assert_same_behaviors(t, j):
    for f in dataclasses.fields(jpre.BehaviorData):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys(), f.name
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k], dtype=object),
                                              np.asarray(b[k], dtype=object),
                                              err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_read_behaviors_matches_jax(tmp_path):
    root = synth_dataset(tmp_path, n_users=90, n_items=40)
    news, beh = root + "TINY/news.tsv", root + "TINY/behaviors.tsv"
    # a user shorter than min_seq_len and a long one that is truncated
    with open(beh, "a") as f:
        f.write("short\ti1 i2\n")
        f.write("long\t" + " ".join(f"i{k}" for k in range(1, 36)) + "\n")
    for mod in (tpre, jpre):
        assert mod.read_items_text(news) == jpre.read_items_text(news)
    dic, n2i, i2n = tpre.read_items_text(news)
    bt = tpre.read_behaviors(beh, dic, n2i, i2n, 8, 3)
    bj = jpre.read_behaviors(beh, dic, n2i, i2n, 8, 3)
    _assert_same_behaviors(bt, bj)
    # tokenized text items and their packed doc matrix
    cfg = tconfig.Config(news_attributes="title,abstract",
                         num_words_title=6, num_words_abstract=4)
    tt = tpre.read_items_tokenized(news, cfg, _tokenizer)
    tj = jpre.read_items_tokenized(news, cfg, _tokenizer)
    assert tt == tj
    bt = tpre.read_behaviors(beh, *tt, 8, 3)
    bj = jpre.read_behaviors(beh, *tj, 8, 3)
    _assert_same_behaviors(bt, bj)
    doc = tpre.build_doc_matrix(bt.item_id_to_dic, cfg)
    np.testing.assert_array_equal(doc, jpre.build_doc_matrix(
        bj.item_id_to_dic, cfg))
    assert doc.shape == (bt.item_num + 1, 2 * (6 + 4)) and not doc[0].any()
    # the vision manifest's store keys
    manifest = tmp_path / "images.tsv"
    manifest.write_text("v007\tx\nv12\ty\nv3\tz\n")
    assert tpre.read_image_manifest(str(manifest)) == \
        jpre.read_image_manifest(str(manifest))


def test_batchers_match_jax(tmp_path):
    root = synth_dataset(tmp_path, n_users=70, n_items=30)
    dic, n2i, i2n = tpre.read_items_text(root + "TINY/news.tsv")
    bd = tpre.read_behaviors(root + "TINY/behaviors.tsv", dic, n2i, i2n,
                             8, 3)
    seqs, lens = tloader.pad_user_sequences(bd.users_train, 9)
    js, jl = jloader.pad_user_sequences(bd.users_train, 9)
    np.testing.assert_array_equal(seqs, js)
    np.testing.assert_array_equal(lens, jl)
    np.testing.assert_array_equal(tloader.log_mask_from_lens(lens, 8),
                                  jloader.log_mask_from_lens(lens, 8))
    for n, pad in ((70, 16), (5, 16), (64, 64)):
        for epoch in (1, 2):
            np.testing.assert_array_equal(
                tloader._epoch_perm(n, 7, epoch, pad),
                jloader._epoch_perm(n, 7, epoch, pad))
    perm_fn = lambda e: np.arange(len(seqs))[::-1] if e == 2 else \
        np.arange(len(seqs))
    for kw in ({}, {"perm_fn": perm_fn}):
        tb = tloader.TrainBatcher(seqs, lens, 8, 16, seed=5, **kw)
        jb = jloader.TrainBatcher(seqs, lens, 8, 16, seed=5, **kw)
        assert tb.steps_per_epoch() == jb.steps_per_epoch() == 5
        for epoch in (1, 2, 3):
            got, want = list(tb.epoch(epoch)), list(jb.epoch(epoch))
            assert len(got) == len(want)
            for (a, b), (c, d) in zip(got, want):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
    for users, hist in ((bd.users_valid, bd.users_history_for_valid),
                        (bd.users_test, bd.users_history_for_test)):
        es, el = tloader.pad_user_sequences(users, 9)
        h = np.zeros((len(hist), 10), np.int64)
        for row, uid in enumerate(sorted(hist)):
            h[row, :len(hist[uid][:10])] = hist[uid][:10]
        for shards in (1, 3):
            got = list(tloader.EvalBatches(es, el, 8, 16, h, shards))
            want = list(jloader.EvalBatches(es, el, 8, 16, h, shards))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            assert sum(int(b[-1].sum()) for b in got) == len(es)


def test_metrics_match_jax():
    """Ranks with ties (scores on a 0.25 grid), history masking and the
    padding column: the same ranks, HR@10 and nDCG@10."""
    rng = np.random.default_rng(0)
    B, I, D = 24, 50, 8
    user = np.round(rng.normal(size=(B, D)) * 2) / 4
    items = np.round(rng.normal(size=(I + 1, D)) * 2) / 4
    hist = rng.integers(0, I + 1, size=(B, 6))
    target = rng.integers(1, I + 1, size=B)
    hist[hist == target[:, None]] = 0
    ts = tmetrics.masked_catalog_scores(torch.from_numpy(user).float(),
                                        torch.from_numpy(items).float(),
                                        torch.from_numpy(hist))
    js = jmetrics.masked_catalog_scores(jnp.asarray(user, jnp.float32),
                                        jnp.asarray(items, jnp.float32),
                                        jnp.asarray(hist))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tr = tmetrics.target_rank(ts, torch.from_numpy(target))
    jr = jmetrics.target_rank(js, jnp.asarray(target))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    tgt = ts.numpy()[np.arange(B), target]
    assert (ts.numpy()[:, 1:] == tgt[:, None]).sum() > B   # ties present
    for k in (1, 10):
        th, tn = tmetrics.hit_and_ndcg(tr, k)
        jh, jn = jmetrics.hit_and_ndcg(jr, k)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-7)


def test_logging_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod in (tlogging, jlogging):
        assert mod.para_and_log(100, 80, 1000, 64, quiet_log(), 8, 2) == \
            (2, 8)
    lf, ls = tlogging.setuplogger("id", "paras", "-t", "train", "b.tsv")
    lf.info("x")
    tlogging.print_metrics([0.5, 0.25], lf, "valid")
    for h in lf.handlers:
        h.flush()
    text = (tmp_path / "logs_id_train" / "log_paras-t.log").read_text()
    assert "valid_results   50.00000\t25.00000" in text
    lf.handlers.clear()
    ls.handlers.clear()


def _images(rng, n):
    return [rng.integers(0, 256, size=(int(rng.integers(9, 70)),
                                       int(rng.integers(9, 70)), 3),
                         dtype=np.uint8) for _ in range(n)]


def test_mkv_store_and_transform_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    imgs = _images(rng, 7)
    recs = [(str(k).encode(), im) for k, im in enumerate(imgs, start=1)]
    for writer, reader in ((tstore.write_mkv, jstore.MKVStore),
                           (jstore.write_mkv, tstore.MKVStore)):
        path = str(tmp_path / f"{writer.__module__}.mkv")
        assert writer(path, recs) == len(recs)
        store = reader(path)
        assert len(store) == len(recs)
        for key, im in recs:
            np.testing.assert_array_equal(store.get(key), im)
        store.close()
    assert isinstance(tstore.open_store(path), tstore.MKVStore)
    with pytest.raises(NotImplementedError):
        tstore.open_store(str(tmp_path / "lmdb_dir"))
    for mode in ("f32", "u8"):
        a = tstore.BatchTransform(24, mode=mode)(imgs)
        b = jstore.BatchTransform(24, mode=mode)(imgs)
        assert a.dtype == b.dtype and a.shape == (7, 24, 24, 3)
        np.testing.assert_array_equal(a, b)
    assert tstore.library_path().exists()


def test_vision_pipe_and_prefetcher(tmp_path):
    """images_for: id 0 is a zero image, duplicates share one transform; the
    prefetcher yields in order and re-raises a worker's error."""
    rng = np.random.default_rng(2)
    imgs = _images(rng, 4)
    path = str(tmp_path / "s.mkv")
    tstore.write_mkv(path, [(str(k).encode(), im)
                            for k, im in enumerate(imgs, start=1)])
    keys = {k: str(k).encode() for k in range(1, 5)}
    pipe = VisionBatchPipe(tstore.MKVStore(path), keys, 16)
    ids = np.array([[3, 0, 3], [1, 4, 2]])
    out = pipe.images_for(ids)
    assert out.shape == (6, 16, 16, 3) and out.dtype == np.uint8
    assert not out[1].any()
    np.testing.assert_array_equal(out[0], out[2])
    np.testing.assert_array_equal(out[3], tstore.BatchTransform(
        16, mode="u8")([imgs[0]])[0])
    assert list(Prefetcher(iter(range(9)), lambda x: x * x)) == \
        [x * x for x in range(9)]

    def bad(x):
        raise ValueError("worker")
    with pytest.raises(ValueError, match="worker"):
        list(Prefetcher(iter(range(3)), bad))
