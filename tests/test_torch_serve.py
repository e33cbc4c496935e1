"""The serving slice end to end: the JAX Retriever (catalog encode +
recommend) vs the port's, on a 2-layer BERT (H = 32) + SASRec (D = 32)
text MoRec with the same Flax weights; and the port running without jax."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.serve import Retriever as JaxRetriever
from idvs.morec_tpu.serve import pad_histories as jax_pad_histories
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.serve import Retriever, pad_histories

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS, L, D, T, CHUNK = 60, 6, 32, 8, 16
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16)
HIST = [[3, 7, 11], [5], [2, 2, 9, 40, 41, 42, 43, 44], [59, 1]]


@pytest.fixture(scope="module")
def engines():
    cfg = Config(item_tower="modal", max_seq_len=L, embedding_dim=D,
                 num_attention_heads=2, transformer_block=2, drop_rate=0.0,
                 num_words_title=T)
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    content = np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att,
                              att], axis=1)
    jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                        embedding_dim=D, word_embedding_dim=32)
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    v = jm.init(jax.random.PRNGKey(0), jnp.ones((2, L + 1), jnp.int32),
                jnp.asarray(content[:2 * (L + 1)]), jnp.ones((2, L)))
    jtable = JaxRetriever.encode_catalog(jm, v, ITEMS, jnp.asarray(content),
                                         D, batch_size=CHUNK)
    tm = make_model(cfg, ITEMS, TextTower(
        BertModel(BertConfig(**BERT), device="cpu"), D, 32, device="cpu"),
        device="cpu")
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, v)))
    ttable = Retriever.encode_catalog(tm, ITEMS, torch.from_numpy(content),
                                      D, batch_size=CHUNK)
    return jm, v, jtable, tm, ttable, content


def _retrievers(engines, exclude=True):
    jm, v, jtable, tm, ttable, _ = engines
    return (JaxRetriever(jm, v, jtable, max_seq_len=L, batch_sizes=(4,),
                         exclude_history=exclude),
            Retriever(tm, ttable, max_seq_len=L, batch_sizes=(4,),
                      exclude_history=exclude))


def test_catalog_tables_match(engines):
    jr, tr = _retrievers(engines)
    assert tuple(tr.item_table.shape) == (ITEMS + 1, D)
    np.testing.assert_allclose(tr.item_table.numpy(),
                               np.asarray(jr.item_table),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exclude", [True, False])
def test_recommend_matches_jax(engines, exclude):
    jr, tr = _retrievers(engines, exclude)
    j_ids, j_scores = jr.recommend(HIST, top_k=5)
    t_ids, t_scores = tr.recommend(HIST, top_k=5)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5, atol=1e-5)
    # ids may differ only inside score ties (or at the cut after the last)
    for g, w, gs in zip(t_ids, j_ids, t_scores):
        for k in np.flatnonzero(g != w):
            assert (k == len(g) - 1
                    or np.isclose(gs, gs[k], rtol=1e-5, atol=1e-5).sum() > 1)
    assert (t_ids != 0).all()
    if exclude:
        for row, h in zip(t_ids, HIST):
            assert not set(h[-L:]) & set(row.tolist())


def test_bucketing_and_update_items(engines):
    _, tr = _retrievers(engines)
    tr.item_table = tr.item_table.clone()       # the fixture's stays intact
    one, _ = tr.recommend([[3, 7]], top_k=3)            # pads 1 -> 4
    four, _ = tr.recommend([[3, 7]] * 4, top_k=3)
    assert one.shape == (1, 3) and four.shape == (4, 3)
    np.testing.assert_array_equal(one[0], four[0])
    six, _ = tr.recommend([[3, 7]] * 6, top_k=3)        # beyond the bucket
    assert six.shape == (6, 3)
    ids, mask = pad_histories([[3, 7]], L)
    with torch.no_grad():
        uvec = tr.model.user_states(tr.item_table[torch.from_numpy(ids)],
                                    torch.from_numpy(mask))[0, -1]
    tr.update_items([49], embeddings=uvec[None] * 100.0)
    top, _ = tr.recommend([[3, 7]], top_k=1)
    assert top[0, 0] == 49
    # from raw content: item 5 takes item 12's title through the tower
    content = torch.from_numpy(engines[5])
    tr.update_items([5], content=content[[12]])
    torch.testing.assert_close(tr.item_table[5], tr.item_table[12],
                               rtol=1e-6, atol=1e-6)


def test_pad_histories_matches_jax():
    for hist, n in ((HIST, L), ([[], [1, 2]], 3)):
        ids_t, mask_t = pad_histories(hist, n)
        ids_j, mask_j = jax_pad_histories(hist, n)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)


def test_serving_runs_in_eval_mode_whatever_the_model_mode():
    """A tiny IDRec model at dropout 0.1, through make_train_state (which
    leaves it in training mode): encode_catalog, recommend and
    update_items give their eval-mode results, and the model stays in
    training mode."""
    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.train.state import make_train_state
    cfg = Config(item_tower="id", user_tower="sasrec", stage="end2end",
                 embedding_dim=D, num_attention_heads=2, transformer_block=2,
                 max_seq_len=L, drop_rate=0.1, lr=1e-3, l2_weight=0.0,
                 fine_tune_lr=1e-3, fine_tune_l2_weight=0.0)
    model = make_model(cfg, ITEMS, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    model.eval()
    want_table = Retriever.encode_catalog(model, ITEMS, None, D,
                                          batch_size=CHUNK)
    want = Retriever(model, want_table, max_seq_len=L).recommend(HIST, 5)
    make_train_state(model, cfg)
    assert model.training
    table = Retriever.encode_catalog(model, ITEMS, None, D, batch_size=CHUNK)
    engine = Retriever(model, table, max_seq_len=L)
    got = engine.recommend(HIST, 5)
    engine.update_items([3], content=torch.tensor([3]))
    assert model.training
    assert torch.equal(table, want_table)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_port_runs_the_slice_without_jax():
    """A fresh interpreter, where importing jax or the JAX package raises,
    imports the port, encodes a catalog, serves a request and takes one
    train step on the CPU (text MoRec), then encodes an image catalog
    through a Swin tower, serves a request and takes one train step over
    images shipped with the batch (vision MoRec); then imports the runner's
    modules and the CLI, trains IDRec for one epoch through
    ``Trainer(cfg, device="cpu")`` and reloads the best checkpoint in test
    mode; takes one BCE step (text MoRec, sampled negatives) and one DSSM
    step (IDRec) and serves a DSSM ``recommend_users`` call; builds a
    two-stage catalog cache through the runner's frozen text tower and
    takes one BCE step of the fused two-stage head over it, and one BCE
    step of the fusion end2end tower over BERT; runs a cold and a new-item
    evaluation (train/special_eval.py) and two micro-steps of gradient
    accumulation; builds every other vision encoder's tower from each CLI
    name and runs a tiny ResNet-18, ViT-MAE, BEiT and CLIP tower through an
    encode, a request and a train step (``transformers`` blocked too);
    builds an OPT and a DeBERTa tower through ``build_text_tower`` from a
    directory holding config.json alone (``safetensors`` blocked too), each
    encoding a catalog and taking one train step; the CLI itself
    refuses to run without a GPU (the test process itself has jax loaded
    by conftest, hence the subprocess)."""
    code = textwrap.dedent("""
        import importlib.abc
        import sys

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                top = name.split(".")[0]
                if (top in ("jax", "jaxlib", "flax", "optax",
                            "transformers", "safetensors")
                        or name == "idvs.morec_tpu"
                        or name.startswith("idvs.morec_tpu.")):
                    raise ImportError(f"{name} is blocked in this test")
                return None

        sys.meta_path.insert(0, NoJax())
        from idvs.morec_tpu_torch.config import Config
        import numpy as np
        import torch
        import idvs.morec_tpu_torch
        from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
        from idvs.morec_tpu_torch.models.model import make_model
        from idvs.morec_tpu_torch.models.text_tower import TextTower
        from idvs.morec_tpu_torch.serve import Retriever
        cfg = Config(item_tower="modal", user_tower="sasrec",
                     stage="end2end", embedding_dim=32,
                     num_attention_heads=2, transformer_block=2,
                     max_seq_len=6)
        enc = TextTower(BertModel(BertConfig(
            vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16), device="cpu"), 32, 32,
            attr_lengths=(8,), device="cpu")
        model = make_model(cfg, 40, enc, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        tok = rng.integers(1, 97, size=(41, 8))
        content = torch.from_numpy(np.concatenate([tok, np.ones_like(tok)],
                                                  axis=1))
        table = Retriever.encode_catalog(model, 40, content, 32,
                                         batch_size=16)
        ids, scores = Retriever(model, table, max_seq_len=6).recommend(
            [[1, 2, 3]], top_k=5)
        assert ids.shape == (1, 5) and np.isfinite(scores).all()
        assert not {1, 2, 3} & set(ids[0].tolist()) and 0 not in ids
        # one train step, dropout on, host-side dedup
        from idvs.morec_tpu_torch.train.state import (make_train_state,
                                                      param_labels)
        from idvs.morec_tpu_torch.train.step import (dedup_pack,
                                                     make_train_step)
        cfg.__dict__.update(loss="inbatch_ce", compute_dtype="float32",
                            lr=1e-3, l2_weight=0.0, fine_tune_lr=5e-4,
                            fine_tune_l2_weight=0.0)
        state = make_train_state(model, cfg, param_labels(model))
        step = make_train_step(cfg, item_content=content,
                               log_pop=torch.zeros(41))
        ids = rng.integers(1, 41, size=(4, 7))
        uniq, inv = dedup_pack(ids, 32)
        before = model.user_encoder.ln_in.weight.detach().clone()
        loss = step(state, {"ids": torch.from_numpy(ids),
                            "log_mask": torch.ones(4, 6),
                            "uniq_ids": torch.from_numpy(uniq),
                            "inverse": torch.from_numpy(inv)})
        assert torch.isfinite(loss) and state.step == 1
        assert not torch.equal(before, model.user_encoder.ln_in.weight)
        # vision MoRec: a Swin tower over uint8 images drawn from a pool
        from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
        from idvs.morec_tpu_torch.models.vision_tower import VisionTower
        import idvs.morec_tpu_torch.convert
        scfg = SwinConfig(image_size=32, embed_dim=32, depths=(2, 2),
                          num_heads=(2, 4), window_size=4,
                          hidden_dropout_prob=0.1,
                          attention_probs_dropout_prob=0.1)
        tower = VisionTower(SwinModel(scfg, device="cpu"), "swin", 32,
                            scfg.num_features, device="cpu")
        vmodel = make_model(cfg, 40, tower, device="cpu",
                            generator=torch.Generator().manual_seed(1))
        pool = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
        vtable = Retriever.encode_catalog(
            vmodel, 40, None, 32, batch_size=16,
            content_fn=lambda ids: pool[ids % 8])
        assert vtable.shape == (41, 32) and torch.isfinite(vtable).all()
        engine = Retriever(vmodel, vtable, max_seq_len=6)
        ids, scores = engine.recommend([[1, 2, 3]], top_k=5)
        assert ids.shape == (1, 5) and np.isfinite(scores).all()
        assert not {1, 2, 3} & set(ids[0].tolist()) and 0 not in ids
        engine.update_items([7], content=pool[[2]])
        # one vision train step: images shipped with the batch, DropPath and
        # dropout drawn (Swin's attention and hidden dropout too: the window
        # path and the bias table's gradient), the tower chunked and
        # rematerialised; then a request, served in eval mode
        cfg.__dict__.update(encoder_chunk=8, drop_rate=0.1)
        vstate = make_train_state(vmodel, cfg, param_labels(vmodel))
        vstep = make_train_step(cfg, log_pop=torch.zeros(41))
        uniq, inv = dedup_pack(ids_train := rng.integers(1, 41, size=(4, 7)),
                               32)
        table0 = vmodel.encoder.net.stage_0_block_1.\
            relative_position_bias_table.detach().clone()
        loss = vstep(vstate, {
            "ids": torch.from_numpy(ids_train), "log_mask": torch.ones(4, 6),
            "uniq_ids": torch.from_numpy(uniq),
            "inverse": torch.from_numpy(inv),
            "uniq_content": torch.from_numpy(pool[uniq % 8])})
        assert torch.isfinite(loss) and vstate.step == 1
        assert not torch.equal(table0, vmodel.encoder.net.stage_0_block_1.
                               relative_position_bias_table)
        assert vmodel.training
        first = engine.recommend([[1, 2, 3]], top_k=5)
        again = engine.recommend([[1, 2, 3]], top_k=5)
        assert (first[0] == again[0]).all() and vmodel.training
        # the runner: every module of it and the CLI, one IDRec epoch and a
        # test-mode reload of the best checkpoint on the CPU
        import os, tempfile
        import idvs.morec_tpu_torch.data.imagestore
        import idvs.morec_tpu_torch.data.loader
        import idvs.morec_tpu_torch.data.preprocess
        import idvs.morec_tpu_torch.data.vision_loader
        import idvs.morec_tpu_torch.ops.metrics
        import idvs.morec_tpu_torch.train.checkpoint
        import idvs.morec_tpu_torch.train.evaluate
        import idvs.morec_tpu_torch.utils.logging
        from idvs.morec_tpu_torch import quickstart, run
        from idvs.morec_tpu_torch.config import parse_args
        from idvs.morec_tpu_torch.train.runner import Trainer
        os.chdir(tempfile.mkdtemp())
        quickstart.make_dataset("SYNTH", n_users=120, n_items=40, n_groups=4)
        flags = quickstart.FLAGS + ["--epoch", "1"]
        tr = Trainer(parse_args(flags), device="cpu")
        tr.load_data()
        tr.build_model()
        best, best_epoch = tr.train()
        assert best_epoch == 1 and 0 < best <= 1
        te = Trainer(parse_args(flags + ["--mode", "test", "--load_ckpt_name",
                                         "epoch-1.pt"]), device="cpu")
        te.load_data()
        te.build_model()
        hit, ndcg = te.test()
        assert 0 <= ndcg <= hit <= 1
        assert te.run_eval("valid")[0] == best
        # BCE with sampled negatives: one text MoRec step over the
        # positives and negatives deduplicated together; DSSM: one IDRec
        # step at dnn_layers 1 and a recommend_users call
        from idvs.morec_tpu_torch.data.loader import BCETrainBatcher
        cfg.__dict__.update(loss="bce", encoder_chunk=0)
        bstep = make_train_step(cfg, item_content=content)
        pos, neg, lm = next(BCETrainBatcher(
            rng.integers(1, 41, size=(4, 7)), np.full(4, 7), 6, 4, 40
            ).epoch(1))
        uniq, inv = dedup_pack(np.concatenate([pos.ravel(), neg.ravel()]), 64)
        loss = bstep(state, {
            k: torch.from_numpy(v) for k, v in dict(
                ids=pos, neg_ids=neg, log_mask=lm, uniq_ids=uniq,
                inverse=inv).items()})
        assert torch.isfinite(loss) and state.step == 2
        dcfg = Config(item_tower="id", user_tower="dssm", loss="bce",
                      embedding_dim=32, dnn_layers=1, neg_num=2,
                      compute_dtype="float32", lr=1e-3, l2_weight=0.0)
        dmodel = make_model(dcfg, 40, user_num=9, device="cpu",
                            generator=torch.Generator().manual_seed(2))
        dstate = make_train_state(dmodel, dcfg)
        items = torch.from_numpy(rng.integers(1, 41, size=(4, 3)))
        loss = make_train_step(dcfg)(dstate, {
            "users": torch.tensor([1, 4, 9, 2]), "items": items,
            "labels": torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1)})
        assert torch.isfinite(loss) and dstate.step == 1
        dtable = Retriever.encode_catalog(dmodel, 40, None, 32)
        ids, scores = Retriever(dmodel, dtable).recommend_users([3, 9], 5)
        assert ids.shape == (2, 5) and 0 not in ids
        assert np.isfinite(scores).all()
        # two-stage: the frozen text tower's catalog cache through the
        # runner, one BCE step of the fused (cat) head over it; fusion
        # end2end: one BCE step of the add tower over BERT
        bce = dict(ids=pos, neg_ids=neg, log_mask=lm, uniq_ids=uniq,
                   inverse=inv)
        scfg = Config(item_tower="modal_id_cat", stage="two_stage",
                      loss="bce", embedding_dim=32, num_attention_heads=2,
                      transformer_block=1, max_seq_len=6, mo_dnn_layers=1,
                      dnn_layers=1, compute_dtype="bfloat16", lr=1e-3,
                      item_emb_batch_size=16)
        raw = TextTower(BertModel(BertConfig(
            vocab_size=97, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=16), device="cpu"), 32, 24,
            attr_lengths=(8,), project=False, device="cpu")
        cache = Trainer(scfg, device="cpu")._encode_catalog(
            (raw, None, set(), 24), content.numpy().__getitem__, 40)
        assert cache.shape == (41, 24) and scfg.word_embedding_dim == 24
        smodel = make_model(scfg, 40, device="cpu",
                            generator=torch.Generator().manual_seed(3))
        sstate = make_train_state(smodel, scfg)
        loss = make_train_step(scfg, item_content=cache)(sstate, {
            k: torch.from_numpy(v) for k, v in bce.items()})
        assert torch.isfinite(loss) and sstate.step == 1
        fcfg = Config(item_tower="modal_id_add", loss="bce", embedding_dim=32,
                      num_attention_heads=2, transformer_block=1,
                      max_seq_len=6, compute_dtype="float32", lr=1e-3)
        fmodel = make_model(fcfg, 40, TextTower(BertModel(BertConfig(
            vocab_size=97, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16), device="cpu"), 32, 32,
            attr_lengths=(8,), device="cpu"), device="cpu",
            generator=torch.Generator().manual_seed(4))
        fstate = make_train_state(fmodel, fcfg, param_labels(fmodel))
        loss = make_train_step(fcfg, item_content=content)(fstate, {
            k: torch.from_numpy(v) for k, v in bce.items()})
        assert torch.isfinite(loss) and fstate.step == 1
        # cold and new-item evaluation of the text model, then two
        # micro-steps of an accumulation window of 2 on the fusion tower
        from idvs.morec_tpu_torch.train import special_eval
        seqs = {0: [1, 2, 3], 1: [4, 5, 6, 7], 2: [8, 9, 1]}
        hist = {u: np.asarray(q[:-1]) for u, q in seqs.items()}
        table = Retriever.encode_catalog(model, 40, content, 32,
                                         batch_size=16)
        hit, ndcg = special_eval.eval_cold(model, table, seqs, hist, 6, 2)
        new_embs = special_eval.encode_new_items(model, content[:3], 2)
        new = {u: q[:-1] + [1 + u % 2] for u, q in seqs.items()}
        hit_n, ndcg_n = special_eval.eval_new(model, table, new_embs, new,
                                              hist, 6, 2)
        assert 0 <= ndcg <= hit <= 1 and 0 <= ndcg_n <= hit_n <= 1
        fcfg.accumulation_step = 2
        fstate = make_train_state(fmodel, fcfg, param_labels(fmodel))
        fstep = make_train_step(fcfg, item_content=content)
        w = fmodel.user_encoder.ln_in.weight
        w0 = w.detach().clone()
        for micro in (1, 2):
            loss = fstep(fstate, {k: torch.from_numpy(v)
                                  for k, v in bce.items()})
            assert torch.isfinite(loss) and fstate.step == micro
            assert torch.equal(w, w0) == (micro == 1)
        # the other vision encoders: every CLI name's bundle built at its
        # default geometry (on the meta device; resnet34 two-stage), then a
        # tiny ResNet-18,
        # ViT-MAE, BEiT and CLIP tower each encodes a catalog, serves a
        # request and takes one train step (BatchNorm's running averages
        # move; MAE masks from the step's generator)
        from idvs.morec_tpu_torch.models import beit, clip_vit, vit_mae
        from idvs.morec_tpu_torch.models.resnet import ResNet
        from idvs.morec_tpu_torch.train.runner import load_encoder
        for name in ("resnet18", "resnet34", "resnet50", "resnet101",
                     "resnet152", "vit_mae", "mae", "beit_base",
                     "clip_vit"):
            stage = "two_stage" if name.endswith("4") else "end2end"
            zcfg = Config(item_tower="modal", modality="vision",
                          cv_model_load=name, stage=stage,
                          freeze_paras_before=4)
            tower, _, frozen, _ = load_encoder(zcfg, "meta")
            assert tower.project == (stage == "end2end")
            assert len(frozen) == (4 if stage == "end2end" else 0)
        vit = dict(image_size=32, patch_size=8, hidden_size=32,
                   num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=64)
        nets = {"resnet": (ResNet("resnet18", 32, device="cpu"), 32),
                "mae": (vit_mae.ViTMAEModel(vit_mae.ViTMAEConfig(**vit),
                                            device="cpu"), 32),
                "swin": (beit.BeitModel(beit.BeitConfig(**vit),
                                        device="cpu"), 32)}
        zoo = [(kind, *nets[kind]) for kind in nets] + [(
            "swin", clip_vit.CLIPVisionModel(
                clip_vit.CLIPVisionConfig(**vit), device="cpu"), 32)]
        cfg.__dict__.update(loss="inbatch_ce", encoder_chunk=8,
                            drop_rate=0.0, accumulation_step=1)
        for kind, net, width in zoo:
            zmodel = make_model(cfg, 40, VisionTower(
                net, kind, 32, width, device="cpu"), device="cpu",
                generator=torch.Generator().manual_seed(5))
            # the ResNet on 16 x 16 images: every stage at a quarter of
            # the work
            zpool = pool[:, :16, :16] if kind == "resnet" else pool
            ztable = Retriever.encode_catalog(
                zmodel, 40, None, 32, batch_size=16,
                content_fn=lambda ids: zpool[ids % 8])
            assert torch.isfinite(ztable).all()
            ids, _ = Retriever(zmodel, ztable, max_seq_len=6).recommend(
                [[1, 2, 3]], top_k=5)
            assert 0 not in ids
            zstate = make_train_state(zmodel, cfg, param_labels(zmodel))
            stats = [b.clone() for b in zmodel.buffers()
                     if b.dtype.is_floating_point]
            loss = make_train_step(cfg, log_pop=torch.zeros(41))(zstate, {
                "ids": torch.from_numpy(ids_train),
                "log_mask": torch.ones(4, 6),
                "uniq_ids": torch.from_numpy(uniq),
                "inverse": torch.from_numpy(inv),
                "uniq_content": torch.from_numpy(zpool[uniq % 8])})
            assert torch.isfinite(loss) and zstate.step == 1
            moved = [not torch.equal(a, b) for a, b in zip(stats, [
                b for b in zmodel.buffers() if b.dtype.is_floating_point])]
            assert all(moved) and bool(moved) == (kind == "resnet")
        # the text zoo: an OPT and a DeBERTa tower built by
        # build_text_tower from a directory that holds config.json alone
        # (no weights: none converted), each encodes the catalog and takes
        # one train step with dropout
        import json
        from idvs.morec_tpu_torch.models.text_tower import build_text_tower
        pm = tempfile.mkdtemp()
        tiny = dict(vocab_size=97, hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=2, max_position_embeddings=16)
        zoo_dirs = {
            "opt-tiny": dict(tiny, model_type="opt", ffn_dim=64,
                             word_embed_proj_dim=32,
                             do_layer_norm_before=True),
            "deberta-tiny": dict(tiny, model_type="deberta",
                                 intermediate_size=64,
                                 relative_attention=True,
                                 pos_att_type="c2p|p2c",
                                 position_biased_input=False)}
        tids = rng.integers(1, 41, size=(4, 7))
        tu, ti = dedup_pack(tids, 32)
        for name, conf in zoo_dirs.items():
            os.makedirs(os.path.join(pm, name))
            with open(os.path.join(pm, name, "config.json"), "w") as f:
                json.dump(conf, f)
            tcfg = Config(item_tower="modal", modality="text",
                          bert_model_load=name, pretrained_models_dir=pm,
                          num_words_title=8, embedding_dim=32,
                          num_attention_heads=2, transformer_block=1,
                          max_seq_len=6, loss="inbatch_ce",
                          compute_dtype="float32", lr=1e-3,
                          fine_tune_lr=5e-4, freeze_paras_before=2)
            ttower, tsd, tfrozen, twidth = build_text_tower(tcfg,
                                                            device="cpu")
            assert tsd is None and twidth == 32 and len(tfrozen) == 2
            tmodel = make_model(tcfg, 40, ttower, device="cpu",
                                generator=torch.Generator().manual_seed(6))
            ttable = Retriever.encode_catalog(tmodel, 40, content, 32,
                                              batch_size=16)
            assert torch.isfinite(ttable).all()
            tst = make_train_state(tmodel, tcfg,
                                   param_labels(tmodel, frozen=tfrozen))
            loss = make_train_step(tcfg, item_content=content,
                                   log_pop=torch.zeros(41))(tst, {
                "ids": torch.from_numpy(tids), "log_mask": torch.ones(4, 6),
                "uniq_ids": torch.from_numpy(tu),
                "inverse": torch.from_numpy(ti)})
            assert torch.isfinite(loss) and tst.step == 1
        if not torch.cuda.is_available():
            try:
                run.main(flags)
            except RuntimeError as e:
                assert "no CUDA device" in str(e)
            else:
                raise AssertionError("the CLI ran without a GPU")
        mods = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
        assert not mods, mods
        print("ok")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().endswith("ok")
