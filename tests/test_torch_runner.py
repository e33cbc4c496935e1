"""The port's runner (train/runner.py ``Trainer``, train/checkpoint.py,
train/state.py's frozen group) on the CPU, against the JAX package's
``Trainer`` where both run:

- per-step losses over one epoch within 1e-5 relative and valid HR@10 /
  nDCG@10 within 2 / n_users, IDRec and text MoRec (BERT 2 layers, width
  24), float32, dropout 0, the JAX weights loaded into the port;
- bit-exact resume: two epochs straight give the same losses and weights as
  one epoch, a checkpoint, a fresh Trainer and one more (the twin of
  test_resume_and_eval_parity.py::test_bitexact_resume), by hand and
  through ``train`` with ``load_ckpt_name``;
- checkpoint names, early stop, the frozen group (counted as the JAX
  runner counts), steps_per_dispatch, the vision path over an MKV store,
  and what is not ported (and what now is: accumulation, cold items).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.convert_text import bert_frozen_paths
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.parallel.mesh import make_mesh
from idvs.morec_tpu.train import checkpoint as jckpt
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data.imagestore import write_mkv
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.train import checkpoint as tckpt
from idvs.morec_tpu_torch.train.runner import Trainer, load_encoder, run
from idvs.morec_tpu_torch.train.state import FROZEN_LABEL, param_labels

from tests.test_torch_config_data import _tokenizer
from tests.test_train_integration import quiet_log, synth_dataset

T = 8
BERT = dict(vocab_size=97, hidden_size=24, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BASE = dict(dataset="TINY", news="news.tsv", behaviors="behaviors.tsv",
            max_seq_len=8, min_seq_len=3, batch_size=8, embedding_dim=16,
            num_attention_heads=2, transformer_block=1, epoch=1, lr=1e-3,
            fine_tune_lr=5e-4, eval_batch_size=32, num_words_title=T)


def jit_jax_init(monkeypatch):
    """Makes the JAX runner's ``model.init`` (an eager call in its
    ``build_model``) a jitted one: the same tree, compiled once instead of
    run op by op, which took most of a JAX ``Trainer``'s set-up time."""
    from idvs.morec_tpu.train import runner as jrunner
    make = jrunner.make_model

    def jitted(*args, **kwargs):
        model = make(*args, **kwargs)
        object.__setattr__(model, "init", jax.jit(model.init))
        return model

    monkeypatch.setattr(jrunner, "make_model", jitted)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    jit_jax_init(monkeypatch)


def _cfg(cls, root, **kw):
    return cls(root_data_dir=root, **{**BASE, **kw})


def _text_bundle(frozen=()):
    tower = TextTower(BertModel(BertConfig(**BERT), device="cpu"), 16, 24,
                      attr_lengths=(T,), device="cpu")
    return tower, None, set(frozen), 24


def _port(root, encoder_bundle=None, **kw):
    tr = Trainer(_cfg(Config, root, **kw), quiet_log(), quiet_log(),
                 device="cpu", encoder_bundle=encoder_bundle,
                 tokenizer=_tokenizer)
    tr.load_data()
    tr.build_model()
    return tr


def _run_epoch(tr, epoch):
    return [tr.train_step(tr.state, tr.make_batch(raw)).item()
            for raw in tr.batcher.epoch(epoch)]


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("item_tower", ["id", "modal"])
def test_trainer_matches_jax(tmp_path, monkeypatch, item_tower):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=96, n_items=40)
    modal = item_tower == "modal"
    kw = dict(item_tower=item_tower, compute_dtype="float32", drop_rate=0.0)
    jbundle = tbundle = None
    if modal:
        jbundle = (JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                                embedding_dim=16, word_embedding_dim=24),
                   None, set(), 24)
        tbundle = _text_bundle()
    jtr = JTrainer(_cfg(JConfig, root, **kw), quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    if modal:   # the JAX runner reads its tokenizer from files
        base = root + "TINY/"
        items = jpre.read_items_tokenized(base + "news.tsv", jtr.cfg,
                                          _tokenizer)
        bd = jpre.read_behaviors(base + "behaviors.tsv", *items, 8, 3)
        jtr.set_data(bd, jpre.build_doc_matrix(bd.item_id_to_dic, jtr.cfg))
    else:
        jtr.load_data()
    jtr.build_model()
    tr = _port(root, tbundle, **kw)
    assert tr.item_num == jtr.item_num
    convert.load_flax(tr.model, jtr.state.params)
    assert (tr.n_total, tr.n_trainable) == (jtr.n_total, jtr.n_trainable)

    jlosses = []
    for raw in jtr.batcher.epoch(1):
        jtr.state, loss = jtr.train_step(jtr.state, jtr.make_batch(raw))
        jlosses.append(float(loss))
    losses = _run_epoch(tr, 1)
    assert len(losses) == len(jlosses) == tr.batcher.steps_per_epoch()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    hit, ndcg = tr.run_eval("valid")
    jhit, jndcg = jtr.run_eval("valid")
    n = tr.last_eval["users"]
    assert n == tr.eval_valid.n
    assert abs(hit - jhit) <= 2 / n and abs(ndcg - jndcg) <= 2 / n


def test_bitexact_resume(tmp_path, monkeypatch):
    """Dropout on (0.1), bf16 compute: the generator, the AdamW moments and
    the step count all come back from the checkpoint."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path)
    tr1 = _port(root, drop_rate=0.1)
    _run_epoch(tr1, 1)
    straight = _run_epoch(tr1, 2)

    tr2 = _port(root, drop_rate=0.1)
    _run_epoch(tr2, 1)
    path = tckpt.save_checkpoint(str(tmp_path / "ck"), 1, tr2.state,
                                 {"best": 0.5})
    assert os.path.basename(path) == "epoch-1.pt"
    tr3 = _port(root, drop_rate=0.1)
    _, payload = tckpt.load_checkpoint(path, tr3.state)
    assert payload["epoch"] == 1 and payload["extra"] == {"best": 0.5}
    assert tr3.state.step == tr2.state.step
    resumed = _run_epoch(tr3, 2)
    assert straight == resumed
    _same_weights(tr1.model, tr3.model)


def test_resume_through_train(tmp_path, monkeypatch):
    """train() for 2 epochs == train() for 1 (saving epoch-1.pt) and a
    fresh Trainer resuming it for 1 more, by name and as "latest"; the
    resumed epoch's in-memory evaluation is the straight run's, bit for
    bit, and so is a test-mode reload's."""
    root = synth_dataset(tmp_path)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "a")
    tra = _port(root, drop_rate=0.1, epoch=2, early_stop_gap=5)
    tra.train()
    monkeypatch.chdir(tmp_path / "b")
    trb = _port(root, drop_rate=0.1, epoch=1)
    best, best_epoch = trb.train()
    assert best_epoch == 1 and os.path.exists(
        os.path.join(trb.model_dir, "epoch-1.pt"))
    for name in ("epoch-1.pt", "latest"):
        # a directory of its own holding epoch-1.pt alone
        shutil.copytree(tmp_path / "b", tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        trc = _port(root, drop_rate=0.1, epoch=1, load_ckpt_name=name)
        trc.train()
        assert list(trc.valid_results) == [2]
        _same_weights(tra.model, trc.model)
        got, want = trc.valid_results[2], tra.valid_results[2]
        assert (got["hit"], got["ndcg"]) == (want["hit"], want["ndcg"])
        np.testing.assert_array_equal(got["hits"], want["hits"])
        np.testing.assert_array_equal(got["ndcgs"], want["ndcgs"])
    # test mode: the best checkpoint evaluates as the run did in memory
    monkeypatch.chdir(tmp_path / "b")
    trt = _port(root, drop_rate=0.1, mode="test", load_ckpt_name="epoch-1.pt")
    trt.test()
    assert trt.last_eval["split"] == "test"
    assert trt.run_eval("valid") == (trb.valid_results[1]["hit"],
                                     trb.valid_results[1]["ndcg"])


def test_checkpoint_names(tmp_path):
    for name in ("epoch-12.pt", "dir/epoch-3.pt", "epoch-7.ckpt"):
        assert tckpt.epoch_from_name(name) == jckpt.epoch_from_name(name)
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    for f in ("epoch-1.pt", "epoch-10.pt", "epoch-2.pt", "epoch-30.ckpt",
              "epoch-40.pt.tmp", "notes.txt"):
        (tmp_path / f).write_text("")
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "epoch-10.pt")
    assert tckpt.get_checkpoint(str(tmp_path), "epoch-2.pt") == str(
        tmp_path / "epoch-2.pt")
    assert tckpt.get_checkpoint(str(tmp_path), "epoch-5.pt") is None


def test_early_stop(tmp_path, monkeypatch):
    """lr 0: no epoch beats the first, so with early_stop_gap 1 the run
    stops after epoch 3 having saved epoch 1 only; a resumed run does not
    stop early (the reference's is_early_stop)."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path)
    tr = _port(root, lr=0.0, epoch=6, early_stop_gap=1)
    best, best_epoch = tr.train()
    assert best > 0 and best_epoch == 1
    assert list(tr.valid_results) == [1, 2, 3]
    assert sorted(os.listdir(tr.model_dir)) == ["epoch-1.pt"]
    tr2 = _port(root, lr=0.0, epoch=3, early_stop_gap=0,
                load_ckpt_name="epoch-1.pt")
    tr2.train()
    assert list(tr2.valid_results) == [2, 3, 4]


def test_nan_loss_stops(tmp_path, monkeypatch):
    """A NaN loss ends the run at that step: no evaluation, no checkpoint
    (the reference's run.py:249-251)."""
    monkeypatch.chdir(tmp_path)
    tr = _port(synth_dataset(tmp_path), epoch=3)
    step, calls = tr.train_step, []

    def nan_at_third(state, batch):
        calls.append(1)
        loss = step(state, batch)
        return loss * float("nan") if len(calls) == 3 else loss

    tr.train_step = nan_at_third
    assert tr.train() == (0.0, 0)
    assert len(calls) == 3 and tr.valid_results == {}
    assert not os.path.exists(tr.model_dir)


def test_frozen_group(tmp_path, monkeypatch):
    """The first 21 BERT parameters frozen: no gradient, no optimizer group,
    no update, no weight decay; the rest of the encoder trains; the counts
    are the JAX runner's."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=48, n_items=30)
    frozen = convert.bert_frozen_names(2, 21)
    kw = dict(item_tower="modal", fine_tune_l2_weight=0.1, l2_weight=0.1)
    tr = _port(root, _text_bundle(frozen), **kw)
    jbundle = (JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=16, word_embedding_dim=24), None,
               bert_frozen_paths(2, 21, prefix=("encoder", "net")), 24)
    jtr = JTrainer(_cfg(JConfig, root, **kw), quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    base = root + "TINY/"
    bd = jpre.read_behaviors(base + "behaviors.tsv", *jpre.read_items_tokenized(
        base + "news.tsv", jtr.cfg, _tokenizer), 8, 3)
    jtr.set_data(bd, jpre.build_doc_matrix(bd.item_id_to_dic, jtr.cfg))
    jtr.build_model()
    assert (tr.n_total, tr.n_trainable) == (jtr.n_total, jtr.n_trainable)
    assert tr.n_trainable < tr.n_total

    params = dict(tr.model.named_parameters())
    assert len(frozen) == 21 and frozen <= params.keys()
    in_groups = {id(p) for g in tr.state.optimizer.param_groups
                 for p in g["params"]}
    labels = param_labels(tr.model, frozen=frozen)
    assert {n for n, v in labels.items() if v == FROZEN_LABEL} == frozen
    for name, p in params.items():
        assert p.requires_grad == (name not in frozen), name
        assert (id(p) in in_groups) == (name not in frozen), name
    before = {k: v.detach().clone() for k, v in params.items()}
    _run_epoch(tr, 1)
    for name, p in params.items():
        # a key bias's gradient is zero: softmax ignores a shift of a row
        if not name.endswith("key.bias"):
            assert torch.equal(p, before[name]) == (name in frozen), name


def test_steps_per_dispatch(tmp_path, monkeypatch):
    """Four steps a group (the epoch's last group shorter) make the same
    updates as one at a time."""
    root = synth_dataset(tmp_path)
    runs = []
    for k in (1, 4):
        (tmp_path / str(k)).mkdir()
        monkeypatch.chdir(tmp_path / str(k))
        tr = _port(root, drop_rate=0.1, steps_per_dispatch=k)
        assert tr.batcher.steps_per_epoch() % 4
        tr.train()
        runs.append(tr)
    _same_weights(runs[0].model, runs[1].model)
    assert runs[0].train_stats == {**runs[1].train_stats,
                                   "seconds": runs[0].train_stats["seconds"]}


def test_vision_runner(tmp_path, monkeypatch):
    """Vision end2end over an MKV store through a tiny Swin tower: a train
    epoch with dedup and images in the batch, a full eval, the best
    checkpoint reloaded by a fresh Trainer to the same evaluation bits."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    root = synth_dataset(tmp_path, n_users=40, n_items=24)
    base = tmp_path / "TINY"
    (base / "images.tsv").write_text(
        "".join(f"v{k}\tx\n" for k in range(1, 25)))
    beh = (base / "behaviors.tsv").read_text().replace("\ti", "\tv")
    (base / "behaviors.tsv").write_text(beh.replace(" i", " v"))
    write_mkv(str(base / "imgs.mkv"), [
        (str(k).encode(), rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
        for k in range(1, 25)])
    scfg = SwinConfig(image_size=32, embed_dim=16, depths=(2, 2),
                      num_heads=(2, 4), window_size=4)

    def trainer(**kw):
        tower = VisionTower(SwinModel(scfg, device="cpu"), "swin", 16,
                            scfg.num_features, device="cpu")
        tr = Trainer(_cfg(Config, root, modality="vision",
                          item_tower="modal", news="images.tsv",
                          image_store="imgs.mkv", image_resize=32,
                          dedup_items=True, batch_size=16, **kw),
                     quiet_log(), quiet_log(), device="cpu",
                     encoder_bundle=(tower, None, set(), scfg.num_features))
        tr.load_data()
        tr.build_model()
        return tr

    tr = trainer(epoch=1)
    batch = tr.make_batch(next(tr.batcher.epoch(1)))
    assert batch["uniq_content"].dtype == torch.uint8
    assert batch["uniq_content"].shape[1:] == (32, 32, 3)
    best, best_epoch = tr.train()
    assert best_epoch == 1 and tr.train_stats["steps"] == 3
    te = trainer(mode="test", load_ckpt_name="epoch-1.pt")
    te.test()
    assert te.run_eval("valid") == (best, tr.valid_results[1]["ndcg"])
    np.testing.assert_array_equal(te.last_eval["hits"],
                                  tr.valid_results[1]["hits"])


def test_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path)
    for kw in (dict(stage="two_stage"), dict(item_tower="modal_id_add"),
               dict(accumulation_step=2)):
        # two-stage and fusion (ROADMAP A4) and gradient accumulation (A1)
        # are ported
        Trainer(_cfg(Config, root, **kw), quiet_log(), quiet_log(),
                device="cpu")
    # a text tower is built from its HF model directory (ROADMAP A7b):
    # there is none here, and the error names the config.json it read for
    with pytest.raises(FileNotFoundError, match="config.json"):
        load_encoder(Config(item_tower="modal",
                            pretrained_models_dir=str(tmp_path)), "cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        Trainer(_cfg(Config, root, item_tower="modal"), quiet_log(),
                quiet_log(), device="cpu").load_data()
    # cold-item evaluation is ported (ROADMAP A5): an IDRec test reads the
    # cold file and ignores a new-item file, as the JAX runner does
    with open(root + "TINY/behaviors.tsv") as f:
        cold = [" ".join(ln.split(" ")[:5]) for ln in f.read().split("\n")[:5]]
    with open(root + "TINY/cold.tsv", "w") as f:
        f.write("\n".join(cold) + "\n")
    tr = _port(root, mode="test", cold_behaviors="cold.tsv",
               new_behaviors="missing.tsv")
    tr.test()
    assert list(tr.special_results) == ["cold"]
    assert tr.special_results["cold"]["users"] == 5
    if not torch.cuda.is_available():
        # the CLI runs on the card: no GPU, no run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(_cfg(Config, root))
