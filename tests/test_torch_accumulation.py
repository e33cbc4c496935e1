"""Gradient accumulation (``accumulation_step`` k > 1) in the port's train
step and runner, against the JAX runner's ``optax.MultiSteps`` on the CPU:

- IDRec (k = 2) and text MoRec (BERT 2 layers, width 24; k = 3), float32,
  dropout 0, the JAX weights loaded into the port, the same batches: after
  every micro-step the losses agree within 1e-5 relative (the runner parity
  test's tolerance), the window's running mean of the gradients agrees
  with MultiSteps' acc_grads (1e-4 of each one's scale, at least 1e-3 of
  the largest), the parameters do
  not change between updates in either package (bit for bit), and after
  each update they agree within 3 * lr (AdamW's first steps move an
  element by about lr whatever the size of its gradient);
- a checkpoint in the middle of a window: a fresh trainer that loads it
  continues bit for bit as the straight run (bf16, dropout 0.1);
- BCE with sampled negatives and DSSM, whose losses are means over users
  (each half of the batch with as many valid positions): the mean of two
  micro-steps' gradients is one step's on the two halves together, to
  float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.data import preprocess as jpre
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.parallel.mesh import make_mesh
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.train import checkpoint as tckpt
from idvs.morec_tpu_torch.train.state import make_train_state
from idvs.morec_tpu_torch.train.step import make_train_step

from tests.test_torch_config_data import _tokenizer
from tests.test_torch_runner import (BERT, _cfg, _port, _run_epoch,
                                     _same_weights, _text_bundle,
                                     jit_jax_init)
from tests.test_train_integration import quiet_log, synth_dataset

LOSS_RTOL, MEAN_TOL, LR = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    jit_jax_init(monkeypatch)


def _jax_trainer(root, item_tower, **kw):
    jbundle = None
    if item_tower == "modal":
        jbundle = (JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                                embedding_dim=16, word_embedding_dim=24),
                   None, set(), 24)
    jtr = JTrainer(_cfg(JConfig, root, item_tower=item_tower, **kw),
                   quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    if item_tower == "modal":   # the JAX runner reads its tokenizer from files
        base = root + "TINY/"
        items = jpre.read_items_tokenized(base + "news.tsv", jtr.cfg,
                                          _tokenizer)
        bd = jpre.read_behaviors(base + "behaviors.tsv", *items, 8, 3)
        jtr.set_data(bd, jpre.build_doc_matrix(bd.item_id_to_dic, jtr.cfg))
    else:
        jtr.load_data()
    jtr.build_model()
    return jtr


def _torch_tree(tree) -> dict:
    """A Flax 'params' tree (parameters, or gradients shaped as them) by the
    port's parameter names."""
    return convert.from_flax({"params": jax.tree.map(np.asarray, tree)})


@pytest.mark.parametrize("item_tower,k", [("id", 2), ("modal", 3)])
def test_accumulation_matches_multisteps(tmp_path, monkeypatch, item_tower,
                                         k):
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=96, n_items=40)
    kw = dict(compute_dtype="float32", drop_rate=0.0, accumulation_step=k,
              lr=LR)
    jtr = _jax_trainer(root, item_tower, **kw)
    tr = _port(root, _text_bundle() if item_tower == "modal" else None,
               item_tower=item_tower, **kw)
    convert.load_flax(tr.model, jtr.state.params)
    params = dict(tr.model.named_parameters())
    steps = 0
    for raw in jtr.batcher.epoch(1):
        before = {n: p.detach().clone() for n, p in params.items()}
        jbefore = jax.tree.map(np.array, jtr.state.params)  # donated
        jtr.state, jloss = jtr.train_step(jtr.state, jtr.make_batch(raw))
        loss = tr.train_step(tr.state, tr.make_batch(raw)).item()
        steps += 1
        np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
        ms = jtr.state.opt_state
        assert int(ms.mini_step) == tr.state.micro_step == steps % k
        if steps % k:
            for n, p in params.items():
                assert torch.equal(p, before[n]), n
            assert all(jax.tree.leaves(jax.tree.map(
                lambda a, b: bool((a == np.asarray(b)).all()), jbefore,
                jtr.state.params)))
            want = _torch_tree(ms.acc_grads)
            assert tr.state.grad_mean.keys() == want.keys()
            top = max(w.abs().max().item() for w in want.values())
            for n, g in tr.state.grad_mean.items():
                # a floor for gradients that are rounding noise on both
                # sides (a key bias: the softmax ignores a row's shift)
                scale = max(want[n].abs().max().item(), 1e-3 * top)
                err = (g - want[n]).abs().max().item()
                assert err <= MEAN_TOL * scale, (n, err, scale)
        else:
            assert tr.state.grad_mean == {}
            got = _torch_tree(jtr.state.params["params"])
            for n, p in params.items():
                np.testing.assert_allclose(p.detach().numpy(),
                                           got[n].numpy(), atol=3 * LR,
                                           err_msg=n)
    assert steps >= 2 * k and tr.state.step == steps
    # AdamW's count: one update a window
    opt = tr.state.optimizer
    counts = {int(opt.state[p]["step"]) for p in params.values()
              if p in opt.state}
    assert counts == {steps // k}


def test_resume_in_the_middle_of_a_window(tmp_path, monkeypatch):
    """k = 4, dropout 0.1, bf16: one epoch and one more straight against one
    epoch, a checkpoint with the window part-way through (the epoch's
    steps are no multiple of 4), a fresh trainer loading it and the same
    second epoch; the losses and the weights are the same bits."""
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path)
    kw = dict(drop_rate=0.1, accumulation_step=4)
    tr1 = _port(root, **kw)
    _run_epoch(tr1, 1)
    straight = _run_epoch(tr1, 2)

    tr2 = _port(root, **kw)
    _run_epoch(tr2, 1)
    assert tr2.state.micro_step and tr2.state.grad_mean
    path = tckpt.save_checkpoint(str(tmp_path / "ck"), 1, tr2.state)
    tr3 = _port(root, **kw)
    tckpt.load_checkpoint(path, tr3.state)
    assert tr3.state.micro_step == tr2.state.micro_step
    assert tr3.state.grad_mean.keys() == tr2.state.grad_mean.keys()
    for n, g in tr2.state.grad_mean.items():
        assert torch.equal(tr3.state.grad_mean[n], g), n
    resumed = _run_epoch(tr3, 2)
    assert straight == resumed
    _same_weights(tr1.model, tr3.model)


def _grads(model, cfg, batches, k):
    """The gradients the optimizer gets after len(batches) micro-steps of
    an accumulation window of k (the last micro-step applies it)."""
    cfg.accumulation_step = k
    state = make_train_state(model, cfg)
    step = make_train_step(cfg)
    for b in batches:
        step(state, b)
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _halves(batch, key_rows):
    half = len(batch[key_rows]) // 2
    return [{n: v[:half] for n, v in batch.items()},
            {n: v[half:] for n, v in batch.items()}]


@pytest.mark.parametrize("user_tower", ["sasrec", "dssm"])
def test_accumulated_gradient_is_the_concatenated_batch(user_tower):
    items, B, L = 40, 8, 6
    g = torch.Generator().manual_seed(0)
    cfg = Config(loss="bce", user_tower=user_tower, max_seq_len=L,
                 embedding_dim=16, num_attention_heads=2,
                 transformer_block=1, drop_rate=0.0, lr=LR,
                 compute_dtype="float32", dnn_layers=1, neg_num=2)
    if user_tower == "sasrec":
        ids = torch.randint(1, items + 1, (B, L + 1), generator=g)
        # both halves with as many valid positions: the loss's mean over
        # them is then the mean of the halves' means
        lm = (torch.arange(L)[None] >= torch.tensor(
            [0, 2, 3, 5] * 2)[:, None]).float()
        batch = {"ids": ids, "log_mask": lm,
                 "neg_ids": torch.randint(1, items + 1, (B, L + 1),
                                          generator=g)}
        key = "ids"
    else:
        batch = {"users": torch.randint(1, 21, (B,), generator=g),
                 "items": torch.randint(1, items + 1, (B, 3), generator=g),
                 "labels": torch.tensor([[1.0, 0.0, 0.0]] * B)}
        key = "users"
    model = make_model(cfg, items, user_num=20, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    twin = make_model(cfg, items, user_num=20, device="cpu")
    twin.load_state_dict(model.state_dict())
    one = _grads(model, cfg, [batch], 1)
    two = _grads(twin, cfg, _halves(batch, key), 2)
    for n, want in one.items():
        scale = max(want.abs().max().item(), 1e-6)
        assert (two[n] - want).abs().max().item() <= 1e-5 * scale, n
