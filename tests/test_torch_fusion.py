"""ID+modality fusion (reference bce_text/id_plus_mo-end2end) in the port,
against the JAX package on the CPU:

- ``FCLayers`` (dnn_layers 0 and 2), ``AddFusion`` and ``CatFusion``
  (n_layers 1 and 3) against their Flax twins within 2e-5, the weights
  carried by ``convert.py`` both ways; a bf16 and a float32 operand fuse
  in float32 on both sides;
- ``RecModel.item_embs`` end2end for ``modal_id_add``, ``modal_id_cat`` and
  ``modal_cat_3`` (``cat_layers`` 3) over a tiny BERT, under SASRec and
  under DSSM, and ``modal_id_add`` over a tiny Swin, against
  ``RecModel.apply(..., method="item_embs")`` within 2e-5; ``to_flax``
  gives back the Flax tree;
- the optimizer groups: the encoder group holds ``encoder.net`` alone, the
  fusion MLP and the ID table are recsys, as the JAX labels say;
- five float32 BCE train steps at dropout 0 against the JAX
  ``make_train_step`` for add, cat and cat_3 (tests/test_torch_train.py's
  tolerances: the losses within 1e-5 relative, the first step's gradients
  within rtol 2e-4 / atol 2e-5, the weights after the steps within
  3 * lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models import layers as jlayers
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.layers import AddFusion, CatFusion, FCLayers
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.train.state import (ENCODER_LABEL, RECSYS_LABEL,
                                              make_train_state, param_labels)
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

from tests.test_torch_train import _keep_grads, _state_dict

TOL = 2e-5
ITEMS, B, L, D, T, STEPS = 30, 4, 6, 32, 8, 5
LR, FT_LR = 1e-3, 5e-4
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SWIN = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4)
# item tower (the launchers' spelling) -> the Config's fields
TOWERS = {"add": dict(item_tower="modal_id_add"),
          "cat": dict(item_tower="modal_id_cat"),
          "cat_3": dict(item_tower="modal_id_cat", cat_layers=3)}


def _numpy(tree, rng, jitter=0.05):
    """numpy leaves, each perturbed (biases are zero at init)."""
    return jax.tree.map(lambda a: np.asarray(a) + jitter * rng.standard_normal(
        a.shape).astype(np.float32), tree)


def _same_tree(got, want):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[k], np.asarray(w), err_msg=str(k))


@pytest.mark.parametrize("case", ["fc0", "fc2", "add", "cat1", "cat3"])
def test_fusion_layers_match_flax(case):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    a, b = (rng.normal(size=(5, 16)).astype(np.float32) for _ in range(2))
    if case.startswith("fc"):
        n = int(case[2:])
        jm, tm = (jlayers.FCLayers(24, 16, n, 0.0),
                  FCLayers(24, 16, n, 0.0, device="cpu"))
        args = (x,)
    elif case == "add":
        jm, tm, args = jlayers.AddFusion(), AddFusion(), (a, b)
    else:
        n = int(case[3:])
        jm, tm = (jlayers.CatFusion(16, 0.0, n_layers=n),
                  CatFusion(16, 0.0, n, device="cpu"))
        args = (a, b)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    if "params" in v:
        v = {"params": _numpy(v["params"], rng)}
        tm.load_state_dict(convert.from_flax(v), strict=True)
        _same_tree(convert.to_flax(tm)["params"], v["params"])
    want = jax.jit(jm.apply)(v, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(t) for t in args))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if len(args) == 2:
        # a bf16 ID row and a float32 modal vector fuse in float32
        jb = jm.apply(v, jnp.asarray(a, jnp.bfloat16), jnp.asarray(b))
        with torch.no_grad():
            tb = tm(torch.from_numpy(a).bfloat16(), torch.from_numpy(b))
        assert jb.dtype == jnp.float32 and tb.dtype == torch.float32
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL,
                                   atol=TOL)


def _content(rng):
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    return np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att, att],
                          axis=1)


def _text_towers():
    return (JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                         embedding_dim=D, word_embedding_dim=32),
            TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 32,
                      attr_lengths=(T,), device="cpu"))


def _cfg(tower, **kw):
    return Config(**TOWERS[tower], loss="bce", max_seq_len=L,
                  embedding_dim=D, batch_size=B, num_attention_heads=2,
                  transformer_block=1, compute_dtype="float32",
                  drop_rate=0.0, lr=LR, fine_tune_lr=FT_LR,
                  num_words_title=T, **kw)


_INIT = {}


def _fusion_models(tower, user_tower="sasrec"):
    """(cfg, token rows, JAX model, its perturbed init tree, port model with
    that tree loaded) of the text fusion tower."""
    cfg = _cfg(tower, user_tower=user_tower)
    rng = np.random.default_rng(1)
    content = _content(rng)
    jenc, tenc = _text_towers()
    jm = jax_make_model(cfg, item_num=ITEMS, user_num=7, encoder=jenc)
    key = (tower, user_tower)
    if key not in _INIT:
        ids = jnp.asarray(rng.integers(1, ITEMS + 1, (2, L + 1)), jnp.int32)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), ids,
                             jnp.asarray(content[np.asarray(ids).ravel()]),
                             jnp.ones((2, L)))
        _INIT[key] = {"params": _numpy(v["params"], rng, 0.02)}
    params = _INIT[key]
    tm = make_model(cfg, ITEMS, tenc, user_num=7, device="cpu")
    convert.load_flax(tm, params)
    return cfg, content, jm, params, tm


@pytest.mark.parametrize("tower,user_tower", [("add", "sasrec"),
                                              ("cat", "sasrec"),
                                              ("cat_3", "sasrec"),
                                              ("add", "dssm")])
def test_fusion_item_embs_match_flax(tower, user_tower):
    cfg, content, jm, params, tm = _fusion_models(tower, user_tower)
    if tower == "cat_3":
        assert [n for n, _ in tm.fusion.named_parameters()] == [
            f"mlp.Dense_{i}.{w}" for i in range(3) for w in ("weight", "bias")]
    ids = np.array([0, 3, 7, 7, 30, 12])
    want = jax.jit(lambda p, i, c: jm.apply(p, i, c, True,
                                            method="item_embs"))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(content[ids]))
    with torch.no_grad():
        got = tm.item_embs(torch.from_numpy(ids),
                           torch.from_numpy(content[ids]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _same_tree(convert.to_flax(tm)["params"], params["params"])


def test_vision_fusion_item_embs_match_flax():
    """modal_id_add over a tiny Swin: uint8 images, item 0's slot the
    padding item's zero image."""
    cfg = Config(item_tower="modal_id_add", modality="vision", max_seq_len=L,
                 embedding_dim=D, num_attention_heads=2, transformer_block=1,
                 drop_rate=0.0)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    jc = jswin.SwinConfig(**SWIN)
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=JaxVisionTower(
        net=jswin.SwinModel(jc), kind="swin", embedding_dim=D,
        feature_dim=jc.num_features))
    ids = np.array([0, 4, 9, 9, 30, 1])
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.asarray(ids[None], jnp.int32),
                         jnp.asarray(images), jnp.ones((1, 5)))
    params = {"params": _numpy(v["params"], rng, 0.02)}
    sc = SwinConfig(**SWIN)
    tm = make_model(cfg, ITEMS, VisionTower(
        SwinModel(sc, device="cpu"), "swin", D, sc.num_features,
        device="cpu"), device="cpu")
    convert.load_flax(tm, params)
    want = jax.jit(lambda p, i, c: jm.apply(p, i, c, True,
                                            method="item_embs"))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(images))
    with torch.no_grad():
        got = tm.item_embs(torch.from_numpy(ids), torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_fusion_optimizer_groups_match_jax_labels():
    cfg, _, _, params, tm = _fusion_models("cat_3")
    jl = jstate.param_labels(params["params"],
                             jstate.default_encoder_predicate, set())
    want = {convert.flax_name(tuple(k.key for k in path)): lbl
            for path, lbl in jax.tree_util.tree_flatten_with_path(jl)[0]}
    labels = param_labels(tm)
    assert labels == want
    assert {n for n, lb in labels.items() if lb == ENCODER_LABEL} == {
        n for n, _ in tm.named_parameters() if n.startswith("encoder.net.")}
    assert labels["id_embedding.weight"] == RECSYS_LABEL
    assert labels["fusion.mlp.Dense_2.weight"] == RECSYS_LABEL
    state = make_train_state(tm, cfg, labels)
    groups = state.optimizer.param_groups
    assert [(g["lr"], g["weight_decay"]) for g in groups] == [
        (cfg.lr, cfg.l2_weight), (cfg.fine_tune_lr, cfg.fine_tune_l2_weight)]
    by_id = {id(p): n for n, p in tm.named_parameters()}
    assert {by_id[id(p)] for p in groups[1]["params"]} == {
        n for n, lb in labels.items() if lb == ENCODER_LABEL}


def bce_batches(rng, dedup: bool, steps: int = STEPS) -> list:
    """BCE host batches over ITEMS items: ids that repeat, left padding,
    one negative at each valid transition; with dedup one pack over the
    positives and negatives."""
    batches = []
    for _ in range(steps):
        ids = rng.integers(1, 12, size=(B, L + 1))
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
    return batches


def steps_against_jax(cfg, jm, params, tm, content, batches, labels,
                      rtol=1e-5, grad_tol=(2e-4, 2e-5)):
    """The port's train steps against the JAX ``make_train_step``'s on a
    one-device mesh over ``batches``: each loss within ``rtol``, the first
    step's gradients within ``grad_tol`` (rtol, atol), the weights after
    the steps within 3 * max(lr, fine_tune_lr). labels: the port's
    param_labels, None for one group (as the JAX labels)."""
    jlabels = None
    if labels is not None:
        jlabels = jstate.param_labels(params["params"],
                                      jstate.default_encoder_predicate, set())
    tx = _keep_grads(jstate.make_optimizer(cfg, jlabels))
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    jst = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    jstep = jax_train_step(
        jm, cfg, tx, mesh, item_content=jnp.asarray(
            content, jnp.float32 if content.dtype.kind == "f" else jnp.int32))
    state = make_train_state(tm, cfg, labels)
    step = make_train_step(cfg, item_content=torch.from_numpy(content))
    for i, raw in enumerate(batches):
        jst, jloss = jstep(jst, {k: jnp.asarray(v) for k, v in raw.items()})
        loss = step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
        if i == 0:
            grads = _state_dict(jst.opt_state[0])
            for name, q in tm.named_parameters():
                np.testing.assert_allclose(
                    q.grad.numpy(), grads[name].numpy(), rtol=grad_tol[0],
                    atol=grad_tol[1], err_msg=name)
    assert state.step == len(batches)
    final = _state_dict(jst.params)
    for name, q in tm.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=3 * max(LR, FT_LR),
                                   err_msg=name)


@pytest.mark.parametrize("tower,dedup", [("add", True), ("cat", False),
                                         ("cat_3", True)])
def test_fusion_bce_steps_match_jax(tower, dedup):
    cfg, content, jm, params, tm = _fusion_models(tower)
    cfg.dedup_items = dedup
    steps_against_jax(cfg, jm, params, tm, content,
                      bce_batches(np.random.default_rng(3), dedup),
                      param_labels(tm))
