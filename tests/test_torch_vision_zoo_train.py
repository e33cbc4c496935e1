"""The other vision encoders in the port's training slice, on the CPU
against the JAX package:

- one end2end in-batch CE train step of ``RecModel`` per encoder (ResNet-18
  with its BatchNorm on 16 x 16 images, ViT-MAE with the masking noise
  injected into both packages, BEiT, CLIP-ViT; hidden 64, 2 layers,
  32 x 32 images, patch 8)
  under SASRec (D = 16), with dedup, against the JAX ``make_train_step``
  on a one-device mesh: the loss within 1e-5 relative, every gradient
  within rtol 2e-4 / atol 2e-5 (as tests/test_torch_train.py), the
  BatchNorm running averages after the step within 1e-5; the weights come
  from the port's draw carried into the Flax tree by ``convert.to_flax``;
- a BatchNorm tower takes no encoder chunk (its running averages update
  once a step);
- the two-stage cache of each kind through the runner's
  ``_encode_catalog``;
- the names ``freeze_paras_before`` freezes for every encoder name at
  several indices against the JAX package's ``*_frozen_paths``, and the
  CLI's bundle (``load_encoder``) at both stages;
- ``count_params``: parameters only (the running averages are buffers and
  in no optimizer group), as the JAX runner counts the ``params``
  collection;
- a checkpoint with BatchNorm buffers saved after a step and resumed: the
  buffers, and the next step, bit-equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import beit as jbeit
from idvs.morec_tpu.models import clip_vit as jclip
from idvs.morec_tpu.models import resnet as jresnet
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models import vit_mae as jmae
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config as PortConfig
from idvs.morec_tpu_torch.models.beit import BeitConfig, BeitModel
from idvs.morec_tpu_torch.models.clip_vit import (CLIPVisionConfig,
                                                  CLIPVisionModel)
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.resnet import ResNet
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.models.vit_mae import ViTMAEConfig, ViTMAEModel
from idvs.morec_tpu_torch.train import runner
from idvs.morec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from idvs.morec_tpu_torch.train.state import (count_params, make_train_state,
                                              param_labels)
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

from test_torch_train import _keep_grads
from test_torch_vision_zoo import perturbed, same_noise  # noqa: F401

ITEMS, B, L, D, POOL, CAP, IMG = 30, 4, 6, 16, 8, 16, 32
# the ResNet's images: 16 x 16 keeps every stage (1 x 1 from stage 3 on)
# at a quarter of the CPU's work
RES_IMG = 16
LR, FT_LR = 1e-3, 5e-4
VIT = dict(image_size=IMG, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128)
ENCODERS = ("resnet", "mae", "beit", "clip")


def _towers(name, project=True):
    """(Flax tower, port tower) of one encoder."""
    if name == "resnet":
        return (JaxVisionTower(net=jresnet.ResNet(arch="resnet18",
                                                  out_dim=D),
                               kind="resnet", embedding_dim=D, feature_dim=D,
                               project=project),
                VisionTower(ResNet("resnet18", D, device="cpu"), "resnet", D,
                            D, project, device="cpu"))
    jc, jn, pc, pn, kind = {
        "mae": (jmae.ViTMAEConfig, jmae.ViTMAEModel, ViTMAEConfig,
                ViTMAEModel, "mae"),
        "beit": (jbeit.BeitConfig, jbeit.BeitModel, BeitConfig, BeitModel,
                 "swin"),
        "clip": (jclip.CLIPVisionConfig, jclip.CLIPVisionModel,
                 CLIPVisionConfig, CLIPVisionModel, "swin")}[name]
    return (JaxVisionTower(net=jn(jc(**VIT)), kind=kind, embedding_dim=D,
                           feature_dim=64, project=project),
            VisionTower(pn(pc(**VIT), device="cpu"), kind, D, 64, project,
                        device="cpu"))


def _config(cls=Config, **kw):
    base = dict(item_tower="modal", modality="vision", loss="inbatch_ce",
                max_seq_len=L, embedding_dim=D, batch_size=B,
                num_attention_heads=2, transformer_block=1,
                compute_dtype="float32", drop_rate=0.0, lr=LR,
                fine_tune_lr=FT_LR, dedup_items=True, dedup_cap=CAP)
    base.update(kw)
    return cls(**base)


def _batch(seed=0, img=RES_IMG):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, size=(POOL, img, img, 3), dtype=np.uint8)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    ids = rng.integers(1, 12, size=(B, L + 1))
    lm = np.ones((B, L), np.float32)
    for b, pad in enumerate(rng.integers(0, L, size=B)):
        lm[b, :pad] = 0.0
        ids[b, :pad] = 0
    uniq, inverse = dedup_pack(ids, CAP)
    batch = {"ids": ids, "log_mask": lm, "uniq_ids": uniq,
             "inverse": inverse, "uniq_content": pool[uniq % POOL]}
    return batch, np.log(pop).astype(np.float32)


def _port_model(name, seed=0):
    model = make_model(_config(PortConfig), ITEMS, _towers(name)[1],
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    return model


@pytest.fixture(scope="module")
def resnet_models():
    """Two ResNet-18 models drawn from seeds 0 and 5, each test taking
    copies: the draw of 11 M parameters once."""
    return {seed: _port_model("resnet", seed) for seed in (0, 5)}


def _wide_batch(raw, log_pop, xp, dtype):
    """The batch with the images normalised (ToTensor + Normalize(.5, .5))
    and the float inputs in ``dtype``, for array module ``xp``."""
    out = dict(raw)
    out["uniq_content"] = (raw["uniq_content"].astype(np.float64) / 255.0
                           - 0.5) / 0.5
    out = {k: (xp.asarray(v, dtype=dtype) if v.dtype.kind == "f"
               else xp.asarray(v)) for k, v in out.items()}
    return out, xp.asarray(log_pop, dtype=dtype)


@pytest.mark.parametrize("name", ENCODERS)
def test_train_step_matches_jax(same_noise, name):  # noqa: F811
    """In float32, but ResNet-18 in float64 on both sides: its batch
    statistics over 16 images, 1 x 1 at the last stage, amplify float32's
    rounding, and the JAX step's float32 loss lies 1.6e-5 (relative) from
    its float64 one, the port's 1.8e-6."""
    wide = name == "resnet"
    raw, log_pop = _batch(img=RES_IMG if wide else IMG)
    tm = _port_model(name)
    variables = perturbed(convert.to_flax(tm))
    tm.load_state_dict(convert.from_flax(variables))
    with jax.enable_x64(wide):
        cfg = _config()
        if wide:
            variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     variables)
            batch, jlog_pop = _wide_batch(raw, log_pop, jnp, jnp.float64)
        else:
            batch = {k: jnp.asarray(v) for k, v in raw.items()}
            jlog_pop = jnp.asarray(log_pop)
        jm = jax_make_model(cfg, item_num=ITEMS, encoder=_towers(name)[0])
        labels = jstate.param_labels(variables["params"],
                                     jstate.default_encoder_predicate, set())
        tx = _keep_grads(jstate.make_optimizer(cfg, labels))
        mesh = make_mesh(jax.devices("cpu")[:1])
        p = replicate(mesh, variables)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                                  opt_state=tx.init(p["params"]),
                                  dropout_rng=jax.random.PRNGKey(1))
        jstep = jax_train_step(jm, cfg, tx, mesh, log_pop=jlog_pop)
        state, jloss = jstep(state, batch)
        jgrads = convert.from_flax(jax.tree.map(np.asarray,
                                                state.opt_state[0]))
        jstats = jax.tree.map(np.asarray, state.params.get("batch_stats",
                                                           {}))
        jloss = float(jloss)
    if wide:
        tm = tm.double()
        tbatch, tlog_pop = _wide_batch(raw, log_pop, torch, torch.float64)
    else:
        tbatch = {k: torch.from_numpy(v) for k, v in raw.items()}
        tlog_pop = torch.from_numpy(log_pop)

    ts = make_train_state(tm, cfg, param_labels(tm))
    before = {n: b.clone() for n, b in tm.named_buffers()}
    step = make_train_step(cfg, log_pop=tlog_pop)
    loss = step(ts, tbatch).item()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for n, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), jgrads[n].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=n)
    stats = convert.from_flax({"batch_stats": jstats})
    buffers = dict(tm.named_buffers())
    assert set(stats) == {n for n in buffers if n in tm.state_dict()}
    assert bool(stats) == (name == "resnet")
    assert all(not torch.equal(buffers[n], before[n]) for n in stats)
    for n, want in stats.items():
        np.testing.assert_allclose(buffers[n].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_batch_norm_tower_takes_no_chunks(monkeypatch, resnet_models):
    """encoder_chunk and remat_encoder leave a BatchNorm tower in one piece:
    no checkpoint, the running averages updated once, and the step equal
    to the unchunked one."""
    raw, log_pop = _batch()
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    results = []
    for kw in ({}, dict(encoder_chunk=4), dict(remat_encoder=True)):
        tm = copy.deepcopy(resnet_models[0])
        cfg = _config(PortConfig, **kw)
        ts = make_train_state(tm, cfg, param_labels(tm))
        called = []
        monkeypatch.setattr("idvs.morec_tpu_torch.train.step.checkpoint",
                            lambda *a, **k: called.append(1))
        loss = make_train_step(cfg, log_pop=torch.from_numpy(log_pop))(
            ts, batch)
        assert not called
        results.append((loss, dict(tm.state_dict())))
    for loss, sd in results[1:]:
        assert torch.equal(loss, results[0][0])
        for n, t in sd.items():
            assert torch.equal(t, results[0][1][n]), n


@pytest.mark.parametrize("name", ["resnet", "mae", "clip"])
def test_two_stage_cache_is_the_raw_tower(name):
    """The runner's cache (``Trainer._encode_catalog``) through a
    ``project=False`` tower is the tower's eval-mode output chunk by chunk
    (tests/test_torch_vision_zoo.py holds those raw features against the
    Flax tower's), row 0 zero."""
    tower = _towers(name, project=False)[1]
    img = RES_IMG if name == "resnet" else IMG
    pool = np.random.default_rng(3).integers(0, 256, (5, img, img, 3),
                                             dtype=np.uint8)
    tr = runner.Trainer.__new__(runner.Trainer)
    tr.cfg, tr.device = _config(PortConfig, item_emb_batch_size=4,
                                stage="two_stage"), torch.device("cpu")
    cache = tr._encode_catalog((tower, None, set(), D), pool.__getitem__, 4)
    with torch.no_grad():
        want = torch.cat([tower.eval()(torch.from_numpy(pool[ids]))
                          for ids in ([0, 1, 2, 3], [4, 4, 4, 4])])
    want[0] = 0.0
    assert torch.equal(cache, want[:5])
    assert tr.cfg.word_embedding_dim == D


FROZEN_CASES = [("resnet18", jresnet.resnet_frozen_paths, "resnet18"),
                ("resnet50", jresnet.resnet_frozen_paths, "resnet50"),
                ("resnet152", jresnet.resnet_frozen_paths, "resnet152"),
                ("swin_tiny", jswin.swin_frozen_paths, jswin.SwinConfig()),
                ("swin_base", jswin.swin_frozen_paths,
                 jswin.SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                                  num_heads=(4, 8, 16, 32))),
                ("vit_mae", jmae.vit_mae_frozen_paths, jmae.ViTMAEConfig()),
                ("beit_base", jbeit.beit_frozen_paths, jbeit.BeitConfig()),
                ("clip_vit", jclip.clip_frozen_paths,
                 jclip.CLIPVisionConfig())]


@pytest.mark.parametrize("name,jax_paths,jax_cfg", FROZEN_CASES,
                         ids=[c[0] for c in FROZEN_CASES])
def test_frozen_names_match_jax(name, jax_paths, jax_cfg):
    """The CLI's bundle freezes, at several indices, the JAX package's
    frozen paths under their port names, each a parameter of the tower;
    a two-stage bundle freezes nothing (its tower is frozen whole)."""
    for n in (0, 1, 3, 50, 10_000):
        cfg = PortConfig(item_tower="modal", modality="vision",
                         cv_model_load=name, embedding_dim=D,
                         freeze_paras_before=n)
        tower, state, frozen, width = runner.load_encoder(cfg, "meta")
        want = convert.frozen_names(jax_paths(jax_cfg, n,
                                              prefix=("encoder", "net")))
        assert frozen == want and state is None and width == D
        names = {"encoder." + k for k, _ in tower.named_parameters()}
        assert frozen <= names
        if n == 10_000:
            # every parameter of the net but a ResNet's fc
            assert frozen == {k for k in names
                              if k.startswith("encoder.net.")
                              and ".fc." not in k}
        cfg.stage = "two_stage"
        assert runner.load_encoder(cfg, "meta")[2] == set()


def test_count_params_and_optimizer_leave_out_running_averages(
        resnet_models):
    tm = copy.deepcopy(resnet_models[0])
    flax = convert.to_flax(tm)
    total = sum(a.size for a in jax.tree.leaves(flax["params"]))
    stats = sum(a.size for a in jax.tree.leaves(flax["batch_stats"]))
    assert stats > 0
    frozen = convert.frozen_names(jresnet.resnet_frozen_paths(
        "resnet18", 6, prefix=("encoder", "net")))
    labels = param_labels(tm, frozen=frozen)
    n_frozen = sum(p.numel() for k, p in tm.named_parameters()
                   if k in frozen)
    assert count_params(tm, labels) == {"total": total,
                                        "trainable": total - n_frozen}
    opt = make_train_state(tm, _config(PortConfig), labels).optimizer
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not held & {id(b) for b in tm.buffers()}
    assert len(held) == len(labels) - len(frozen)


def test_checkpoint_round_trip_keeps_running_averages(tmp_path,
                                                     resnet_models):
    """A step, a save, a fresh model resumed from the file: the running
    averages and every parameter bit-equal, and the next step too."""
    raw, log_pop = _batch()
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    cfg = _config(PortConfig)
    step = make_train_step(cfg, log_pop=torch.from_numpy(log_pop))
    tm = copy.deepcopy(resnet_models[0])
    ts = make_train_state(tm, cfg, param_labels(tm))
    step(ts, batch)
    path = save_checkpoint(str(tmp_path), 1, ts)
    back = make_train_state(copy.deepcopy(resnet_models[5]), cfg,
                            param_labels(tm))
    load_checkpoint(path, back)
    for (n, a), b in zip(tm.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(a, b), n
    raw2, _ = _batch(seed=1)
    batch2 = {k: torch.from_numpy(v) for k, v in raw2.items()}
    assert torch.equal(step(ts, batch2), step(back, batch2))
    for (n, a), b in zip(tm.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(a, b), n
