"""The vision training slice end to end on the CPU: the port's train step
over a tiny Swin tower (image 32, embed 32, depths (2, 2), heads (2, 4),
window 4) under SASRec (D = 32) against the JAX package's make_train_step
on a one-device mesh, with the Flax ``init`` tree carried over by
convert.from_flax and uint8 images shipped with each batch, as
``batch["content"]`` (every slot) or as ``uniq_ids`` / ``inverse`` /
``uniq_content``. Float32, DropPath and dropout 0 for the parity:

- each loss within 1e-5 relative;
- the first step's gradients within rtol 2e-4 / atol 2e-5 (the JAX kernel
  tests' gradient tolerance);
- the parameters after three steps within 3 * lr absolute, the bound on
  AdamW's moves in three steps, in case a near-zero gradient flips sign.

Then the port's own promises: encoder chunks and rematerialisation change no
gradient beyond float32 round-off (1e-6 on a scale of max(1, max |g|)), the
recomputation draws the masks of the first forward (bit-equal gradients with
and without ``checkpoint``), DropPath drops whole images, and the vision
model's optimizer groups.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from idvs.morec_tpu.train import state as jstate
from idvs.morec_tpu.train.step import make_train_step as jax_train_step
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.layers import DropPath, drop_path_scale
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp_plain,
                                               fused_mlp_res_plain)
from idvs.morec_tpu_torch.train import step as step_module
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

from test_torch_train import _keep_grads, _state_dict

ITEMS, B, L, D, STEPS, POOL, CAP = 30, 4, 6, 32, 3, 8, 16
LR, FT_LR = 1e-3, 5e-4
SWIN = dict(image_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=4)


def _config(**kw):
    base = dict(item_tower="modal", modality="vision", loss="inbatch_ce",
                max_seq_len=L, embedding_dim=D, batch_size=B,
                num_attention_heads=2, transformer_block=2,
                compute_dtype="float32", drop_rate=0.0, lr=LR,
                fine_tune_lr=FT_LR)
    base.update(kw)
    return Config(**base)


def _data(mode):
    """STEPS batches; mode "content": an image for every slot; "uniq": the
    dedup triple with the unique items' images."""
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(POOL, 32, 32, 3), dtype=np.uint8)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(1, 12, size=(B, L + 1))    # items repeat
        lm = np.ones((B, L), np.float32)
        for b, pad in enumerate(rng.integers(0, L, size=B)):
            lm[b, :pad] = 0.0
            ids[b, :pad] = 0
        batch = {"ids": ids, "log_mask": lm}
        if mode == "uniq":
            batch["uniq_ids"], batch["inverse"] = dedup_pack(ids, CAP)
            batch["uniq_content"] = pool[batch["uniq_ids"] % POOL]
        else:
            batch["content"] = pool[ids.ravel() % POOL]
        batches.append(batch)
    return pool, np.log(pop).astype(np.float32), batches


def _tower(drop_path=0.0, kernels="band"):
    sc = SwinConfig(drop_path_rate=drop_path, **SWIN)
    return VisionTower(SwinModel(sc, kernels=kernels, device="cpu"), "swin",
                       D, sc.num_features, device="cpu")


@pytest.fixture(scope="module")
def flax_init():
    """The JAX RecModel over the tiny tower (DropPath 0) and its init tree,
    every leaf perturbed (biases and the bias tables are zero or tiny at
    init)."""
    cfg = _config()
    jc = jswin.SwinConfig(drop_path_rate=0.0, **SWIN)
    jenc = JaxVisionTower(net=jswin.SwinModel(jc), kind="swin",
                          embedding_dim=D, feature_dim=jc.num_features)
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=jenc)
    rng = np.random.default_rng(1)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.ones((2, L + 1), jnp.int32),
                         jnp.zeros((2 * (L + 1), 32, 32, 3), jnp.uint8),
                         jnp.ones((2, L)))
    v = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), v)
    return jm, v


def _torch_model(params, cfg, **tower):
    tm = make_model(cfg, ITEMS, _tower(**tower), device="cpu")
    tm.load_state_dict(convert.from_flax(params))
    return tm


def _jax_run(cfg, log_pop, batches, jm, params, tx):
    mesh = make_mesh(jax.devices("cpu")[:1])
    p = replicate(mesh, params)
    # the whole state replicated as the step returns it: the later steps
    # reuse the first one's compilation
    state = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    step = jax_train_step(jm, cfg, tx, mesh, log_pop=jnp.asarray(log_pop))
    states, losses = [], []
    for raw in batches:
        dev = {"ids": jnp.asarray(raw["ids"], jnp.int32),
               "log_mask": jnp.asarray(raw["log_mask"])}
        if "content" in raw:
            dev["content"] = jnp.asarray(raw["content"])
        batch = shard_batch(mesh, dev)
        if "uniq_ids" in raw:
            batch["uniq_ids"] = jnp.asarray(raw["uniq_ids"], jnp.int32)
            batch["inverse"] = jnp.asarray(raw["inverse"], jnp.int32)
            batch["uniq_content"] = jnp.asarray(raw["uniq_content"])
        state, loss = step(state, batch)
        losses.append(float(loss))
        states.append(state)
    return states, losses


def _torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.parametrize("mode", ["content", "uniq"])
def test_vision_train_step_matches_jax(flax_init, mode):
    jm, params = flax_init
    cfg = _config(dedup_items=mode == "uniq",
                  dedup_cap=CAP if mode == "uniq" else 0)
    _, log_pop, batches = _data(mode)
    labels = jstate.param_labels(params["params"],
                                 jstate.default_encoder_predicate, set())
    j_states, j_losses = _jax_run(
        cfg, log_pop, batches, jm, params,
        _keep_grads(jstate.make_optimizer(cfg, labels)))
    j_grads = _state_dict(j_states[0].opt_state[0])

    tm = _torch_model(params, cfg)
    state = make_train_state(tm, cfg, param_labels(tm))
    step = make_train_step(cfg, log_pop=torch.from_numpy(log_pop))
    for i, raw in enumerate(batches):
        loss = step(state, _torch_batch(raw)).item()
        np.testing.assert_allclose(loss, j_losses[i], rtol=1e-5)
        if i == 0:
            assert any("relative_position_bias_table" in n
                       for n, _ in tm.named_parameters())
            for name, p in tm.named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), j_grads[name].numpy(), rtol=2e-4,
                    atol=2e-5, err_msg=name)
    assert state.step == STEPS
    final = _state_dict(j_states[-1].params)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=3 * max(LR, FT_LR),
                                   err_msg=name)


def _one_step_grads(params, cfg, raw, log_pop, seed=5, **tower):
    tm = _torch_model(params, cfg, **tower)
    state = make_train_state(tm, cfg, param_labels(tm), seed=seed)
    loss = make_train_step(cfg, log_pop=torch.from_numpy(log_pop))(
        state, _torch_batch(raw)).item()
    return loss, {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("kw", [dict(encoder_chunk=4), dict(encoder_chunk=8),
                                dict(remat_encoder=True),
                                dict(encoder_chunk=5)])   # 5 does not divide
def test_chunks_and_remat_change_no_gradient(flax_init, kw):
    """At DropPath and dropout 0 the chunked, rematerialised step gives the
    unchunked step's loss and gradients to float32 round-off (the tower's
    matmuls see other batch sizes)."""
    _, params = flax_init
    _, log_pop, batches = _data("uniq")
    base_loss, base = _one_step_grads(params, _config(dedup_cap=CAP),
                                      batches[0], log_pop)
    loss, grads = _one_step_grads(params, _config(dedup_cap=CAP, **kw),
                                  batches[0], log_pop)
    np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
    for name, g in grads.items():
        scale = max(1.0, base[name].abs().max().item())
        assert (g - base[name]).abs().max().item() <= 1e-6 * scale, name


@pytest.mark.parametrize("kernels", ["band", "windows"])
def test_recompute_sees_the_masks_of_the_first_forward(flax_init, kernels,
                                                       monkeypatch):
    """DropPath 0.2 and dropout 0.1: the checkpointed chunks' gradients are
    bit-equal to those of the same chunked forward without ``checkpoint``
    (every seed the recomputation draws is the first forward's), and another
    generator seed gives other gradients."""
    _, params = flax_init
    _, log_pop, batches = _data("uniq")
    cfg = _config(dedup_cap=CAP, encoder_chunk=4, drop_rate=0.1)
    tower = dict(drop_path=0.2, kernels=kernels)
    loss, grads = _one_step_grads(params, cfg, batches[0], log_pop, **tower)
    other_loss, _ = _one_step_grads(params, cfg, batches[0], log_pop, seed=6,
                                    **tower)
    assert loss != other_loss
    calls = []

    def plain_call(fn, *args, **kwargs):
        calls.append(kwargs)
        return fn(*args)

    monkeypatch.setattr(step_module, "checkpoint", plain_call)
    want_loss, want = _one_step_grads(params, cfg, batches[0], log_pop,
                                      **tower)
    assert len(calls) == CAP // 4 and not calls[0]["use_reentrant"]
    assert loss == want_loss
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


def test_drop_path_drops_whole_images():
    """Training mode: a mask per image with values in {0, 1 / keep}, mean
    within 5 standard errors of 1 (4096 draws at keep 0.8: 5 * 0.0078), the
    same seed the same mask; eval mode and rate 0: the identity."""
    dp = DropPath(0.2).train()
    x = torch.ones(4096, 3, 5)
    out = dp(x, torch.Generator().manual_seed(3))
    rows = out.reshape(4096, -1)
    assert (rows == rows[:, :1]).all()
    assert set(rows[:, 0].tolist()) == {0.0, 1.25}
    assert abs(rows[:, 0].mean().item() - 1.0) <= 5 * 0.0078
    again = dp(x, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert not torch.equal(out, dp(x, torch.Generator().manual_seed(4)))
    scale = dp.scale(4096, torch.Generator().manual_seed(3))
    assert torch.equal(scale, rows[:, 0])
    assert torch.equal(drop_path_scale(11, 64, 0.2),
                       drop_path_scale(11, 64, 0.2))
    assert dp.eval()(x) is x and dp.scale(4, None) is None
    assert DropPath(0.0).train()(x) is x
    with pytest.raises(ValueError):
        dp.train()(x)                      # no generator to draw from


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_mlp_res_plain_is_x_plus_scale_times_the_mlp(dtype):
    rng = np.random.default_rng(4)
    t = lambda *s, k=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * k).to(dtype)
    x = t(3, 16, 32)
    ws = (t(32, 128, k=32 ** -0.5), t(128, k=0.1), t(128, 32, k=128 ** -0.5),
          t(32, k=0.1))
    ln = (1.0 + 0.1 * t(32).float(), 0.1 * t(32).float())
    scale = drop_path_scale(7, 3, 0.5)[:, None].expand(3, 16).reshape(-1)
    assert 0 < int((scale == 0).sum()) < 48
    got = fused_mlp_res_plain(x, scale, *ws, ln=ln)
    # the kernel's float32 sum, cast once: in bf16 the two-step sum below
    # rounds the MLP first, so one bf16 unit of the result (2^-7 relative)
    mlp = fused_mlp_plain(x, *ws, ln=ln).float()
    want = (x.float() + scale.reshape(3, 16, 1) * mlp).to(dtype)
    tol = 1e-6 if dtype == torch.float32 else 4e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    dropped = scale.reshape(3, 16)[:, 0] == 0
    assert torch.equal(got[dropped], x[dropped])


def test_vision_optimizer_groups(flax_init):
    """encoder.classifier.* trains with the recsys group at lr, encoder.net.*
    with the encoder group at fine_tune_lr, as the JAX package labels
    them."""
    _, params = flax_init
    cfg = _config()
    tm = _torch_model(params, cfg)
    labels = param_labels(tm)
    jlabels = jstate.param_labels(params["params"],
                                  jstate.default_encoder_predicate, set())
    want = {".".join(path[:-1] + (convert._TO_TORCH.get(path[-1], path[-1]),)):
            label for path, label in convert._flatten(jlabels)}
    assert labels == want
    assert labels["encoder.classifier.weight"] == "recsys"
    assert labels["encoder.classifier.bias"] == "recsys"
    table = "encoder.net.stage_0_block_0.relative_position_bias_table"
    assert labels[table] == "encoder"
    assert all(v == "encoder" for k, v in labels.items()
               if k.startswith("encoder.net."))
    assert all(v == "recsys" for k, v in labels.items()
               if not k.startswith("encoder.net."))
    opt = make_train_state(tm, cfg, labels).optimizer
    by_lr = {g["lr"]: len(g["params"]) for g in opt.param_groups}
    n_enc = sum(v == "encoder" for v in labels.values())
    assert by_lr == {FT_LR: n_enc, LR: len(labels) - n_enc}
