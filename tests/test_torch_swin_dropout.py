"""Swin's two dropouts in training mode on the CPU (the plain versions):

- the window path that dropout of the attention probabilities takes (QKV
  product, ``fused_mha`` with the trainable score bias, output product),
  driven at rate 0 through ``SwinBlock._forward``, against ``jax.grad`` of
  the Flax ``SwinBlock(fused=False)``: output, input gradient and every
  parameter's gradient, the relative position bias table's by name; 2e-5
  on each gradient's scale max(1, max |reference|), as
  tests/test_torch_swin_grad.py;
- at rate 0.1 the block against an independent composition in plain torch
  whose masks come from ``ops/dropout.py`` with the seeds the block draws:
  the same output and gradients to float32 round-off (1e-5);
- a block built with both rates serves in eval mode as the block without;
- chunked and rematerialised encoder steps draw the masks of the first
  forward again with both dropouts on.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.layers import init_parameters, layer_norm
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import (SwinBlock, SwinConfig,
                                              SwinModel, window_partition,
                                              window_reverse)
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.train import step as step_module
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

TOL = 2e-5
GEOM = dict(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4)


def _flax_block(resolution, shift, rng, x):
    jblk = jswin.SwinBlock(jswin.SwinConfig(drop_path_rate=0.0, **GEOM), 32,
                           2, resolution, shift=shift, drop_path=0.0,
                           fused=False)
    params = jax.jit(jblk.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    # biases and the table are zero or tiny at init: perturb every leaf
    return jblk, jax.tree.map(lambda a: np.asarray(a) + 0.1 *
                              rng.standard_normal(a.shape).astype(np.float32),
                              params)


@pytest.mark.parametrize("kernels", ["band", "windows"])
@pytest.mark.parametrize("resolution,shift", [((8, 8), False), ((8, 8), True),
                                              ((10, 6), True)])   # pad path
def test_window_path_matches_flax(resolution, shift, kernels):
    H, W = resolution
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, H * W, 32)).astype(np.float32)
    dout = rng.standard_normal((3, H * W, 32)).astype(np.float32)
    jblk, params = _flax_block(resolution, shift, rng, x)
    want_out = np.asarray(jax.jit(jblk.apply)(params, jnp.asarray(x)))
    loss = lambda p, xx: jnp.sum(jblk.apply(p, xx) * jnp.asarray(dout))
    jg_params, jg_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    want = convert.from_flax(jax.tree.map(np.asarray, jg_params))

    blk = SwinBlock(SwinConfig(drop_path_rate=0.0, **GEOM), 32, 2,
                    resolution, shift=shift, drop_path=0.0, kernels=kernels,
                    device="cpu").train()
    blk.load_state_dict(convert.from_flax(params), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = blk._forward(tx, None, window_path=True)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=TOL,
                               atol=TOL)
    assert "relative_position_bias_table" in want
    for name, p in blk.named_parameters():
        w_ = want[name].numpy()
        scale = max(1.0, np.abs(w_).max())
        assert np.abs(p.grad.numpy() - w_).max() <= TOL * scale, name
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), rtol=0,
                               atol=TOL * max(1.0, np.abs(jg_x).max()))


def _drop(x, seed, p=0.1):
    keep = dropout.keep_mask(seed, x.shape, p)
    return torch.where(keep, x * dropout.scale(p), torch.zeros_like(x)), keep


def _composition(blk, x, seeds):
    """The block's training forward, written out: every mask is
    ops/dropout.py's over the tensor it drops, with the seeds the block
    draws in its order (attention probabilities, attention output, MLP
    output); DropPath off."""
    p = {n: t for n, t in blk.named_parameters()}
    B, L, C = x.shape
    (H, W), w, s, nh = blk.resolution, blk.window, blk.shift, blk.n_heads
    T, dh = w * w, C // nh
    h = layer_norm(x, p["layernorm_before.weight"],
                   p["layernorm_before.bias"], 1e-5).reshape(B, H, W, C)
    if s:
        h = torch.roll(h, (-s, -s), dims=(1, 2))
    wins = window_partition(h, w)
    q, k, v = (wins @ p[f"{n}.weight"] + p[f"{n}.bias"]
               for n in ("query", "key", "value"))
    q, k, v = (t.reshape(-1, T, nh, dh).transpose(1, 2) for t in (q, k, v))
    bias = blk.rel_bias()
    scores = q @ k.transpose(-1, -2) / math.sqrt(dh)
    scores = scores + bias.repeat(scores.shape[0] // bias.shape[0], 1, 1, 1)
    probs, keep = _drop(torch.softmax(scores, -1), seeds[0])
    ctx = (probs @ v).transpose(1, 2).reshape(-1, T, C)
    out = ctx @ p["attention_output.weight"] + p["attention_output.bias"]
    a = window_reverse(out, w, H, W)
    if s:
        a = torch.roll(a, (s, s), dims=(1, 2))
    x = x + _drop(a.reshape(B, L, C), seeds[1])[0]
    h = layer_norm(x, p["layernorm_after.weight"], p["layernorm_after.bias"],
                   1e-5)
    h = torch.nn.functional.gelu(h @ p["intermediate.weight"]
                                 + p["intermediate.bias"])
    h = h @ p["output.weight"] + p["output.bias"]
    return x + _drop(h, seeds[2])[0], keep


@pytest.mark.parametrize("kernels", ["band", "windows"])
@pytest.mark.parametrize("shift", [False, True])
def test_dropouts_are_the_masks_of_ops_dropout(shift, kernels):
    cfg = SwinConfig(hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1, **GEOM)
    blk = SwinBlock(cfg, 32, 2, (8, 8), shift, 0.0, kernels=kernels,
                    device="cpu").train()
    init_parameters(blk, torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.relative_position_bias_table.normal_(0.0, 0.5,
                                                 generator=torch.Generator()
                                                 .manual_seed(1))
    x = torch.randn(8, 64, 32, generator=torch.Generator().manual_seed(2))
    dout = torch.randn(8, 64, 32, generator=torch.Generator().manual_seed(3))
    xk = x.clone().requires_grad_(True)
    got = blk(xk, torch.Generator().manual_seed(7))
    got.backward(dout)
    got_grads = {n: t.grad.clone() for n, t in blk.named_parameters()}
    blk.zero_grad()
    gen = torch.Generator().manual_seed(7)
    seeds = [dropout.draw_seed(gen) for _ in range(3)]
    xw = x.clone().requires_grad_(True)
    want, keep = _composition(blk, xw, seeds)
    want.backward(dout)
    # about 1 - p of the 8 x 4 windows x 2 heads x 16 x 16 probabilities
    kept = keep.float().mean().item()
    assert abs(kept - 0.9) < 5 * math.sqrt(0.09 / keep.numel())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xk.grad, xw.grad, rtol=1e-5, atol=1e-5)
    for n, t in blk.named_parameters():
        torch.testing.assert_close(got_grads[n], t.grad, rtol=1e-5,
                                   atol=1e-5, msg=n)


@pytest.mark.parametrize("kernels", ["band", "windows"])
def test_dropout_block_serves_as_the_block_without(kernels):
    """Both rates are inert in eval mode: the kernel pair runs, and the
    output is the rate-0 block's."""
    plain = SwinBlock(SwinConfig(**GEOM), 32, 2, (8, 8), True, 0.1,
                      kernels=kernels, device="cpu")
    init_parameters(plain, torch.Generator().manual_seed(0))
    drops = SwinBlock(SwinConfig(hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1, **GEOM),
                      32, 2, (8, 8), True, 0.1, kernels=kernels,
                      device="cpu")
    drops.load_state_dict(plain.state_dict())
    x = torch.randn(4, 64, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(drops.eval()(x), plain.eval()(x))


def test_recompute_draws_the_dropouts_of_the_first_forward(monkeypatch):
    """A tiny vision MoRec with both Swin dropouts, DropPath and the
    model's dropout at 0.1: the step at encoder_chunk 4 (each chunk under
    ``checkpoint``) gives the loss and gradients, to the bit, of the same
    chunked step without ``checkpoint``, whose forward runs once."""
    scfg = SwinConfig(image_size=32, embed_dim=32, depths=(2, 2),
                      num_heads=(2, 4), window_size=4, drop_path_rate=0.1,
                      hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    cfg = Config(item_tower="modal", user_tower="sasrec", stage="end2end",
                 embedding_dim=32, num_attention_heads=2,
                 transformer_block=2, max_seq_len=6, drop_rate=0.1,
                 loss="inbatch_ce", compute_dtype="float32", lr=1e-3,
                 l2_weight=0.0, fine_tune_lr=5e-4, fine_tune_l2_weight=0.0,
                 encoder_chunk=4)
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 12, size=(4, 7))
    uniq, inv = dedup_pack(ids, 16)
    batch = {"ids": torch.from_numpy(ids), "log_mask": torch.ones(4, 6),
             "uniq_ids": torch.from_numpy(uniq),
             "inverse": torch.from_numpy(inv),
             "uniq_content": torch.from_numpy(pool[uniq % 8])}

    def one_step():
        tower = VisionTower(SwinModel(scfg, device="cpu"), "swin", 32,
                            scfg.num_features, device="cpu")
        model = make_model(cfg, 30, tower, device="cpu",
                           generator=torch.Generator().manual_seed(3))
        state = make_train_state(model, cfg, param_labels(model), seed=5)
        loss = make_train_step(cfg, log_pop=torch.zeros(31))(state, batch)
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    loss, grads = one_step()
    calls = []

    def plain_call(fn, *args, **kwargs):
        calls.append(kwargs)
        return fn(*args)

    monkeypatch.setattr(step_module, "checkpoint", plain_call)
    want_loss, want = one_step()
    assert len(calls) == 16 // 4
    assert loss == want_loss
    assert any("relative_position_bias_table" in n for n in grads)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name
