"""The vision serving slice of the port against the JAX package on the CPU:
a tiny Swin tower (image 32, embed 32, depths (2, 2), heads (2, 4),
window 4) with a SASRec user tower (D = 32), the Flax ``init`` tree carried
over by convert.from_flax, uint8 images and item 0 the padding item.

Float32. The tower and blocks agree within 2e-5, the JAX package's own
tolerance for its Swin modules; the catalog table within 1e-4 (a tower, a
classifier and a GELU deep); top-k ids are the same outside score ties.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.sasrec import TransformerBlock as JaxBlock
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu.ops.masking import causal_additive_mask as jax_causal
from idvs.morec_tpu.serve import Retriever as JaxRetriever
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config as PortConfig
from idvs.morec_tpu_torch.models.layers import init_parameters
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.sasrec import TransformerBlock
from idvs.morec_tpu_torch.models.swin import SwinConfig, SwinModel
from idvs.morec_tpu_torch.models.vision_tower import (VisionTower,
                                                      build_vision_tower)
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask
from idvs.morec_tpu_torch.serve import Retriever

TOL = 2e-5
TABLE_TOL = 1e-4
SWIN = dict(image_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=4)
ITEMS, L, D, CHUNK, POOL = 40, 6, 32, 16, 8
HIST = [[3, 7, 11], [5], [2, 2, 9, 30, 31, 32, 33, 34], [39, 1]]


def _numpy(tree, rng=None, jitter=0.05):
    """numpy leaves; with rng, every leaf perturbed (biases and the bias
    tables are zero or tiny at init)."""
    if rng is None:
        return jax.tree.map(np.asarray, tree)
    return jax.tree.map(lambda a: np.asarray(a) + jitter * rng.standard_normal(
        a.shape).astype(np.float32), tree)


def _jax_tower():
    jc = jswin.SwinConfig(**SWIN)
    return JaxVisionTower(net=jswin.SwinModel(jc), kind="swin",
                          embedding_dim=D, feature_dim=jc.num_features)


def _tower(kernels="band"):
    sc = SwinConfig(**SWIN)
    return VisionTower(SwinModel(sc, kernels=kernels, device="cpu"), "swin",
                       D, sc.num_features, device="cpu")


@pytest.fixture(scope="module")
def flax_model():
    """The JAX RecModel over the tiny tower, its init tree (numpy leaves,
    perturbed) and the image pool the catalog draws from."""
    cfg = Config(item_tower="modal", max_seq_len=L, embedding_dim=D,
                 num_attention_heads=2, transformer_block=2, drop_rate=0.0)
    rng = np.random.default_rng(1)
    pool = rng.integers(0, 256, size=(POOL, 32, 32, 3), dtype=np.uint8)
    jm = jax_make_model(cfg, item_num=ITEMS, encoder=_jax_tower())
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.ones((2, L + 1), jnp.int32),
                         jnp.asarray(pool[np.arange(2 * (L + 1)) % POOL]),
                         jnp.ones((2, L)))
    return cfg, jm, _numpy(v, rng, jitter=0.02), pool


@pytest.fixture(scope="module")
def tower_case(flax_model):
    _, _, v, pool = flax_model
    return _jax_tower(), {"params": v["params"]["encoder"]}, pool[:5]


@pytest.mark.parametrize("kernels", ["band", "windows"])
def test_swin_model_matches_flax(tower_case, kernels):
    jt, v, images = tower_case
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    jnet = jswin.SwinModel(jswin.SwinConfig(**SWIN))
    want = jax.jit(jnet.apply)({"params": v["params"]["net"]},
                               jnp.asarray(x))
    net = SwinModel(SwinConfig(**SWIN), kernels=kernels, device="cpu").eval()
    net.load_state_dict(convert.from_flax(v["params"]["net"]), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert tuple(got.shape) == (5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kernels", ["band", "windows"])
def test_vision_tower_matches_flax_with_uint8_and_a_pad_item(tower_case,
                                                             kernels):
    jt, v, images = tower_case
    pad = np.array([True, False, False, True, False])
    want = jax.jit(jt.apply)(v, jnp.asarray(images),
                             pad_mask=jnp.asarray(pad))
    tt = _tower(kernels).eval()
    tt.load_state_dict(convert.from_flax(v), strict=True)
    with torch.no_grad():
        got = tt(torch.from_numpy(images), pad_mask=torch.from_numpy(pad))
        zero = tt(torch.zeros(1, 32, 32, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # a padding slot is the tower's output for a zero image
    torch.testing.assert_close(got[[0, 3]], zero.expand(2, -1), rtol=1e-6,
                               atol=1e-6)


def test_vision_tower_compute_dtype_and_refusals():
    tt = _tower()
    init_parameters(tt, torch.Generator().manual_seed(0))
    tt.compute_dtype = torch.bfloat16
    with torch.no_grad():
        out = tt.eval()(torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    net = SwinModel(SwinConfig(**SWIN), device="cpu")
    # ResNet and MAE are ported kinds; an unknown kind is refused
    with pytest.raises(ValueError, match="kind"):
        VisionTower(net, "vit", D, 64, device="cpu")
    # project=False (the two-stage cache's tower) is ported: the
    # classifier's output before the GELU
    raw = VisionTower(net, "swin", D, 64, project=False, device="cpu")
    raw.load_state_dict(tt.state_dict())
    raw.compute_dtype = torch.bfloat16
    with torch.no_grad():
        feats = raw.eval()(torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    torch.testing.assert_close(torch.nn.functional.gelu(feats), out)
    with pytest.raises(ValueError):
        SwinModel(SwinConfig(**SWIN), kernels="fallback", device="cpu")


@pytest.mark.parametrize("name,features,depths", [
    ("swin-tiny", 768, (2, 2, 6, 2)), ("swin_base", 1024, (2, 2, 18, 2))])
def test_build_vision_tower_default_geometries(name, features, depths):
    cfg = PortConfig(cv_model_load=name, embedding_dim=64,
                     compute_dtype="bfloat16", stage="end2end")
    tower, state, frozen, width = build_vision_tower(cfg, device="meta")
    assert state is None and frozen == set() and width == features
    assert tower.net.cfg.depths == depths
    assert tuple(tower.classifier.weight.shape) == (features, 64)
    assert tower.compute_dtype == torch.bfloat16
    jc = (jswin.SwinConfig() if "tiny" in name else
          jswin.SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32)))
    assert (tower.net.cfg.embed_dim, tuple(tower.net.cfg.num_heads)) == (
        jc.embed_dim, tuple(jc.num_heads))


@pytest.mark.parametrize("name", ["resnet50", "mae", "beit_base", "clip_vit"])
def test_build_vision_tower_names_the_later_slice(name):
    """The encoders of the later slice are ported: each name builds the JAX
    package's default geometry (models/vision_tower.py:81-189) and kind,
    and bf16 compute reaches the tower."""
    from idvs.morec_tpu.models import beit, clip_vit, vit_mae
    cfg = PortConfig(cv_model_load=name, embedding_dim=64,
                     compute_dtype="bfloat16")
    tower, state, _, width = build_vision_tower(cfg, device="meta")
    assert tower.compute_dtype == torch.bfloat16 and state is None
    assert width == (64 if name == "resnet50" else 768)
    if name == "resnet50":
        assert tower.kind == "resnet" and tower.net.arch == "resnet50"
        assert tuple(tower.net.fc.weight.shape) == (2048, 64)
        return
    want = {"mae": vit_mae.ViTMAEConfig(), "beit_base": beit.BeitConfig(),
            "clip_vit": clip_vit.CLIPVisionConfig()}[name]
    assert tower.kind == ("mae" if name == "mae" else "swin")
    got = tower.net.cfg
    for field in ("image_size", "patch_size", "hidden_size",
                  "num_hidden_layers", "num_attention_heads",
                  "intermediate_size", "layer_norm_eps"):
        assert getattr(got, field) == getattr(want, field), field
    head = tower.cv_proj if name == "mae" else tower.classifier
    assert tuple(head.weight.shape) == (768, 64)


@pytest.mark.parametrize("build", [
    lambda cfg: build_vision_tower(cfg),
    lambda cfg: make_model(cfg, ITEMS),
    lambda cfg: SwinModel(SwinConfig(**SWIN)),
    lambda cfg: TransformerBlock(32, 2)],
    ids=["build_vision_tower", "make_model", "SwinModel", "TransformerBlock"])
def test_entry_points_build_on_the_gpu_unless_told(build):
    """With no device named a module is built on the GPU; where none is
    visible that raises and nothing lands on the CPU unasked."""
    cfg = PortConfig(cv_model_load="swin-tiny", embedding_dim=D,
                     item_tower="id", user_tower="sasrec", stage="end2end",
                     num_attention_heads=2, transformer_block=1,
                     max_seq_len=L)
    if torch.cuda.is_available():
        assert {p.device.type for p in build(cfg).parameters()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)


@pytest.fixture(scope="module")
def engines(flax_model):
    cfg, jm, v, pool = flax_model
    content_fn = lambda ids: pool[np.asarray(ids) % POOL]
    jv = jax.tree.map(jnp.asarray, v)      # the jitted chunks index params
    jtable = JaxRetriever.encode_catalog(jm, jv, ITEMS, None, D,
                                         batch_size=CHUNK,
                                         content_fn=content_fn)
    tm = make_model(cfg, ITEMS, _tower(), device="cpu")
    tm.load_state_dict(convert.from_flax(v), strict=True)
    ttable = Retriever.encode_catalog(tm, ITEMS, None, D, batch_size=CHUNK,
                                      content_fn=content_fn)
    return jm, jv, jtable, tm, ttable, pool


def test_vision_catalog_table_matches_jax(engines):
    _, _, jtable, tm, ttable, pool = engines
    assert tuple(ttable.shape) == (ITEMS + 1, D)
    np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable),
                               rtol=TABLE_TOL, atol=TABLE_TOL)
    # row 0, the padding item, is the tower's output for a zero image, and
    # not its pool image's (items 8, 16, ... share that one)
    with torch.no_grad():
        zero = tm.encoder(torch.zeros(1, 32, 32, 3))[0]
    torch.testing.assert_close(ttable[0], zero, rtol=1e-6, atol=1e-6)
    assert (ttable[0] - ttable[POOL]).abs().max() > 1e-3
    torch.testing.assert_close(ttable[POOL], ttable[2 * POOL], rtol=1e-6,
                               atol=1e-6)


def test_vision_recommend_matches_jax(engines):
    jm, v, jtable, tm, ttable, _ = engines
    jr = JaxRetriever(jm, v, jtable, max_seq_len=L, batch_sizes=(4,))
    tr = Retriever(tm, ttable, max_seq_len=L, batch_sizes=(4,))
    j_ids, j_scores = jr.recommend(HIST, top_k=5)
    t_ids, t_scores = tr.recommend(HIST, top_k=5)
    np.testing.assert_allclose(t_scores, j_scores, rtol=TABLE_TOL,
                               atol=TABLE_TOL)
    # the pool repeats every 8 items, so scores tie: ids may differ only
    # inside a tie (or at the cut after the last place)
    for g, w, gs in zip(t_ids, j_ids, t_scores):
        for k in np.flatnonzero(g != w):
            assert (k == len(g) - 1 or np.isclose(
                gs, gs[k], rtol=TABLE_TOL, atol=TABLE_TOL).sum() > 1)
    assert (t_ids != 0).all()
    for row, h in zip(t_ids, HIST):
        assert not set(h[-L:]) & set(row.tolist())


def test_content_fn_may_return_a_tensor_and_update_items_takes_images(
        engines):
    _, _, _, tm, ttable, pool = engines
    tpool = torch.from_numpy(pool)
    again = Retriever.encode_catalog(
        tm, ITEMS, None, D, batch_size=CHUNK,
        content_fn=lambda ids: tpool[torch.from_numpy(ids % POOL)])
    torch.testing.assert_close(again, ttable, rtol=0, atol=0)
    tr = Retriever(tm, ttable.clone(), max_seq_len=L, batch_sizes=(4,))
    tr.update_items([5, 0], content=pool[[3, 3]])   # item 5 takes image 3
    torch.testing.assert_close(tr.item_table[5], ttable[3], rtol=1e-6,
                               atol=1e-6)
    # id 0 stays the padding item whatever image comes with it
    torch.testing.assert_close(tr.item_table[0], ttable[0], rtol=1e-6,
                               atol=1e-6)


def test_flax_tree_round_trips(engines):
    _, v, _, tm, _, _ = engines
    back = convert.to_flax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, np.asarray(b))
    flat = {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(back)}
    assert ("params/encoder/net/stage_1_block_1/"
            "relative_position_bias_table") in flat
    assert "params/encoder/net/patch_projection/kernel" in flat


def test_sasrec_block_at_the_vision_width_matches_flax():
    """The post-LN tails' plain versions at C = 2048, F = 8192 (the vision
    flagship's SASRec width) on a few rows, against the Flax block."""
    B, T, C = 2, 4, 2048
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    log_mask = np.array([[0, 1, 1, 1], [1, 1, 1, 1]], np.float32)
    jb = JaxBlock(d_model=C, n_heads=2, drop_rate=0.0)
    v = jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                jax_causal(jnp.asarray(log_mask)))
    want = jb.apply(v, jnp.asarray(x), jax_causal(jnp.asarray(log_mask)))
    tb = TransformerBlock(C, 2, device="cpu").eval()
    tb.load_state_dict(convert.from_flax(_numpy(v)), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x),
                 causal_additive_mask(torch.from_numpy(log_mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
