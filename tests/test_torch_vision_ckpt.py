"""Pretrained vision checkpoints in the port against the JAX package on the
CPU: HF model directories written by ``save_pretrained`` of small Swin (2
stages), BEiT, CLIP (a ``CLIPVisionModel`` and a whole ``CLIPModel``) and
ViT-MAE models (hidden 32-64, 2 layers), and a torchvision ``.pth`` of
ResNet-18 from a module with torchvision's structure and names (this
file's copy of tests/test_resnet.py's), float32, weights drawn by torch
from a seed:

- each converter equals ``convert.from_flax`` of the JAX converter's
  output exactly (the task models' prefixes tolerated; a missing tensor
  raises, naming it);
- each ``from_dict(config.json)`` equals the JAX ``from_hf`` of
  ``AutoConfig.from_pretrained`` field by field, also once the file is
  stripped of every key at HF's class default (which ``AutoConfig``
  fills from HF's class, not from the port's defaults);
- ``build_vision_tower(cfg, device="cpu")`` on the directory against the
  JAX ``build_vision_tower``: the same feature width and frozen set, and
  the tower's output within 2e-5 (the vision zoo's forward tolerance),
  ResNet-18 in float64 within 1e-9 (as tests/test_torch_vision_zoo.py
  holds it); a directory without weights draws them, as JAX does;
- the refusals: every key of ROADMAP C15 and a width the card's kernels do
  not take (on the card only, before anything is built);
- one ``Trainer`` each for Swin and ResNet from the same directory as the
  JAX ``Trainer``: the pretrained net loaded bit for bit, the frozen sets
  equal, the first step's loss within 1e-5 relative.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.models import beit as jbeit
from idvs.morec_tpu.models import clip_vit as jclip
from idvs.morec_tpu.models import resnet as jresnet
from idvs.morec_tpu.models import swin as jswin
from idvs.morec_tpu.models import vit_mae as jmae
from idvs.morec_tpu.models.encoders_zoo import load_encoder as jax_encoder
from idvs.morec_tpu.models.vision_tower import (
    build_vision_tower as jax_build)
from idvs.morec_tpu.parallel.mesh import make_mesh
from idvs.morec_tpu.train.runner import Trainer as JTrainer
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.data.imagestore import write_mkv
from idvs.morec_tpu_torch.models import beit, clip_vit, swin, vit_mae
from idvs.morec_tpu_torch.models.vision_tower import build_vision_tower
from idvs.morec_tpu_torch.train.runner import (Trainer, load_encoder,
                                               load_net_state)

from test_torch_runner import jit_jax_init
from test_torch_vision_zoo import same_noise  # noqa: F401
from tests.test_train_integration import quiet_log, synth_dataset

transformers = pytest.importorskip("transformers")

ATOL = 2e-5
IMG, D = 32, 16
VIT = dict(image_size=IMG, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128)
# name under pretrained_models_dir -> (HF model and config, config kwargs)
HF = {
    "swin_tiny": ("SwinModel", "SwinConfig", dict(
        image_size=IMG, patch_size=4, embed_dim=16, depths=[2, 2],
        num_heads=[2, 4], window_size=4, drop_path_rate=0.0)),
    "beit_base": ("BeitModel", "BeitConfig", dict(
        VIT, use_relative_position_bias=True, drop_path_rate=0.0)),
    "clip_vit": ("CLIPVisionModel", "CLIPVisionConfig", dict(VIT)),
    "clip_full": ("CLIPModel", "CLIPConfig", dict(
        vision_config=dict(VIT, hidden_size=32, intermediate_size=64),
        text_config=dict(vocab_size=99, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2),
        projection_dim=16)),
    "vit_mae": ("ViTMAEModel", "ViTMAEConfig", dict(
        VIT, decoder_num_hidden_layers=1, decoder_hidden_size=32,
        decoder_num_attention_heads=2, decoder_intermediate_size=64)),
}
# name -> (JAX config class, port config class, JAX converter, port
# converter)
FAMILY = {
    "swin": (jswin.SwinConfig, swin.SwinConfig,
             jswin.convert_swin_state_dict, convert.convert_swin_state_dict),
    "beit": (jbeit.BeitConfig, beit.BeitConfig,
             jbeit.convert_beit_state_dict, convert.convert_beit_state_dict),
    "clip": (jclip.CLIPVisionConfig, clip_vit.CLIPVisionConfig,
             jclip.convert_clip_state_dict, convert.convert_clip_state_dict),
    "mae": (jmae.ViTMAEConfig, vit_mae.ViTMAEConfig,
            jmae.convert_vit_mae_state_dict,
            convert.convert_vit_mae_state_dict),
}
NAMES = list(HF) + ["resnet18"]


def family(name: str) -> str:
    return next(k for k in FAMILY if k in name)


# -- torchvision's ResNet-18 (structure and state_dict names) ----------------

class TorchBasicBlock(tnn.Module):
    def __init__(self, inp, out, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(inp, out, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(out)
        self.conv2 = tnn.Conv2d(out, out, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inp != out:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(inp, out, 1, stride, bias=False),
                tnn.BatchNorm2d(out))


class TorchResNet18(tnn.Module):
    """torchvision resnet18's modules under its state_dict names, the
    1000-class fc included (no forward: only its checkpoint is read)."""

    def __init__(self, out_dim=1000):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        inp = 64
        for s, f in enumerate((64, 128, 256, 512)):
            blocks = []
            for b in range(2):
                blocks.append(TorchBasicBlock(inp, f, 2 if s and not b
                                              else 1))
                inp = f
            setattr(self, f"layer{s + 1}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(512, out_dim)


def _resnet_checkpoint() -> dict:
    torch.manual_seed(0)
    ref = TorchResNet18()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0.0, 0.1)
                m.num_batches_tracked.fill_(7)
    return ref.state_dict()


def _perturb(model) -> None:
    """Moves every parameter a little: HF's init leaves biases, layer
    scales and bias tables zero or constant."""
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory) -> str:
    """pretrained_models_dir holding each HF directory (weights in
    model.safetensors, the swin one's in pytorch_model.bin) and
    resnet18/resnet18.pth."""
    root = tmp_path_factory.mktemp("pretrained")
    for i, (name, (model, config, kw)) in enumerate(HF.items()):
        torch.manual_seed(i)
        m = getattr(transformers, model)(getattr(transformers, config)(**kw))
        _perturb(m)
        m.save_pretrained(str(root / name),
                          safe_serialization=name != "swin_tiny")
    (root / "resnet18").mkdir()
    torch.save(_resnet_checkpoint(), str(root / "resnet18" / "resnet18.pth"))
    return str(root)


def _hf_dir(models_dir, name) -> str:
    return os.path.join(models_dir, name)


def _sd(models_dir, name) -> dict:
    if name == "resnet18":
        return {k: v.numpy() for k, v in torch.load(
            os.path.join(models_dir, "resnet18", "resnet18.pth"),
            weights_only=True).items()}
    return convert.load_torch_state_dict(_hf_dir(models_dir, name))


def _config_json(path) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _jax_config(name, path):
    hf = transformers.AutoConfig.from_pretrained(path)
    return FAMILY[family(name)][0].from_hf(getattr(hf, "vision_config", hf))


def _same_state(got, want) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# -- converters ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_converter_matches_jax(models_dir, name):
    """The port's converter equals convert.from_flax of the JAX converter's
    output exactly; a ResNet's fc (and num_batches_tracked) left out."""
    sd = _sd(models_dir, name)
    if name == "resnet18":
        params, stats = jresnet.convert_resnet_state_dict(sd, "resnet18")
        params.pop("fc")
        want = convert.from_flax({"params": params, "batch_stats": stats})
        got = convert.convert_resnet_state_dict(sd, "resnet18")
        assert not any(k.startswith("fc.") or "num_batches" in k
                       for k in got)
        assert sum(k.endswith((".mean", ".var")) for k in got) == 2 * 20
    else:
        jc, pc, jconv, pconv = FAMILY[family(name)]
        path = _hf_dir(models_dir, name)
        pcfg = pc.from_dict(_config_json(path))
        want = convert.from_flax(jconv(sd, _jax_config(name, path)))
        got = pconv(sd, pcfg)
    _same_state(got, want)
    # torch tensors convert as numpy arrays do
    _same_state(convert.convert_resnet_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, "resnet18")
        if name == "resnet18" else pconv(
            {k: torch.from_numpy(v) for k, v in sd.items()}, pcfg), want)


def test_converters_take_the_task_models_prefixes(models_dir):
    """SwinForImageClassification's ``swin.``, BeitForImageClassification's
    ``beit.``, ViTMAEForPreTraining's ``vit.`` (its decoder left), and a
    whole CLIPModel (its ``text_model.*`` left); a missing tensor raises,
    naming it."""
    for name, prefix in (("swin_tiny", "swin."), ("beit_base", "beit."),
                         ("vit_mae", "vit.")):
        sd = _sd(models_dir, name)
        pconv = FAMILY[family(name)][3]
        cfg = FAMILY[family(name)][1].from_dict(
            _config_json(_hf_dir(models_dir, name)))
        task = {prefix + k: v for k, v in sd.items()}
        task["classifier.weight"] = np.zeros((3, 4), np.float32)
        task["decoder.decoder_embed.weight"] = np.zeros((3, 4), np.float32)
        _same_state(pconv(task, cfg), pconv(sd, cfg))
        first = next(iter(sd))
        del task[prefix + first]
        with pytest.raises(KeyError, match=first.replace(".", r"\.")):
            pconv(task, cfg)
    sd = _sd(models_dir, "clip_full")
    assert any(k.startswith("text_model.") for k in sd)
    cfg = clip_vit.CLIPVisionConfig.from_dict(
        _config_json(_hf_dir(models_dir, "clip_full")))
    assert cfg.hidden_size == 32
    got = convert.convert_clip_state_dict(sd, cfg)
    assert len(got) == len(clip_vit.clip_param_order(cfg))
    with pytest.raises(KeyError, match="running_var"):
        convert.convert_resnet_state_dict(
            {k: v for k, v in _sd(models_dir, "resnet18").items()
             if k != "layer2.0.bn1.running_var"}, "resnet18")


@pytest.mark.parametrize("name", ["swin_tiny", "beit_base", "clip_vit",
                                  "vit_mae", "resnet18"])
def test_to_checkpoint_inverts_the_converters(models_dir, name):
    """convert.to_checkpoint of a net loaded from a checkpoint gives back
    every tensor of it the net holds, under its names and in its layouts
    (a ResNet's fc is the net's Dense, not the checkpoint's)."""
    sd = _sd(models_dir, name)
    tower, state, _, _ = build_vision_tower(
        _cfg(Config, models_dir, name), device="cpu")
    load_net_state(tower.net, state)
    if name == "resnet18":
        order = convert.resnet_param_order("resnet18")
    else:
        cfg = tower.net.cfg
        order = {"swin": swin.swin_param_order, "beit": beit.beit_param_order,
                 "clip": clip_vit.clip_param_order,
                 "mae": vit_mae.vit_mae_param_order}[family(name)](cfg)
    back = convert.to_checkpoint(tower.net, order)
    skipped = {k for k in sd if k.startswith("fc.")
               or "num_batches" in k} if name == "resnet18" else set()
    want = {k: v for k, v in sd.items() if k in dict(order)
            or k.endswith(("running_mean", "running_var"))}
    assert set(back) - {"fc.weight", "fc.bias"} == set(want) - skipped
    for k in set(want) - skipped:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)


def test_square_convolutions_keep_kh_and_kw():
    """An OIHW convolution goes to HWIO (kh, kw, in, out): ``.T`` would
    give (kw, kh, in, out), which a square kernel takes without an
    error."""
    sd = {k: v.numpy() for k, v in _resnet_checkpoint().items()}
    got = convert.convert_resnet_state_dict(sd, "resnet18")["conv1.weight"]
    np.testing.assert_array_equal(got.numpy(),
                                  sd["conv1.weight"].transpose(2, 3, 1, 0))
    assert not np.array_equal(got.numpy(), sd["conv1.weight"].T)


# -- config readers -----------------------------------------------------------

def _strip_defaults(hf: dict, cls) -> dict:
    """hf without the keys at HF's class default (nested vision_config
    too)."""
    default = cls().to_dict()
    out = {}
    for k, v in hf.items():
        if k == "vision_config":
            v = _strip_defaults(v, transformers.CLIPVisionConfig)
        elif k in default and default[k] == v and k != "model_type":
            continue
        out[k] = v
    return out


@pytest.mark.parametrize("stripped", [False, True], ids=["full", "stripped"])
@pytest.mark.parametrize("name", list(HF))
def test_config_reader_matches_jax(models_dir, tmp_path, name, stripped):
    path = _hf_dir(models_dir, name)
    hf = _config_json(path)
    if stripped:
        cls = getattr(transformers, HF[name][1])
        hf = _strip_defaults(hf, cls)
        assert len(hf) < len(_config_json(path))
        (tmp_path / "config.json").write_text(json.dumps(hf))
        path = str(tmp_path)
    got = FAMILY[family(name)][1].from_dict(hf)
    want = _jax_config(name, path)
    assert dataclasses.asdict(got) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in dataclasses.asdict(want).items()}


def test_a_missing_key_takes_hfs_default(tmp_path):
    """A config.json of BEiT's model_type alone: HF's BeitConfig() has no
    relative position bias, where the port's BEiT-B default has one; the
    reader follows HF, as the JAX package's AutoConfig does."""
    (tmp_path / "config.json").write_text('{"model_type": "beit"}')
    got = beit.BeitConfig.from_dict({"model_type": "beit"})
    assert not got.use_relative_position_bias
    assert beit.BeitConfig().use_relative_position_bias
    want = jbeit.BeitConfig.from_hf(
        transformers.AutoConfig.from_pretrained(str(tmp_path)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ROADMAP C15: each family's keys HF builds and the JAX model does not
REFUSED = [
    (swin.SwinConfig, "use_absolute_embeddings", True),
    (swin.SwinConfig, "qkv_bias", False),
    (swin.SwinConfig, "hidden_act", "relu"),
    (beit.BeitConfig, "use_shared_relative_position_bias", True),
    (beit.BeitConfig, "use_absolute_position_embeddings", True),
    (beit.BeitConfig, "use_mask_token", True),
    (beit.BeitConfig, "use_mean_pooling", False),
    (beit.BeitConfig, "layer_scale_init_value", 0.0),
    (beit.BeitConfig, "hidden_act", "relu"),
    (beit.BeitConfig, "hidden_dropout_prob", 0.1),
    (beit.BeitConfig, "attention_probs_dropout_prob", 0.1),
    (clip_vit.CLIPVisionConfig, "hidden_act", "gelu"),
    (clip_vit.CLIPVisionConfig, "attention_dropout", 0.1),
    (vit_mae.ViTMAEConfig, "qkv_bias", False),
    (vit_mae.ViTMAEConfig, "hidden_act", "relu"),
]


@pytest.mark.parametrize("cls,key,value", REFUSED,
                         ids=[f"{c.__name__}.{k}" for c, k, _ in REFUSED])
def test_config_refusals(cls, key, value):
    """A key whose value makes HF build a model the JAX package's does not
    is refused, naming it; HF's defaults are built."""
    hf = {key: value}
    if cls is clip_vit.CLIPVisionConfig:
        hf = {"vision_config": hf}
    with pytest.raises(NotImplementedError, match=key):
        cls.from_dict(hf)
    cls.from_dict({})


def _cfg(cls, models_dir, name, **kw):
    return cls(**{**dict(item_tower="modal", modality="vision",
                         stage="end2end", cv_model_load=name,
                         pretrained_models_dir=models_dir, embedding_dim=D,
                         image_resize=IMG, freeze_paras_before=5,
                         compute_dtype="float32"), **kw})


@pytest.mark.parametrize("cfg_kw,width", [
    (dict(model_type="swin", embed_dim=192, depths=[2, 2, 18, 2],
          num_heads=[6, 12, 24, 48]), "C=1536"),
    (dict(model_type="beit", hidden_size=1536, num_attention_heads=16,
          intermediate_size=6144, use_relative_position_bias=True),
     "C=1536"),
    (dict(model_type="vit_mae", intermediate_size=3000), "F=3000")],
    ids=["swin_large", "beit_wide", "vit_mae_odd_ffn"])
def test_uncovered_widths_are_refused_on_the_card(tmp_path, cfg_kw, width):
    """Swin-L's last stage (C 1536) and widths outside premlp_plan's are
    refused before anything is built on the card, naming the width; on
    the CPU the plain versions take them."""
    name = {"swin": "swin_large", "beit": "beit_wide",
            "vit_mae": "vit_mae_odd"}[cfg_kw["model_type"]]
    (tmp_path / name).mkdir()
    (tmp_path / name / "config.json").write_text(json.dumps(cfg_kw))
    cfg = _cfg(Config, str(tmp_path), name)
    with pytest.raises(ValueError, match=width):
        build_vision_tower(cfg, device="cuda")
    tower, state, _, _ = build_vision_tower(cfg, device="meta")
    assert state is None


# -- towers -------------------------------------------------------------------

def _jax_variables(module, params, x):
    """The JAX runner's tree: init, the converted collections merged over
    the net's (train/runner.py:336-345)."""
    variables = jax.jit(lambda rngs, x: module.init(rngs, x, True))(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        x)
    variables = jax.tree.map(np.asarray, variables)
    for coll, sub in params.items():
        variables[coll]["net"] = {**variables[coll]["net"], **sub}
    return variables


@pytest.mark.parametrize("name", NAMES)
def test_tower_matches_jax(models_dir, same_noise, name):  # noqa: F811
    """The port's bundle against the JAX package's on the same directory:
    the pretrained net from the port's own reader, the head (classifier,
    cv_proj, a ResNet's fc) carried over from the Flax tree."""
    jcfg, cfg = (_cfg(c, models_dir, name) for c in (JConfig, Config))
    module, params, jfrozen, jwidth = jax_build(jcfg)
    tower, state, frozen, width = build_vision_tower(cfg, device="cpu")
    assert params is not None and state is not None
    assert width == jwidth and frozen == convert.frozen_names(jfrozen)
    assert len(frozen) == 5
    resnet = name == "resnet18"
    x = np.random.default_rng(1).integers(0, 256, (4, IMG, IMG, 3),
                                          dtype=np.uint8)
    variables = _jax_variables(module, params, jnp.asarray(x))
    full = convert.from_flax(variables)
    full.update({"net." + k: v for k, v in state.items()})
    tower.load_state_dict(full)
    tower.eval()
    if resnet:
        # float64 on both sides (tests/test_torch_vision_zoo.py): batch
        # statistics aside, float32's rounding through 8 convolutions
        # passes the ViTs' bound
        xf = (x.astype(np.float64) / 255.0 - 0.5) / 0.5
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)
            want = np.asarray(module.apply(v64, jnp.asarray(xf), True))
        with torch.no_grad():
            got = tower.double()(torch.from_numpy(xf)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        return
    want = np.asarray(jax.jit(lambda v, x: module.apply(
        v, x, True, rngs={"masking": jax.random.PRNGKey(2)}))(
            variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_directory_without_weights_draws_them(models_dir, tmp_path):
    """config.json alone: the geometry read, no state (the net drawn), as
    the JAX package's ``except (FileNotFoundError, OSError)``; no
    directory: the named default geometry; the CLI's bundle carries the
    state on (end2end and two-stage alike)."""
    (tmp_path / "swin_tiny").mkdir()
    shutil.copy(os.path.join(models_dir, "swin_tiny", "config.json"),
                tmp_path / "swin_tiny")
    cfg, jcfg = (_cfg(c, str(tmp_path), "swin_tiny") for c in
                 (Config, JConfig))
    tower, state, frozen, width = build_vision_tower(cfg, device="meta")
    assert state is None and jax_build(jcfg)[1] is None
    assert tower.net.cfg.depths == (2, 2) and width == 32
    cfg.pretrained_models_dir = str(tmp_path / "none")
    tower, state, _, width = build_vision_tower(cfg, device="meta")
    assert state is None and tower.net.cfg == swin.SwinConfig()
    assert width == 768
    cfg = _cfg(Config, models_dir, "resnet18")
    for stage in ("end2end", "two_stage"):
        cfg.stage = stage
        tower, state, frozen, width = load_encoder(cfg, "cpu")
        assert state is not None and width == D
        assert tower.project == (stage == "end2end")
        assert len(frozen) == (5 if stage == "end2end" else 0)
    # {dir}.pth beside the directory, as JAX reads it too
    flat = tmp_path / "flat"
    flat.mkdir()
    shutil.copy(os.path.join(models_dir, "resnet18", "resnet18.pth"),
                flat / "resnet18.pth")
    cfg = _cfg(Config, str(flat), "resnet18")
    _same_state(build_vision_tower(cfg, device="meta")[1],
                load_encoder(_cfg(Config, models_dir, "resnet18"), "cpu")[1])


def test_load_net_state_keeps_only_the_drawn_keys(models_dir):
    """A ResNet's fc keeps its drawn value and every other tensor is the
    checkpoint's; a key missing beyond those, or one the net lacks,
    raises."""
    cfg = _cfg(Config, models_dir, "resnet18")
    tower, state, _, _ = build_vision_tower(cfg, device="cpu")
    torch.nn.init.ones_(tower.net.fc.weight)
    load_net_state(tower.net, state)
    assert torch.equal(tower.net.fc.weight, torch.ones_like(
        tower.net.fc.weight))
    sd = tower.net.state_dict()
    for k, v in state.items():
        assert torch.equal(sd[k], v), k
    short = dict(state)
    short.pop("layer1_0.bn1.mean")
    with pytest.raises(KeyError, match="layer1_0.bn1.mean"):
        load_net_state(tower.net, short)
    with pytest.raises(KeyError, match="extra"):
        load_net_state(tower.net, {**state, "extra": torch.zeros(1)})
    swin_tower = build_vision_tower(_cfg(Config, models_dir, "swin_tiny"),
                                    device="cpu")
    state = dict(swin_tower[1])
    state.pop("layernorm.bias")
    with pytest.raises(KeyError, match="layernorm.bias"):
        load_net_state(swin_tower[0].net, state)


# -- the Trainer --------------------------------------------------------------

TRAIN = dict(dataset="TINY", news="images.tsv", behaviors="behaviors.tsv",
             image_store="imgs.mkv", max_seq_len=6, min_seq_len=3,
             batch_size=8, num_attention_heads=2, transformer_block=1,
             epoch=1, lr=1e-3, fine_tune_lr=5e-4, eval_batch_size=32,
             dedup_items=True, drop_rate=0.0)


@pytest.mark.parametrize("name", ["swin_tiny", "resnet18"])
def test_trainer_from_the_directory_matches_jax(models_dir, tmp_path,
                                                monkeypatch, name):
    """Both runners' bundles from the same checkpoint: the port's Trainer
    loads the net bit for bit as the JAX one merges it, freezes the same
    parameters and counts the same trainable ones; with the head carried
    over, the first step's loss within 1e-5 relative."""
    jit_jax_init(monkeypatch)
    monkeypatch.chdir(tmp_path)
    root = synth_dataset(tmp_path, n_users=24, n_items=16)
    base = tmp_path / "TINY"
    (base / "images.tsv").write_text(
        "".join(f"v{k}\tx\n" for k in range(1, 17)))
    beh = (base / "behaviors.tsv").read_text().replace("\ti", "\tv")
    (base / "behaviors.tsv").write_text(beh.replace(" i", " v"))
    rng = np.random.default_rng(0)
    side = 48 if name == "resnet18" else IMG
    write_mkv(str(base / "imgs.mkv"), [
        (str(k).encode(), rng.integers(0, 256, (side, side, 3),
                                       dtype=np.uint8))
        for k in range(1, 17)])
    jcfg, cfg = (_cfg(c, models_dir, name, root_data_dir=root,
                      **dict(TRAIN, image_resize=side))
                 for c in (JConfig, Config))
    jbundle = jax_encoder(jcfg)
    bundle = load_encoder(cfg, "cpu")
    assert bundle[2] == convert.frozen_names(jbundle[2]) and bundle[2]
    jtr = JTrainer(jcfg, quiet_log(), quiet_log(),
                   mesh=make_mesh(jax.devices("cpu")[:1]),
                   encoder_bundle=jbundle)
    jtr.load_data()
    jtr.build_model()
    tr = Trainer(cfg, quiet_log(), quiet_log(), device="cpu",
                 encoder_bundle=bundle)
    tr.load_data()
    tr.build_model()
    assert (tr.n_total, tr.n_trainable) == (jtr.n_total, jtr.n_trainable)
    jstate = convert.from_flax(jtr.state.params)
    drawn = tuple(getattr(tr.model.encoder.net, "drawn_on_load", ()))
    net = [k for k in tr.model.state_dict() if k.startswith("encoder.net.")
           and not k[len("encoder.net."):].startswith(drawn)]
    assert len(net) == len(bundle[1])
    for k in net:
        assert torch.equal(tr.model.state_dict()[k], jstate[k]), k
    tr.model.load_state_dict(jstate)
    jraw = next(iter(jtr.batcher.epoch(1)))
    raw = next(iter(tr.batcher.epoch(1)))
    for a, b in zip(raw, jraw):
        np.testing.assert_array_equal(a, b)
    _, jloss = jtr.train_step(jtr.state, jtr.make_batch(jraw))
    loss = tr.train_step(tr.state, tr.make_batch(raw)).item()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
