"""The port's other vision encoders against the JAX package on the CPU
(its XLA path), float32, weights carried by convert.from_flax, inputs from
a numpy seed:

- ``layers.pre_ln_mlp`` in both editions (the residual inside the kernel,
  and the bare MLP whose residual the caller adds) with gelu, relu and
  quick_gelu: output within 2e-5, gradients within rtol 2e-4 / atol 2e-5;
- CLIP-ViT, ViT-MAE (the masking noise injected into both packages, whose
  generators differ) and BEiT at hidden 64, 2 layers, 32 x 32 images,
  patch 8, in eval mode and in training mode with their gradients;
- ResNet-18 and the ResNet-50 bottleneck arch at 32 x 32 images in float64
  on both sides: eval mode on perturbed running averages, training mode's
  output, gradients (ResNet-18) and running averages after the forward,
  within 1e-9 (rtol 1e-7 for the gradients);
- each ``VisionTower`` kind over uint8 images with a padding slot,
  end2end (the GELU) and two-stage (``project=False``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.models import beit as jbeit
from idvs.morec_tpu.models import clip_vit as jclip
from idvs.morec_tpu.models import resnet as jresnet
from idvs.morec_tpu.models import vit_mae as jmae
from idvs.morec_tpu.models.layers import pre_ln_mlp as jax_pre_ln_mlp
from idvs.morec_tpu.models.vision_tower import VisionTower as JaxVisionTower
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models import vit_mae
from idvs.morec_tpu_torch.models.beit import BeitConfig, BeitModel
from idvs.morec_tpu_torch.models.clip_vit import (CLIPVisionConfig,
                                                  CLIPVisionModel)
from idvs.morec_tpu_torch.models.layers import (Dense, LayerNorm,
                                                init_parameters, pre_ln_mlp)
from idvs.morec_tpu_torch.models.resnet import ResNet
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.models.vit_mae import ViTMAEConfig, ViTMAEModel

ATOL, G_RTOL, G_ATOL = 2e-5, 2e-4, 2e-5
N, IMG, D = 4, 32, 16
VIT = dict(image_size=IMG, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128)
NETS = {"clip": (jclip.CLIPVisionConfig, jclip.CLIPVisionModel,
                 CLIPVisionConfig, CLIPVisionModel),
        "mae": (jmae.ViTMAEConfig, jmae.ViTMAEModel, ViTMAEConfig,
                ViTMAEModel),
        "beit": (jbeit.BeitConfig, jbeit.BeitModel, BeitConfig, BeitModel)}


def noise_of(shape) -> np.ndarray:
    """The masking noise both packages take in these tests: a function of
    the shape alone."""
    return np.random.default_rng(shape[0] * 1000 + shape[1]).uniform(
        size=shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """ViT-MAE's masking noise injected into both packages."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(
                            noise_of(shape)))
    monkeypatch.setattr(vit_mae, "masking_noise",
                        lambda n, length, gen, device: torch.from_numpy(
                            noise_of((n, length))).to(device))


def perturbed(variables, seed=1):
    """Every leaf moved a little (biases, layer scales and bias tables are
    zero or constant at init); running variances kept positive."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.asarray(a, np.float32)
                       + 0.02 * rng.standard_normal(a.shape).astype(
                           np.float32), dict(variables))
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (np.abs(a) + 0.5 if p[-1].key == "var"
                          else a + 0.1 * rng.standard_normal(a.shape)
                          ).astype(np.float32), out["batch_stats"])
    return out


def images(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal(
        (n, IMG, IMG, 3)).astype(np.float32)


def grads_of(model) -> dict:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def assert_grads(got: dict, want_tree, prefix=()):
    want = convert.from_flax({"params": jax.tree.map(np.asarray,
                                                     want_tree)})
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name].numpy(), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


# -- pre_ln_mlp ---------------------------------------------------------------

class _JaxMLP(fnn.Module):
    act: str
    residual: bool

    @fnn.compact
    def __call__(self, x):
        return jax_pre_ln_mlp(x, 48, ln_name="ln", fc1_name="fc1",
                              fc2_name="fc2", eps=1e-6, act=self.act,
                              residual=self.residual)


class _PortMLP(torch.nn.Module):
    def __init__(self, act, residual):
        super().__init__()
        self.act, self.residual = act, residual
        self.ln = LayerNorm(24, 1e-6, device="cpu")
        self.fc1 = Dense(24, 48, device="cpu")
        self.fc2 = Dense(48, 24, device="cpu")

    def forward(self, x):
        return pre_ln_mlp(x, self.ln, self.fc1, self.fc2, act=self.act,
                          residual=self.residual)


MLP_CASES = [(act, residual) for act in ("gelu", "relu", "quick_gelu")
             for residual in (True, False)]


@pytest.fixture(scope="module")
def mlp_refs():
    """Every case's input, weights, Flax output and gradients (of the sum
    of squares, in the parameters and the input), from one jitted
    program."""
    x = np.random.default_rng(2).standard_normal((3, 7, 24)).astype(
        np.float32)
    mods = {case: _JaxMLP(*case) for case in MLP_CASES}
    v0 = jax.jit(mods[MLP_CASES[0]].init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x))
    v = perturbed(v0, seed=3)

    def refs(p, x):
        return {case: (m.apply({"params": p}, x), jax.grad(
            lambda p, x: jnp.sum(m.apply({"params": p}, x) ** 2),
            argnums=(0, 1))(p, x)) for case, m in mods.items()}

    return x, v, jax.tree.map(np.asarray,
                              jax.jit(refs)(v["params"], jnp.asarray(x)))


@pytest.mark.parametrize("residual", [True, False], ids=["res", "bare"])
@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
def test_pre_ln_mlp_matches_jax(mlp_refs, act, residual):
    x, v, refs = mlp_refs
    want, jgrads = refs[(act, residual)]
    tm = _PortMLP(act, residual)
    tm.load_state_dict(convert.from_flax(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    (got ** 2).sum().backward()
    assert_grads(grads_of(tm), jgrads[0])
    np.testing.assert_allclose(xt.grad.numpy(), jgrads[1], rtol=G_RTOL,
                               atol=G_ATOL)


# -- the ViTs -----------------------------------------------------------------

def port_variables(net, seed=0) -> dict:
    """A port module's drawn weights as a perturbed Flax variable tree
    (``convert.to_flax``), which both packages then load: no Flax init to
    compile."""
    init_parameters(net, torch.Generator().manual_seed(seed))
    return perturbed(convert.to_flax(net))


def _vit_cfg(name, jax_side):
    cfg = NETS[name][0 if jax_side else 2]
    return cfg(**VIT, **({"mask_ratio": 0.5} if name == "mae" else {}))


@pytest.fixture(scope="module")
def vits():
    """Each ViT's Flax module and a perturbed weight tree."""
    return {name: (NETS[name][1](_vit_cfg(name, True)),
                   port_variables(NETS[name][3](_vit_cfg(name, False),
                                                device="cpu")))
            for name in NETS}


def _port_net(name, variables):
    net = NETS[name][3](_vit_cfg(name, False), device="cpu")
    net.load_state_dict(convert.from_flax(variables))
    return net


@pytest.mark.parametrize("name", list(NETS))
def test_vit_encoders_match_jax(vits, same_noise, name):
    """Eval mode (the MLP's residual in the kernel) and training mode
    (fused_mlp, the residual added after it) against the deterministic and
    the training forward of the Flax module, and the training mode's
    gradients."""
    module, v = vits[name]
    x = images(4)
    net = _port_net(name, v)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    rngs = {"dropout": jax.random.PRNGKey(2),
            "masking": jax.random.PRNGKey(3)}
    want = jax.jit(lambda v, x: module.apply(v, x, True, rngs=rngs))(
        v, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if name == "mae":
        # the kept patches: 1 + 16 * (1 - 0.5) rows
        assert got.shape == (N, 9, VIT["hidden_size"])

    def jloss(p):
        out = module.apply({"params": p}, jnp.asarray(x), False, rngs=rngs)
        return jnp.sum(out * out), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])
    out = net.train()(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    (out * out).sum().backward()
    assert_grads(grads_of(net), jgrads)


def test_vit_mae_masks_by_its_generator():
    """Without injected noise, training mode draws the noise from the
    generator it is handed (the same seed, the same patches kept), and
    eval mode from a generator seeded with EVAL_MASK_SEED a call, so two
    encodes agree; the sin-cos table is JAX's."""
    net = ViTMAEModel(ViTMAEConfig(**VIT), device="cpu")
    from idvs.morec_tpu_torch.models.layers import init_parameters
    init_parameters(net, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        net.position_embeddings.detach().numpy(),
        jmae.sincos_pos_embed(64, IMG // 8))
    x = torch.from_numpy(images(5))
    with torch.no_grad():
        a, b = net.eval()(x), net(x)
        net.train()
        c = net(x, torch.Generator().manual_seed(7))
        d = net(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and torch.equal(c, d)
    assert a.shape == (N, 1 + 4, 64)
    with pytest.raises(ValueError, match="generator"):
        net(x)


# -- ResNet -------------------------------------------------------------------

def _port_resnet(arch, v):
    net = ResNet(arch, D, device="cpu")
    net.load_state_dict(convert.from_flax(v))
    return net


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax(arch):
    """Eval mode on perturbed running averages; training mode's batch
    statistics, the running averages after one training forward (momentum
    0.9, the biased variance) and, at ResNet-18, the gradients through the
    statistics. Float64 on both sides, one JAX program an arch: batch
    statistics of 8 images, 1 x 1 at the last stage, amplify float32's
    rounding past any useful bound (each package's float32 output lies up
    to 2.5e-3 from a float64 run of the port at ResNet-50), so float64
    holds the semantics to 1e-9. The train step's tests hold float32
    ResNet towers."""
    module = jresnet.ResNet(arch=arch, out_dim=D)
    v = port_variables(ResNet(arch, D, device="cpu"))
    x = images(7, n=8).astype(np.float64)
    r = np.random.default_rng(9).standard_normal((8, D))
    grads = arch == "resnet18"
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)

        def jloss(p, x):
            out, mut = module.apply({"params": p,
                                     "batch_stats": v64["batch_stats"]},
                                    x, True, mutable=["batch_stats"])
            return jnp.sum(out * r), (out, mut["batch_stats"])

        def run(p, x):
            ev = module.apply({"params": p,
                               "batch_stats": v64["batch_stats"]}, x, False)
            if grads:
                (_, aux), g = jax.value_and_grad(jloss, has_aux=True)(p, x)
            else:
                (_, aux), g = jloss(p, x), {}
            return ev, aux, g

        jeval, (jout, jstats), jgrads = jax.tree.map(
            np.asarray, jax.jit(run)(v64["params"], jnp.asarray(x)))
    assert jout.dtype == np.float64
    net = _port_resnet(arch, v).double()
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jeval, rtol=1e-9, atol=1e-9)
    out = net.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-9,
                               atol=1e-9)
    if grads:
        (out * torch.from_numpy(r)).sum().backward()
        want = convert.from_flax({"params": jgrads})
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=1e-7, atol=1e-9, err_msg=name)
    want = convert.from_flax({"batch_stats": jstats})
    buffers = dict(net.named_buffers())
    assert set(want) == set(buffers)
    for name, b in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), b.numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    assert convert.to_flax(net).keys() == {"params", "batch_stats"}


# -- the tower kinds ----------------------------------------------------------

def _towers(kind):
    """(Flax tower, port tower builder) of each kind over a tiny
    encoder."""
    if kind == "resnet":
        return (JaxVisionTower(net=jresnet.ResNet(arch="resnet18",
                                                  out_dim=D),
                               kind="resnet", embedding_dim=D, feature_dim=D),
                lambda project: VisionTower(ResNet("resnet18", D,
                                                   device="cpu"),
                                            "resnet", D, D, project,
                                            device="cpu"))
    name = {"swin": "clip", "mae": "mae"}[kind]
    return (JaxVisionTower(net=NETS[name][1](_vit_cfg(name, True)),
                           kind=kind, embedding_dim=D, feature_dim=64),
            lambda project: VisionTower(NETS[name][3](_vit_cfg(name, False),
                                                      device="cpu"),
                                        kind, D, 64, project, device="cpu"))


@pytest.mark.parametrize("kind", ["resnet", "swin", "mae"])
def test_vision_tower_kinds_match_jax(same_noise, kind):
    """uint8 images with the padding item's slot, end2end (GELU) and
    two-stage (project=False), in eval mode."""
    jt, build = _towers(kind)
    u8 = np.random.default_rng(8).integers(0, 256, (N, IMG, IMG, 3),
                                           dtype=np.uint8)
    pad = np.array([True, False, False, True])
    v = port_variables(build(True))
    rngs = {"masking": jax.random.PRNGKey(1)}
    wants = jax.jit(lambda v, x, m: [
        jt.clone(project=project).apply(v, x, True, pad_mask=m, rngs=rngs)
        for project in (True, False)])(v, jnp.asarray(u8), jnp.asarray(pad))
    for project, want in zip((True, False), wants):
        tower = build(project)
        tower.load_state_dict(convert.from_flax(v))
        with torch.no_grad():
            got = tower.eval()(torch.from_numpy(u8),
                               pad_mask=torch.from_numpy(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"project={project}")
