"""The port's text encoder zoo against the JAX package and HF transformers
on the CPU, float32, tiny geometries (2 layers, hidden 32, 4 heads):

- OPT (``models/opt.py``) and DeBERTa (``models/deberta.py``) against the
  JAX modules with the same Flax weights (convert.from_flax): OPT within
  2e-5 at every position (JAX's position rule at the pads), DeBERTa within
  2e-5 at every position, a row that is all padding included, at T below
  the relative span and at T above max_relative_positions;
- both against HF ``OPTModel`` / ``DebertaModel`` through the port's
  converters, within 2e-4 at the valid positions (HF gives OPT's pads
  another position and leaves DeBERTa's padded rows unnormalised);
- the text tower over OPT (masked mean) and DeBERTa (CLS) against the JAX
  ``TextTower``, a catalog's all-padding row 0 included;
- each family's converted state_dict (BERT, RoBERTa, DistilBERT, OPT,
  DeBERTa) equal to ``from_flax`` of the JAX converter's tree, and each
  family's frozen names equal to the JAX frozen paths through
  ``flax_name``;
- ``build_text_tower`` on directories HF's ``save_pretrained`` wrote, as
  ``model.safetensors`` and as ``pytorch_model.bin``: the dispatch, pooling,
  attribute lengths and frozen names of the JAX ``build_text_tower``, the
  net's output with the loaded weights against HF's; a config alone gives
  no weights; ``read_safetensors`` widens bfloat16;
- the OPT and DeBERTa configs the port refuses (ROADMAP C14).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idvs.morec_tpu.config import Config as JConfig
from idvs.morec_tpu.models import convert_text as jconv
from idvs.morec_tpu.models import deberta as jdeberta
from idvs.morec_tpu.models import opt as jopt
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.models.text_tower import \
    build_text_tower as jax_build_text_tower
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.deberta import DebertaConfig, DebertaModel
from idvs.morec_tpu_torch.models.layers import init_parameters
from idvs.morec_tpu_torch.models.opt import OPTConfig, OPTModel
from idvs.morec_tpu_torch.models.text_tower import (TextTower,
                                                    build_text_tower)

transformers = pytest.importorskip("transformers")

ATOL, HF_ATOL = 2e-5, 2e-4
B, T, V, H, LAYERS, HEADS, FFN = 3, 12, 120, 32, 2, 4, 64
OPT = dict(vocab_size=V, hidden_size=H, num_hidden_layers=LAYERS,
           num_attention_heads=HEADS, ffn_dim=FFN,
           max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
           pad_token_id=1)
DEBERTA = dict(vocab_size=V, hidden_size=H, num_hidden_layers=LAYERS,
               num_attention_heads=HEADS, intermediate_size=FFN,
               max_position_embeddings=64, type_vocab_size=0,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
HF_DEBERTA = dict(DEBERTA, relative_attention=True,
                  pos_att_type=["c2p", "p2c"], position_biased_input=False)
HF_OPT = dict(OPT, do_layer_norm_before=True, word_embed_proj_dim=H)


def inputs(pad: int, seed: int = 0, t: int = T):
    """(B, t) ids and masks: row 0 ends in 4 pads, row 1 is full, row 2
    is all padding (a catalog's padding item)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, size=(B, t)).astype(np.int64)
    mask = np.ones((B, t), np.int64)
    mask[0, -4:] = 0
    mask[2] = 0
    ids[mask == 0] = pad
    return ids, mask


def hf_state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def jax_params(module, ids, mask, seed=0):
    """A Flax init, every leaf moved a little (biases and LayerNorms start
    at 0 and 1)."""
    params = jax.jit(lambda k, i, m: module.init(k, i, m, True))(
        jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05
                        * rng.standard_normal(a.shape).astype(np.float32),
                        dict(params))


def port_apply(net, params, ids, mask):
    net.load_state_dict(convert.from_flax(params))
    with torch.no_grad():
        return net.eval()(torch.from_numpy(ids),
                          torch.from_numpy(mask)).numpy()


def jax_apply(module, params, ids, mask):
    return np.asarray(jax.jit(module.apply, static_argnums=3)(
        params, jnp.asarray(ids), jnp.asarray(mask), True))


# -- the modules against JAX and HF -------------------------------------------

def test_opt_matches_jax_and_hf():
    ids, mask = inputs(pad=1)
    jm = jopt.OPTModel(jopt.OPTConfig(**OPT))
    params = jax_params(jm, ids, mask)
    got = port_apply(OPTModel(OPTConfig(**OPT), device="cpu"), params, ids,
                     mask)
    np.testing.assert_allclose(got, jax_apply(jm, params, ids, mask),
                               atol=ATOL)
    hf_cfg = transformers.OPTConfig(**HF_OPT)
    torch.manual_seed(2)
    hf = transformers.OPTModel(hf_cfg).eval()
    net = OPTModel(OPTConfig.from_dict(hf_cfg.to_dict()), device="cpu")
    net.load_state_dict(convert.convert_opt_state_dict(hf_state(hf),
                                                       LAYERS))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask))[0].numpy()
        got = net.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid],
                               atol=HF_ATOL)


@pytest.mark.parametrize("t,max_rel", [(T, -1), (T, 5)],
                         ids=["T<span", "T>max_rel"])
def test_deberta_matches_jax_and_hf(t, max_rel):
    """T below max_relative_positions (span = T) and above it (span =
    max_rel = 5: D clamps on both sides)."""
    ids, mask = inputs(pad=0, seed=1, t=t)
    cfg = dict(DEBERTA, max_relative_positions=max_rel)
    jm = jdeberta.DebertaModel(jdeberta.DebertaConfig(**cfg))
    params = jax_params(jm, ids, mask, seed=3)
    got = port_apply(DebertaModel(DebertaConfig(**cfg), device="cpu"),
                     params, ids, mask)
    np.testing.assert_allclose(got, jax_apply(jm, params, ids, mask),
                               atol=ATOL)
    hf_cfg = transformers.DebertaConfig(**HF_DEBERTA,
                                        max_relative_positions=max_rel)
    torch.manual_seed(4)
    hf = transformers.DebertaModel(hf_cfg).eval()
    net = DebertaModel(DebertaConfig.from_dict(hf_cfg.to_dict()),
                       device="cpu")
    net.load_state_dict(convert.convert_deberta_state_dict(
        hf_state(hf), LAYERS, HEADS))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask))[0].numpy()
        got = net.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid],
                               atol=HF_ATOL)


@pytest.mark.parametrize("family", ["opt", "deberta"])
def test_text_tower_matches_jax(family):
    """TextTower over each net, two attributes, the catalog's all-padding
    row 0 among the rows: OPT's masked mean divides by the clamped 0,
    DeBERTa pools CLS."""
    pooling = "mean" if family == "opt" else "cls"
    rng = np.random.default_rng(5)
    rows = []
    for n in (T, 6):
        ids, mask = inputs(pad=1 if family == "opt" else 0,
                           seed=int(rng.integers(100)), t=n)
        rows += [ids, mask]
    content = np.concatenate(rows, axis=1)[[2, 0, 1]]   # row 0: padding
    if family == "opt":
        jnet, net = (jopt.OPTModel(jopt.OPTConfig(**OPT)),
                     OPTModel(OPTConfig(**OPT), device="cpu"))
    else:
        jnet, net = (jdeberta.DebertaModel(jdeberta.DebertaConfig(**DEBERTA)),
                     DebertaModel(DebertaConfig(**DEBERTA), device="cpu"))
    jt = JaxTextTower(net=jnet, embedding_dim=16, word_embedding_dim=H,
                      pooling=pooling, attr_lengths=(T, 6))
    params = jax.jit(jt.init)(jax.random.PRNGKey(6), jnp.asarray(content))
    want = np.asarray(jax.jit(jt.apply)(params, jnp.asarray(content)))
    tower = TextTower(net, 16, H, pooling=pooling, attr_lengths=(T, 6),
                      device="cpu")
    tower.load_state_dict(convert.from_flax(params))
    with torch.no_grad():
        got = tower.eval()(torch.from_numpy(content)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


# -- converters and frozen names ----------------------------------------------

def _hf_models():
    """family -> (HF model, the JAX converter, the port's converter, the
    JAX frozen paths, the port's frozen names)."""
    torch.manual_seed(7)
    bert = transformers.BertModel(transformers.BertConfig(
        vocab_size=V, hidden_size=H, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        max_position_embeddings=64))
    roberta = transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=V, hidden_size=H, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        max_position_embeddings=66, type_vocab_size=1, pad_token_id=1))
    distil = transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=V, dim=H, n_layers=LAYERS, n_heads=HEADS,
        hidden_dim=FFN, max_position_embeddings=64))
    opt = transformers.OPTModel(transformers.OPTConfig(**HF_OPT))
    deberta = transformers.DebertaModel(transformers.DebertaConfig(
        **HF_DEBERTA))
    L = LAYERS
    return {
        "bert": (bert, lambda sd: jconv.convert_bert_state_dict(sd, L),
                 lambda sd: convert.convert_bert_state_dict(sd, L),
                 jconv.bert_frozen_paths, convert.bert_frozen_names),
        "roberta": (roberta, lambda sd: jconv.convert_bert_state_dict(sd, L),
                    lambda sd: convert.convert_bert_state_dict(sd, L),
                    jconv.bert_frozen_paths, convert.bert_frozen_names),
        "distilbert": (distil,
                       lambda sd: jconv.convert_distilbert_state_dict(sd, L),
                       lambda sd: convert.convert_distilbert_state_dict(sd,
                                                                        L),
                       jconv.distilbert_frozen_paths,
                       convert.distilbert_frozen_names),
        "opt": (opt, lambda sd: jopt.convert_opt_state_dict(sd, L),
                lambda sd: convert.convert_opt_state_dict(sd, L),
                jopt.opt_frozen_paths, convert.opt_frozen_names),
        "deberta": (deberta,
                    lambda sd: jdeberta.convert_deberta_state_dict(sd, L,
                                                                   HEADS),
                    lambda sd: convert.convert_deberta_state_dict(sd, L,
                                                                  HEADS),
                    jdeberta.deberta_frozen_paths,
                    convert.deberta_frozen_names)}


@pytest.fixture(scope="module")
def hf_models():
    return _hf_models()


FAMILIES = ["bert", "roberta", "distilbert", "opt", "deberta"]


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_state_dict_is_from_flax_of_jax(hf_models, family):
    """The port's converter gives from_flax of the JAX converter's tree,
    name for name and bit for bit, from the bare model's names and from a
    task model's (``bert.``, ``model.``, ...)."""
    hf, jax_convert, port_convert, _, _ = hf_models[family]
    sd = hf_state(hf)
    want = convert.from_flax(jax_convert(sd))
    prefix = {"bert": "bert.", "roberta": "roberta.",
              "distilbert": "distilbert.", "opt": "model.",
              "deberta": "deberta."}[family]
    for state in (sd, {prefix + k: v for k, v in sd.items()}):
        got = port_convert(state)
        assert list(got) and set(got) == set(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), name


@pytest.mark.parametrize("family", FAMILIES)
def test_frozen_names_match_jax(hf_models, family):
    _, _, _, jax_frozen, port_frozen = hf_models[family]
    for n in (0, 3, 5, 17, 40):
        want = convert.frozen_names(jax_frozen(LAYERS, n,
                                               prefix=("encoder", "net")))
        assert port_frozen(LAYERS, n) == want, n


# -- build_text_tower -----------------------------------------------------------

@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, hf_models):
    """Each family saved by save_pretrained twice, as model.safetensors and
    as pytorch_model.bin; names as the dispatch reads them ("opt" in the
    name)."""
    root = tmp_path_factory.mktemp("pretrained")
    for family in ("opt", "deberta", "distilbert", "roberta"):
        for safe in (True, False):
            d = root / f"{family}-tiny-{'st' if safe else 'bin'}"
            hf_models[family][0].save_pretrained(str(d),
                                                 safe_serialization=safe)
    return root


def text_cfg(cls, root, name, **kw):
    return cls(**{**dict(item_tower="modal", modality="text",
                         stage="end2end", bert_model_load=name,
                         pretrained_models_dir=str(root), num_words_title=T,
                         num_words_abstract=6,
                         news_attributes=("title", "abstract"),
                         embedding_dim=16, freeze_paras_before=5), **kw})


@pytest.mark.parametrize("family", ["opt", "deberta", "distilbert",
                                    "roberta"])
@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_build_text_tower(model_dirs, hf_models, family, fmt):
    name = f"{family}-tiny-{fmt}"
    (model_dirs / name / ("model.safetensors" if fmt == "st"
                          else "pytorch_model.bin")).stat()
    tower, state, frozen, width = build_text_tower(
        text_cfg(Config, model_dirs, name), device="cpu")
    jtower, jparams, jfrozen, jwidth = jax_build_text_tower(
        text_cfg(JConfig, model_dirs, name))
    assert width == jwidth == H
    assert tower.pooling == jtower.pooling
    assert tower.attr_lengths == tuple(jtower.attr_lengths) == (T, 6)
    assert tower.project and frozen == convert.frozen_names(jfrozen)
    assert set(state) == set(convert.from_flax(jparams))
    tower.net.load_state_dict(state)
    pad = 1 if family in ("opt", "roberta") else 0
    ids, mask = inputs(pad=pad, seed=8)
    hf = hf_models[family][0].eval()
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask))[0].numpy()
        got = tower.net.eval()(torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=HF_ATOL)


def test_build_text_tower_reads_a_config_alone(tmp_path):
    """A directory with config.json only: the tower, no weights; the
    two-stage stage builds no fc; the text_pooling override; a missing
    directory names the config path."""
    d = tmp_path / "deberta-cfg"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        HF_DEBERTA, model_type="deberta")))
    cfg = text_cfg(Config, tmp_path, "deberta-cfg", stage="two_stage",
                   text_pooling="mean")
    tower, state, frozen, width = build_text_tower(cfg, device="cpu")
    assert state is None and width == H and len(frozen) == 5
    assert not tower.project and tower.pooling == "mean"
    init_parameters(tower, torch.Generator().manual_seed(0))
    ids, mask = inputs(pad=0)
    out = tower(torch.from_numpy(np.concatenate(
        [ids, mask, ids[:, :6], mask[:, :6]], axis=1)))
    assert out.shape == (B, H) and torch.isfinite(out).all()
    with pytest.raises(FileNotFoundError, match="config.json"):
        build_text_tower(text_cfg(Config, tmp_path, "absent"), device="cpu")


def test_text_model_table_is_the_jax_one():
    """The hidden sizes and pooler indices by model size (JAX
    encoders_zoo.py:18-32), and the lookup by name."""
    from idvs.morec_tpu.models import encoders_zoo
    from idvs.morec_tpu_torch.models import text_tower
    assert text_tower.TEXT_MODEL_TABLE == encoders_zoo.TEXT_MODEL_TABLE
    for name in ("bert-base-uncased", "chinese_roberta_wwm_large_ext",
                 "bert_small", "opt-125m", "deberta-base", "mini_lm"):
        assert (text_tower.text_model_spec(name)
                == encoders_zoo.text_model_spec(name)), name


def test_read_safetensors_widens_bfloat16(tmp_path):
    from safetensors.torch import save_file
    rng = np.random.default_rng(9)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).bfloat16(),
        "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
        "c": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    save_file(tensors, str(tmp_path / "model.safetensors"),
              metadata={"format": "pt"})
    got = convert.load_torch_state_dict(str(tmp_path))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        np.testing.assert_array_equal(got[k], want)


# -- what the port refuses ------------------------------------------------------

@pytest.mark.parametrize("key,value", [
    ("do_layer_norm_before", False), ("word_embed_proj_dim", 16),
    ("enable_bias", False), ("_remove_final_layer_norm", True)])
def test_opt_config_refusals(key, value):
    """What JAX's OPTConfig.from_hf ignores (ROADMAP C14): the port
    refuses it; the 125m-class config reads."""
    hf = transformers.OPTConfig(**HF_OPT).to_dict()
    assert OPTConfig.from_dict(hf) == OPTConfig(**OPT)
    with pytest.raises(NotImplementedError, match=key):
        OPTConfig.from_dict({**hf, key: value})


@pytest.mark.parametrize("key,value", [
    ("position_biased_input", True), ("embedding_size", 16),
    ("talking_head", True), ("relative_attention", False)])
def test_deberta_config_refusals(key, value):
    hf = transformers.DebertaConfig(**HF_DEBERTA).to_dict()
    got = DebertaConfig.from_dict(hf)
    assert got == DebertaConfig(**DEBERTA) and got.max_rel == 64
    with pytest.raises(NotImplementedError, match=key):
        DebertaConfig.from_dict({**hf, key: value})


# -- the ReLU kink rule of rows 5-6's plain versions ---------------------------

@pytest.mark.parametrize("residual", [False, True])
def test_pre_ln_mlp_kink_from_takes_the_other_branch_only_at_the_kink(
        residual):
    """fused_mlp_plain / fused_mlp_res_plain with kink_from take its sign
    for ReLU's branch where relu_kink marks h, their own elsewhere: given
    their own h they are the plain versions to the bit; given an h of the
    other sign only the db1 entries of the marked units move by a row's
    step. relu_kink's bound for a bfloat16 x adds a unit roundoff of each
    x with independent signs, 2^-8 sqrt(x^2 w1^2)."""
    from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp_plain,
                                                   fused_mlp_res_plain,
                                                   relu_kink)
    from idvs.morec_tpu_torch.models.layers import layer_norm
    rng = np.random.default_rng(17)
    M, C, F = 9, 64, 32
    t = lambda *s, scale=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * scale)
    x, w1, w2 = t(M, C), t(C, F, scale=C ** -0.5), t(F, C, scale=F ** -0.5)
    b2, g, bt = t(C, scale=0.1), 1.0 + t(C, scale=0.1), t(C, scale=0.1)
    xn = layer_norm(x, g, bt, 1e-5)
    # units 0-3 of row 0 a few roundings from 0, units 4-7 1e-3 away
    b1 = t(F, scale=0.1)
    s = (xn[0].double() @ w1.double()).float()
    b1[:4] = -s[:4]
    b1[4:8] = -s[4:8] + 1e-3
    h = xn @ w1 + b1
    at_kink = relu_kink(h, xn, w1, b1)
    assert at_kink[0, :4].all() and not at_kink[0, 4:8].any()
    assert at_kink.sum() == 4
    # in bf16 the band is 2^-8 sqrt(xn^2 w1^2), about 4e-3 here: 1e-3 is
    # inside, 0.05 outside
    band = 2.0 ** -8 * (xn.square() @ w1.square()).sqrt()
    assert (band[0, 4:8] > 2e-3).all() and (band < 2e-2).all()
    hb = relu_kink(h, xn.bfloat16(), w1, b1)
    assert hb[0, :8].all() and not (hb & (h.abs() > 0.05)).any()
    dout = t(M, C)

    def grads(**k):
        leaves = [v.clone().requires_grad_(True) for v in (x, w1, b1)]
        if residual:
            out = fused_mlp_res_plain(leaves[0], None, *leaves[1:], w2, b2,
                                      ln=(g, bt), act="relu", **k)
        else:
            out = fused_mlp_plain(*leaves, w2, b2, ln=(g, bt), act="relu",
                                  save_h=True, **k)
        return out, torch.autograd.grad(out, leaves, dout)

    out, want = grads()
    same, same_grads = grads(kink_from=h)
    assert torch.equal(out, same)
    assert all(torch.equal(a, b) for a, b in zip(want, same_grads))
    _, flipped = grads(kink_from=torch.where(h > 0, -1.0, 1.0))
    step = (flipped[2] - want[2]).abs()
    assert (step[:4] > 1e-3).all() and (step[4:] <= 1e-5).all()
    with pytest.raises(ValueError, match="relu"):
        fused_mlp_plain(x, w1, b1, w2, b2, ln=(g, bt), act="gelu",
                        kink_from=h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_premlp_kink_census_caps(dtype):
    """premlp_kink_census counts relu_kink's marks of the plain h and the
    marked that kink_from puts on the other side of 0: a few flips pass;
    the band on the other side throughout, or a band over KINK_SHARE of the
    pre-activations, raise."""
    from idvs.morec_tpu_torch.ops.cuda.mlp import (KINK_SHARE,
                                                   premlp_kink_census,
                                                   relu_kink)
    from idvs.morec_tpu_torch.models.layers import layer_norm
    rng = np.random.default_rng(18)
    M, C, F = 128, 64, 256
    t = lambda *s, scale=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * scale)
    x, w1 = t(M, C).to(dtype), t(C, F, scale=C ** -0.5)
    g, bt = 1.0 + t(C, scale=0.1), t(C, scale=0.1)
    xn = layer_norm(x, g, bt, 1e-5)
    s = xn.float() @ w1.to(dtype).float()
    # row 0's units 0-15 put at 0, within rounding (bf16: b1's own)
    b1 = t(F, scale=0.1)
    b1[:16] = -s[0, :16]
    ln = dict(ln=(g, bt), eps=1e-5)
    h = s + b1.to(dtype).float()
    at_kink = relu_kink(h, xn, w1.to(dtype), b1.to(dtype))
    n, marked, flips = premlp_kink_census(x, w1, b1, h, **ln)
    assert (n, marked, flips) == (M * F, int(at_kink.sum()), 0)
    assert 12 <= marked <= KINK_SHARE[dtype] * n
    # three marked on the other side pass
    few = h.clone()
    rows, cols = at_kink.nonzero()[:3].T
    few[rows, cols] = torch.where(h[rows, cols] > 0, -1.0, 1.0)
    assert premlp_kink_census(x, w1, b1, few, **ln)[2] == 3
    # the whole band on the other side: refused
    with pytest.raises(ValueError, match="KINK_FLIPS"):
        premlp_kink_census(x, w1, b1, torch.where(h > 0, -1.0, 1.0), **ln)
    # every pre-activation at 0: the band over its cap, refused
    with pytest.raises(ValueError, match="KINK_SHARE"):
        premlp_kink_census(x.new_zeros(M, C), w1, torch.zeros(F),
                           torch.zeros(M, F), ln=None, eps=1e-5)
