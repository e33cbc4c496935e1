"""Port's towers vs their Flax twins (the XLA path on the CPU), with the
Flax weights carried over by convert.from_flax; and the weight bridge
itself. Float32, tolerance 2e-5 as the JAX package's own module tests."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.sasrec import SASRecEncoder as JaxSASRec
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.sasrec import SASRecEncoder
from idvs.morec_tpu_torch.models.text_tower import TextTower

TOL = 2e-5
BERT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(convert.from_flax(_numpy(variables)), strict=True)
    return module.eval()


def _tokens(rng, N, T, vocab=97):
    ids = rng.integers(1, vocab, size=(N, T))
    lens = rng.integers(1, T + 1, size=N)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    return ids * att, att


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_sasrec_encoder_matches_flax():
    B, L, D = 5, 8, 32
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, size=B)
    log_mask = (np.arange(L)[None] >= L - lens[:, None]).astype(np.float32)
    jm = JaxSASRec(d_model=D, n_heads=2, n_layers=2, max_seq_len=L,
                   drop_rate=0.0)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(embs),
                jnp.asarray(log_mask))
    want = jm.apply(v, jnp.asarray(embs), jnp.asarray(log_mask))
    tm = _load(SASRecEncoder(D, 2, 2, L, device="cpu"), v)
    _close(tm(torch.from_numpy(embs), torch.from_numpy(log_mask)), want)


@pytest.mark.parametrize("roberta", [False, True])
def test_bert_model_matches_flax(roberta):
    rng = np.random.default_rng(1)
    ids, att = _tokens(rng, 6, 12)
    extra = dict(is_roberta=True, pad_token_id=1, position_offset=2) \
        if roberta else {}
    if roberta:
        ids = np.where(att == 1, ids, 1)
    jm = jbert.BertModel(jbert.BertConfig(**BERT, **extra))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(att))
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(att))
    tm = _load(BertModel(BertConfig(**BERT, **extra), device="cpu"), v)
    _close(tm(torch.from_numpy(ids), torch.from_numpy(att)), want)


@pytest.mark.parametrize("pooling,attrs", [("cls", (10,)), ("mean", (10,)),
                                           ("cls", (10, 6))])
def test_text_tower_matches_flax(pooling, attrs):
    """CLS and masked-mean pooling, and the mean over two attributes."""
    rng = np.random.default_rng(2)
    parts = []
    for n in attrs:
        ids, att = _tokens(rng, 7, n)
        parts += [ids, att]
    content = np.concatenate(parts, axis=1)
    jm = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                      embedding_dim=24, word_embedding_dim=32,
                      pooling=pooling, attr_lengths=attrs)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(content))
    want = jm.apply(v, jnp.asarray(content))
    tm = _load(TextTower(BertModel(BertConfig(**BERT), device="cpu"), 24, 32,
                         pooling=pooling, attr_lengths=attrs,
                         device="cpu"), v)
    _close(tm(torch.from_numpy(content)), want)


def _rec_models(item_tower):
    """The same RecModel in both packages, the Flax init loaded into the
    port; content is a (item_num + 1, 2 * T) token catalog for 'modal'."""
    item_num, L, D, T = 30, 6, 32, 10
    cfg = Config(item_tower=item_tower, max_seq_len=L, embedding_dim=D,
                 num_attention_heads=2, transformer_block=2, drop_rate=0.0,
                 num_words_title=T)
    rng = np.random.default_rng(3)
    ids, att = _tokens(rng, item_num + 1, T)
    content = np.concatenate([ids, att], axis=1)
    jenc = tenc = None
    if item_tower == "modal":
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=32)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 32,
                         device="cpu")
    jm = jax_make_model(cfg, item_num=item_num, encoder=jenc)
    item_ids = rng.integers(1, item_num + 1, size=(2, L + 1))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(item_ids),
                jnp.asarray(content[item_ids.reshape(-1)])
                if jenc is not None else None,
                jnp.ones((2, L), jnp.float32))
    tm = _load(make_model(cfg, item_num, tenc, device="cpu"), v)
    return jm, v, tm, content, rng, (item_num, L, D)


@pytest.mark.parametrize("item_tower", ["id", "modal"])
def test_rec_model_towers_match_flax(item_tower):
    jm, v, tm, content, rng, (item_num, L, D) = _rec_models(item_tower)
    ids = np.arange(item_num + 1)
    c = content if item_tower == "modal" else None
    want = jm.apply(v, jnp.asarray(ids),
                    None if c is None else jnp.asarray(c),
                    method="item_embs")
    got = tm.item_embs(torch.from_numpy(ids),
                       None if c is None else torch.from_numpy(c))
    _close(got, want)
    if item_tower == "id":
        assert not got[0].any()          # padding row 0 is zero
    embs = rng.standard_normal((4, L, D)).astype(np.float32)
    log_mask = np.ones((4, L), np.float32)
    log_mask[1, :3] = 0
    want = jm.apply(v, jnp.asarray(embs), jnp.asarray(log_mask),
                    method="user_states")
    _close(tm.user_states(torch.from_numpy(embs),
                          torch.from_numpy(log_mask)), want)


def test_from_flax_then_to_flax_is_identity():
    _, v, tm, *_ = _rec_models("modal")
    v = _numpy(v)
    back = convert.to_flax(tm)
    flat_in = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_out[k], flat_in[k])


def test_port_init_is_seeded_and_pads_row_zero():
    cfg = Config(item_tower="id", max_seq_len=6, embedding_dim=16,
                 num_attention_heads=2, transformer_block=1)
    a = make_model(cfg, 20, device="cpu",
                   generator=torch.Generator().manual_seed(7))
    b = make_model(cfg, 20, device="cpu",
                   generator=torch.Generator().manual_seed(7))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    assert not a.id_embedding.weight[0].any()
    assert a.id_embedding.weight[1:].abs().sum() > 0
