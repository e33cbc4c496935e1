"""The port's full-catalog evaluation (train/evaluate.py ``evaluate`` over
``compute_item_embeddings``) against the JAX package's, for IDRec and text
MoRec (BERT 2 layers, width 24, built from its config), on the same
Flax-initialised weights (convert.load_flax) and the same eval batches of a
synthetic dataset: HR@10 / nDCG@10 within 1e-6 and the same per-user values,
except for users whose target's score lies within 1e-5 of another item's,
where float32 rounding may order the two either way. The port's result does
not depend on the model's mode, and padding users never count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from idvs.morec_tpu.config import Config
from idvs.morec_tpu.models import bert as jbert
from idvs.morec_tpu.models.model import make_model as jax_make_model
from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower
from idvs.morec_tpu.train.evaluate import (
    compute_item_embeddings as jax_item_embeddings, evaluate as jax_evaluate)
from idvs.morec_tpu_torch import convert
from idvs.morec_tpu_torch.data.loader import EvalBatches, pad_user_sequences
from idvs.morec_tpu_torch.data.preprocess import (read_behaviors,
                                                  read_items_text)
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.ops.metrics import masked_catalog_scores
from idvs.morec_tpu_torch.train.evaluate import (compute_item_embeddings,
                                                 eval_mode, evaluate)
from idvs.morec_tpu_torch.train.runner import _pad_histories

from tests.test_train_integration import synth_dataset

L, D, T, EVAL_B = 6, 16, 8, 24
BERT = dict(vocab_size=97, hidden_size=24, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=16, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
NEAR_TIE = 1e-5


def _data(tmp_path):
    root = synth_dataset(tmp_path, n_users=100, n_items=48)
    dic, n2i, i2n = read_items_text(root + "TINY/news.tsv")
    bd = read_behaviors(root + "TINY/behaviors.tsv", dic, n2i, i2n, L, 3)
    seqs, lens = pad_user_sequences(bd.users_valid, L + 1)
    hist = _pad_histories(bd.users_history_for_valid, L + 2)
    batches = EvalBatches(seqs, lens, L, EVAL_B, hist)
    assert batches.n % EVAL_B               # padding users in the last batch
    rng = np.random.default_rng(0)
    lens_t = rng.integers(1, T + 1, size=bd.item_num + 1)
    att = (np.arange(T)[None] < lens_t[:, None]).astype(np.int64)
    content = np.concatenate(
        [rng.integers(1, 97, (bd.item_num + 1, T)) * att, att], axis=1)
    content[0] = 0
    return bd.item_num, batches, content


def _models(item_tower, item_num, content):
    cfg = Config(item_tower=item_tower, max_seq_len=L, embedding_dim=D,
                 num_attention_heads=2, transformer_block=2, drop_rate=0.1)
    modal = item_tower == "modal"
    jenc = tenc = None
    if modal:
        jenc = JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                            embedding_dim=D, word_embedding_dim=24)
        tenc = TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 24,
                         attr_lengths=(T,), device="cpu")
    jm = jax_make_model(cfg, item_num=item_num, encoder=jenc)
    ids = jnp.ones((2, L + 1), jnp.int32)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(3), ids,
        jnp.asarray(content[np.ones(2 * (L + 1), int)]) if modal else None,
        jnp.ones((2, L), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    tm = make_model(cfg, item_num, tenc, device="cpu")
    convert.load_flax(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("item_tower", ["id", "modal"])
def test_evaluate_matches_jax(tmp_path, item_tower):
    item_num, batches, content = _data(tmp_path)
    jm, params, tm = _models(item_tower, item_num, content)
    modal = item_tower == "modal"
    jtable = jax_item_embeddings(
        jm, params, item_num,
        jnp.asarray(content, jnp.int32) if modal else None, D, batch_size=32)
    jh, jn, jhits, jndcgs = jax_evaluate(jm, params, jtable, batches,
                                         per_user=True)
    tcontent = torch.from_numpy(content) if modal else None
    table = compute_item_embeddings(tm, item_num, tcontent, D, batch_size=32)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=1e-5,
                               atol=1e-6)
    th, tn, thits, tndcgs = evaluate(tm, table, batches, per_user=True)
    assert len(thits) == len(jhits) == batches.n

    # users whose per-user values differ must sit on a near tie
    ids, lm, target, hist, _ = (np.concatenate(x) for x in zip(*batches))
    with torch.no_grad(), eval_mode(tm):
        uvec = tm.user_states(table[torch.from_numpy(ids).long()],
                              torch.from_numpy(lm))[:, -1]
    scores = masked_catalog_scores(uvec, table, torch.from_numpy(hist)
                                   ).numpy()[:batches.n]
    differ = ~np.isclose(thits, jhits, atol=1e-6) | \
        ~np.isclose(tndcgs, jndcgs, atol=1e-6)
    for u in np.flatnonzero(differ):
        row = scores[u, 1:]
        gap = np.abs(row - scores[u, target[u]])
        gap[target[u] - 1] = np.inf
        assert gap.min() < NEAR_TIE, (u, gap.min())
    slack = differ.sum() / batches.n
    assert abs(th - jh) <= 1e-6 + slack and abs(tn - jn) <= 1e-6 + slack
    assert differ.sum() <= 1

    # the model's mode changes nothing: dropout is off inside evaluate
    tm.train()
    again = evaluate(tm, compute_item_embeddings(tm, item_num, tcontent, D,
                                                 batch_size=32),
                     batches, per_user=True)
    assert tm.training
    assert again[:2] == (th, tn)
    np.testing.assert_array_equal(again[2], thits)
    np.testing.assert_array_equal(again[3], tndcgs)
