"""The port's data-parallel train step (train/step.py under a process
group, parallel/mesh.py) against the JAX package's sharded step on a
2-device CPU mesh: IDRec and a tiny text MoRec (BERT 2 layers, hidden 64),
with ``gather_negatives`` and ``use_pallas`` each on and off, float32,
dropout 0, three steps on the rows of three global batches.

The port runs as 2 gloo ranks in fresh interpreters (this file run as a
script), which meet through a FileStore in the test's directory and never
import jax. They start from the same Flax-initialised weights as the JAX
step (convert.from_flax), take the rows ``host_rows`` gives them, and
write their losses, gradients and parameters back. Tolerances as
tests/test_torch_train.py: each loss within 1e-5 relative; the first step's
averaged gradients within rtol 2e-4 / atol 2e-5; the parameters after
three steps within 3 * lr, AdamW's bound on three moves. The two ranks end
with equal parameters. IDRec with ``accumulation_step`` 3 over the same
batches against the JAX step under optax.MultiSteps: one update.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, ITEMS, B, L, D, T, STEPS = 2, 30, 4, 6, 32, 8, 3
LR, FT_LR = 1e-3, 5e-4
BERT = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CASES = list(itertools.product(("id", "modal"), (False, True),
                               (False, True)))
CFG = dict(user_tower="sasrec", stage="end2end", loss="inbatch_ce",
           max_seq_len=L, embedding_dim=D, num_attention_heads=2,
           transformer_block=2, compute_dtype="float32", drop_rate=0.0,
           lr=LR, fine_tune_lr=FT_LR, l2_weight=0.0, fine_tune_l2_weight=0.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case_name(item_tower, gather, pallas):
    return f"{item_tower}-gather{int(gather)}-pallas{int(pallas)}"


def _data():
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=ITEMS + 1)
    att = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    content = np.concatenate([rng.integers(1, 97, (ITEMS + 1, T)) * att,
                              att], axis=1)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    batches = []
    for _ in range(STEPS):
        ids = rng.integers(1, 12, size=(B, L + 1))    # items repeat
        lm = np.ones((B, L), np.float32)
        for b, pad in enumerate(rng.integers(0, L, size=B)):
            lm[b, :pad] = 0.0
            ids[b, :pad] = 0
        batches.append((ids, lm))
    return content, np.log(pop).astype(np.float32), batches


# -- the ranks (no jax) -------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
    from idvs.morec_tpu_torch.models.model import make_model
    from idvs.morec_tpu_torch.models.text_tower import TextTower
    from idvs.morec_tpu_torch.parallel import mesh
    from idvs.morec_tpu_torch.train.state import (make_train_state,
                                                  param_labels)
    from idvs.morec_tpu_torch.train.step import make_train_step

    mesh.init_distributed(rank, WORLD, backend="gloo",
                          store=torch.distributed.FileStore(
                              os.path.join(tmp, "store"), WORLD))
    inputs = torch.load(os.path.join(tmp, "inputs.pt"))
    rows = mesh.host_rows(B)
    assert rows == slice(rank * B // WORLD, (rank + 1) * B // WORLD)
    out = {}
    for item_tower, gather, pallas in CASES:
        cfg = Config(**CFG, item_tower=item_tower,
                     gather_negatives=gather, use_pallas=pallas)
        modal = item_tower == "modal"
        enc = (TextTower(BertModel(BertConfig(**BERT), device="cpu"), D, 64,
                         attr_lengths=(T,), device="cpu") if modal else None)
        model = make_model(cfg, ITEMS, enc, device="cpu")
        model.load_state_dict(inputs[item_tower])
        state = make_train_state(model, cfg,
                                 param_labels(model) if modal else None)
        step = make_train_step(cfg, item_content=inputs["content"],
                               log_pop=inputs["log_pop"])
        losses, grads = [], None
        for ids, lm in inputs["batches"]:
            losses.append(step(state, {"ids": ids[rows],
                                       "log_mask": lm[rows]}).item())
            if grads is None:
                grads = {n: p.grad.clone()
                         for n, p in model.named_parameters()}
        out[_case_name(item_tower, gather, pallas)] = {
            "losses": losses, "grads": grads,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}
    # IDRec with one accumulation window over the three batches: the
    # gradients averaged over the ranks every micro-step, one update
    cfg = Config(**CFG, item_tower="id", accumulation_step=STEPS)
    model = make_model(cfg, ITEMS, device="cpu")
    model.load_state_dict(inputs["id"])
    state = make_train_state(model, cfg)
    step = make_train_step(cfg, log_pop=inputs["log_pop"])
    losses, params = [], []
    for ids, lm in inputs["batches"]:
        losses.append(step(state, {"ids": ids[rows],
                                   "log_mask": lm[rows]}).item())
        params.append({n: p.detach().clone()
                       for n, p in model.named_parameters()})
    out["accumulation"] = {"losses": losses, "params": params}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    assert "jax" not in sys.modules
    torch.distributed.destroy_process_group()


# -- the test process ---------------------------------------------------------

def _jax_config(item_tower, gather, pallas):
    from idvs.morec_tpu.config import Config

    return Config(**{k: v for k, v in CFG.items() if k != "stage"},
                  item_tower=item_tower, batch_size=B, num_words_title=T,
                  gather_negatives=gather, use_pallas=pallas)


def _jax_setup(item_tower, content, batch):
    """The JAX model of item_tower and its Flax initialisation (neither
    flag changes a parameter)."""
    import jax
    import jax.numpy as jnp

    from idvs.morec_tpu.models import bert as jbert
    from idvs.morec_tpu.models.model import make_model as jax_make_model
    from idvs.morec_tpu.models.text_tower import TextTower as JaxTextTower

    enc = (JaxTextTower(net=jbert.BertModel(jbert.BertConfig(**BERT)),
                        embedding_dim=D, word_embedding_dim=64)
           if item_tower == "modal" else None)
    jm = jax_make_model(_jax_config(item_tower, False, False),
                        item_num=ITEMS, encoder=enc)
    ids0 = jnp.asarray(batch[0][:2], jnp.int32)
    items = (jnp.asarray(content[batch[0][:2].ravel()])
             if item_tower == "modal" else None)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids0, items,
                              jnp.asarray(batch[1][:2]))
    return jm, jax.tree.map(np.asarray, params)


def _jax_run(cfg, jm, params, content, log_pop, batches, k: int = 1):
    """The JAX sharded step on 2 CPU devices: losses, the first step's
    averaged gradients (kept by an optax stage in front of AdamW; None
    with k > 1, the optimizer then under optax.MultiSteps of k, as the JAX
    runner wraps it) and the final parameters, as port state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from idvs.morec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from idvs.morec_tpu.train import state as jstate
    from idvs.morec_tpu.train.step import make_train_step as jax_train_step
    from idvs.morec_tpu_torch import convert

    labels = (jstate.param_labels(params["params"],
                                  jstate.default_encoder_predicate, set())
              if cfg.item_tower == "modal" else None)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, jstate.make_optimizer(cfg, labels))
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    mesh = make_mesh(jax.devices("cpu")[:WORLD])
    p = replicate(mesh, params)
    # the whole state replicated as the step returns it: the second step
    # then reuses the first one's compilation
    state = replicate(mesh, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        opt_state=tx.init(p["params"]), dropout_rng=jax.random.PRNGKey(1)))
    step = jax_train_step(jm, cfg, tx, mesh,
                          item_content=(jnp.asarray(content, jnp.int32)
                                        if cfg.item_tower == "modal"
                                        else None),
                          log_pop=jnp.asarray(log_pop))
    losses, grads = [], None
    for ids, lm in batches:
        state, loss = step(state, shard_batch(mesh, {
            "ids": jnp.asarray(ids, jnp.int32),
            "log_mask": jnp.asarray(lm)}))
        losses.append(float(loss))
        if grads is None and k == 1:
            grads = convert.from_flax(jax.tree.map(np.asarray,
                                                   state.opt_state[0]))
    return losses, grads, convert.from_flax(jax.tree.map(np.asarray,
                                                         state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every case, and the JAX references."""
    from idvs.morec_tpu_torch import convert

    tmp = str(tmp_path_factory.mktemp("dp"))
    content, log_pop, batches = _data()
    setups = {tower: _jax_setup(tower, content, batches[0])
              for tower in ("id", "modal")}
    torch.save({"content": torch.from_numpy(content),
                "log_pop": torch.from_numpy(log_pop),
                "batches": [(torch.from_numpy(i), torch.from_numpy(m))
                            for i, m in batches],
                **{tower: convert.from_flax(s[1])
                   for tower, s in setups.items()}},
               os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), tmp], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(WORLD)]
    return content, log_pop, batches, setups, ranks


@pytest.mark.parametrize("item_tower,gather,pallas", CASES,
                         ids=[_case_name(*c) for c in CASES])
def test_data_parallel_step_matches_jax_sharded(runs, item_tower, gather,
                                                pallas):
    content, log_pop, batches, setups, ranks = runs
    jm, params = setups[item_tower]
    losses, grads, final = _jax_run(_jax_config(item_tower, gather, pallas),
                                    jm, params, content, log_pop, batches)
    name = _case_name(item_tower, gather, pallas)
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert ranks[1][name]["losses"] == got["losses"]
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), grads[n].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=n)
    bound = 3 * max(LR, FT_LR)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), final[n].numpy(), rtol=0,
                                   atol=bound, err_msg=n)
        assert torch.equal(p, ranks[1][name]["params"][n]), n


def test_data_parallel_accumulation_matches_multisteps(runs):
    """IDRec, accumulation_step 3 over the three batches on 2 ranks, the
    ranks' gradients averaged every micro-step (as the JAX step averages
    before its optimizer): the losses against the JAX sharded step under
    optax.MultiSteps, the parameters unchanged after micro-steps 1 and 2,
    the one update within 3 * lr of JAX's, both ranks equal."""
    content, log_pop, batches, setups, ranks = runs
    jm, params = setups["id"]
    cfg = _jax_config("id", False, False)
    losses, _, final = _jax_run(cfg, jm, params, content, log_pop, batches,
                                k=STEPS)
    got = ranks[0]["accumulation"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert ranks[1]["accumulation"]["losses"] == got["losses"]
    from idvs.morec_tpu_torch import convert

    start = convert.from_flax(params)
    for before in got["params"][:-1]:
        for n, p in before.items():
            assert torch.equal(p, start[n]), n
    for n, p in got["params"][-1].items():
        assert not torch.equal(p, start[n]), n
        np.testing.assert_allclose(p.numpy(), final[n].numpy(), rtol=0,
                                   atol=3 * LR, err_msg=n)
        assert torch.equal(p, ranks[1]["accumulation"]["params"][-1][n]), n


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
