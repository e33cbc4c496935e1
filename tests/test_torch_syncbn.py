"""SyncBN: the port's data-parallel ResNet-18 train step (BatchNorm's
statistics averaged over the process group, ``parallel/mesh.py``
``all_mean``) against the JAX package's sharded step on a 2-device CPU
mesh, whose ResNet normalises with ``axis_name='data'``.

The port runs as 2 gloo ranks in fresh interpreters (this file run as a
script, as tests/test_torch_dp.py runs its ranks), never importing jax,
from the same weights (the port's draw, perturbed, carried into the Flax
tree by ``convert.to_flax``). One in-batch CE step of 4 users (16 image
slots, 16 x 16 images, 8 a rank) in float64 on both sides: BatchNorm over a
few images amplifies float32's rounding past the tolerances below (see
tests/test_torch_vision_zoo_train.py). The losses within 1e-5 relative,
the averaged gradients within rtol 2e-4 / atol 2e-5, both ranks' running
averages within 1e-5 of the JAX step's; the ranks end equal. A step whose
norm does not sync differs from JAX's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, ITEMS, B, L, D, IMG, POOL = 2, 30, 4, 3, 16, 16, 8
CFG = dict(item_tower="modal", modality="vision", loss="inbatch_ce",
           user_tower="sasrec", max_seq_len=L, embedding_dim=D,
           batch_size=B, num_attention_heads=2, transformer_block=1,
           compute_dtype="float32", drop_rate=0.0, lr=1e-3,
           fine_tune_lr=5e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data():
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(POOL, IMG, IMG, 3), dtype=np.uint8)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    pop[0] = 1.0
    ids = rng.integers(1, 12, size=(B, L + 1))
    lm = np.ones((B, L))
    lm[1, :1] = 0.0
    ids[1, :1] = 0
    images = (pool[ids.ravel() % POOL].astype(np.float64) / 255.0
              - 0.5) / 0.5
    return ids, lm, images, np.log(pop)


def _port_model():
    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.models.model import make_model
    from idvs.morec_tpu_torch.models.resnet import ResNet
    from idvs.morec_tpu_torch.models.vision_tower import VisionTower

    tower = VisionTower(ResNet("resnet18", D, device="cpu"), "resnet", D, D,
                        device="cpu")
    return make_model(Config(**CFG), ITEMS, tower, device="cpu",
                      generator=torch.Generator().manual_seed(0))


# -- the ranks (no jax) -------------------------------------------------------

def _rank_main(rank: int, tmp: str) -> None:
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.models import resnet
    from idvs.morec_tpu_torch.parallel import mesh
    from idvs.morec_tpu_torch.train.state import (make_train_state,
                                                  param_labels)
    from idvs.morec_tpu_torch.train.step import make_train_step

    mesh.init_distributed(rank, WORLD, backend="gloo",
                          store=torch.distributed.FileStore(
                              os.path.join(tmp, "store"), WORLD))
    inputs = torch.load(os.path.join(tmp, "inputs.pt"))
    out = {}
    synced = resnet.batch_stats
    for sync in (True, False):
        # the unsynced step: each rank's own statistics
        resnet.batch_stats = (synced if sync else
                              lambda x, pg: synced(x, None))
        model = _port_model().double()
        model.load_state_dict(inputs["model"])
        cfg = Config(**CFG)
        state = make_train_state(model, cfg, param_labels(model))
        rows = mesh.host_rows(B)
        per = (L + 1) * B // WORLD
        batch = {"ids": inputs["ids"][rows], "log_mask": inputs["lm"][rows],
                 "content": inputs["images"][rank * per:(rank + 1) * per]}
        loss = make_train_step(cfg, log_pop=inputs["log_pop"])(state, batch)
        out[sync] = {"loss": loss.item(),
                     "grads": {n: p.grad.clone()
                               for n, p in model.named_parameters()},
                     "stats": {n: b.clone() for n, b in model.named_buffers()
                               if n.endswith((".mean", ".var"))}}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    assert "jax" not in sys.modules
    torch.distributed.destroy_process_group()


# -- the test process ---------------------------------------------------------

def _jax_step(variables, ids, lm, images, log_pop):
    """The JAX sharded step over 2 CPU devices in float64: the loss, the
    averaged gradients and the running averages, as port state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from idvs.morec_tpu.config import Config
    from idvs.morec_tpu.models.model import make_model as jax_make_model
    from idvs.morec_tpu.models.resnet import ResNet as JaxResNet
    from idvs.morec_tpu.models.vision_tower import VisionTower as JaxTower
    from idvs.morec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from idvs.morec_tpu.train import state as jstate
    from idvs.morec_tpu.train.step import make_train_step as jax_train_step
    from idvs.morec_tpu_torch import convert

    with jax.enable_x64(True):
        cfg = Config(**CFG)
        tower = JaxTower(net=JaxResNet(arch="resnet18", out_dim=D,
                                       axis_name="data"),
                         kind="resnet", embedding_dim=D, feature_dim=D)
        jm = jax_make_model(cfg, item_num=ITEMS, encoder=tower)
        labels = jstate.param_labels(variables["params"],
                                     jstate.default_encoder_predicate, set())
        keep = optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda g, s, p=None: (g, g))
        tx = optax.chain(keep, jstate.make_optimizer(cfg, labels))
        mesh = make_mesh(jax.devices("cpu")[:WORLD])
        p = replicate(mesh, jax.tree.map(jnp.asarray, variables))
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                                  opt_state=tx.init(p["params"]),
                                  dropout_rng=jax.random.PRNGKey(1))
        step = jax_train_step(jm, cfg, tx, mesh,
                              log_pop=jnp.asarray(log_pop))
        state, loss = step(state, shard_batch(mesh, {
            "ids": jnp.asarray(ids, jnp.int32), "log_mask": jnp.asarray(lm),
            "content": jnp.asarray(images)}))
        grads = convert.from_flax(jax.tree.map(np.asarray,
                                               state.opt_state[0]))
        stats = convert.from_flax({"batch_stats": jax.tree.map(
            np.asarray, state.params["batch_stats"])})
        return float(loss), grads, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from idvs.morec_tpu_torch import convert
    from test_torch_vision_zoo import perturbed

    tmp = str(tmp_path_factory.mktemp("syncbn"))
    ids, lm, images, log_pop = _data()
    variables = jax_tree_f64(perturbed(convert.to_flax(_port_model())))
    torch.save({"model": convert.from_flax(variables),
                "ids": torch.from_numpy(ids), "lm": torch.from_numpy(lm),
                "images": torch.from_numpy(images),
                "log_pop": torch.from_numpy(log_pop)},
               os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), tmp], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    want = _jax_step(variables, ids, lm, images, log_pop)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(WORLD)]
    return want, ranks


def jax_tree_f64(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def test_syncbn_step_matches_jax_sharded(runs):
    (loss, grads, stats), ranks = runs
    got = ranks[0][True]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert ranks[1][True]["loss"] == got["loss"]
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), grads[n].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=n)
        assert torch.equal(g, ranks[1][True]["grads"][n]), n
    assert set(stats) == set(got["stats"])
    for r in range(WORLD):
        for n, s in ranks[r][True]["stats"].items():
            np.testing.assert_allclose(s.numpy(), stats[n].numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {n}")


def test_unsynced_norm_differs(runs):
    """Each rank's own statistics give other running averages on the two
    ranks and another loss: the check above sees the all-reduce."""
    (loss, _, _), ranks = runs
    local = [ranks[r][False] for r in range(WORLD)]
    assert abs(local[0]["loss"] - loss) > 1e-4 * abs(loss)
    assert any(not torch.equal(local[0]["stats"][n], local[1]["stats"][n])
               for n in local[0]["stats"])


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _rank_main(int(sys.argv[1]), sys.argv[2])
