"""``save_checkpoint`` under a process group: every rank returns only once
rank 0's file is there, so any rank may load it next.

Two gloo ranks in fresh interpreters (this file run as a script, as
tests/test_torch_dp.py runs its ranks), meeting through a FileStore in the
test's directory, never importing jax. Both build the same tiny IDRec
model (``make_train_state`` broadcasts rank 0's weights); rank 1 then
overwrites its own weights, rank 0 comes to the save a second late, and
rank 1 loads the checkpoint the moment ``save_checkpoint`` returns. It
must find the file and get rank 0's weights, not its own.
"""

import os
import subprocess
import sys
import time

import torch

WORLD, ITEMS, D, L = 2, 30, 32, 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_main(rank: int, tmp: str) -> None:
    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    from idvs.morec_tpu_torch.config import Config
    from idvs.morec_tpu_torch.models.model import make_model
    from idvs.morec_tpu_torch.parallel import mesh
    from idvs.morec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
    from idvs.morec_tpu_torch.train.state import make_train_state

    mesh.init_distributed(rank, WORLD, backend="gloo",
                          store=torch.distributed.FileStore(
                              os.path.join(tmp, "store"), WORLD))
    cfg = Config(user_tower="sasrec", item_tower="id", loss="inbatch_ce",
                 max_seq_len=L, embedding_dim=D, num_attention_heads=2,
                 transformer_block=1, compute_dtype="float32", drop_rate=0.0)
    torch.manual_seed(rank)
    state = make_train_state(make_model(cfg, ITEMS, None, device="cpu"), cfg)
    mine = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    if rank == 1:
        with torch.no_grad():
            for p in state.model.parameters():
                p.fill_(7.0)
    else:
        time.sleep(1.0)     # rank 0 comes to the save late
    path = save_checkpoint(os.path.join(tmp, "ckpt"), 3, state)
    found = os.path.exists(path)
    if rank == 1:
        load_checkpoint(path, state)
    got = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.save({"found": found, "mine": mine, "got": got},
               os.path.join(tmp, f"rank{rank}.pt"))
    assert "jax" not in sys.modules
    torch.distributed.destroy_process_group()


def test_every_rank_loads_what_rank_0_just_saved(tmp_path):
    tmp = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), tmp], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    zero, one = (torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(WORLD))
    assert zero["found"] and one["found"]
    # the broadcast gave rank 1 rank 0's weights; it overwrote them, and
    # the load brought rank 0's back
    assert zero["mine"].keys() == one["got"].keys()
    for n, p in zero["mine"].items():
        assert torch.equal(one["mine"][n], p), n
        assert torch.equal(one["got"][n], p), n
        assert not torch.equal(p, torch.full_like(p, 7.0)), n


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
