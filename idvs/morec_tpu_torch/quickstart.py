"""Self-contained quickstart through the port (JAX twin:
examples/synthetic_quickstart.py): generates a synthetic dataset with group
structure, trains IDRec (SASRec + in-batch debiased CE), evaluates, and
reloads the best ``epoch-N.pt`` in test mode; no external data needed.

    python -m idvs.morec_tpu_torch.quickstart [workdir] [--device cpu] \
        [config flags]

The card by default; ``--device cpu`` runs it on the CPU. Any other flags
are the CLI's and follow the quickstart's own, e.g. ``--loss bce`` (BCE with
sampled negatives) or ``--loss bce --user_tower dssm`` (DSSM).
"""

import argparse
import os

import numpy as np

from .config import parse_args
from .train.runner import run


def make_dataset(base: str, n_users=400, n_items=100, n_groups=10, seed=0,
                 lengths=(6, 11)):
    """news.tsv (items i1..i<n_items>) and behaviors.tsv (user u draws
    lengths[0] to lengths[1] - 1 distinct items of group u % n_groups)."""
    rng = np.random.default_rng(seed)
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "news.tsv"), "w") as f:
        for k in range(1, n_items + 1):
            f.write(f"i{k}\ttitle of item {k}\tabstract {k}\n")
    groups = [list(range(1 + g * n_items // n_groups,
                         1 + (g + 1) * n_items // n_groups))
              for g in range(n_groups)]
    with open(os.path.join(base, "behaviors.tsv"), "w") as f:
        for u in range(n_users):
            g = groups[u % n_groups]
            L = int(rng.integers(*lengths))
            items = rng.choice(g, size=min(L, len(g)), replace=False)
            f.write(f"u{u}\t" + " ".join(f"i{k}" for k in items) + "\n")


FLAGS = ["--root_data_dir", "./", "--dataset", "SYNTH",
         "--news", "news.tsv", "--behaviors", "behaviors.tsv",
         "--item_tower", "id", "--max_seq_len", "10", "--min_seq_len", "3",
         "--batch_size", "32", "--embedding_dim", "64",
         "--transformer_block", "2", "--lr", "1e-3",
         "--eval_batch_size", "128"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", nargs="?", default="./quickstart_data")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args, flags = parser.parse_known_args(argv)
    flags = FLAGS + flags
    make_dataset(os.path.join(args.workdir, "SYNTH"))
    os.chdir(args.workdir)

    best, best_epoch = run(parse_args(flags + ["--epoch", "5",
                                               "--mode", "train"]),
                           device=args.device)
    print(f"\nbest valid HR@10 = {best * 100:.2f} at epoch {best_epoch}")
    hit, ndcg = run(parse_args(flags + [
        "--epoch", "1", "--mode", "test",
        "--load_ckpt_name", f"epoch-{best_epoch}.pt"]), device=args.device)
    print(f"test HR@10 = {hit * 100:.2f}, nDCG@10 = {ndcg * 100:.2f}")
    return best, best_epoch, hit, ndcg


if __name__ == "__main__":
    main()
