"""Runs chip_smoke.py's float32 gradient checks of the text steps several
times on one GPU, each time on a freshly trained model, to show how often
the checks pass and how many SASRec ReLU units at the kink each leaves out
(chip_smoke.same_step's rule, V_KINK and V_KINK_SHARE): per run the
training phase's 20 + 10 bf16 steps and its gradient check, the BCE step
with the BERT tower and with the ID+BERT fusion towers (add, cat), and the
Swin-T fusion step, each with its float32 check against the CPU plain path.

    python3 tools/text_grad_checks.py [--runs N]

From a checkout's root, on a machine with a GPU. Prints each check's lines
as the smoke does, then one line a run and the count of runs that passed;
exits non-zero if any check failed.
"""

import argparse
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from idvs.morec_tpu_torch.ops.cuda import lib  # noqa: E402


def one_run(dev, card, content, batches, cap, pool) -> None:
    model, _, _ = cs.train_path(dev, card, content, batches, cap)
    cs.grad_check(dev, model, content, batches[0])
    del model
    for tower in ("modal", "modal_id_add", "modal_id_cat"):
        cs.bce_path(dev, card, content, batches, tower)
        torch.cuda.empty_cache()
    cs.fusion_vision(dev, card, pool)
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("text_grad_checks: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = cs.card_info()
    lib.library()
    content = torch.from_numpy(cs.catalog(
        np.random.default_rng(cs.SEED + 1), cs.ITEM_NUM)).to(dev)
    batches = cs.train_batches(np.random.default_rng(cs.SEED + 4),
                               cs.TIMED_STEPS + 1)
    cap = cs.dedup_cap(batches)
    pool = cs.image_pool(dev).cpu().numpy()
    passed = 0
    for run in range(1, args.runs + 1):
        try:
            one_run(dev, card, content, batches, cap, pool)
        except cs.PhaseError:
            traceback.print_exc()
            print(f"run {run}: a check failed", flush=True)
        else:
            passed += 1
            print(f"run {run}: every check passed", flush=True)
        torch.cuda.empty_cache()
    print(f"{passed} of {args.runs} runs passed every check [{card}]")
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    raise SystemExit(main())
