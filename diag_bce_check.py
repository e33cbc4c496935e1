"""Runs chip_smoke.py's float32 gradient checks of the text BCE steps on
one GPU, each twice on the same trained model: with the float32 attention
backward through its kernel (fused_mha_bwd) and through autograd of its
plain version on the card, and prints every parameter's worst error over
its scale for both (ROADMAP C11: such a check fails when one of SASRec's
ReLU units sits at its kink, whichever attention backward runs).

    python3 diag_bce_check.py

From a checkout's root; chip_smoke and the package are imported from
there, so another checkout's root runs that checkout's code.
"""

import numpy as np
import torch

import chip_smoke as cs
from idvs.morec_tpu_torch.ops.cuda import attention, lib

TOWERS = ("modal", "modal_id_add", "modal")


def plain_bwd(qkv, table, dout, args, code, drop):
    """fused_mha_bwd's result through autograd of fused_mha_plain (no
    dropout: the checks run in eval mode)."""
    nh, mode = args[2], args[4]
    with torch.enable_grad():
        q = qkv.detach().requires_grad_(True)
        kw = dict(mask=table) if mode == 0 else dict(bias=table)
        out = attention.fused_mha_plain(q, n_heads=nh, **kw)
        return torch.autograd.grad(out, q, dout.to(qkv.dtype))[0]


def report(runs, what: str) -> None:
    (lk, _, gk, _), (lp, _, gp, _) = runs
    top = max(w.abs().max().item() for w in gp.values())
    errs = sorted(((gk[n] - w).abs().max().item()
                   / max(w.abs().max().item(), cs.GRAD_FLOOR * top), n)
                  for n, w in gp.items())[::-1]
    print(f"{what}: loss {lk:.7f} vs {lp:.7f}; worst "
          + ", ".join(f"{n} {e:.2e}" for e, n in errs[:6]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("diag_bce_check: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = cs.card_info()
    lib.library()
    content = torch.from_numpy(cs.catalog(
        np.random.default_rng(cs.SEED + 1), cs.ITEM_NUM)).to(dev)
    batches = cs.train_batches(np.random.default_rng(cs.SEED + 4),
                               cs.TIMED_STEPS + 1)
    kernel_bwd, checked = attention.fused_mha_bwd, cs.card_and_plain

    def both(*a, **kw):
        runs = checked(*a, **kw)
        report(runs, "kernel")
        attention.fused_mha_bwd = plain_bwd
        try:
            report(checked(*a, **kw), "plain attention backward")
        finally:
            attention.fused_mha_bwd = kernel_bwd
        return runs

    cs.card_and_plain = both
    cs.same_step = lambda runs, what, grad_tol=None: None
    for tower in TOWERS:
        cs.bce_path(dev, card, content, batches, tower)
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
