"""Times the in-batch CE kernels (csrc/inbatch_ce.cu) at the port's CE
shapes on one GPU.

    python -m idvs.morec_tpu_torch.bench_ce [--dtype bf16|f32|both]
        [--reps N] [--cases text,IDRec] [--report]

The cases are chip_smoke.py's: the text step (B 128, L 20, D 512), the
IDRec step (B 256), the vision step (B 64, L 10, D 2048), the gathered
text step at W = 4 (every rank's candidates on the card, the rows rank 2's)
and the gathered IDRec step at W = 8 (rank 5's rows), with the smoke's
inputs: Zipf(1.2) ids for text and vision, uniform ids for IDRec, a 90 %
log mask, random log popularity. For each case and dtype: the forward
(``fused_ce``, no graph) and the backward alone on a kept graph, as
CUDA-event time around the Python call and as device time a call by
kernel (torch.profiler: ``ce_fwd_kernel``, ``ce_merge_kernel``,
``ce_bwd_kernel``, ``ce_sum_kernel``); the plain version
(``inbatch_ce_candidates``, cuBLAS and elementwise kernels) the same way;
the block plan (``ce_plan``); and the bounds, one product of 2 M N D
operations forward and three backward against the inputs' and outputs'
bytes, float32 at 3xTF32's rate (the FMA units' beside it). --report
prints ``-Xptxas -v`` and the HMMA count of every kernel of the source.

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernels
with the same cases.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from idvs.morec_tpu_torch.bench_swin import device_ms
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.ops.cuda import inbatch_ce
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import fused_ce
from idvs.morec_tpu_torch.ops.losses import inbatch_ce_candidates

ITEMS = 100_000             # the smoke's catalog
ZIPF_A = 1.2                # bench.py's Zipf exponent
# (label, users B, L, D, ranks W, rank, Zipf ids)
CASES = (("text", 128, 20, 512, 1, 0, True),
         ("IDRec", 256, 20, 512, 1, 0, False),
         ("vision", 64, 10, 2048, 1, 0, True),
         ("gathered text W=4", 128, 20, 512, 4, 2, True),
         ("gathered IDRec W=8", 256, 20, 512, 8, 5, False))
KERNELS = ("ce_fwd_kernel", "ce_merge_kernel", "ce_bwd_kernel",
           "ce_sum_kernel")


def inputs(case, dt, gen, rng, dev):
    """fused_ce's operands of one case (chip_smoke.py ce_inputs)."""
    _, B, L, D, W, rank, zipf = case
    S = L + 1
    ids = (np.minimum(rng.zipf(ZIPF_A, size=(W * B, S)), ITEMS) if zipf
           else rng.integers(1, ITEMS + 1, size=(W * B, S)))
    lm = (rng.uniform(size=(W * B, L)) < 0.9).astype(np.float32)
    pop = rng.uniform(0.01, 1.0, ITEMS + 1)
    sd = 2.0 * D ** -0.25
    u = torch.randn(B, L, D, generator=gen, device=dev) * sd
    cand = torch.randn(W * B, S, D, generator=gen, device=dev) * sd
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    own = slice(rank * B, (rank + 1) * B)
    colmask = np.concatenate([lm, np.ones((W * B, 1), np.float32)], axis=1)
    return (u.to(dt), cand.to(dt), t(ids[own].astype(np.int64)), t(lm[own]),
            t(ids.astype(np.int64)), t(colmask),
            t(np.log(pop).astype(np.float32)[ids]), rank * B * S)


def by_kernel(kernels: dict) -> dict:
    """Device ms a call of each of the CE kernels, by short name."""
    return {k: round(sum(v for n, v in kernels.items() if k in n), 5)
            for k in KERNELS if any(k in n for n in kernels)}


def run_case(case, dt, reps, gen, rng, dev):
    args = inputs(case, dt, gen, rng, dev)
    label, B, L, D, W = case[:5]
    M, N = B * L, W * B * (L + 1)
    it = torch.finfo(dt).bits // 8
    row = {"case": label, "M": M, "N": N, "D": D,
           "dtype": str(dt).split(".")[-1],
           # a checkout older than the tensor-core kernels has no plan
           "plan": inbatch_ce.ce_plan(M, N, D, L, dt,
                                      inbatch_ce.sm_count(dev.index or 0))
           if hasattr(inbatch_ce, "ce_plan") else None}
    for name, fn in (("kernel", fused_ce), ("plain", inbatch_ce_candidates)):
        with torch.no_grad():
            fwd = lambda: fn(*args)
            row[f"{name}_fwd_ms"] = cuda_ms(fwd, reps)
            total, kernels = device_ms(fwd, reps)
            row[f"{name}_fwd_device_ms"] = total
        leaves = [a.detach().requires_grad_(True) for a in args[:2]]
        loss = fn(*leaves, *args[2:])
        bwd = lambda: torch.autograd.grad(loss, leaves, retain_graph=True)
        row[f"{name}_bwd_ms"] = cuda_ms(bwd, reps)
        btotal, bkernels = device_ms(bwd, reps)
        row[f"{name}_bwd_device_ms"] = btotal
        if name == "kernel":
            row["kernel_fwd_by_kernel"] = by_kernel(kernels)
            row["kernel_bwd_by_kernel"] = by_kernel(bkernels)
        del loss
    # bytes: u, cand, the ids, masks and log popularity, the loss rows;
    # backward also m, l, ws read and du, dcand written
    aux = 12 * N + 4 * args[2].numel() + 12 * M
    fwd_work = (2 * M * N * D, (M + N) * D * it + aux)
    bwd_work = (6 * M * N * D, 2 * (M + N) * D * it + aux)
    for what, work in (("fwd", fwd_work), ("bwd", bwd_work)):
        ms, by = bound_of(work, dt, tf32x3=True)
        row[f"{what}_bound_ms"], row[f"{what}_bound_by"] = ms, by
        if dt == torch.float32:
            row[f"{what}_fma_bound_ms"] = bound_of(work, dt)[0]
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("bf16", "f32", "both"),
                        default="both")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--cases", default="",
                        help="comma-separated labels; only these cases")
    parser.add_argument("--report", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_ce: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.report:
        from idvs.morec_tpu_torch.bench_gemm import report
        report(("inbatch_ce.cu",))
    dts = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
           "both": (torch.float32, torch.bfloat16)}[args.dtype]
    labels = [w for w in args.cases.split(",") if w]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    for case in CASES:
        if labels and case[0] not in labels:
            continue
        for dt in dts:
            print(json.dumps(run_case(case, dt, args.reps, gen, rng, dev)),
                  flush=True)
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
