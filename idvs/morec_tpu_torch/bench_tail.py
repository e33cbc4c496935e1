"""Times the post-LN FFN tail's forward (csrc/mlp_resln.cu, and at C =
2048 the products of csrc/gemm.cu around its row pass) at the port's
main-path shapes on one GPU, and reports what the compiler made of it.

    python -m idvs.morec_tpu_torch.bench_tail [--reps N] [--report]

Rows (``TAILS``), LN(x + dropout(act(x w1 + b1) w2 + b2)):
T, a text train step's BERT tail (768 titles of 30 tokens, C = 512, F =
2048, GELU, bf16, the training edition at dropout 0.1) and its SASRec tail
(128 users of 20, ReLU); E, a text encode chunk's BERT tail (512 titles,
float32, forward only); VT, a vision train step's SASRec tail (64 users of
10 at D = 2048, F = 8192, ReLU, bf16, training edition, dropout 0.1); R, a
vision ``recommend``'s (B = 64 and 1: M = 640 and 10, float32, forward
only) and the same in bf16. Each as CUDA-event time around the Python call
(median of --reps) and as device time a call (torch.profiler, every kernel
the call launched), beside the least time the card could take
(``measure.bound_of``), TFLOP/s, and the yardstick torch.matmul of the
tail's two products on the same operands (x w1, then g w2 with g an (M, F)
tensor in the compute dtype), which the port never calls for this.

--report compiles mlp_resln.cu and mlp_mma.cuh's other user premlp.cu with
the library's flags and -Xptxas -v and prints each kernel's registers,
spills and shared memory and its HMMA instructions (bench_gemm's report).

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernel
with the same cases (the checkout needs ``measure.py``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import NamedTuple

import torch

from idvs.morec_tpu_torch.bench_swin import device_ms
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp_resln,
                                               fused_mlp_resln_res)

BF16, F32 = torch.bfloat16, torch.float32
DROP = 0.1


class Tail(NamedTuple):
    path: str     # T, E, VT or R
    M: int
    C: int
    F: int
    act: str
    dtype: torch.dtype
    train: bool   # the training edition (y_pre and h saved), dropout 0.1


TAILS = (Tail("T", 768 * 30, 512, 2048, "gelu", BF16, True),
         Tail("T", 128 * 20, 512, 2048, "relu", BF16, True),
         Tail("E", 512 * 30, 512, 2048, "gelu", F32, False),
         Tail("VT", 64 * 10, 2048, 8192, "relu", BF16, True),
         Tail("R", 64 * 10, 2048, 8192, "relu", F32, False),
         Tail("R", 10, 2048, 8192, "relu", F32, False),
         Tail("R", 64 * 10, 2048, 8192, "relu", BF16, False),
         Tail("R", 10, 2048, 8192, "relu", BF16, False))


def tail_work(t: Tail):
    """(operations, bytes) of a call: x, the weights and biases read once,
    the output (and y_pre and h in training) written once, the LN's float
    vectors."""
    it = 2 if t.dtype == BF16 else 4
    saved = (t.M * t.C + t.M * t.F) * it if t.train else 0
    return (4 * t.M * t.C * t.F,
            (2 * t.M * t.C + 2 * t.C * t.F + t.F + t.C) * it + 8 * t.C
            + saved)


def tail_products(x, w1, w2):
    """A function that runs the tail's two products through torch.matmul
    on operands in x's dtype (x w1, then g w2 with g an (M, F) tensor):
    the yardstick of a tail, never called by the port."""
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    g = torch.matmul(x, w1)
    return lambda: (torch.matmul(x, w1), torch.matmul(g, w2))


def tail_call(t: Tail, g):
    """(call, yardstick factory) of a tail; g(*shape, scale=) draws a float
    tensor on the card."""
    x = g(t.M, t.C).to(t.dtype)
    w1, b1 = g(t.C, t.F, scale=t.C ** -0.5), g(t.F, scale=0.1)
    w2, b2 = g(t.F, t.C, scale=t.F ** -0.5), g(t.C, scale=0.1)
    ln = (1.0 + g(t.C, scale=0.1), g(t.C, scale=0.1))
    ops = [w.to(t.dtype).contiguous() for w in (w1, b1, w2, b2)]
    if t.train:
        drop = dropout.kernel_args(DROP, 7)
        call = lambda: fused_mlp_resln_res(
            x, *ops, *ln, eps=1e-6, act=t.act, drop=drop,
            code=lib.dtype_code(x))
    else:
        call = lambda: fused_mlp_resln(x, *ops, ln=ln, eps=1e-6, act=t.act)
    return call, lambda: tail_products(x, ops[0], ops[2])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--report", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_tail: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.report:
        from idvs.morec_tpu_torch.bench_gemm import report
        report(("mlp_resln.cu", "premlp.cu"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    for t in TAILS:
        call, products = tail_call(t, g)
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        work = tail_work(t)
        bound, by = bound_of(work, t.dtype)
        row = {"path": t.path, "case": f"M={t.M} C={t.C} F={t.F} {t.act} "
               f"{str(t.dtype)[6:]}" + (" training drop=0.1" if t.train
                                        else ""),
               "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
               "bound_ms": round(bound, 4), "bound_by": by,
               "bound_share": dev_ms and round(bound / dev_ms, 4),
               "tflops": dev_ms and round(work[0] / dev_ms / 1e9, 1),
               "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}
        fn = products()
        row["matmul_ms"] = round(cuda_ms(fn, args.reps), 4)
        del fn
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
