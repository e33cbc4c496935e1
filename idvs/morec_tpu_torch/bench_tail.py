"""Times the post-LN tails' forward, the FFN tail (csrc/mlp_resln.cu, and
at C = 2048 the products of csrc/gemm.cu around its row pass) and the
projection tail (csrc/proj_resln.cu in bf16 at C <= 512, else gemm.cu's
product and the row pass), at the port's main-path shapes on one GPU, and
reports what the compiler made of them.

    python -m idvs.morec_tpu_torch.bench_tail [--reps N] [--report]
        [--paths E,TR] [--backward]

Rows (``TAILS``), LN(x + dropout(act(x w1 + b1) w2 + b2)):
T, a text train step's BERT tail (768 titles of 30 tokens, C = 512, F =
2048, GELU, bf16, the training edition at dropout 0.1) and its SASRec tail
(128 users of 20, ReLU); E, a text encode chunk's BERT tail (512 titles,
float32, forward only); 2E, a two-stage text cache chunk's BERT-base tail
(512 titles, C = 768, F = 3072, float32, forward only); VT, a vision train step's SASRec tail (64 users of
10 at D = 2048, F = 8192, ReLU, bf16, training edition, dropout 0.1); R, a
vision ``recommend``'s (B = 64 and 1: M = 640 and 10, float32, forward
only) and the same in bf16; TR, a text ``recommend``'s SASRec tail (B = 64
and 1: M = 1280 and 20, C = 512, F = 2048, ReLU, float32, forward only).
Each as CUDA-event time around the Python call (median of --reps) and as
device time a call (torch.profiler, every kernel the call launched),
beside the least time the card could take (``measure.bound_of``),
TFLOP/s, and the yardstick torch.matmul of the tail's two products on the
same operands (x w1, then g w2 with g an (M, F) tensor in the compute
dtype; event and device time), which the port never calls for this.

Projection rows (``PROJS``), LN(res + dropout(x w + b)): T, the text train
step's BERT (M = 23040) and SASRec (M = 2560) tails at C = 512, bf16,
training edition at dropout 0.1; IT, IDRec's SASRec (M = 5120); E, the
text encode's BERT tail (M = 15360, float32, forward only); 2E, the
two-stage text cache's BERT-base tail (M = 15360, C = 768, float32,
forward only); VT, the vision
train step's SASRec at D = 2048 (M = 640, bf16, training); R, a vision
``recommend``'s at B = 64 and 1 (M = 640 and 10) in float32 and bf16; TR,
a text ``recommend``'s SASRec at B = 64 and 1 (M = 1280 and 20, C = 512,
float32). The same columns, the yardstick torch.matmul of x w, and the
plain version's event time (``fused_proj_resln_plain`` on the same
operands and dropout).

Backward rows (``TAIL_BWDS``, ``PROJ_BWDS``; --backward prints only
these): the tails' backward alone (``fused_mlp_resln_bwd``,
``fused_proj_resln_bwd``) at the shapes the main paths run it, bf16,
dropout 0.1: T, the text train step's BERT (M = 23040) and SASRec (M =
2560) tails at C = 512, F = 2048; IT, IDRec's SASRec (M = 5120); VT, the
vision train step's SASRec at D = 2048 (M = 640, F = 8192). Operands come
from a training forward on random data. Each row is the route
``resln_bwd_plan`` picks ("route"), as CUDA-event time and device time by
kernel, beside the bound of the backward's work (the four products of the
FFN tail or the two of the projection, x, y_pre, h, dout and the weights
read once, dx, dres and the weight gradients written once) and the
yardstick torch.matmul of the same products on operands of the same
shapes (event and device time). Where the plan picks the fused route, a
second row times the products route on the same operands, in the same
call. A checkout without ``resln_bwd_plan`` (older than the fused route)
times its one route.

Every row also gives the host's time a call (``measure.host_ms``, the card
idle before it): where it exceeds the device time, the host holds the
call. A float32 row whose call launched gemm.cu (its launch counter moved)
ran its products as 3xTF32 on the tensor cores: its bound takes that rate
(165 TFLOP/s), the FMA units' bound beside it.

--report compiles mlp_resln.cu, proj_resln.cu, mlp_mma.cuh's other user
premlp.cu and the backward's resln_bwd_wg.cu with the library's flags and
-Xptxas -v and prints each kernel's registers, spills and shared memory
and its HMMA (mma.sync) and HGMMA (wgmma) instructions (bench_gemm's
report).

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernel
with the same cases (the checkout needs ``measure.py``). --paths keeps the
rows of the given paths.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import NamedTuple

import torch

from idvs.morec_tpu_torch.bench_swin import device_ms
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms, host_ms
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.gemm import gemm
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp_resln,
                                               fused_mlp_resln_res,
                                               fused_proj_resln,
                                               fused_proj_resln_plain,
                                               fused_proj_resln_res)

BF16, F32 = torch.bfloat16, torch.float32
DROP = 0.1


class Tail(NamedTuple):
    path: str     # T, E, 2E, VT, R or TR
    M: int
    C: int
    F: int
    act: str
    dtype: torch.dtype
    train: bool   # the training edition (y_pre and h saved), dropout 0.1


TAILS = (Tail("T", 768 * 30, 512, 2048, "gelu", BF16, True),
         Tail("T", 128 * 20, 512, 2048, "relu", BF16, True),
         Tail("E", 512 * 30, 512, 2048, "gelu", F32, False),
         Tail("2E", 512 * 30, 768, 3072, "gelu", F32, False),
         Tail("VT", 64 * 10, 2048, 8192, "relu", BF16, True),
         Tail("R", 64 * 10, 2048, 8192, "relu", F32, False),
         Tail("R", 10, 2048, 8192, "relu", F32, False),
         Tail("R", 64 * 10, 2048, 8192, "relu", BF16, False),
         Tail("R", 10, 2048, 8192, "relu", BF16, False),
         Tail("TR", 64 * 20, 512, 2048, "relu", F32, False),
         Tail("TR", 20, 512, 2048, "relu", F32, False))


class Proj(NamedTuple):
    path: str     # T, IT, E, 2E, VT, R or TR
    M: int
    C: int
    dtype: torch.dtype
    train: bool   # the training edition (y_pre saved), dropout 0.1


PROJS = (Proj("T", 768 * 30, 512, BF16, True),
         Proj("T", 128 * 20, 512, BF16, True),
         Proj("IT", 256 * 20, 512, BF16, True),
         Proj("E", 512 * 30, 512, F32, False),
         Proj("2E", 512 * 30, 768, F32, False),
         Proj("VT", 64 * 10, 2048, BF16, True),
         Proj("R", 64 * 10, 2048, F32, False),
         Proj("R", 10, 2048, F32, False),
         Proj("R", 64 * 10, 2048, BF16, False),
         Proj("R", 10, 2048, BF16, False),
         Proj("TR", 64 * 20, 512, F32, False),
         Proj("TR", 20, 512, F32, False))


def proj_work(t: Proj):
    """(operations, bytes) of a projection call: x, res, w and b read
    once, the output (and y_pre in training) written once, the LN's float
    vectors."""
    it = 2 if t.dtype == BF16 else 4
    return (2 * t.M * t.C * t.C,
            (3 * t.M * t.C + t.C * t.C + t.C) * it + 8 * t.C
            + (t.M * t.C * it if t.train else 0))


def proj_call(t: Proj, g):
    """(call, yardstick factory, plain call) of a projection tail."""
    x, res = g(t.M, t.C).to(t.dtype), g(t.M, t.C).to(t.dtype)
    w, b = g(t.C, t.C, scale=t.C ** -0.5), g(t.C, scale=0.1)
    ln = (1.0 + g(t.C, scale=0.1), g(t.C, scale=0.1))
    ops = [w.to(t.dtype).contiguous(), b.to(t.dtype)]
    if t.train:
        drop = dropout.kernel_args(DROP, 7)
        call = lambda: fused_proj_resln_res(
            x, res, *ops, *ln, eps=1e-6, drop=drop, code=lib.dtype_code(x))
    else:
        call = lambda: fused_proj_resln(x, res, *ops, ln=ln, eps=1e-6)
    rate = DROP if t.train else 0.0
    plain = lambda: fused_proj_resln_plain(x, res, *ops, ln=ln, eps=1e-6,
                                           drop_rate=rate,
                                           seed=7 if rate else None)
    return call, lambda: proj_products(x, ops[0]), plain


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
    the yardstick of a tail, never called by the port. float32 products
    in full float32 (TF32 off, set here)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    g = torch.matmul(x, w1)
    return lambda: (torch.matmul(x, w1), torch.matmul(g, w2))


def proj_products(x, w):
    """The projection tail's yardstick: x w through torch.matmul in x's
    dtype (TF32 off, set here), never called by the port."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w = w.to(x.dtype)
    return lambda: torch.matmul(x, w)


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


TAIL_BWDS = (Tail("T", 768 * 30, 512, 2048, "gelu", BF16, True),
             Tail("T", 128 * 20, 512, 2048, "relu", BF16, True),
             Tail("IT", 256 * 20, 512, 2048, "relu", BF16, True),
             Tail("VT", 64 * 10, 2048, 8192, "relu", BF16, True))
PROJ_BWDS = (Proj("T", 768 * 30, 512, BF16, True),
             Proj("T", 128 * 20, 512, BF16, True),
             Proj("IT", 256 * 20, 512, BF16, True),
             Proj("VT", 64 * 10, 2048, BF16, True))


def tail_bwd_work(M, C, F, it):
    """(operations, bytes) of the FFN tail's backward: dW2, dh, dW1, dx;
    x, y_pre, h, dout, W1, W2 read, dx, dW1, dW2 written, the float
    vectors."""
    return 8 * M * C * F, (4 * M * C + M * F + 4 * C * F) * it + 16 * C


def proj_bwd_work(M, C, it):
    """(operations, bytes) of the projection tail's backward: dW and dx;
    x, y_pre, dout, W read, dx, dres, dW written, the float vectors."""
    return 4 * M * C * C, (5 * M * C + 2 * C * C) * it + 16 * C


def bwd_yardstick(M, C, F, dt, g):
    """torch.matmul of the backward's products on operands of their
    shapes in dt: the FFN tail's four (F = None: the projection's two)."""
    r = lambda *s: g(*s).to(dt)
    x, dz = r(M, C), r(M, C)
    if F is None:
        w = r(C, C)
        return lambda: (x.t() @ dz, dz @ w.t())
    h, dh, w1, w2 = r(M, F), r(M, F), r(C, F), r(F, C)
    return lambda: (h.t() @ dz, dz @ w2.t(), x.t() @ dh, dh @ w1.t())


def bwd_calls(t, g):
    """[(route, call)] of a tail's backward (Tail or Proj) on operands
    from its training forward: the wrapper (the plan's route) and, where
    the plan picks the fused route, the products route's entry."""
    from idvs.morec_tpu_torch.ops.cuda import mlp
    code, drop = lib.dtype_code(torch.empty(0, dtype=t.dtype)), \
        dropout.kernel_args(DROP, 7)
    x = g(t.M, t.C).to(t.dtype)
    ln = (1.0 + g(t.C, scale=0.1), g(t.C, scale=0.1))
    dout = g(t.M, t.C).to(t.dtype)
    plan = getattr(mlp, "resln_bwd_plan", None)
    if isinstance(t, Tail):
        ops = [w.to(t.dtype).contiguous() for w in (
            g(t.C, t.F, scale=t.C ** -0.5), g(t.F, scale=0.1),
            g(t.F, t.C, scale=t.F ** -0.5), g(t.C, scale=0.1))]
        _, ypre, h = fused_mlp_resln_res(x, *ops, *ln, eps=1e-6, act=t.act,
                                         drop=drop, code=code)
        args = (x, ops[0], ops[2], ln[0], ypre, h, dout)
        kw = dict(eps=1e-6, act=t.act, drop=drop, code=code)
        calls = [(plan and plan("mlp", t.C, t.M, t.dtype)["route"],
                  lambda: mlp.fused_mlp_resln_bwd(*args, **kw))]
        if calls[0][0] == "fused":
            calls.append(("products", lambda: mlp.mlp_resln_bwd_products(
                *args, *kw.values())))
        return calls
    w = g(t.C, t.C, scale=t.C ** -0.5).to(t.dtype).contiguous()
    b = g(t.C, scale=0.1).to(t.dtype)
    _, ypre = fused_proj_resln_res(x, g(t.M, t.C).to(t.dtype), w, b, *ln,
                                   eps=1e-6, drop=drop, code=code)
    args = (x, w, ln[0], ypre, dout)
    kw = dict(eps=1e-6, drop=drop, code=code)
    calls = [(plan and plan("proj", t.C, t.M, t.dtype)["route"],
              lambda: mlp.fused_proj_resln_bwd(*args, **kw))]
    if calls[0][0] == "fused":
        calls.append(("products", lambda: mlp.proj_resln_bwd_products(
            *args, *kw.values())))
    return calls


def backward_rows(g, reps: int):
    """The backward rows, one JSON line each."""
    cases = [(t, f"M={t.M} C={t.C} F={t.F} {t.act}",
              tail_bwd_work(t.M, t.C, t.F, 2), t.F) for t in TAIL_BWDS]
    cases += [(t, f"proj M={t.M} C={t.C}", proj_bwd_work(t.M, t.C, 2), None)
              for t in PROJ_BWDS]
    for t, case, work, F in cases:
        bound, by = bound_of(work, t.dtype)
        fn = bwd_yardstick(t.M, t.C, F, t.dtype, g)
        yard = (round(cuda_ms(fn, reps), 4), round(device_ms(fn, reps)[0], 4))
        del fn
        for route, call in bwd_calls(t, g):
            call()
            torch.cuda.synchronize()
            dev_ms, kernels = device_ms(call, reps)
            print(json.dumps({
                "path": t.path, "case": f"backward {case} bf16 drop=0.1",
                "route": route, "ms": round(cuda_ms(call, reps), 4),
                "device_ms": round(dev_ms, 4),
                "bound_ms": round(bound, 4), "bound_by": by,
                "bound_share": round(bound / dev_ms, 4),
                "tflops": round(work[0] / dev_ms / 1e9, 1),
                "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()},
                "matmul_ms": yard[0], "matmul_device_ms": yard[1]}),
                flush=True)
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--report", action="store_true")
    parser.add_argument("--backward", action="store_true",
                        help="only the backward rows")
    parser.add_argument("--paths", default="",
                        help="comma-separated paths (T, IT, E, 2E, VT, R, TR); "
                             "only their rows")
    args = parser.parse_args()
    paths = [p for p in args.paths.split(",") if p]
    if not torch.cuda.is_available():
        raise SystemExit("bench_tail: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.report:
        from idvs.morec_tpu_torch.bench_gemm import report
        report(("mlp_resln.cu", "proj_resln.cu", "premlp.cu",
                "resln_bwd_wg.cu"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    keep = lambda t: not paths or t.path in paths
    if args.backward:
        backward_rows(g, args.reps)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        return
    rows = [(t, f"M={t.M} C={t.C} F={t.F} {t.act}", *tail_call(t, g),
             None, tail_work(t)) for t in TAILS if keep(t)]
    rows += [(t, f"proj M={t.M} C={t.C}", *proj_call(t, g), proj_work(t))
             for t in PROJS if keep(t)]
    for t, case, call, products, plain, work in rows:
        before = gemm.launches
        call()
        tc = t.dtype == F32 and gemm.launches > before
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        bound, by = bound_of(work, t.dtype, tc)
        row = {"path": t.path, "case": f"{case} {str(t.dtype)[6:]}"
               + (" training drop=0.1" if t.train else ""),
               "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
               "host_ms": round(host_ms(call, args.reps), 4),
               "bound_ms": round(bound, 4), "bound_by": by,
               "bound_share": dev_ms and round(bound / dev_ms, 4),
               "tflops": dev_ms and round(work[0] / dev_ms / 1e9, 1),
               "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}
        if tc:
            row["fma_bound_ms"] = round(bound_of(work, t.dtype)[0], 4)
        fn = products()
        row["matmul_ms"] = round(cuda_ms(fn, args.reps), 4)
        row["matmul_device_ms"] = round(device_ms(fn, args.reps)[0], 4)
        del fn
        if plain is not None:
            row["plain_ms"] = round(cuda_ms(plain, args.reps), 4)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    backward_rows(g, args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
