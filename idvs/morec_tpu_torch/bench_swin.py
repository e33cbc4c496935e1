"""Times the Swin block's forward kernels (csrc/premlp.cu and
csrc/win_attn.cu) and the windowed attention's backward (its attention
core csrc/win_attn_bwd.cu among gemm.cu's products) at the four Swin-T
stages on one GPU, and reports what the compiler made of them.

    python -m idvs.morec_tpu_torch.bench_swin [--reps N] [--report]

Rows, bf16, 512 images a stage (an encode chunk, ``item_emb_batch_size``):
``fused_mlp`` with its LayerNorm and ``fused_mlp_res`` (unit), F = 4C, GELU;
``fused_mha_proj_band`` with one bias (P = 1) and ``fused_mha_proj`` on the
partitioned windows with a bias per window (P = nW), T = 49, heads of 32.
Each as CUDA-event time around the Python call (median of --reps) and as
device time a call (torch.profiler: every kernel the call launched, by
name), beside the least time the card could take (``measure.bound_of``:
operations at the bf16 rate, or bytes) and the yardstick: the same
products through torch.matmul on bf16 operands (the MLP's two; the
attention's qkv projection, the batched scores and P . V, the output
projection), which the port never calls for these.

Backward rows, bf16, 288 images a stage (a Zipf train batch's dedup
capacity): ``fused_mha_proj_band``'s backward with one bias (P = 1), as
CUDA-event and device time of autograd's backward of the call, and the
device time of the attention core alone (the kernels of ``CORE``: the core
and its fixed-order dbias sum) beside the core's own bound (``core_work``).

--report compiles premlp.cu, win_attn.cu and win_attn_bwd.cu with the
library's flags and -Xptxas -v and prints each kernel's registers, spills
and static shared memory and its HMMA instructions (bench_gemm's report);
the bf16 plans' dynamic shared memory is in each row (``plan_smem``).

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernels
with the same cases (the checkout needs ``measure.py``).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.ops.cuda.attention import (fused_mha_proj,
                                                     fused_mha_proj_band,
                                                     window_partition)
from idvs.morec_tpu_torch.ops.cuda.mlp import fused_mlp, fused_mlp_res

BF16 = torch.bfloat16
IMAGES, WINDOW = 512, 7
BWD_IMAGES = 288
# the backward's attention core by kernel name: this tree's (fused_mha.cu's
# tensor-core backward, shared) or an older tree's, and the dbias sum
CORE = ("win_attn_bwd", "mha_bwd_mma", "sum_partials")
SWIN_T = ((96, 3, 56), (192, 6, 28), (384, 12, 14), (768, 24, 7))


def mlp_work(M, C, F, it=2):
    """(operations, bytes) of the pre-LN MLP: x, the weights and biases
    read once, the output written once, the LayerNorm's float vectors."""
    return 4 * M * C * F, (2 * M * C + 2 * C * F + F + C) * it + 8 * C


def win_attn_work(windows, T, C, nh, P, it=2):
    """(operations, bytes) of the windowed attention with its projections:
    x, the weights and the float bias read once, the output written once."""
    rows = windows * T
    return (rows * (8 * C * C + 4 * T * C),
            (2 * rows * C + 4 * C * C + 4 * C) * it + 4 * P * nh * T * T)


def core_work(windows, T, C, nh, P, it=2):
    """(operations, bytes) of the backward's attention core: qkv and dctx
    read, dqkv and the recomputed context written once, the float bias read
    and its gradient written; six (T, T, dh) products a (window, head)."""
    rows = windows * T
    return rows * 12 * T * C, 8 * rows * C * it + 8 * P * nh * T * T


def mlp_products(x2, w1, w2):
    """A function that runs the MLP's two products through torch.matmul on
    bf16 operands (x w1, then g w2 with g an (M, F) bf16 tensor)."""
    g = torch.matmul(x2, w1)
    return lambda: (torch.matmul(x2, w1), torch.matmul(g, w2))


def attention_products(xw, wqkv, wo, nh):
    """A function that runs the windowed attention's products through
    torch.matmul on bf16 operands: x wqkv, the (T, T) scores and P . V of
    every window and head, ctx wo."""
    B, T, C = xw.shape
    x2 = xw.reshape(-1, C)
    qkv = torch.matmul(x2, wqkv).reshape(B, T, 3, nh, C // nh)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    kt = k.transpose(-1, -2).contiguous()
    p = torch.softmax(torch.matmul(q, kt).float(), -1).to(xw.dtype)
    ctx = torch.matmul(p, v).transpose(1, 2).reshape(-1, C).contiguous()
    return lambda: (torch.matmul(x2, wqkv), torch.matmul(q, kt),
                    torch.matmul(p, v), torch.matmul(ctx, wo))


def swin_rows(g, images=IMAGES):
    """(row, stage, label, call, work, plan smem or None, products factory)
    for each bf16 forward row at each Swin-T stage; g(*shape, scale=) draws
    a float tensor on the card."""
    from idvs.morec_tpu_torch.ops.cuda import attention, mlp
    plan_mlp = getattr(mlp, "premlp_plan", None)
    plan_win = getattr(attention, "win_attn_plan", None)
    T = WINDOW * WINDOW
    for stage, (C, nh, side) in enumerate(SWIN_T):
        nW = (side // WINDOW) ** 2
        M, F, windows = images * side * side, 4 * C, images * nW
        x = g(images, side, side, C).to(BF16)
        x2 = x.reshape(M, C)
        w1, b1 = g(C, F, scale=C ** -0.5), g(F, scale=0.1)
        w2, b2 = g(F, C, scale=F ** -0.5), g(C, scale=0.1)
        ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
        mlp_smem = plan_mlp and plan_mlp(C, BF16)["smem"]
        yield ("fused_mlp", stage, f"LN M={M} C={C} F={F} gelu",
               lambda: fused_mlp(x2, w1, b1, w2, b2, ln=ln),
               mlp_work(M, C, F), mlp_smem,
               lambda: mlp_products(x2, w1.to(BF16), w2.to(BF16)))
        yield ("fused_mlp_res", stage, f"unit M={M} C={C} F={F} gelu",
               lambda: fused_mlp_res(x2, None, w1, b1, w2, b2, ln=ln),
               mlp_work(M, C, F), mlp_smem,
               lambda: mlp_products(x2, w1.to(BF16), w2.to(BF16)))
        ws = (g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
              g(C, C, scale=C ** -0.5), g(C, scale=0.1))
        rel = g(1, nh, T, T, scale=0.5)
        win_smem = plan_win and plan_win(T, C, nh)["smem"]
        yield ("fused_mha_proj_band", stage,
               f"P=1 N={images} {side}x{side} C={C} nh={nh}",
               lambda: fused_mha_proj_band(x, rel, *ws, n_heads=nh,
                                           window=WINDOW),
               win_attn_work(windows, T, C, nh, 1), win_smem,
               lambda: attention_products(window_partition(x, WINDOW),
                                          ws[0].to(BF16), ws[2].to(BF16), nh))
        wins = window_partition(x, WINDOW)
        bias = rel.repeat(nW, 1, 1, 1)
        yield ("fused_mha_proj", stage,
               f"P={nW} B={windows} T={T} C={C} nh={nh}",
               lambda: fused_mha_proj(wins, bias, *ws, n_heads=nh),
               win_attn_work(windows, T, C, nh, nW), win_smem,
               lambda: attention_products(wins, ws[0].to(BF16),
                                          ws[2].to(BF16), nh))


def swin_bwd_rows(g, images=BWD_IMAGES):
    """(row, stage, label, call, work of the core) for the band backward at
    each Swin-T stage, bf16: call runs autograd's backward of one kept
    forward."""
    T = WINDOW * WINDOW
    for stage, (C, nh, side) in enumerate(SWIN_T):
        windows = images * (side // WINDOW) ** 2
        x = g(images, side, side, C).to(BF16).requires_grad_(True)
        leaves = [x, g(1, nh, T, T, scale=0.5).requires_grad_(True)] + [
            w.requires_grad_(True) for w in (
                g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
                g(C, C, scale=C ** -0.5), g(C, scale=0.1))]
        out = fused_mha_proj_band(*leaves, n_heads=nh, window=WINDOW)
        dout = g(images, side, side, C).to(BF16)
        yield ("fused_mha_proj_band_bwd", stage,
               f"P=1 N={images} {side}x{side} C={C} nh={nh}",
               lambda: torch.autograd.grad(out, leaves, dout,
                                           retain_graph=True),
               core_work(windows, T, C, nh, 1))


def device_ms(fn, reps):
    """Device time a call (ms) and the kernels it launched, by name, from a
    torch.profiler trace of `reps` calls. A trace can miss kernels (on the
    H100 one row read 0 ms and one a third of its other runs' time,
    PERF.md): repeat a row before trusting an outlier."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    return sum(kernels.values()), kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--report", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_swin: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.report:
        from idvs.morec_tpu_torch.bench_gemm import report
        report(("premlp.cu", "win_attn.cu", "win_attn_bwd.cu"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    for name, stage, label, call, work, smem, products in swin_rows(g):
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        bound, by = bound_of(work, BF16)
        row = {"kernel": name, "stage": stage, "case": label,
               "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
               "bound_ms": round(bound, 4), "bound_by": by,
               "bound_share": dev_ms and round(bound / dev_ms, 4),
               "tflops": dev_ms and round(work[0] / dev_ms / 1e9, 1),
               "plan_smem": smem,
               "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}
        fn = products()
        row["matmul_ms"] = round(cuda_ms(fn, args.reps), 4)
        del fn
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    for name, stage, label, call, work in swin_bwd_rows(g):
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        core = sum(v for k, v in kernels.items()
                   if any(c in k for c in CORE))
        bound, by = bound_of(work, BF16)
        print(json.dumps({
            "kernel": name, "stage": stage, "case": label,
            "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
            "core_device_ms": round(core, 4), "core_bound_ms": round(bound, 4),
            "core_bound_by": by, "core_bound_share": core and round(bound / core, 4),
            "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}),
            flush=True)
        del call
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
