"""Times the Swin block's forward kernels (csrc/premlp.cu and
csrc/win_attn.cu) and the windowed attention's backward (its attention
core csrc/win_attn_bwd.cu among gemm.cu's products) at the four Swin-T
stages on one GPU, and reports what the compiler made of them.

    python -m idvs.morec_tpu_torch.bench_swin [--reps N] [--report]
        [--rows fwd,bwd,mlp,opt] [--dtype bf16|f32]

Rows, bf16 or (``--dtype f32``) float32, 512 images a stage (an encode
chunk, ``item_emb_batch_size``): ``fused_mlp`` with its LayerNorm and
``fused_mlp_res`` (unit), F = 4C, GELU; ``fused_mha_proj_band`` with one
bias (P = 1) and ``fused_mha_proj`` on the partitioned windows with a bias
per window (P = nW), T = 49, heads of 32. Row ``opt``: ``fused_mlp_res``
(unit, ReLU) at OPT-125M's encode chunk, 512 titles of 30 tokens, C 768,
F 3072. Each as CUDA-event time around the Python call (median of --reps)
and as device time a call (torch.profiler: every kernel the call
launched, by name), beside the least time the card could take
(``measure.bound_of``: operations at the bf16 rate or, in float32, at
3xTF32's, or bytes) and the yardstick: the same products through
torch.matmul in the row's dtype (float32 with TF32 off; the MLP's two; the
attention's qkv projection, the batched scores and P . V, the output
projection), which the port never calls for these.

Backward rows, 288 images a stage (a Zipf train batch's dedup capacity),
bf16 or (``--dtype f32``) float32: ``fused_mha_proj_band``'s backward with
one bias (P = 1) and ``fused_mha_proj``'s on the partitioned windows with a
bias per window (P = nW), as CUDA-event and device time of autograd's
backward of the call, and the device time of the attention core alone (the
kernels of ``CORE``: the core and its fixed-order dbias sum) beside the
core's own bound (``core_work``).

MLP backward rows, bf16, 288 images a stage: ``fused_mlp_res`` with
DropPath's row scale (the band path's block) and ``fused_mlp`` with its
LayerNorm (the window path's), F = 4C, GELU, as CUDA-event and device time
of autograd's backward of one kept forward, by kernel, beside
``mlp_bwd_work``'s bound and the yardstick of its five products through
torch.matmul on bf16 operands (h = xn w1, dg = dy w2ᵀ, dW2 = gᵀ dy, dW1 =
xnᵀ dh, dxn = dh w1ᵀ); where the tree has ``premlp_bwd_plan``, the row
names the plan's route and times its call alone and the products
route's (``routes``: event and device ms; "fused" at stages 0-2, "wg" at
stage 3 from PR 17 on, "products" at stage 3 before).

--report compiles premlp.cu, premlp_bwd.cu, premlp_bwd_wg.cu, win_attn.cu and win_attn_bwd.cu with the
library's flags and -Xptxas -v and prints each kernel's registers, spills
and static shared memory and its HMMA instructions (bench_gemm's report);
the bf16 plans' dynamic shared memory is in each row (``plan_smem``).
--rows keeps the forward, backward, MLP backward and OPT rows named;
--dtype sets the forward, backward and OPT rows' dtype (the MLP backward
rows are bf16).

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernels
with the same cases (the checkout needs ``measure.py``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

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
# tensor-core backward in either dtype, shared) or an older tree's, and the
# dbias sum
CORE = ("win_attn_bwd", "mha_bwd_mma", "mha_bwd_tf32", "sum_partials")
# device_ms: the traces of a call it takes before it gives up
TRACE_TRIES = 5
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


def mlp_bwd_work(M, C, F, it=2, scale=False):
    """(operations, bytes) of the pre-LN MLP's backward: h again, dW2, dg,
    dW1, dxn (10 M C F); x, dout, the weights and biases read once, dx and
    the weights' and biases' gradients written once, the LayerNorm's float
    vectors and their gradients, the float row scale."""
    return 10 * M * C * F, ((3 * M * C + 4 * C * F + 2 * F + 2 * C) * it
                            + 16 * C + (4 * M if scale else 0))


def mlp_bwd_products(x2, dy, w1, w2):
    """A function that runs the MLP backward's five products through
    torch.matmul on bf16 operands, an (M, F) bf16 tensor standing for g
    and dh."""
    g = torch.matmul(x2, w1)
    return lambda: (torch.matmul(x2, w1), torch.matmul(dy, w2.t()),
                    torch.matmul(g.t(), dy), torch.matmul(x2.t(), g),
                    torch.matmul(g, w1.t()))


def mlp_products(x2, w1, w2):
    """A function that runs the MLP's two products through torch.matmul on
    operands of x2's dtype (x w1, then g w2 with g an (M, F) tensor)."""
    g = torch.matmul(x2, w1)
    return lambda: (torch.matmul(x2, w1), torch.matmul(g, w2))


def attention_products(xw, wqkv, wo, nh):
    """A function that runs the windowed attention's products through
    torch.matmul on operands of xw's dtype: x wqkv, the (T, T) scores and
    P . V of every window and head, ctx wo."""
    B, T, C = xw.shape
    x2 = xw.reshape(-1, C)
    qkv = torch.matmul(x2, wqkv).reshape(B, T, 3, nh, C // nh)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    kt = k.transpose(-1, -2).contiguous()
    p = torch.softmax(torch.matmul(q, kt).float(), -1).to(xw.dtype)
    ctx = torch.matmul(p, v).transpose(1, 2).reshape(-1, C).contiguous()
    return lambda: (torch.matmul(x2, wqkv), torch.matmul(q, kt),
                    torch.matmul(p, v), torch.matmul(ctx, wo))


def _plan_smem(plan, *args, dt):
    """A plan's shared-memory bytes for dtype dt, or None where the tree
    has no such plan (an older checkout's: no plan, or bf16's alone)."""
    if plan is None:
        return None
    try:
        return plan(*args, dt)["smem"]
    except (TypeError, KeyError):
        return plan(*args)["smem"] if dt == BF16 else None


def swin_rows(g, images=IMAGES, dt=BF16):
    """(row, stage, label, call, work, plan smem or None, products factory)
    for each forward row at each Swin-T stage in dtype dt; g(*shape,
    scale=) draws a float tensor on the card."""
    from idvs.morec_tpu_torch.ops.cuda import attention, mlp
    plan_mlp = getattr(mlp, "premlp_plan", None)
    plan_win = getattr(attention, "win_attn_plan", None)
    T, it = WINDOW * WINDOW, torch.finfo(dt).bits // 8
    for stage, (C, nh, side) in enumerate(SWIN_T):
        nW = (side // WINDOW) ** 2
        M, F, windows = images * side * side, 4 * C, images * nW
        x = g(images, side, side, C).to(dt)
        x2 = x.reshape(M, C)
        w1, b1 = g(C, F, scale=C ** -0.5), g(F, scale=0.1)
        w2, b2 = g(F, C, scale=F ** -0.5), g(C, scale=0.1)
        ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
        mlp_smem = _plan_smem(plan_mlp, C, dt=dt)
        yield ("fused_mlp", stage, f"LN M={M} C={C} F={F} gelu",
               lambda: fused_mlp(x2, w1, b1, w2, b2, ln=ln),
               mlp_work(M, C, F, it), mlp_smem,
               lambda: mlp_products(x2, w1.to(dt), w2.to(dt)))
        yield ("fused_mlp_res", stage, f"unit M={M} C={C} F={F} gelu",
               lambda: fused_mlp_res(x2, None, w1, b1, w2, b2, ln=ln),
               mlp_work(M, C, F, it), mlp_smem,
               lambda: mlp_products(x2, w1.to(dt), w2.to(dt)))
        ws = (g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
              g(C, C, scale=C ** -0.5), g(C, scale=0.1))
        rel = g(1, nh, T, T, scale=0.5)
        win_smem = _plan_smem(plan_win, T, C, nh, dt=dt)
        yield ("fused_mha_proj_band", stage,
               f"P=1 N={images} {side}x{side} C={C} nh={nh}",
               lambda: fused_mha_proj_band(x, rel, *ws, n_heads=nh,
                                           window=WINDOW),
               win_attn_work(windows, T, C, nh, 1, it), win_smem,
               lambda: attention_products(window_partition(x, WINDOW),
                                          ws[0].to(dt), ws[2].to(dt), nh))
        wins = window_partition(x, WINDOW)
        bias = rel.repeat(nW, 1, 1, 1)
        yield ("fused_mha_proj", stage,
               f"P={nW} B={windows} T={T} C={C} nh={nh}",
               lambda: fused_mha_proj(wins, bias, *ws, n_heads=nh),
               win_attn_work(windows, T, C, nh, nW, it), win_smem,
               lambda: attention_products(wins, ws[0].to(dt),
                                          ws[2].to(dt), nh))


# OPT-125M's encode chunk: 512 titles of 30 tokens, C 768, F 3072
OPT_M, OPT_C, OPT_F = 512 * 30, 768, 3072


def opt_rows(g, dt=BF16):
    """The ``opt`` row: fused_mlp_res unit ReLU at OPT's encode chunk, as
    swin_rows gives its rows."""
    from idvs.morec_tpu_torch.ops.cuda import mlp
    M, C, F = OPT_M, OPT_C, OPT_F
    x2 = g(M, C).to(dt)
    w1, b1 = g(C, F, scale=C ** -0.5), g(F, scale=0.1)
    w2, b2 = g(F, C, scale=F ** -0.5), g(C, scale=0.1)
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    yield ("fused_mlp_res", "opt", f"unit M={M} C={C} F={F} relu",
           lambda: fused_mlp_res(x2, None, w1, b1, w2, b2, ln=ln,
                                 act="relu"),
           mlp_work(M, C, F, torch.finfo(dt).bits // 8),
           _plan_smem(getattr(mlp, "premlp_plan", None), C, dt=dt),
           lambda: mlp_products(x2, w1.to(dt), w2.to(dt)))


def swin_bwd_rows(g, images=BWD_IMAGES, dt=BF16):
    """(row, stage, label, call, work of the core) for the band backward
    (P = 1) and the window layout's (P = nW) at each Swin-T stage in dtype
    dt: call runs autograd's backward of one kept forward."""
    T, it = WINDOW * WINDOW, torch.finfo(dt).bits // 8
    for stage, (C, nh, side) in enumerate(SWIN_T):
        nW = (side // WINDOW) ** 2
        windows = images * nW
        x = g(images, side, side, C).to(dt)
        rel = g(1, nh, T, T, scale=0.5)
        weights = (g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
                   g(C, C, scale=C ** -0.5), g(C, scale=0.1))
        dout = g(images, side, side, C).to(dt)
        for name, P in (("fused_mha_proj_band_bwd", 1),
                        ("fused_mha_proj_bwd", nW)):
            if name == "fused_mha_proj_band_bwd":
                leaves = [x.clone().requires_grad_(True),
                          rel.clone().requires_grad_(True)]
                fn = lambda *a: fused_mha_proj_band(*a, n_heads=nh,
                                                    window=WINDOW)
                d, label = dout, f"P=1 N={images} {side}x{side}"
            else:
                leaves = [window_partition(x, WINDOW).requires_grad_(True),
                          rel.repeat(nW, 1, 1, 1).requires_grad_(True)]
                fn = lambda *a: fused_mha_proj(*a, n_heads=nh)
                d, label = window_partition(dout, WINDOW), \
                    f"P={nW} B={windows} T={T}"
            leaves += [w.clone().requires_grad_(True) for w in weights]
            out = fn(*leaves)
            yield (name, stage, f"{label} C={C} nh={nh} {str(dt)[6:]}",
                   lambda out=out, leaves=leaves, d=d: torch.autograd.grad(
                       out, leaves, d, retain_graph=True),
                   core_work(windows, T, C, nh, P, it))
            del out, leaves


def mlp_bwd_rows(g, images=BWD_IMAGES):
    """(row, stage, label, call, work, products factory, routes, plan) for
    the MLP backward at each Swin-T stage, bf16: call runs autograd's
    backward of one kept forward; routes maps each route of
    ``PREMLP_BWD_ROUTES`` to a call of it alone on the same operands: the
    plan's route and the products route (None in a tree without the plan,
    or where the plan takes the products route)."""
    from idvs.morec_tpu_torch.ops.cuda import mlp
    plan = getattr(mlp, "premlp_bwd_plan", None)
    routes = getattr(mlp, "PREMLP_BWD_ROUTES", None)
    for stage, (C, _, side) in enumerate(SWIN_T):
        M, F = images * side * side, 4 * C
        x2 = g(M, C).to(BF16)
        dout = g(M, C).to(BF16)
        weights = [g(C, F, scale=C ** -0.5), g(F, scale=0.1),
                   g(F, C, scale=F ** -0.5), g(C, scale=0.1)]
        ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
        # DropPath's factor: an image kept (1 / 0.9) or dropped (0)
        keep = (g(images) > -1.2815516).float() / 0.9
        scale = keep.repeat_interleave(side * side).contiguous()
        bf = [t.to(BF16).contiguous() for t in weights[:3]]
        for name, label, res in (
                ("fused_mlp_res_bwd", f"scaled M={M} C={C} F={F} gelu", True),
                ("fused_mlp_bwd", f"LN M={M} C={C} F={F} gelu", False)):
            leaves = [t.clone().requires_grad_(True)
                      for t in [x2] + weights + ln]
            if res:
                out = fused_mlp_res(leaves[0], scale, *leaves[1:5],
                                    ln=leaves[5:])
            else:
                out = fused_mlp(*leaves[:5], ln=leaves[5:])
            k = plan(C, M, BF16) if plan else None
            calls = None
            if routes and k["route"] != "products":
                ops = (x2, dout, scale if res else None, *bf, ln, None, 1e-5,
                       "gelu", res, 1)
                calls = {r: (lambda fn=routes[r], ops=ops: fn(*ops))
                         for r in (k["route"], "products")}
            yield (name, stage, label,
                   lambda out=out, leaves=leaves: torch.autograd.grad(
                       out, leaves, dout, retain_graph=True),
                   mlp_bwd_work(M, C, F, scale=res),
                   lambda: mlp_bwd_products(x2, dout, bf[0], bf[2]), calls,
                   k)


def device_ms(fn, reps, expect=()):
    """Device time a call (ms) and the kernels it launched, by name (ms a
    call each), from a torch.profiler trace of `reps` calls, reps >= 3.

    On the H100 a trace loses launches: without a warm-up, the first
    launch of some kernels in each trace (the window backward's core in
    every trace of three calls), so that the recorded time over `reps`
    read up to 20 % fast (PERF.md §7). So one call runs in the
    profiler's warm-up step, whose records are dropped, before the
    traced calls. Even then a trace can miss a launch; a kernel's time a
    call is therefore its mean time a recorded launch times its launches
    a call, and a trace is kept only where each kernel has a whole
    multiple of `reps` launches or one fewer, and each name of `expect`
    among them. Else the trace is taken again, up to TRACE_TRIES times,
    and then the time is nan: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if reps < 3:
        raise ValueError(f"device_ms takes reps >= 3, got {reps}")
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if (events and all(e.count % reps in (0, reps - 1) for e in events)
                and all(any(n in e.key for e in events) for n in expect)):
            kernels = {e.key: e.self_device_time_total / 1e3 / e.count
                       * -(-e.count // reps) for e in events}
            return sum(kernels.values()), kernels
    print(f"device_ms: {TRACE_TRIES} traces of {reps} calls each lost "
          f"launches; device time not measured", file=sys.stderr, flush=True)
    return math.nan, {}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--report", action="store_true")
    parser.add_argument("--rows", default="fwd,bwd,mlp",
                        help="comma-separated: fwd, bwd, mlp, opt")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                        help="the forward, backward and opt rows' dtype")
    args = parser.parse_args()
    rows = set(args.rows.split(","))
    bwd_dt = BF16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("bench_swin: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.report:
        from idvs.morec_tpu_torch.bench_gemm import report
        report(("premlp.cu", "premlp_bwd.cu", "premlp_bwd_wg.cu",
                "win_attn.cu", "win_attn_bwd.cu"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    fwd = [swin_rows(g, dt=bwd_dt)] if "fwd" in rows else []
    if "opt" in rows:
        fwd.insert(0, opt_rows(g, dt=bwd_dt))
    for name, stage, label, call, work, smem, products in (
            r for part in fwd for r in part):
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        bound, by = bound_of(work, bwd_dt, tf32x3=True)
        row = {"kernel": name, "stage": stage, "case": label,
               "dtype": args.dtype,
               "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
               "bound_ms": round(bound, 4), "bound_by": by,
               "bound_share": dev_ms and round(bound / dev_ms, 4),
               "tflops": dev_ms and round(work[0] / dev_ms / 1e9, 1),
               "plan_smem": smem,
               "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}
        fn = products()
        row["matmul_ms"] = round(cuda_ms(fn, args.reps), 4)
        row["matmul_device_ms"] = round(device_ms(fn, args.reps)[0], 4)
        del fn, call, products
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    for name, stage, label, call, work in (
            swin_bwd_rows(g, dt=bwd_dt) if "bwd" in rows else ()):
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        core = sum(v for k, v in kernels.items()
                   if any(c in k for c in CORE))
        bound, by = bound_of(work, bwd_dt, tf32x3=True)
        print(json.dumps({
            "kernel": name, "stage": stage, "case": label,
            "ms": round(ms, 4), "device_ms": round(dev_ms, 4),
            "core_device_ms": round(core, 4), "core_bound_ms": round(bound, 4),
            "core_bound_by": by, "core_bound_share": core and round(bound / core, 4),
            "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}),
            flush=True)
        del call
        torch.cuda.empty_cache()
    for (name, stage, label, call, work, products, routes,
         plan) in (mlp_bwd_rows(g) if "mlp" in rows else ()):
        ms = cuda_ms(call, args.reps)
        dev_ms, kernels = device_ms(call, args.reps)
        bound, by = bound_of(work, BF16)
        row = {"kernel": name, "stage": stage, "case": label,
               "route": plan and plan["route"], "ms": round(ms, 4),
               "device_ms": round(dev_ms, 4), "bound_ms": round(bound, 4),
               "bound_by": by,
               "bound_share": dev_ms and round(bound / dev_ms, 4),
               "tflops": dev_ms and round(work[0] / dev_ms / 1e9, 1),
               "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()}}
        fn = products()
        row["matmul_ms"] = round(cuda_ms(fn, args.reps), 4)
        del fn
        if routes:
            row["routes"] = {
                r: {"ms": round(cuda_ms(c, args.reps), 4),
                    "device_ms": round(device_ms(
                        c, args.reps, expect=(plan["kernels"][0],)
                        if r == plan["route"] else ())[0], 4)}
                for r, c in routes.items()}
        print(json.dumps(row), flush=True)
        del call, routes
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
