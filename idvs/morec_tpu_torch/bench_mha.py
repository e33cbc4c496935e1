"""Times fused_mha's kernels at the port's main-path shapes on one GPU.

    python -m idvs.morec_tpu_torch.bench_mha [--dtype bf16|f32] [--reps N]

For each shape: the forward (no graph) and the backward alone on a kept
graph (autograd: ``fused_mha_bwd``, or ``fused_mha_bwd_dbias`` and its
cast for a trainable bias), each as CUDA-event time around the Python call
(host work included, which dominates the small shapes) and as the device
time a call of the library's kernels (torch.profiler: the kernels named
``mha_fwd*``, ``mha_bwd*`` and ``sum_partials``, the dbias edition's second
pass); F.scaled_dot_product_attention's forward and backward on the same
operands (the library yardstick, dropout off, the mask trainable where the
bias is; the port never calls it); and the least time the card could take
by bytes for each direction (inputs read once, outputs written once).
Shapes: BERT's attention over deduplicated titles (serving 512, training
768 titles of 30 tokens, 8 heads of 64, key mask), SASRec's (text: 64 /
128 users of L 20, 2 heads of 256; vision: 64 / 1 users of L 10, 2 heads
of 1024; causal) and Swin-T's window attention at 288 images a train step
(T 49, heads of 32, a trainable bias for all windows or one per window),
training shapes at dropout 0.1 as the train steps run them.

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernels
with the same cases.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from idvs.morec_tpu_torch.measure import PEAK_BYTES, cuda_ms
from idvs.morec_tpu_torch.ops.cuda.attention import fused_mha
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask

IMAGES = 288                # a vision train step's deduplicated images
SWIN_T = ((3, 56), (6, 28), (12, 14), (24, 7))   # heads, side of the map


def cases():
    """(label, B, T, nh, dh, kind, P, drop, trainable bias)."""
    out = [("BERT serve", 512, 30, 8, 64, "mask", 0, 0.0, False),
           ("BERT train", 768, 30, 8, 64, "mask", 0, 0.1, False),
           ("SASRec text serve", 64, 20, 2, 256, "causal", 0, 0.0, False),
           ("SASRec text train", 128, 20, 2, 256, "causal", 0, 0.1, False),
           ("SASRec vision serve", 64, 10, 2, 1024, "causal", 0, 0.0, False),
           ("SASRec vision request", 1, 10, 2, 1024, "causal", 0, 0.0,
            False),
           ("SASRec vision train", 64, 10, 2, 1024, "causal", 0, 0.1,
            False)]
    for stage, (nh, side) in enumerate(SWIN_T):
        nW = (side // 7) ** 2
        for P in sorted({1, nW}):
            out.append((f"Swin-T stage {stage} P={P}", IMAGES * nW, 49, nh,
                        32, "bias", P, 0.1, True))
    return out


def kernel_ms(fn, reps: int) -> float:
    """Device milliseconds a call of the library's fused_mha kernels
    (profiler), over reps calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in ("mha_fwd", "mha_bwd",
                                            "sum_partials"))) / 1e3 / reps


def run_case(label, B, T, nh, dh, kind, P, drop, trainable, dt, reps, gen,
             dev):
    H, it = nh * dh, torch.finfo(dt).bits // 8
    qkv = torch.randn(B, T, 3 * H, generator=gen, device=dev).to(dt)
    dout = torch.randn(B, T, H, generator=gen, device=dev).to(dt)
    if kind == "mask":
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
        kw = dict(mask=mask)
        sdpa_mask = ((1.0 - mask) * -1e9).to(dt)[:, None, None, :]
        table = B * T
    elif kind == "causal":
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        log = (torch.arange(T, device=dev)[None] >= T - lens[:, None]).float()
        bias = causal_additive_mask(log)
        kw = dict(bias=bias)
        sdpa_mask = bias.to(dt)
        table = bias.numel()
    else:
        bias = torch.randn(P, nh, T, T, generator=gen, device=dev) * 0.5
        kw = dict(bias=bias.requires_grad_(trainable))
        sdpa_mask = bias.detach().to(dt).repeat(B // P, 1, 1, 1)
        table = bias.numel()
    fwd = lambda: fused_mha(qkv, n_heads=nh, drop_rate=drop, seed=7, **kw)
    with torch.no_grad():
        fwd_ms, fwd_kernel = cuda_ms(fwd, reps), kernel_ms(fwd, reps)
    leaf = qkv.detach().requires_grad_(True)
    leaves = [leaf] + ([kw["bias"]] if trainable else [])
    out = fused_mha(leaf, n_heads=nh, drop_rate=drop, seed=7, **kw)
    bwd = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    bwd_ms, bwd_kernel = cuda_ms(bwd, reps), kernel_ms(bwd, reps)
    del out
    # the library call on views of the same operands
    heads = lambda t: t.reshape(B, T, nh, dh).transpose(1, 2)
    sleaf = qkv.detach().requires_grad_(True)
    smask = sdpa_mask.detach().requires_grad_(trainable)
    sdpa = lambda q: F.scaled_dot_product_attention(
        *(heads(t) for t in q.split(H, dim=-1)), attn_mask=smask)
    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: sdpa(qkv), reps)
    sout = sdpa(sleaf)
    sleaves = [sleaf] + ([smask] if trainable else [])
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        sout, sleaves, heads(dout), retain_graph=True), reps)
    del sout
    # bytes: qkv, the table and out forward; qkv, dout, the table, dqkv
    # (and dbias) backward
    tb = 4 * table
    fwd_bound = (4 * B * T * H * it + tb) / PEAK_BYTES * 1e3
    bwd_bound = ((7 * B * T * H * it + tb + (tb if trainable else 0))
                 / PEAK_BYTES * 1e3)
    return {"case": label, "B": B, "T": T, "nh": nh, "dh": dh,
            "P": P or None, "drop": drop, "dbias": trainable,
            "dtype": str(dt).split(".")[-1],
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_kernel_ms": fwd_kernel,
            "bwd_kernel_ms": bwd_kernel, "sdpa_fwd_ms": sdpa_fwd,
            "sdpa_bwd_ms": sdpa_bwd, "fwd_bound_ms": fwd_bound,
            "bwd_bound_ms": bwd_bound}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mha: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in cases():
        row = run_case(*case, dt, args.reps, gen, dev)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
