"""Times the backward products (csrc/gemm.cu) and the word table's
scatter-add (csrc/embed_scatter.cu) at the port's main-path shapes on one
GPU, and reports what the compiler made of those kernels.

    python -m idvs.morec_tpu_torch.bench_gemm [--reps N] [--report]

Products, bf16 (``product_cases``, which ``chip_smoke.py`` checks and times
too): the three largest of Swin-T stage 0's window-attention backward for
288 images (M = 903168 rows, C = 96: the recomputed qkv = x wqkv + b,
dwqkv = xᵀ dqkv, dx = dqkv wqkvᵀ), the four of the text FFN tail's
backward (M = 23040 rows, C = 512, F = 2048: dw2 = cast(gelu(h))ᵀ dz from
the saved bf16 h, dh = (dz w2ᵀ) gelu'(h), dw1 = xᵀ dh, dx = dh w1ᵀ + dyp)
and, here only, the four of Swin-T stage 0's MLP (F = 384: h = xn w1 + b1
in float, dw2 = cast(gelu(h))ᵀ dy from the float h, dh = (dy w2ᵀ)
gelu'(h), dxn = dh w1ᵀ in float). Each as CUDA-event time around the
Python call (median of --reps), beside the one PyTorch call computing the
same function where there is one and torch.matmul of the same operands
(the library yardsticks; the port never calls them for these), with
TFLOP/s and the least time the card could take (``measure.bound_of``).
Products, float32 (``f32_product_cases``, 3xTF32 on the tensor cores; the
smoke checks and times them too): SASRec's tails at D = 2048 for a
``recommend`` of 64 and of 1 users (M = 640 and 10 rows: the projection y
= x w, dense1 h = x w1 + b1, dense2 y = relu(h) w2 with F = 8192) and the
text encode's projection (M = 15360, C = 512), each also as device time
(torch.profiler), beside torch.matmul float32 with TF32 off. The
scatter-add: BERT's 23040 token rows of 512 into the 30522-row table, in
f32 and bf16, uniform ids and titles that end in padding, beside
``index_add_``.

--report compiles gemm.cu and embed_scatter.cu with the library's flags
and -Xptxas -v and prints each kernel's registers, spills and shared
memory, and the HMMA (tensor-core) instructions of each in the SASS
(cuobjdump).

Prints one JSON object a line, then the card's name and power limit. The
package is imported from sys.path, so ``PYTHONPATH=<checkout> python
<this file>`` from another checkout's root times that checkout's kernels
with the same cases (the checkout needs ``measure.py``).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from idvs.morec_tpu_torch.bench_swin import device_ms
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import scatter_add_rows
from idvs.morec_tpu_torch.ops.cuda.gemm import gemm

BF16 = torch.bfloat16
SWIN_C, SWIN_SIDE = 96, 56           # Swin-T stage 0: C, side of the map
TITLE_LEN, HIDDEN, FFN = 30, 512, 2048   # BERT-small over titles


class Product(NamedTuple):
    label: str
    args: tuple        # gemm's (A, B, M, N, K, sa, sb)
    kw: dict           # its epilogue and prologue
    nbytes: int        # what it must move: inputs once, output once
    library: object    # the one PyTorch call of the same function, or None
    matmul: object     # torch.matmul of the same operands, or None

    @property
    def flops(self) -> int:
        M, N, K = self.args[2:5]
        return 2 * M * N * K


def product_cases(g, images: int = 288, titles: int = 768,
                  mlp: bool = True) -> list:
    """The main paths' largest bf16 products; g(*shape, scale=, d=) draws
    a tensor on the card. Swin-T stage 0 for `images` images, then (mlp)
    its MLP's, then the text FFN tail's for `titles` titles."""
    C, M = SWIN_C, images * SWIN_SIDE * SWIN_SIDE
    x, dqkv = g(M, C), g(M, 3 * C)
    wqkv, bqkv = g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1)
    io = (M * C + 3 * C * C + 3 * M * C) * 2
    out = [
        Product(f"Swin-T stage 0 qkv = x wqkv + b, M={M} C={C}",
                (x, wqkv, M, 3 * C, C, (C, 1), (3 * C, 1)),
                dict(bias=bqkv), io, lambda: torch.addmm(bqkv, x, wqkv),
                lambda: torch.matmul(x, wqkv)),
        Product(f"Swin-T stage 0 dwqkv = xT dqkv, K={M}",
                (x, dqkv, C, 3 * C, M, (1, C), (3 * C, 1)), {}, io,
                lambda: torch.matmul(x.t(), dqkv), None),
        Product(f"Swin-T stage 0 dx = dqkv wqkvT, M={M}",
                (dqkv, wqkv, M, C, 3 * C, (3 * C, 1), (1, 3 * C)), {}, io,
                lambda: torch.matmul(dqkv, wqkv.t()), None)]
    if mlp:
        F = 4 * C
        w1, b1, w2 = g(C, F, scale=C ** -0.5), g(F, scale=0.1), g(F, C)
        hf, dy, dh = g(M, F, d=torch.float32), g(M, C), g(M, F)
        out += [
            Product(f"Swin-T stage 0 h = xn w1 + b1 (f32 out), M={M}",
                    (x, w1, M, F, C, (C, 1), (F, 1)),
                    dict(bias=b1, out_f32=True),
                    (M * C + C * F + F) * 2 + M * F * 4, None,
                    lambda: torch.matmul(x, w1)),
            Product(f"Swin-T stage 0 dw2 = gelu(h)T dy (f32 h), K={M}",
                    (hf, dy, F, C, M, (1, F), (C, 1)),
                    dict(act="gelu", pro_act=True, dtype=BF16),
                    M * F * 4 + (M * C + F * C) * 2, None, None),
            Product(f"Swin-T stage 0 dh = (dy w2T) gelu'(h), M={M}",
                    (dy, w2, M, F, C, (C, 1), (1, C)),
                    dict(gate=hf, act="gelu"),
                    M * F * 4 + (M * C + F * C + M * F) * 2, None,
                    lambda: torch.matmul(dy, w2.t())),
            Product(f"Swin-T stage 0 dxn = dh w1T (f32 out), M={M}",
                    (dh, w1, M, C, F, (F, 1), (1, F)), dict(out_f32=True),
                    (M * F + C * F) * 2 + M * C * 4, None,
                    lambda: torch.matmul(dh, w1.t()))]
    Mt, Ct, Ft = titles * TITLE_LEN, HIDDEN, FFN
    h, dz, xt, dht = g(Mt, Ft), g(Mt, Ct), g(Mt, Ct), g(Mt, Ft)
    w1t, w2t = g(Ct, Ft, scale=Ct ** -0.5), g(Ft, Ct, scale=Ft ** -0.5)
    dyp = g(Mt, Ct, d=torch.float32)
    out += [
        Product(f"text dw2 = gelu(h)T dz, K={Mt}",
                (h, dz, Ft, Ct, Mt, (1, Ft), (Ct, 1)),
                dict(act="gelu", pro_act=True),
                (Mt * Ft + Mt * Ct + Ft * Ct) * 2, None,
                lambda: torch.matmul(h.t(), dz)),
        Product(f"text dh = (dz w2T) gelu'(h), M={Mt}",
                (dz, w2t, Mt, Ft, Ct, (Ct, 1), (1, Ct)),
                dict(gate=h, act="gelu"),
                (Mt * Ct + Ft * Ct + 2 * Mt * Ft) * 2, None,
                lambda: torch.matmul(dz, w2t.t())),
        Product(f"text dw1 = xT dh, K={Mt}",
                (xt, dht, Ct, Ft, Mt, (1, Ct), (Ft, 1)), {},
                (Mt * Ct + Mt * Ft + Ct * Ft) * 2, None,
                lambda: torch.matmul(xt.t(), dht)),
        Product(f"text dx = dh w1T + dyp, M={Mt}",
                (dht, w1t, Mt, Ct, Ft, (Ft, 1), (1, Ft)), dict(add=dyp),
                (Mt * Ft + Ct * Ft + Mt * Ct) * 2 + Mt * Ct * 4, None,
                lambda: torch.matmul(dht, w1t.t()))]
    return out


def f32_product_cases(g, d: int = 2048, text: bool = True) -> list:
    """The float32 products of SASRec's tails at D = d for a recommend of
    64 and of 1 users (L = 10) and (text) of the text encode's BERT
    projection; g(*shape, scale=) draws a float32 tensor on the card."""
    out = []
    F = 4 * d
    w, w1 = g(d, d, scale=d ** -0.5), g(d, F, scale=d ** -0.5)
    b1, w2 = g(F, scale=0.1), g(F, d, scale=F ** -0.5)
    for M in (640, 10):
        x, h = g(M, d), g(M, F)
        out += [
            Product(f"SASRec y = x w, M={M} C={d}",
                    (x, w, M, d, d, (d, 1), (d, 1)), dict(out_f32=True),
                    (2 * M * d + d * d) * 4, lambda x=x: torch.matmul(x, w),
                    lambda x=x: torch.matmul(x, w)),
            Product(f"SASRec h = x w1 + b1, M={M} F={F}",
                    (x, w1, M, F, d, (d, 1), (F, 1)),
                    dict(bias=b1, out_f32=True),
                    (M * d + d * F + F + M * F) * 4,
                    lambda x=x: torch.addmm(b1, x, w1),
                    lambda x=x: torch.matmul(x, w1)),
            Product(f"SASRec y = relu(h) w2, M={M} K={F}",
                    (h, w2, M, d, F, (F, 1), (d, 1)),
                    dict(act="relu", pro_act=True, out_f32=True),
                    (M * F + F * d + M * d) * 4, None,
                    lambda h=h: torch.matmul(h, w2))]
    if text:
        M, C = 512 * TITLE_LEN, HIDDEN
        x, wt = g(M, C), g(C, C, scale=C ** -0.5)
        out.append(Product(f"BERT y = x w, M={M} C={C}",
                           (x, wt, M, C, C, (C, 1), (C, 1)),
                           dict(out_f32=True), (2 * M * C + C * C) * 4,
                           lambda: torch.matmul(x, wt),
                           lambda: torch.matmul(x, wt)))
    return out


def run_f32_products(reps):
    """The float32 products, event and device time, beside torch.matmul
    float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device="cuda") * scale
    code = lib.DTYPE_CODES[torch.float32]
    for p in f32_product_cases(g):
        call = lambda: gemm(*p.args, code, **p.kw)
        ms = cuda_ms(call, reps)
        dev_ms, kernels = device_ms(call, reps)
        bound, by = bound_of((p.flops, p.nbytes), torch.float32, True)
        fma, _ = bound_of((p.flops, p.nbytes), torch.float32)
        timed = lambda fn: fn and round(cuda_ms(fn, reps), 4)
        print(json.dumps({
            "case": p.label + " f32", "ms": round(ms, 4),
            "device_ms": round(dev_ms, 4),
            "tflops": round(p.flops / dev_ms / 1e9, 1) if dev_ms else None,
            "kernels": {k[:80]: round(v, 4) for k, v in kernels.items()},
            "library_ms": timed(p.library), "matmul_ms": timed(p.matmul),
            "bound_ms": round(bound, 4), "bound_by": by,
            "fma_bound_ms": round(fma, 4)}), flush=True)


def run_products(reps):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def g(*s, scale=1.0, d=BF16):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(d)

    code = lib.DTYPE_CODES[BF16]
    for p in product_cases(g):
        ms = cuda_ms(lambda: gemm(*p.args, code, **p.kw), reps)
        timed = lambda fn: fn and round(cuda_ms(fn, reps), 4)
        bound, by = bound_of((p.flops, p.nbytes), BF16)
        print(json.dumps({
            "case": p.label, "ms": round(ms, 4),
            "tflops": round(p.flops / ms / 1e9, 1),
            "library_ms": timed(p.library), "matmul_ms": timed(p.matmul),
            "bound_ms": round(bound, 4), "bound_by": by}), flush=True)


def run_scatter(reps):
    gen = torch.Generator(device="cuda").manual_seed(1)
    M, D, V = 23040, 512, 30522
    uniform = torch.randint(1, V, (M,), generator=gen, device="cuda")
    lens = torch.randint(5, 31, (M // 30, 1), generator=gen, device="cuda")
    padded = (torch.randint(1, V, (M // 30, 30), generator=gen,
                            device="cuda")
              * (torch.arange(30, device="cuda")[None] < lens)).reshape(-1)
    for dt in (torch.float32, BF16):
        dx = torch.randn(M, D, generator=gen, device="cuda").to(dt)
        table = torch.zeros(V, D, dtype=dt, device="cuda")
        it = dx.element_size()
        bound, _ = bound_of((M * D, M * D * it + 8 * M + V * D * it), dt)
        for what, ids in (("uniform ids", uniform),
                          ("titles ending in padding", padded)):
            print(json.dumps({
                "case": f"scatter_add_rows {what} {str(dt)[6:]}",
                "ms": round(cuda_ms(lambda: scatter_add_rows(ids, dx, V),
                                    reps), 4),
                "library_ms": round(cuda_ms(
                    lambda: table.index_add_(0, ids, dx), reps), 4),
                "bound_ms": round(bound, 4)}), flush=True)


def report(sources=("gemm.cu", "embed_scatter.cu")):
    """Registers, spills and shared memory (-Xptxas -v), and HMMA
    (mma.sync) and HGMMA (wgmma) instructions (cuobjdump -sass), of the
    kernels of `sources` (files of csrc/), each kernel by its demangled
    name where c++filt is there."""
    nvcc = lib._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    filt = shutil.which("c++filt")
    name_of = (lambda n: subprocess.run([filt, n], capture_output=True,
                                        text=True).stdout.strip() or n
               ) if filt else (lambda n: n)
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            obj = Path(tmp) / f"{src}.o"
            done = subprocess.run(
                [nvcc, *lib.NVCC_FLAGS, "-c", "-Xptxas", "-v", "-I",
                 str(lib.CSRC), "-o", str(obj), str(lib.CSRC / src)],
                capture_output=True, text=True)
            if done.returncode != 0:
                raise SystemExit(done.stdout + done.stderr)
            kernel = None
            for line in (done.stdout + done.stderr).splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    kernel = name_of(m.group(1))
                elif kernel and ("registers" in line or "spill" in line):
                    print(json.dumps({"source": src, "kernel": kernel,
                                      "ptxas": line.strip()}))
            sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                                  capture_output=True, text=True).stdout
            for name, body in re.findall(
                    r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass,
                    re.S):
                print(json.dumps({"source": src, "kernel": name_of(name),
                                  "hmma": body.count("HMMA"),
                                  "hgmma": body.count("HGMMA")}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--report", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
    if args.report:
        report()
    run_products(args.reps)
    run_f32_products(args.reps)
    run_scatter(args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
