"""What the port's timings share: the card's published peaks, the least time
it could take for a call's work, and CUDA-event timing of a call.
``chip_smoke.py``, ``bench_gemm`` and ``bench_mha`` take them from here;
``bench_tail`` also the host's time a call."""

from __future__ import annotations

import statistics
import time

import torch

# H100 SXM data sheet: dense tensor-core bf16, float32 outside the tensor
# cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# float32 products on the tensor cores as 3xTF32 (csrc/gemm.cu): three
# products at the dense TF32 rate of 495 TFLOP/s
PEAK_3XTF32 = 495e12 / 3


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median milliseconds of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median milliseconds the host spends in one call, the card idle
    before each (synchronised), so no launch waits on a full queue: a
    wrapper's own work, what holds a call at small M where the device
    finishes first."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_of(work, dt, tf32x3: bool = False) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for work = (float operations, bytes), the larger of the operations over
    the peak rate of their type `dt` and the bytes over the memory rate.
    tf32x3: float32 operations run as 3xTF32 on the tensor cores, at
    PEAK_3XTF32 rather than the FMA units' rate."""
    peak = PEAK_3XTF32 if tf32x3 and dt == torch.float32 else PEAK_FLOPS[dt]
    ops_ms = work[0] / peak * 1e3
    bytes_ms = work[1] / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))
