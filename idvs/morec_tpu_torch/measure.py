"""What the port's timings share: the card's published peaks, the least time
it could take for a call's work, and CUDA-event timing of a call.
``chip_smoke.py``, ``bench_gemm`` and ``bench_mha`` take them from here."""

from __future__ import annotations

import statistics

import torch

# H100 SXM data sheet: dense tensor-core bf16, float32 outside the tensor
# cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


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


def bound_of(work, dt) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for work = (float operations, bytes), the larger of the operations over
    the peak rate of their type `dt` and the bytes over the memory rate."""
    ops_ms = work[0] / PEAK_FLOPS[dt] * 1e3
    bytes_ms = work[1] / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))
