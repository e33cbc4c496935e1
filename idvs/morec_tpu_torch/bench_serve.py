"""Times text MoRec's ``recommend`` on one GPU: the SASRec user tower (D =
512, 2 blocks of 2 heads, L = 20, float32) scoring a 100_001-row catalog
table, for request batches of 1, 8 and 64, built as ``chip_smoke.py``'s
serving phase builds it (random weights from a seed; the table drawn at
random rather than encoded, since the encode is no part of a request).

    python -m idvs.morec_tpu_torch.bench_serve [--requests N]

For each batch: the p50 and p90 wall time of a request over N requests
(after 10 warm-up ones), timed for every batch before any trace; then a
torch.profiler trace of 20 requests a batch: wall time a request, device
busy time a request, and the device time a request of the kernels that
take most of it, by name; then the p50 again, after the traces. Prints one JSON object a
line, then the card's name and power limit. The package is imported from
sys.path, so ``PYTHONPATH=<checkout> python <this file>`` from another
checkout's root times that checkout (an A/B in one call).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from idvs.morec_tpu_torch.config import Config
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.serve import Retriever

# chip_smoke.py's text flagship (bench.py:71,149-156,168-172)
ITEM_NUM, TITLE_LEN, VOCAB = 100_000, 30, 30522
HIDDEN, LAYERS, HEADS, FFN = 512, 4, 8, 2048
D, USER_HEADS, BLOCKS, L = 512, 2, 2, 20
BATCHES, TOP_K, TRACED, KERNELS_SHOWN = (1, 8, 64), 10, 20, 8


def text_model(dev):
    cfg = Config(item_tower="modal", user_tower="sasrec", stage="end2end",
                 embedding_dim=D, num_attention_heads=USER_HEADS,
                 transformer_block=BLOCKS, max_seq_len=L, drop_rate=0.1)
    bcfg = BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                      num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                      intermediate_size=FFN, max_position_embeddings=512,
                      hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    encoder = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                        word_embedding_dim=HIDDEN, pooling="cls",
                        attr_lengths=(TITLE_LEN,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return make_model(cfg, ITEM_NUM, encoder, device=dev, generator=gen)


def traced(run, n: int) -> tuple:
    """(wall ms, device busy ms, {kernel: device ms}) a call of run, from a
    torch.profiler trace of n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = {e.key: e.self_device_time_total / 1e3 / n
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    return wall, sum(kernels.values()), kernels


def p50_p90(retriever, requests) -> tuple:
    """The p50 and p90 wall ms of a request, after 10 warm-up ones."""
    walls = []
    for h in requests:
        t0 = time.perf_counter()
        retriever.recommend(h, top_k=TOP_K)   # returns host arrays
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = sorted(walls[10:])
    return (round(statistics.median(walls), 4),
            round(walls[int(0.9 * len(walls))], 4))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = text_model(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(ITEM_NUM + 1, D, generator=gen, device=dev)
    retriever = Retriever(model, table, max_seq_len=L, batch_sizes=BATCHES)
    rng = np.random.default_rng(1)
    requests = {B: [[rng.integers(1, ITEM_NUM + 1,
                                  size=int(rng.integers(1, L + 6))).tolist()
                     for _ in range(B)] for _ in range(args.requests + 10)]
                for B in BATCHES}
    # every batch timed before the first trace and again after the last:
    # the profiler's hooks may stay with the process and slow its launches
    before = {B: p50_p90(retriever, h) for B, h in requests.items()}
    traces = {B: traced(lambda: retriever.recommend(h[0], top_k=TOP_K),
                        TRACED) for B, h in requests.items()}
    for B, h in requests.items():
        wall, busy, kernels = traces[B]
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:KERNELS_SHOWN]
        print(json.dumps({
            "B": B, "p50_ms": before[B][0], "p90_ms": before[B][1],
            "p50_after_traces_ms": p50_p90(retriever, h)[0],
            "traced_wall_ms": round(wall, 4),
            "device_busy_ms": round(busy, 4),
            "kernels": {k[:80]: round(v, 4) for k, v in top}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
