"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the flagship widths with random weights
drawn from a seeded generator, through the kernels built from
idvs/morec_tpu_torch/csrc by nvcc on first use: end2end text MoRec
(BERT-small item tower, SASRec user tower, a 100_001-item catalog), serving
(catalog encode, recommend) and training (the bf16 train step with
dropout); end2end vision MoRec (Swin-T item tower at full width and
depth, SASRec at D = 2048), serving and training; the use_pallas train
step (the in-batch CE kernels) of text MoRec, IDRec and vision MoRec; and
the data-parallel step with gather_negatives. Phases, each fatal on
failure:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: build (or load) the kernel library;
3. kernels: each forward kernel against its plain PyTorch version on the
   card, at the serving path's shapes, in float32 and bfloat16, with kernel
   and plain times (CUDA events, median), every post-LN tail beside its
   yardstick, its products through torch.matmul in its dtype (float32 with
   TF32 off); the float32 rows of fused_mha and of the FFN tail (text
   encode's and recommend's, at B = 64 and 1) also with device time
   (torch.profiler) beside the library call's or the yardstick's and the
   share of the bound it reaches; and the FFN tail with quick_gelu, which
   no main path takes, at C = 512 and 2048;
4. backward kernels: the training editions, the backward kernels and the
   scatter-add against autograd of the plain versions at the train step's
   shapes, and the quick_gelu FFN tail at C = 512 and 2048, in float32 and
   bfloat16, dropout 0 and 0.1 (the float32 ReLU tail held as phase 10
   holds it, relu_at_kink), with times (a bf16 FFN tail's training
   forward beside its two products through torch.matmul, in float32
   too); beside
   fused_mha's backward at dropout 0, F.scaled_dot_product_attention's
   with a mask that needs no gradient (the library column);
5. serving: Retriever.encode_catalog over the catalog, then recommend for
   request batches of 1, 8 and 64, with every launch counter set to 0
   first; every kernel launched in the encode and in recommend (gemm
   among them: the float32 tails are its products), and each of them
   through its float32 body on the tensor cores (fused_mha's 3xTF32
   forward, gemm.cu's 3xTF32 products and the tails' row pass: the
   "serving bodies" lines), the table
   is finite, no result holds the padding id or a history id, and on a
   2048-item sub-catalog the kernel path agrees with the plain path (the
   same model and wrappers on the CPU); catalog encode seconds and items/s,
   recommend p50 per batch;
6. training: the counters set to 0, 20 steps on one fixed batch (the loss
   must fall), then 10 timed steps on distinct batches (p50, samples/s);
   every training-edition and backward kernel launched, gemm 36 times a
   step, every parameter finite (phases 11, 14 and 17 print gemm's
   launches a step too);
7. gradient check: one float32 step without dropout on 8 users, on the card
   and through the plain path on a CPU copy of the model: the loss and
   every parameter's gradient agree;
8. vision kernels: the windowed attention (band layout with one bias and
   with a bias per window, window layout) and the pre-LN MLP (with and
   without its LayerNorm, with the residual, unit and scaled) against their
   plain versions at each Swin-T stage's shapes for one encode chunk (in
   bfloat16 beside the yardstick: the same products through torch.matmul,
   bench_swin's), and the post-LN tails and the attention at SASRec's D =
   2048 for request batches of 64 and of 1 (M = 640 and 10), in bfloat16
   and float32, with times and the share of each kernel's bound reached
   (each tail beside its products through torch.matmul in its dtype; the
   float32 attention and FFN tail with device times as in phase 3);
9. vision serving: the counters set to 0, Retriever.encode_catalog through
   the bf16 Swin-T tower over images drawn from a pool on the card (100_001
   items if a probe says that takes 30 s or less, else 16_385), recommend
   for batches of 1, 8 and 64, and an encode of a 128-item sub-catalog
   with the "windows" kernel selection; every kernel of the path launched,
   the table is finite, row 0 is the tower's output for a zero image, no
   result holds the padding id or a history id, and in float32 the
   sub-catalog's table and scores agree between the two kernel selections
   and with the plain path on a CPU copy of the model; images/s, encode
   seconds, recommend p50 per batch;
10. vision backward kernels: the backward of the windowed attention (band
    with one bias and with a bias per window, window layout: dx, dbias and
    the four weights' gradients) and of the pre-LN MLP (residual unit and
    scaled, bare with and without its LayerNorm) at each Swin-T stage's
    shapes for 288 images, and SASRec's attention backward (64 users, 2
    heads of 1024) and the training editions and backward of the post-LN
    tails at C = 2048 (dropout 0 and 0.1), against autograd of the plain
    versions, in bfloat16 and float32 (the float32 ReLU tail's plain
    version takes the kernel's branch where its own h lies within
    float32's rounding of 0, relu_at_kink), with times (SASRec's attention
    beside F.scaled_dot_product_attention's backward at dropout 0; each
    windowed attention backward with its attention core's device time,
    torch.profiler; each tail's training forward beside its products
    through torch.matmul); then
    the tensor-core gemm() (every backward's products) at the three
    largest products of the stage-0 band backward, against torch.matmul
    on the same bf16 operands, and at the four of the text FFN tail's
    backward with their epilogues, against its plain version, with times
    beside torch.matmul's, TFLOP/s and bounds; and the float32 body
    (3xTF32 on the tensor cores) at the float32 recommend tails' products
    at D = 2048 (B = 64 and 1) and the text encode's projection, against
    its plain version, beside torch.matmul float32 with TF32 off;
11. vision training: the counters set to 0, the bf16 train step (DropPath
    0.1, dropout 0.1, lr 1e-4) on batches drawn as bench.py draws them,
    images shipped with the batch from a pool of 1024: Zipf ids with dedup
    at encoder_chunk 0, 6 steps on one batch (the loss must fall) then 10
    timed steps on distinct batches; 3 and 4 at encoder_chunk cap // 3;
    then two steps of uniform ids without dedup (704 images, 8 chunks);
    then, the counters set to 0 again, two Zipf steps under the "windows"
    kernel selection; step p50, samples/s, images/s, losses, peak device
    memory; every training-edition and backward kernel of each selection's
    path launched;
12. vision gradient check: one float32 step in training mode on 2 users,
    on the card under both kernel selections and through the plain path on
    a CPU copy of the model, DropPath and dropout drawn from the same seed:
    the loss and every parameter's gradient agree, the relative position
    bias tables' on a line of their own;
13. ce kernels (run right after phase 4): the in-batch CE kernels, forward
    and backward, against autograd of their plain version on the card at
    the text (M 2560 x N 2688, D 512), IDRec (5120 x 5376), vision (640 x
    704, D 2048) and gathered text (W = 4, N 10752, label offset 2 B S)
    shapes, in float32 and bfloat16, with times; then a wide gathered IDRec
    case (W = 8, N 43008) with the peak device memory of a forward and
    backward through the kernels and through the plain version;
14. pallas training: the counters set to 0, the use_pallas train steps: the
    text flagship on the training phase's batches and dedup cap (2 steps,
    then 10 timed; p50 beside the composition's, the first loss against
    the composition's first), the IDRec step (bench.py GEOM["idrec"]:
    B 256, L 20, D 512, uniform ids) with use_pallas off and on, two vision
    Zipf steps; each step launched the CE kernels once forward and once
    backward; then a float32 use_pallas step against the CPU plain path as
    in phase 7;
15. data-parallel: NCCL at world size 1 through a FileStore in a temporary
    directory, the counters set to 0, two gather_negatives + use_pallas
    text steps whose losses equal the single-process steps' on the same
    batches, weights and seeds; the group destroyed;
16. dbias kernels (run after phase 10): fused_mha's backward with the
    gradient of its trainable bias at the window attention of every Swin-T
    stage for 288 images, one bias for all rows and (shifted blocks) one
    per window, in bfloat16 and float32, dropout 0 and 0.1: dqkv and dbias
    against autograd of the plain version, the same bits on a second run;
    backward, plain and fixed-order-sum times, and at dropout 0
    F.scaled_dot_product_attention's with the bias as a trainable mask;
17. vision dropout training (run after phase 12): the counters set to 0,
    the bf16 train step of phase 11 with Swin's hidden and attention-
    probability dropout at 0.1: 4 steps on one batch (the loss must fall),
    6 timed steps, then 2 steps at encoder_chunk 96; every step at
    encoder_chunk 0 launched fused_mha 14 times forward and backward (12
    Swin blocks through the dbias edition), fused_mlp in every Swin block,
    and no kernel of the two selections' pairs;
18. vision dropout gradient check: phase 12's float32 step with Swin's
    dropouts at 0.1, on the card and on the CPU plain path.

Prints each phase's seconds and a JSON line of per-kernel results (launches
on the main paths, in all and by path: text serving, training, vision
serving, the "windows" sub-catalog, vision training, the "windows" train
step, the vision dropout step, the use_pallas steps, the data-parallel
steps; error
and time against the plain version, the least time the card could take for
the same work (float32 rows that launched gemm.cu, whose products run as
3xTF32, at that rate, 165 TFLOP/s), the time of the one PyTorch call that
computes the same function where there is one, and for the tails and
gemm the device kernels their launches in this run took, "bodies", as
their plans name them), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result, when no GPU
is visible.

    python3 chip_smoke.py --profile

runs only the card and build phases and a torch.profiler split by device
kernel of the train step, of the vision catalog encode, of the vision
recommend at batches of 1 and 64 and of the vision train step without and
with Swin's dropouts (wall and device-busy ms, each kernel's share, and
fused_mha's kernels even outside the top rows), and prints no result
line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from idvs.morec_tpu_torch.bench_gemm import f32_product_cases, product_cases
from idvs.morec_tpu_torch.bench_swin import (CORE, attention_products,
                                             device_ms, mlp_products)
from idvs.morec_tpu_torch.bench_tail import proj_products, tail_products
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models import sasrec
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import (SwinConfig, SwinModel,
                                              _shift_mask)
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import VisionTower
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.attention import (
    FWD_BODIES, dbias_chunks, fused_mha, fused_mha_bwd, fused_mha_bwd_dbias,
    fused_mha_plain, fused_mha_proj, fused_mha_proj_band,
    fused_mha_proj_band_bwd, fused_mha_proj_band_plain, fused_mha_proj_bwd,
    fused_mha_proj_plain, sum_partials, window_partition)
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import (
    scatter_add_rows, scatter_add_rows_plain)
from idvs.morec_tpu_torch.ops.cuda.gemm import (BODIES as GEMM_BODIES, gemm,
                                                gemm_plain)
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import (fused_ce,
                                                      fused_inbatch_ce,
                                                      fused_inbatch_ce_bwd)
from idvs.morec_tpu_torch.ops.cuda.mlp import (fused_mlp, fused_mlp_bwd,
                                               fused_mlp_plain,
                                               fused_mlp_res,
                                               fused_mlp_res_bwd,
                                               fused_mlp_res_plain,
                                               fused_mlp_resln,
                                               fused_mlp_resln_bwd,
                                               fused_mlp_resln_plain,
                                               fused_mlp_resln_res,
                                               fused_proj_resln,
                                               fused_proj_resln_bwd,
                                               fused_proj_resln_plain,
                                               fused_proj_resln_res,
                                               relu_kink)
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.losses import inbatch_ce_candidates
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask
from idvs.morec_tpu_torch.parallel import mesh
from idvs.morec_tpu_torch.serve import Retriever
from idvs.morec_tpu_torch.train.state import make_train_state, param_labels
from idvs.morec_tpu_torch.train.step import dedup_pack, make_train_step

SEED = 0
# flagship geometry (bench.py:71,149-156,168-172)
ITEM_NUM, TITLE_LEN, VOCAB = 100_000, 30, 30522
HIDDEN, LAYERS, HEADS, FFN = 512, 4, 8, 2048
D, USER_HEADS, BLOCKS, L = 512, 2, 2, 20
ENCODE_BATCH = 512          # item_emb_batch_size (config.py:112)
REQUEST_BATCHES = (1, 8, 64)
TOP_K = 10
SUB_ITEMS = 2048            # sub-catalog held against the plain path
# the train step (bench.py text_morec: GEOM, _gen_raw, cfg)
TRAIN_B, ZIPF_A = 128, 1.2  # users a step, Zipf exponent of the item ids
LR, FT_LR, DROP = 1e-4, 5e-5, 0.1
FIXED_STEPS, TIMED_STEPS = 20, 10
CHECK_USERS = 8             # users of the float32 gradient check
PROFILE_STEPS, PROFILE_ROWS = 5, 12   # --profile: steps traced, rows shown
PROFILE_WATCH = "::mha_"    # --profile: fused_mha's kernels, always shown
# --profile: csrc/gemm.cu's kernels (products, split-K sums, A's
# prologue), summed on a line of their own
PROFILE_GEMM = ("::gemm_mma_kernel", "::splitk_reduce_kernel",
                "::act_cast_kernel")
# timed calls behind a median: the text forward kernels (tenths of a
# millisecond each), and the backward and vision cases (milliseconds each)
KERNEL_REPS, FEW_REPS = 10, 5
# the vision flagship (bench.py:31-40,78,137-139,143-144: Swin-T tower in
# bf16, SASRec D 2048, L 10, a pool of 1024 uint8 images)
V_D, V_L, IMAGE, POOL = 2048, 10, 224, 1024
V_CHUNK = ENCODE_BATCH      # images an encode chunk: item_emb_batch_size too
V_ITEMS_FULL, V_ITEMS_CUT = 100_000, 16_384
V_ENCODE_LIMIT_S = 30.0     # the full catalog only if it encodes this fast
V_PROBE_CHUNKS = 2
V_SUB_ITEMS = 128           # sub-catalog held against the plain path
V_PROFILE_REQUESTS = 10     # --profile: recommend calls traced per batch size
# the vision train step (bench.py:78-82, :89-98, :162-186: B 64, L 10,
# Zipf(1.2) ids with dedup or uniform ids without, lr and fine_tune_lr 1e-4,
# SwinConfig's DropPath 0.1, the Config's dropout 0.1)
V_TRAIN_B, V_LR, V_FT_LR = 64, 1e-4, 1e-4
V_CAP_QUANTUM = 96          # the dedup cap's rounding (bench.py:166)
V_NODEDUP_CHUNKS = 8        # encoder chunks without dedup (bench.py:183)
V_FIXED_STEPS, V_TIMED_STEPS = 6, 10
V_CHUNKED_FIXED, V_CHUNKED_TIMED = 3, 4   # the encoder_chunk cap // 3 run
V_CHECK_USERS = 2           # users of the float32 vision gradient check
# Swin's hidden and attention-probability dropout in training (the HF
# SwinConfig's hidden_dropout_prob and attention_probs_dropout_prob; BERT's
# published 0.1): steps on one batch, timed steps, steps at encoder_chunk
# cap // 3
V_SWIN_DROP = 0.1
V_DROP_FIXED, V_DROP_TIMED, V_DROP_CHUNKED = 4, 6, 2
VB_REPS = 3                 # timed calls of a vision backward case
V_BWD_IMAGES = 288          # images of a vision backward case
# the in-batch CE kernels (row 9): (what, users B, L, D, ranks W, rank,
# Zipf ids) of the text, IDRec and vision steps and of a gathered text step
# at W = 4, every rank's candidates concatenated on the card as the
# gathered edition holds them after its all-gather; then the wide case,
# IDRec gathered over W = 8 (PARITY.md:750-757, the kernel's capacity)
IDREC_B = 256               # bench.py GEOM["idrec"]: uniform ids, no dedup
CE_CASES = (("text", TRAIN_B, L, D, 1, 0, True),
            ("IDRec", IDREC_B, L, D, 1, 0, False),
            ("vision", V_TRAIN_B, V_L, V_D, 1, 0, True),
            ("gathered text", TRAIN_B, L, D, 4, 2, True))
CE_WIDE = ("gathered IDRec", IDREC_B, L, D, 8, 5, False)
# fused_mlp_resln's quick_gelu, which no main path takes (CLIP's MLP is
# pre-LN): (M, C, F) of the text and the vision user tower's train steps
QUICK_GELU_SHAPES = ((TRAIN_B * L, D, FFN), (V_TRAIN_B * V_L, V_D, 4 * V_D))
PALLAS_WARM_STEPS = 2       # use_pallas steps on batches[0] before the timed
DP_STEPS = 2                # gather_negatives steps at world size 1
# Swin-T stages: (C, heads, side of the token map)
SWIN_STAGES = ((96, 3, 56), (192, 6, 28), (384, 12, 14), (768, 24, 7))
WINDOW = 7

# Kernel vs plain tolerances (max abs error). float32: both sides accumulate
# in float32 in different orders over K <= 2048 terms of O(1) values, about
# 1e-5 after the LayerNorm; 1e-4 leaves a 10x margin. bfloat16: the outputs
# are rounded to bf16 (one unit in the last place is 2^-6 for values in
# [2, 4)); a different float32 sum can flip a rounding of the probabilities
# or of the pre-LN sum and then of the output, so attention may differ by
# a few units and the LN tails (outputs up to ~5) by up to ~0.1.
# The Swin kernels: the windowed attention's output is a projection of O(1)
# values (one or two bf16 units of 2^-7 relative after three casts in a
# row), the pre-LN MLP adds its result to a residual of up to ~5 (a unit
# is 2^-6 = 1.6e-2 there, and one flipped rounding of the activation moves
# the sum by as much again).
TOL = {"fused_mha": {torch.float32: 1e-4, torch.bfloat16: 6.25e-2},
       "fused_proj_resln": {torch.float32: 1e-4, torch.bfloat16: 1e-1},
       "fused_mlp_resln": {torch.float32: 1e-4, torch.bfloat16: 1e-1},
       "fused_mha_proj": {torch.float32: 1e-4, torch.bfloat16: 6.25e-2},
       "fused_mha_proj_band": {torch.float32: 1e-4, torch.bfloat16: 6.25e-2},
       "fused_mlp": {torch.float32: 1e-4, torch.bfloat16: 6.25e-2},
       "fused_mlp_res": {torch.float32: 1e-4, torch.bfloat16: 1e-1}}
# Backward editions vs autograd of the plain version: max abs error over
# max(1, max |plain value|) of each output and gradient. float32: sums of up
# to titles x 30 terms in other orders, ~1e-6 relative; 1e-4 leaves a
# margin. bfloat16: the gradients are rounded to bf16 (2^-8 relative), and
# the plain version rounds d(y_pre) to bf16 before the dropout where the
# kernel rounds once after it, so one rounding may differ on every
# element; 3e-2 is a few units of bf16 on the largest value.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# scatter_add_rows: float atomics add a token's rows in no fixed order
# (float32 reassociation), and bf16 casts the sum once (one unit, 2^-8).
SCATTER_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Sub-catalog kernel path vs plain path on the CPU, float32 through four
# BERT layers, fc, two SASRec blocks and a 512-wide dot product.
TABLE_TOL = 1e-3
SCORE_TOL = 1e-3            # relative to max(1, |score|)
# float32 train step, card vs CPU plain path: the loss (relative) and each
# parameter's gradient (max abs error over the larger of its max |gradient|
# and GRAD_FLOOR of the model's largest), summed in other orders through
# four BERT layers, two SASRec blocks and the CE. The floor is there for
# gradients that vanish in exact arithmetic and are rounding noise on both
# sides: the key projection's bias shifts all of a query's scores by one
# amount, which the softmax ignores.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-3
# Vision sub-catalog, float32: the card's table against the plain path on
# the CPU through twelve Swin blocks (sums up to 3072 terms in other orders,
# CUDA's erff against the CPU's erf), the classifier and a GELU; scores
# through two SASRec blocks at D = 2048 and a 2048-wide dot product of
# O(1) values, relative to max(1, |score|). The two kernel selections share
# every sum's order except the residual add: 1e-5.
V_TABLE_TOL = 2e-3
V_SCORE_TOL = 2e-3
V_SELECTION_TOL = 1e-5
# float32 vision train step, card vs CPU plain path: as STEP_GRAD_TOL, but
# through twelve Swin blocks (sums up to 3072 terms in other orders, CUDA's
# erff against the CPU's erf) under the classifier and SASRec at D = 2048.
V_STEP_LOSS_TOL = 1e-4
V_STEP_GRAD_TOL = 2e-3
# SASRec's FFN is a ReLU: where a pre-activation lies within the two paths'
# rounding distance of 0, each path may take a different branch, and that
# unit's w_1 column and b_1 entry then differ by one row's contribution (a
# step, not a rounding). The check leaves out the units with a
# pre-activation within V_KINK times the largest difference of the two
# paths' pre-activations, and requires them to be at most V_KINK_SHARE of
# the units.
V_KINK, V_KINK_SHARE = 10.0, 1e-2
# The in-batch CE kernel against autograd of its plain version on the same
# card and operands: the same float32 logits of the same (widened) inputs,
# summed in another order over D and over the columns; the loss relative,
# each gradient's max abs error over its largest magnitude. bfloat16: du
# and dcand are rounded once to bf16 on both sides, and a float32 sum in
# another order may flip a rounding (2^-8 relative) of the largest values.
CE_LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
CE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The world-1 data-parallel steps against the single-process steps: the
# same model, batches and dropout masks; the gathered candidates are the
# local ones and the all-reduce over one rank changes no bit. Only the
# word table's gradient (scatter_add_rows' float atomics) may differ in the
# last bits, and the second step's loss sees that through AdamW.
DP_LOSS_TOL = 1e-6
# Row 0 of the bf16 table against the tower's output for one zero image:
# the same kernels on the same row, but the library matmuls around them
# (patch projection, patch merging, classifier) may sum in another order
# at another batch size; a few bf16 units of values up to ~2.
V_PAD_TOL = 3e-2

CSRC, PALLAS = "idvs/morec_tpu_torch/csrc/", "idvs/morec_tpu/ops/pallas/"
SOURCES = {
    "fused_mha": ("fused_mha.cu", "attention.py:143"),
    "fused_mha_bwd": ("fused_mha.cu", "attention.py:179"),
    "fused_mha_bwd_dbias": ("fused_mha.cu", "attention.py:179"),
    "fused_proj_resln": ("proj_resln.cu", "mlp.py:715"),
    "fused_proj_resln_res": ("proj_resln.cu", "mlp.py:709"),
    "fused_proj_resln_bwd": ("resln_bwd.cu", "mlp.py:723"),
    "fused_mlp_resln": ("mlp_resln.cu", "mlp.py:432"),
    "fused_mlp_resln_res": ("mlp_resln.cu", "mlp.py:424"),
    "fused_mlp_resln_bwd": ("resln_bwd.cu", "mlp.py:444"),
    "scatter_add_rows": ("embed_scatter.cu", "embed_scatter.py:66"),
    "fused_mha_proj_band": ("win_attn.cu", "attention.py:860"),
    "fused_mha_proj": ("win_attn.cu", "attention.py:530"),
    "fused_mlp_res": ("premlp.cu", "mlp.py:105"),
    "fused_mlp": ("premlp.cu", "mlp.py:105"),
    "fused_mha_proj_band_bwd": ("win_attn_bwd.cu", "attention.py:873"),
    "fused_mha_proj_bwd": ("win_attn_bwd.cu", "attention.py:597"),
    "fused_mlp_res_bwd": ("premlp_bwd.cu", "mlp.py:134"),
    "fused_mlp_bwd": ("premlp_bwd.cu", "mlp.py:134"),
    "fused_inbatch_ce": ("inbatch_ce.cu", "inbatch_ce.py:61"),
    "fused_inbatch_ce_bwd": ("inbatch_ce.cu", "inbatch_ce.py:99"),
    "gemm": ("gemm.cu", "mlp.py:444"),
}
WRAPPERS = {"fused_mha": fused_mha, "fused_mha_bwd": fused_mha_bwd,
            "fused_mha_bwd_dbias": fused_mha_bwd_dbias,
            "fused_proj_resln": fused_proj_resln,
            "fused_proj_resln_res": fused_proj_resln_res,
            "fused_proj_resln_bwd": fused_proj_resln_bwd,
            "fused_mlp_resln": fused_mlp_resln,
            "fused_mlp_resln_res": fused_mlp_resln_res,
            "fused_mlp_resln_bwd": fused_mlp_resln_bwd,
            "scatter_add_rows": scatter_add_rows,
            "fused_mha_proj_band": fused_mha_proj_band,
            "fused_mha_proj": fused_mha_proj,
            "fused_mlp_res": fused_mlp_res, "fused_mlp": fused_mlp,
            "fused_mha_proj_band_bwd": fused_mha_proj_band_bwd,
            "fused_mha_proj_bwd": fused_mha_proj_bwd,
            "fused_mlp_res_bwd": fused_mlp_res_bwd,
            "fused_mlp_bwd": fused_mlp_bwd,
            "fused_inbatch_ce": fused_inbatch_ce,
            "fused_inbatch_ce_bwd": fused_inbatch_ce_bwd, "gemm": gemm}
# text serving runs in float32: its projection tails through gemm.cu
SERVE_KERNELS = ("fused_mha", "fused_proj_resln", "fused_mlp_resln", "gemm")
# the device kernels text serving must launch in the encode and in
# recommend, by wrapper: the float32 bodies on the tensor cores (3xTF32)
SERVE_BODIES = {"fused_mha": (FWD_BODIES[torch.float32],),
                "fused_proj_resln": (GEMM_BODIES[torch.float32],
                                     "post_ln_rows_kernel"),
                "fused_mlp_resln": (GEMM_BODIES[torch.float32],
                                    "post_ln_rows_kernel")}
# float32 kernel rows printed with device time beside the library call's
# or the yardstick's (the serving paths' float32 kernels)
DEVICE_ROWS = ("fused_mha", "fused_mlp_resln")
TRAIN_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_proj_resln_res",
                 "fused_proj_resln_bwd", "fused_mlp_resln_res",
                 "fused_mlp_resln_bwd", "scatter_add_rows", "gemm")
VISION_ENCODE_KERNELS = ("fused_mha_proj_band", "fused_mlp_res")
VISION_RECOMMEND_KERNELS = ("fused_mha", "fused_proj_resln",
                            "fused_mlp_resln", "gemm")
VISION_WINDOWS_KERNELS = ("fused_mha_proj", "fused_mlp")
VISION_TRAIN_KERNELS = ("fused_mha_proj_band", "fused_mha_proj_band_bwd",
                        "fused_mlp_res", "fused_mlp_res_bwd", "fused_mha",
                        "fused_mha_bwd", "fused_proj_resln_res",
                        "fused_proj_resln_bwd", "fused_mlp_resln_res",
                        "fused_mlp_resln_bwd", "gemm")
VISION_WINDOWS_TRAIN_KERNELS = ("fused_mha_proj", "fused_mha_proj_bwd",
                                "fused_mlp", "fused_mlp_bwd", "gemm")
PALLAS_KERNELS = ("fused_inbatch_ce", "fused_inbatch_ce_bwd")
# backward rows whose attention core's device time phase 10 prints
WINDOW_BWD = ("fused_mha_proj_band_bwd", "fused_mha_proj_bwd")
# gemm launches a text train step: BERT's 4 and SASRec's 2 layers, each a
# projection tail's backward (2 products) and an FFN tail's (4)
TEXT_GEMM_STEP = 36
# a vision train step with Swin's dropouts: a step's launches of each
# kernel (12 Swin blocks on the window path, SASRec's 2 blocks), and the
# kernel pairs of the two selections, which it never takes
VISION_DROPOUT_STEP = {"fused_mha": 14, "fused_mha_bwd": 2,
                       "fused_mha_bwd_dbias": 12, "fused_mlp": 12,
                       "fused_mlp_bwd": 12, "fused_proj_resln_res": 2,
                       "fused_proj_resln_bwd": 2, "fused_mlp_resln_res": 2,
                       "fused_mlp_resln_bwd": 2}
VISION_DROPOUT_SKIPS = ("fused_mha_proj_band", "fused_mha_proj_band_bwd",
                        "fused_mha_proj", "fused_mha_proj_bwd",
                        "fused_mlp_res", "fused_mlp_res_bwd")


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_info() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Prints the seconds a phase took on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def ragged_mask(rng, B: int, T: int) -> np.ndarray:
    """(B, T) 0/1 key masks: a prefix of random length 1..T (titles)."""
    lens = rng.integers(1, T + 1, size=B)
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def left_padded_mask(rng, B: int, T: int) -> np.ndarray:
    """(B, T) 0/1 masks of histories left-padded to T (length 1..T)."""
    lens = rng.integers(1, T + 1, size=B)
    return (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)


def tag_of(dt) -> str:
    return "f32" if dt == torch.float32 else "bf16"


def size_of(dt) -> int:
    return 4 if dt == torch.float32 else 2


# The work of one call, (float operations, bytes), from its shapes: every
# input read once and every output written once in the compute dtype `it`
# bytes wide (mask, bias table, LayerNorm vectors and scales are float32),
# 2 operations a multiply-add.

def mha_work(B, T, nh, dh, it, table_elems):
    H = nh * dh
    return 4 * B * nh * T * T * dh, 4 * B * T * H * it + 4 * table_elems


def mha_bwd_work(B, T, nh, dh, it, table_elems):
    # scores again, dp, dv, dq, dk: five (T, T, dh) products a head
    H = nh * dh
    return 10 * B * nh * T * T * dh, 7 * B * T * H * it + 4 * table_elems


def mha_dbias_work(B, T, nh, dh, it, P):
    # as mha_bwd_work with the (P, nh, T, T) float32 bias read and its
    # gradient written
    flops, nbytes = mha_bwd_work(B, T, nh, dh, it, P * nh * T * T)
    return flops, nbytes + 4 * P * nh * T * T


def proj_work(M, C, it, saved=0):
    """saved: the training edition's y_pre, in (M, C) tensors."""
    return 2 * M * C * C, ((3 + saved) * M * C + C * C + C) * it + 8 * C


def proj_bwd_work(M, C, it):
    # dw and dx; reads x, y_pre, dout, w; writes dx, dres, dw, three vectors
    return 4 * M * C * C, (5 * M * C + 2 * C * C) * it + 16 * C


def mlp_work(M, C, F, it, saved=False, scale=False):
    """saved: the training edition's y_pre (M, C) and h (M, F)."""
    extra = (M * C + M * F) * it if saved else 0
    return 4 * M * C * F, ((2 * M * C + 2 * C * F + F + C) * it + 8 * C
                           + extra + (4 * M if scale else 0))


def mlp_bwd_work(M, C, F, it):
    # dw2, dh, dw1, dx; reads x, y_pre, h, dout, w1, w2; writes dx, dw1, dw2
    return 8 * M * C * F, (4 * M * C + M * F + 4 * C * F) * it + 16 * C


def scatter_work(M, D, V, it):
    return M * D, M * D * it + 8 * M + V * D * it


def win_attn_work(windows, T, C, nh, P, it):
    rows = windows * T
    return (rows * (8 * C * C + 4 * T * C),
            (2 * rows * C + 4 * C * C + 4 * C) * it + 4 * P * nh * T * T)


def win_attn_bwd_work(windows, T, C, nh, P, it):
    # qkv again, dctx, dwo, dwqkv, dx: 22 C^2 a row; scores and the context
    # again, dp, dv, dq, dk: six (T, T, dh) products a head. Reads x, dout,
    # the weights and the bias; writes dx, the weights' and the bias's
    # gradients.
    rows = windows * T
    return (rows * (22 * C * C + 12 * T * C),
            (3 * rows * C + 8 * C * C + 8 * C) * it + 8 * P * nh * T * T)


def premlp_bwd_work(M, C, F, it, scale=False):
    # h again, dw2, dh, dw1, dxn; reads x, dout, w1, w2; writes dx, dw1, dw2
    return 10 * M * C * F, ((3 * M * C + 4 * C * F + 2 * F + 2 * C) * it
                            + 16 * C + (4 * M if scale else 0))


def ce_work(M, N, D, it, id_elems):
    # the (M, N, D) logit product; reads u, cand, the candidates' ids,
    # column masks and log popularity and the users' ids; writes ce, m, l
    return 2 * M * N * D, (M + N) * D * it + 12 * N + 4 * id_elems + 12 * M


def ce_bwd_work(M, N, D, it, id_elems):
    # the logits again, du and dcand; reads as the forward and m, l, ws;
    # writes du and dcand
    return (6 * M * N * D,
            2 * (M + N) * D * it + 12 * N + 4 * id_elems + 12 * M)


def sdpa_call(qkv, n_heads, bias):
    """F.scaled_dot_product_attention on views of the packed qkv with the
    additive bias (P, 1 or nh, T or 1, T) already in qkv's dtype: the one
    library call that computes fused_mha's function. A yardstick only."""
    B, T, H3 = qkv.shape
    q, k, v = (t.reshape(B, T, n_heads, -1).transpose(1, 2)
               for t in qkv.split(H3 // 3, dim=-1))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def sdpa_backward(qkv, n_heads, bias, dout, drop):
    """A factory of sdpa_grad_calls with a mask that needs no gradient (the
    library column of fused_mha_bwd), or None at dropout above 0, which
    the library call does not draw as the port does."""
    if drop:
        return None
    return lambda: sdpa_grad_calls(qkv, n_heads, bias, dout, trainable=False)


def kernel_cases(rng, dev):
    """(kernel, label, dtype, kernel call, plain call, work, library call or
    None) at the text serving path's shapes. Operands are drawn on the
    card from a seeded generator, the masks' lengths from rng."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device=dev) * scale
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        tag, it = tag_of(dt), size_of(dt)
        # BERT: B = 512 titles of T = 30 tokens, 8 heads of 64
        qkv = g(512, TITLE_LEN, 3 * HIDDEN).to(dt)
        mask = torch.from_numpy(ragged_mask(rng, 512, TITLE_LEN)).to(dev)
        key_bias = ((1.0 - mask) * -1e9).to(dt)[:, None, None, :]
        cases.append(("fused_mha", f"mask B=512 T=30 nh=8 {tag}", dt,
                      lambda q=qkv, m=mask: fused_mha(q, m, n_heads=HEADS),
                      lambda q=qkv, m=mask: fused_mha_plain(
                          q, m, n_heads=HEADS),
                      mha_work(512, TITLE_LEN, HEADS, HIDDEN // HEADS, it,
                               mask.numel()),
                      sdpa_call(qkv, HEADS, key_bias)))
        # SASRec: B = 64 histories of L = 20, 2 heads of 256, causal mask
        qkv = g(64, L, 3 * D).to(dt)
        bias = causal_additive_mask(
            torch.from_numpy(left_padded_mask(rng, 64, L)).to(dev))
        cases.append(("fused_mha", f"bias B=64 T=20 nh=2 {tag}", dt,
                      lambda q=qkv, b=bias: fused_mha(q, bias=b,
                                                      n_heads=USER_HEADS),
                      lambda q=qkv, b=bias: fused_mha_plain(
                          q, bias=b, n_heads=USER_HEADS),
                      mha_work(64, L, USER_HEADS, D // USER_HEADS, it,
                               bias.numel()),
                      sdpa_call(qkv, USER_HEADS, bias.to(dt))))
        for M, eps, act, who in ((512 * TITLE_LEN, 1e-12, "gelu", "BERT"),
                                 (64 * L, 1e-6, "relu", "SASRec")):
            cases += tail_cases(g, dev, dt, M, HIDDEN, FFN, eps, act, who)
        if dt == torch.float32:     # a recommend at B = 1
            cases += tail_cases(g, dev, dt, L, HIDDEN, FFN, 1e-6, "relu",
                                "SASRec")
        for M, C, Fw in QUICK_GELU_SHAPES:     # the FFN tail's case only
            cases += tail_cases(g, dev, dt, M, C, Fw, 1e-5, "quick_gelu",
                                "FFN")[1:]
    return cases


def tail_cases(g, dev, dt, M, C, Fw, eps, act, who):
    """The two post-LN tails (no single library call computes either), each
    beside its yardstick: its products through torch.matmul in its dtype
    (float32 with TF32 off: bench_tail sets it)."""
    tag, it = tag_of(dt), size_of(dt)
    x, res = g(M, C).to(dt), g(M, C).to(dt)
    w = g(C, C, scale=C ** -0.5)
    b = g(C, scale=0.1) if who == "BERT" else torch.zeros(C, device=dev)
    ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
    w1, b1 = g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1)
    w2, b2 = g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1)
    return [
        ("fused_proj_resln", f"{who} M={M} C={C} {tag}", dt,
         lambda: fused_proj_resln(x, res, w, b, ln=ln, eps=eps),
         lambda: fused_proj_resln_plain(x, res, w, b, ln=ln, eps=eps),
         proj_work(M, C, it), None, lambda: proj_products(x, w)),
        ("fused_mlp_resln", f"{who} M={M} C={C} F={Fw} {act} {tag}", dt,
         lambda: fused_mlp_resln(x, w1, b1, w2, b2, ln=ln, eps=eps, act=act),
         lambda: fused_mlp_resln_plain(x, w1, b1, w2, b2, ln=ln, eps=eps,
                                       act=act),
         mlp_work(M, C, Fw, it), None, lambda: tail_products(x, w1, w2))]


def kernel_phase(dev, card: str, cases, reps: int = KERNEL_REPS) -> dict:
    """Holds each case's kernel against its plain version and times both
    (and the library call, where there is one). A case may carry an eighth
    element, a factory of the yardstick: a function running the same
    products through torch.matmul, timed and printed beside the kernel
    (never a library column: no one call computes the function). The
    float32 serving rows of DEVICE_ROWS also print device time (the
    profiler's sum over the call's kernels) beside the library call's or
    the yardstick's, and the share of the bound that device time reaches:
    at a request's shapes the event time is mostly the host's."""
    results = {}
    for name, label, dt, run_kernel, run_plain, work, library, *more in cases:
        got, tf32x3 = gemm_ran(run_kernel, dt)
        want = run_plain()
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype == dt,
                f"{name} {label}: {got.shape}/{got.dtype} vs "
                f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        tol = TOL[name][dt]
        ms = cuda_ms(run_kernel, reps)
        plain_ms = cuda_ms(run_plain, reps)
        library_ms = None if library is None else cuda_ms(library, reps)
        bound_ms, bound_by = bound_of(work, dt, tf32x3)
        lib_text = ("" if library is None
                    else f", library call {library_ms:.4f} ms")
        products = more[0]() if more else None
        if products is not None:
            lib_text += (f", the same products through torch.matmul "
                         f"{cuda_ms(products, reps):.4f} ms")
        if dt == torch.float32 and name in DEVICE_ROWS:
            lib_text += device_text(run_kernel, library or products,
                                    bound_ms, reps)
        del products
        print(f"kernel {name} [{label}]: max_abs_err {err:.3e} "
              f"(tol {tol:g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib_text}, bound {bound_text(work, dt, tf32x3)} "
              f"({100 * bound_ms / ms:.1f} % of it reached) [{card}]",
              flush=True)
        require(math.isfinite(err) and err <= tol,
                f"{name} {label}: max abs error {err} above {tol}")
        _record(results, name, err, ms, plain_ms, work, dt, library_ms,
                tf32x3)
    return results


def device_text(run_kernel, other, bound_ms: float, reps: int) -> str:
    """The device times a serving row prints: the kernel's, with the share
    of its bound reached, beside `other`'s (the library call or the
    yardstick), each the profiler's sum over the call's kernels."""
    ms = device_ms(run_kernel, reps)[0]
    text = (f"; device {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of the "
            f"bound)")
    if other is not None:
        text += f" against {device_ms(other, reps)[0]:.4f} ms"
    return text


def _leaves(tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _rel_err(got, want) -> tuple:
    """(max abs error, max(1, max |want|)) of two tensors."""
    err = (got.float() - want.float()).abs().max().item()
    return err, max(1.0, want.float().abs().max().item())


def _worst_err(got, want, what: str) -> tuple:
    """(error / scale, error, scale) of the worst pair of tensors, each
    error by _rel_err; raises on a shape, dtype or finiteness mismatch."""
    worst = (0.0, 0.0, 1.0)
    for a, b in zip(got, want):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err, scale = _rel_err(a, b)
        require(math.isfinite(err), f"{what}: not finite")
        worst = max(worst, (err / scale, err, scale))
    return worst


def tail_yardstick(x, w1, b1, w2, *rest):
    """The FFN tail's yardstick from a gradient case's inputs."""
    return tail_products(x, w1, w2)


def proj_yardstick(x, res, w, *rest):
    """The projection tail's yardstick from a gradient case's inputs."""
    return proj_products(x, w)


def relu_at_kink(x, w1, b1, w2, b2, g, bt, *, eps, drop_rate, seed):
    """The float32 ReLU tail's plain version that the kernel is held to:
    fused_mlp_resln_plain with ReLU's branch taken from the kernel's h (its
    training edition's) where the plain h lies within float32's rounding of
    0 (relu_kink), and a line that says at how many pre-activations, and
    at how many of those the two sums took opposite branches."""
    kw = dict(eps=eps, drop_rate=drop_rate, seed=seed)
    with torch.no_grad():
        h_k = fused_mlp_resln_res(
            x, w1, b1, w2, b2, g, bt, eps=eps, act="relu",
            drop=dropout.kernel_args(drop_rate, seed),
            code=lib.dtype_code(x))[2]
        h_p = x @ w1 + b1
        at_kink = relu_kink(h_p, x, w1, b1)
        flips = at_kink & ((h_k > 0) != (h_p > 0))
    return (lambda *a: fused_mlp_resln_plain(*a[:5], ln=a[5:], act="relu",
                                             kink_from=h_k, **kw),
            f"ReLU's branch from the kernel's h at {int(at_kink.sum())} "
            f"pre-activations within float32's rounding of 0, "
            f"{int(flips.sum())} of them on the other side")


def backward_cases(rng, dev, titles: int):
    """(res entry or None, bwd entry, label, dtype, inputs, cotangent,
    kernel fn, plain fn, the backward's work, the training forward's work
    or None) at the train step's shapes: BERT over `titles` deduplicated
    titles of 30 tokens, SASRec over TRAIN_B users of L. Operands are
    drawn on the card from a seeded generator, the masks and dropout seeds
    from rng."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    g = lambda *s, scale=1.0, dt=torch.float32: (torch.randn(
        *s, generator=gen, device=dev) * scale).to(dt)
    M_bert, M_user = titles * TITLE_LEN, TRAIN_B * L
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for p in (0.0, DROP):
            tag, it = f"{tag_of(dt)} drop={p}", size_of(dt)
            seed = int(rng.integers(1, 2 ** 31 - 1))
            mask = torch.from_numpy(ragged_mask(rng, titles, TITLE_LEN)
                                    ).to(dev)
            qkv = g(titles, TITLE_LEN, 3 * HIDDEN, dt=dt)
            dout = g(titles, TITLE_LEN, HIDDEN, dt=dt)
            key_bias = ((1.0 - mask) * -1e9)[:, None, None, :]
            cases.append((
                None, "fused_mha_bwd",
                f"mask B={titles} T={TITLE_LEN} nh={HEADS} {tag}", dt,
                [qkv], dout,
                lambda q, m=mask, p=p, s=seed: fused_mha(
                    q, m, n_heads=HEADS, drop_rate=p, seed=s),
                lambda q, m=mask, p=p, s=seed: fused_mha_plain(
                    q, m, n_heads=HEADS, drop_rate=p, seed=s),
                mha_bwd_work(titles, TITLE_LEN, HEADS, HIDDEN // HEADS, it,
                             mask.numel()), None,
                sdpa_backward(qkv, HEADS, key_bias, dout, p)))
            bias = causal_additive_mask(torch.from_numpy(
                bench_log_mask(rng, TRAIN_B)).to(dev))
            qkv, dout = g(TRAIN_B, L, 3 * D, dt=dt), g(TRAIN_B, L, D, dt=dt)
            cases.append((
                None, "fused_mha_bwd",
                f"bias B={TRAIN_B} T={L} nh={USER_HEADS} {tag}", dt,
                [qkv], dout,
                lambda q, b=bias, p=p, s=seed: fused_mha(
                    q, bias=b, n_heads=USER_HEADS, drop_rate=p, seed=s),
                lambda q, b=bias, p=p, s=seed: fused_mha_plain(
                    q, bias=b, n_heads=USER_HEADS, drop_rate=p, seed=s),
                mha_bwd_work(TRAIN_B, L, USER_HEADS, D // USER_HEADS, it,
                             bias.numel()), None,
                sdpa_backward(qkv, USER_HEADS, bias, dout, p)))
            for M, eps, act, who in ((M_bert, 1e-12, "gelu", "BERT"),
                                     (M_user, 1e-6, "relu", "SASRec")):
                C = HIDDEN
                ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
                bias_c = (g(C, scale=0.1) if who == "BERT"
                          else torch.zeros(C, device=dev))
                kw = dict(eps=eps, drop_rate=p, seed=seed)
                cases.append((
                    "fused_proj_resln_res", "fused_proj_resln_bwd",
                    f"{who} M={M} C={C} {tag}", dt,
                    [g(M, C, dt=dt), g(M, C, dt=dt),
                     g(C, C, scale=C ** -0.5), bias_c] + ln,
                    g(M, C, dt=dt),
                    lambda *a, kw=kw: fused_proj_resln(*a[:4], ln=a[4:],
                                                       **kw),
                    lambda *a, kw=kw: fused_proj_resln_plain(
                        *a[:4], ln=a[4:], **kw),
                    proj_bwd_work(M, C, it), proj_work(M, C, it, saved=1)))
                cases.append((
                    "fused_mlp_resln_res", "fused_mlp_resln_bwd",
                    f"{who} M={M} C={C} F={FFN} {act} {tag}", dt,
                    [g(M, C, dt=dt), g(C, FFN, scale=C ** -0.5),
                     g(FFN, scale=0.1), g(FFN, C, scale=FFN ** -0.5),
                     g(C, scale=0.1)] + ln,
                    g(M, C, dt=dt),
                    lambda *a, kw=kw, act=act: fused_mlp_resln(
                        *a[:5], ln=a[5:], act=act, **kw),
                    lambda *a, kw=kw, act=act: fused_mlp_resln_plain(
                        *a[:5], ln=a[5:], act=act, **kw),
                    mlp_bwd_work(M, C, FFN, it),
                    mlp_work(M, C, FFN, it, saved=True), None,
                    tail_yardstick,
                    (lambda *a, kw=kw: relu_at_kink(*a, **kw))
                    if dt == torch.float32 and act == "relu" else None))
            for M, C, Fw in QUICK_GELU_SHAPES:
                kw = dict(eps=1e-5, drop_rate=p, seed=seed, act="quick_gelu")
                cases.append((
                    "fused_mlp_resln_res", "fused_mlp_resln_bwd",
                    f"quick_gelu M={M} C={C} F={Fw} {tag}", dt,
                    [g(M, C, dt=dt), g(C, Fw, scale=C ** -0.5),
                     g(Fw, scale=0.1), g(Fw, C, scale=Fw ** -0.5),
                     g(C, scale=0.1), 1.0 + g(C, scale=0.1), g(C, scale=0.1)],
                    g(M, C, dt=dt),
                    lambda *a, kw=kw: fused_mlp_resln(*a[:5], ln=a[5:], **kw),
                    lambda *a, kw=kw: fused_mlp_resln_plain(*a[:5], ln=a[5:],
                                                            **kw),
                    mlp_bwd_work(M, C, Fw, it),
                    mlp_work(M, C, Fw, it, saved=True), None,
                    tail_yardstick))
    return cases


def gemm_ran(fn, dt) -> tuple:
    """fn's result, and whether a float32 call's products ran as 3xTF32 on
    the tensor cores: fn launched csrc/gemm.cu (its counter moved), whose
    float32 body that is. The bound of such a call takes 3xTF32's rate."""
    before = gemm.launches
    out = fn()
    return out, dt == torch.float32 and gemm.launches > before


def bound_text(work, dt, tf32x3: bool) -> str:
    """The bound as printed: on the tensor cores in float32 beside the
    FMA units' bound of the same work."""
    ms, by = bound_of(work, dt, tf32x3)
    text = f"{ms:.4f} ms by {by}"
    if tf32x3:
        fma, fma_by = bound_of(work, dt)
        text += (f" at 3xTF32's 165 TFLOP/s ({fma:.4f} ms by {fma_by} at "
                 f"the FMA units' 67)")
    return text


def _record(results, name, err, ms, plain_ms, work, dt, library_ms=None,
            tf32x3=False):
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if r["ms"] is None:     # the first case is the headline shape
        bound_ms, bound_by = bound_of(work, dt, tf32x3)
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms)


def gradient_cases(cases, card: str, reps: int = FEW_REPS) -> dict:
    """Holds each case's outputs and gradients against autograd of the plain
    version and times both; times are the forward with a graph (training
    editions) and the backward alone (CUDA events). Only floating-point
    inputs that ask for it get a gradient. A case may carry, after its
    works, the library call's factory (or None) and, for the FFN tail, a
    factory of its yardstick from its inputs (timed beside the training
    forward of the tails at C = 2048) and, for the float32 ReLU tails
    (SASRec's at C = 512 and 2048, both through gemm.cu's 3xTF32), a
    factory of the plain version the check holds it to (relu_at_kink: of
    the 5.2M pre-activations of each a few lie within float32's
    rounding of 0, where the kernel's 3xTF32 sum and torch.matmul's may
    take opposite branches; the plain version takes the kernel's branch
    there and only there); the windowed attention's backward rows also
    print the device time of the attention core alone (torch.profiler)."""
    results = {}
    for (res_name, bwd_name, label, dt, inputs, dout, kern, plain, work_bwd,
         work_fwd, *library) in cases:
        lk, lp = _leaves(inputs), _leaves(inputs)
        out_k, fwd_tf32x3 = gemm_ran(lambda: kern(*lk), dt)
        out_p = plain(*lp)
        got, bwd_tf32x3 = gemm_ran(lambda: torch.autograd.grad(
            out_k, lk, dout, retain_graph=True), dt)
        want = torch.autograd.grad(out_p, lp, dout, retain_graph=True)
        checked, kink_note = (out_p, *want), ""
        if len(library) > 2 and library[2] is not None:
            at_kink, kink_note = library[2](*inputs)
            kink_note = f"; {kink_note}"
            lc = _leaves(inputs)
            out_c = at_kink(*lc)
            checked = (out_c, *torch.autograd.grad(out_c, lc, dout))
            del lc, out_c
        torch.cuda.synchronize()
        worst = _worst_err((out_k, *got), checked, f"{bwd_name} {label}")
        tol = GRAD_TOL[dt]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out_k, lk, dout, retain_graph=True), reps=reps)
        bwd_plain = cuda_ms(lambda: torch.autograd.grad(
            out_p, lp, dout, retain_graph=True), reps=reps)
        line = (f"backward {bwd_name} [{label}]: max_abs_err {worst[1]:.3e} "
                f"on a scale of {worst[2]:.3g} (tol {tol:g} of the scale"
                f"{kink_note}), "
                f"backward {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
                f"{bound_text(work_bwd, dt, bwd_tf32x3)}")
        library_ms = None
        if library and library[0] is not None:
            # the library call's backward alone, as the kernel's
            library_ms = cuda_ms(library[0]()[1], reps=reps)
            line += (f", library call F.scaled_dot_product_attention "
                     f"backward {library_ms:.4f} ms")
        _record(results, bwd_name, worst[1], bwd_ms, bwd_plain, work_bwd, dt,
                library_ms, bwd_tf32x3)
        if bwd_name in WINDOW_BWD:
            # the attention core alone, device time, among the backward's
            # products
            total, split = device_ms(lambda: torch.autograd.grad(
                out_k, lk, dout, retain_graph=True), reps)
            core = sum(v for k, v in split.items()
                       if any(c in k for c in CORE))
            line += (f", of which win_attn_bwd's core {core:.4f} ms device "
                     f"({total:.4f} ms device in all)")
        if res_name is not None:
            fwd_ms = cuda_ms(lambda: kern(*lk), reps=reps)
            fwd_plain = cuda_ms(lambda: plain(*lp), reps=reps)
            line += (f"; training forward {res_name} {fwd_ms:.4f} ms, plain "
                     f"{fwd_plain:.4f} ms, bound "
                     f"{bound_text(work_fwd, dt, fwd_tf32x3)}")
            if len(library) > 1:
                products = library[1](*inputs)
                line += (f", the same products through torch.matmul "
                         f"{cuda_ms(products, reps=reps):.4f} ms")
                del products
            _record(results, res_name, _rel_err(out_k, out_p)[0], fwd_ms,
                    fwd_plain, work_fwd, dt, None, fwd_tf32x3)
        print(f"{line} [{card}]", flush=True)
        require(worst[0] <= tol, f"{bwd_name} {label}: error {worst[1]} "
                f"above {tol} x {worst[2]}")
        del lk, lp, out_k, out_p, got, want, checked
    return results


def backward_phase(dev, card: str, titles: int) -> dict:
    """Training editions and backward kernels at the text train step's
    shapes (gradient_cases), then the embedding scatter-add."""
    rng = np.random.default_rng(SEED + 2)
    results = gradient_cases(backward_cases(rng, dev, titles), card)
    for dt in (torch.float32, torch.bfloat16):
        # BERT's word-table gradient: the titles' token ids, duplicates
        # included, into the 30522-row table
        M = titles * TITLE_LEN
        ids = torch.from_numpy(rng.integers(1, VOCAB, size=M)).to(dev)
        dx = torch.from_numpy(rng.standard_normal((M, HIDDEN)).astype(
            np.float32)).to(dev, dt)
        got = scatter_add_rows(ids, dx, VOCAB)
        want = scatter_add_rows_plain(ids, dx, VOCAB)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype == dt,
                f"scatter_add_rows: {got.shape}/{got.dtype}")
        err, scale = _rel_err(got, want)
        ms = cuda_ms(lambda: scatter_add_rows(ids, dx, VOCAB))
        plain_ms = cuda_ms(lambda: scatter_add_rows_plain(ids, dx, VOCAB))
        # the one library call of the same function: index_add_ of the rows
        # in their own dtype into a table that already exists
        table = torch.zeros(VOCAB, HIDDEN, dtype=dt, device=dev)
        library_ms = cuda_ms(lambda: table.index_add_(0, ids, dx))
        work = scatter_work(M, HIDDEN, VOCAB, size_of(dt))
        bound_ms, bound_by = bound_of(work, dt)
        tol = SCATTER_TOL[dt]
        print(f"kernel scatter_add_rows [M={M} V={VOCAB} D={HIDDEN} "
              f"{tag_of(dt)}]: max_abs_err "
              f"{err:.3e} on a scale of {scale:.3g} (tol {tol:g} of the "
              f"scale), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library call index_add_ {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} [{card}]", flush=True)
        require(math.isfinite(err) and err <= tol * scale,
                f"scatter_add_rows: error {err} above {tol} x {scale}")
        _record(results, "scatter_add_rows", err, ms, plain_ms, work, dt,
                library_ms)
    return results


def catalog(rng, item_num: int) -> np.ndarray:
    """(item_num + 1, 2 * TITLE_LEN) packed [ids || attmask] title rows of
    random length 5..30; row 0 is the empty padding item."""
    lens = rng.integers(5, TITLE_LEN + 1, size=item_num + 1)
    att = (np.arange(TITLE_LEN)[None, :] < lens[:, None]).astype(np.int64)
    ids = rng.integers(1, VOCAB, size=(item_num + 1, TITLE_LEN)) * att
    att[0] = 0
    ids[0] = 0
    return np.concatenate([ids, att], axis=1)


def histories(rng, B: int, item_num: int):
    return [rng.integers(1, item_num + 1,
                         size=int(rng.integers(1, L + 6))).tolist()
            for _ in range(B)]


def model_config(**train) -> SimpleNamespace:
    """The flagship configuration with the JAX Config's field names; the
    train step's fields as keyword arguments."""
    return SimpleNamespace(item_tower="modal", user_tower="sasrec",
                           stage="end2end", embedding_dim=D,
                           num_attention_heads=USER_HEADS,
                           transformer_block=BLOCKS, max_seq_len=L,
                           drop_rate=DROP, **train)


def build_model(dev, cfg, seed: int = SEED):
    bcfg = BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                      num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                      intermediate_size=FFN, max_position_embeddings=512,
                      hidden_dropout_prob=cfg.drop_rate,
                      attention_probs_dropout_prob=cfg.drop_rate)
    encoder = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                        word_embedding_dim=HIDDEN, pooling="cls",
                        attr_lengths=(TITLE_LEN,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_model(cfg, ITEM_NUM, encoder, device=dev, generator=gen)


def counts() -> dict:
    return {n: w.launches for n, w in WRAPPERS.items()}


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def check_results(ids: np.ndarray, hist, max_len: int = L) -> None:
    require((ids != 0).all(), "padding id 0 recommended")
    for row, h in zip(ids, hist):
        seen = set(h[-max_len:])
        require(not (seen & set(row.tolist())), "history id recommended")


def check_ties(mismatch, vals_p, scale, tol) -> None:
    """An id may differ from the plain ranking's only where that ranking
    has a tie within tolerance next to it, or at the cut after the last
    place."""
    for r, j in mismatch:
        near = [k for k in (j - 1, j + 1) if 0 <= k < TOP_K]
        tie = any(abs(vals_p[r, j] - vals_p[r, k]) <= 2 * tol * scale[r, j]
                  for k in near)
        require(tie or j == TOP_K - 1,
                f"sub-catalog ids differ outside a tie at row {r}, place {j}")


def serve_path(dev, card: str, content) -> dict:
    rng = np.random.default_rng(SEED + 1)
    model = build_model(dev, model_config())
    requests = {B: histories(rng, B, ITEM_NUM) for B in REQUEST_BATCHES}

    reset_counts()
    earlier = {n: WRAPPERS[n].bodies for n in SERVE_BODIES}
    for n in SERVE_BODIES:      # each part's bodies, from none
        WRAPPERS[n].bodies = set()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, ITEM_NUM, content, D,
                                     batch_size=ENCODE_BATCH)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    after_encode = counts()
    bodies = {"encode": {n: WRAPPERS[n].bodies for n in SERVE_BODIES}}
    for n in SERVE_BODIES:
        WRAPPERS[n].bodies = set()
    retriever = Retriever(model, table, max_seq_len=L,
                          batch_sizes=REQUEST_BATCHES)
    results = {B: retriever.recommend(h, top_k=TOP_K)
               for B, h in requests.items()}
    final = counts()
    bodies["recommend"] = {n: WRAPPERS[n].bodies for n in SERVE_BODIES}
    for n in SERVE_BODIES:
        WRAPPERS[n].bodies |= earlier[n] | bodies["encode"][n]

    print(f"serving launches after encode {after_encode}, after recommend "
          f"{final}", flush=True)
    for n in SERVE_KERNELS:
        require(after_encode[n] > 0, f"{n} never launched in the encode")
        require(final[n] > after_encode[n],
                f"{n} never launched in recommend")
    for part, seen in bodies.items():
        print(f"serving bodies, {part}: "
              f"{ {n: sorted(b) for n, b in seen.items()} }", flush=True)
        for n, want in SERVE_BODIES.items():
            require(set(want) <= seen[n],
                    f"{n} did not launch {set(want) - seen[n]} in {part}")
    require(tuple(table.shape) == (ITEM_NUM + 1, D), f"table {table.shape}")
    require(bool(torch.isfinite(table).all()), "table not finite")
    for B, (ids, vals) in results.items():
        require(ids.shape == (B, TOP_K), f"B={B}: ids {ids.shape}")
        require(np.isfinite(vals).all(), f"B={B}: scores not finite")
        require((np.diff(vals, axis=1) <= 0).all(), f"B={B}: not sorted")
        check_results(ids, requests[B])

    p50 = {}
    for B, h in requests.items():
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            retriever.recommend(h, top_k=TOP_K)   # returns host arrays
            walls.append((time.perf_counter() - t0) * 1e3)
        p50[B] = statistics.median(walls[5:])
    print(f"catalog encode: {ITEM_NUM + 1} items in {encode_s:.3f} s, "
          f"{(ITEM_NUM + 1) / encode_s:.1f} items/s [{card}]", flush=True)
    for B, ms in p50.items():
        print(f"recommend B={B} top_k={TOP_K}: p50 {ms:.3f} ms over 20 "
              f"requests [{card}]", flush=True)

    sub_catalog_check(model, content, rng)
    return final


def sub_catalog_check(model, content, rng) -> None:
    """Kernel path on the card vs plain path (the CPU dispatch of the same
    wrappers) on the first SUB_ITEMS items and one batch of requests."""
    n = SUB_ITEMS - 1
    hist = histories(rng, 64, n)
    table_k = Retriever.encode_catalog(model, n, content[:SUB_ITEMS], D,
                                       batch_size=ENCODE_BATCH)
    ids_k, vals_k = Retriever(model, table_k, max_seq_len=L,
                              batch_sizes=(64,)).recommend(hist, TOP_K)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    table_p = Retriever.encode_catalog(cpu_model, n,
                                       content[:SUB_ITEMS].cpu(), D,
                                       batch_size=ENCODE_BATCH)
    ids_p, vals_p = Retriever(cpu_model, table_p, max_seq_len=L,
                              batch_sizes=(64,)).recommend(hist, TOP_K)
    table_err = (table_k.cpu() - table_p).abs().max().item()
    scale = np.maximum(1.0, np.abs(vals_p))
    score_err = float((np.abs(vals_k - vals_p) / scale).max())
    mismatch = np.argwhere(ids_k != ids_p)
    print(f"sub-catalog {SUB_ITEMS} items: table max_abs_err {table_err:.3e} "
          f"(tol {TABLE_TOL:g}), score rel err {score_err:.3e} "
          f"(tol {SCORE_TOL:g}), {len(mismatch)} of {ids_k.size} ids "
          f"differ; plain CPU path took {time.perf_counter() - t0:.1f} s",
          flush=True)
    require(table_err <= TABLE_TOL, "sub-catalog table disagrees")
    require(score_err <= SCORE_TOL, "sub-catalog scores disagree")
    check_ties(mismatch, vals_p, scale, SCORE_TOL)
    check_results(ids_k, hist)


def bench_log_mask(rng, B: int, length: int = L) -> np.ndarray:
    """(B, length) log masks as bench.py _gen_raw draws them: each
    transition valid with probability 0.9, the last always."""
    lm = (rng.uniform(size=(B, length)) < 0.9).astype(np.float32)
    lm[:, -1] = 1.0
    return lm


def train_batches(rng, n: int) -> list:
    """n host batches as bench.py _gen_raw("text_morec") draws them
    (bench.py:94-101): a Zipf(1.2) item id capped at ITEM_NUM in every one
    of the L + 1 slots of every user, then the log mask of
    bench_log_mask."""
    return [(np.minimum(rng.zipf(ZIPF_A, size=(TRAIN_B, L + 1)),
                        ITEM_NUM).astype(np.int64),
             bench_log_mask(rng, TRAIN_B)) for _ in range(n)]


def dedup_cap(batches) -> int:
    """bench.py's static dedup capacity: the most unique ids of any batch,
    rounded up to 256."""
    most = max(len(np.unique(ids)) for ids, _ in batches)
    return -(-most // 256) * 256


def device_batch(ids, lm, cap: int, dev) -> dict:
    """A host batch deduplicated (np.unique, padded to cap) and moved to
    the device."""
    packed = dedup_pack(ids, cap)
    require(packed is not None, f"a batch holds more than {cap} items")
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"ids": t(ids), "log_mask": t(lm), "uniq_ids": t(packed[0]),
            "inverse": t(packed[1])}


def log_popularity(dev) -> torch.Tensor:
    """bench.py's uniform popularity; the padding item 0 at 1."""
    pop = np.full(ITEM_NUM + 1, 1.0 / ITEM_NUM)
    pop[0] = 1.0
    return torch.from_numpy(np.log(pop).astype(np.float32)).to(dev)


def train_config(cap: int, compute_dtype: str = "bfloat16"):
    return model_config(loss="inbatch_ce", compute_dtype=compute_dtype,
                        lr=LR, l2_weight=0.0, fine_tune_lr=FT_LR,
                        fine_tune_l2_weight=0.0, dedup_cap=cap)


def train_setup(dev, content, cap: int):
    """(model, train state, step) of the flagship bf16 train step."""
    cfg = train_config(cap)
    model = build_model(dev, cfg, seed=SEED + 3)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg, item_content=content,
                           log_pop=log_popularity(dev))
    return model, state, step


def train_path(dev, card: str, content, batches, cap: int):
    """The bf16 train step with dropout: FIXED_STEPS on batches[0], then
    TIMED_STEPS on the next batches, each deduplicated and copied to the
    device inside its timed step."""
    model, state, step = train_setup(dev, content, cap)
    fixed = device_batch(*batches[0], cap, dev)
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    losses = [step(state, fixed).item() for _ in range(FIXED_STEPS)]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"train: {FIXED_STEPS} steps on one batch of {TRAIN_B} users "
          f"({len(np.unique(batches[0][0]))} unique items, cap {cap}): "
          f"loss mean of the first 5 {first:.5f}, of the last 5 {last:.5f}",
          flush=True)
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    require(last < first, "the loss did not fall on a fixed batch")
    walls = []
    for ids, lm in batches[1:TIMED_STEPS + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, device_batch(ids, lm, cap, dev)).item()
        walls.append((time.perf_counter() - t0) * 1e3)
        require(math.isfinite(loss), "a loss is not finite")
    launched = counts()
    p50 = statistics.median(walls)
    print(f"train step B={TRAIN_B} L={L} bf16, dropout {DROP}, dedup cap "
          f"{cap}: p50 {p50:.3f} ms over {len(walls)} distinct batches "
          f"(min {min(walls):.3f}, max {max(walls):.3f}), "
          f"{TRAIN_B / p50 * 1e3:.1f} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"training launches {launched}", flush=True)
    steps = FIXED_STEPS + len(walls)
    print(f"gemm launches a text train step: {launched['gemm'] / steps:g} "
          f"(BERT's and SASRec's post-LN tails: 2 a projection tail, 4 an "
          f"FFN tail)", flush=True)
    require(launched["gemm"] == TEXT_GEMM_STEP * steps,
            f"gemm launched {launched['gemm']} times in {steps} text steps, "
            f"not {TEXT_GEMM_STEP} a step")
    for n in TRAIN_KERNELS:
        require(launched[n] > 0, f"{n} never launched in training")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "a parameter is not finite after training")
    return model, launched, (losses[0], p50)


def grad_check(dev, model, content, batch, pallas: bool = False) -> None:
    """One float32 step without dropout (eval mode) on CHECK_USERS users:
    on the card through the kernels, and on a CPU copy of the model
    through the plain versions. The loss and every gradient agree. With
    `pallas` the step takes the CE kernels (their plain version on the
    CPU), and the card's step must launch them."""
    ids, lm = batch[0][:CHECK_USERS], batch[1][:CHECK_USERS]
    cap = -(-len(np.unique(ids)) // 8) * 8
    cfg = train_config(cap, "float32")
    cfg.use_pallas = pallas
    runs = []
    for where in (dev, torch.device("cpu")):
        m = copy.deepcopy(model).to(where)
        state = make_train_state(m, cfg, param_labels(m))
        m.eval()
        step = make_train_step(cfg, item_content=content.to(where),
                               log_pop=log_popularity(where))
        before = counts()
        t0 = time.perf_counter()
        loss = step(state, device_batch(ids, lm, cap, where)).item()
        runs.append((loss, time.perf_counter() - t0, {
            n: p.grad.detach().cpu() for n, p in m.named_parameters()}))
        if pallas and where == dev:
            for n in PALLAS_KERNELS:
                require(counts()[n] == before[n] + 1,
                        f"{n} not launched once by the use_pallas step")
    (lk, sk, gk), (lp, sp, gp) = runs
    loss_err = abs(lk - lp) / abs(lp)
    top = max(want.abs().max().item() for want in gp.values())
    worst, worst_name = (-1.0, 0.0, 0.0), None
    for n, want in gp.items():
        scale = max(want.abs().max().item(), GRAD_FLOOR * top)
        err = (gk[n] - want).abs().max().item()
        if err / scale >= worst[0]:
            worst, worst_name = (err / scale, err, scale), n
    print(f"gradient check{' [use_pallas]' if pallas else ''}: f32 step on "
          f"{CHECK_USERS} users ({cap} titles), "
          f"card {sk:.2f} s vs CPU plain path {sp:.2f} s: loss {lk:.6f} vs "
          f"{lp:.6f}, rel err {loss_err:.3e} (tol {STEP_LOSS_TOL:g}); "
          f"largest gradient error {worst[1]:.3e} on a scale of "
          f"{worst[2]:.3e} in {worst_name} (tol {STEP_GRAD_TOL:g} of the "
          f"scale; largest gradient {top:.3e}) over {len(gp)} parameters",
          flush=True)
    require(math.isfinite(loss_err) and loss_err <= STEP_LOSS_TOL,
            "train-step loss disagrees with the plain path")
    require(worst[0] <= STEP_GRAD_TOL,
            f"gradient of {worst_name} disagrees with the plain path")


def profiled(run, n: int, what: str, unit: str, card: str) -> None:
    """torch.profiler split of ``run()`` by device kernel, reported per
    ``unit`` (``run`` covers n of them): the wall and device-busy time and
    each kernel's share of the busy time (user annotations left out); the
    top PROFILE_ROWS kernels, the rest in one line, then each fused_mha
    kernel (PROFILE_WATCH) among the rest on a line of its own, and last
    the sum of gemm.cu's kernels (PROFILE_GEMM)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    require(busy > 0, "the profiler recorded no device time")
    print(f"profile: {what}: wall {wall:.3f} ms a {unit}, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f} %), "
          f"{sum(r[1] for r in rows):.0f} kernels a {unit} [{card}]",
          flush=True)
    for ms, count, name in rows[:PROFILE_ROWS]:
        print(f"  {100 * ms / busy:6.2f} % {ms:8.3f} ms/{unit} x{count:<5g} "
              f"{name[:100]}", flush=True)
    rest = rows[PROFILE_ROWS:]
    ms = sum(r[0] for r in rest)
    print(f"  {100 * ms / busy:6.2f} % {ms:8.3f} ms/{unit} "
          f"x{sum(r[1] for r in rest):<5g} the other {len(rest)} kernels",
          flush=True)
    for ms, count, name in rest:
        if PROFILE_WATCH in name:
            print(f"    of which {100 * ms / busy:6.2f} % {ms:8.3f} "
                  f"ms/{unit} x{count:<5g} {name[:100]}", flush=True)
    gemm = [r for r in rows if any(k in r[2] for k in PROFILE_GEMM)]
    ms = sum(r[0] for r in gemm)
    print(f"  gemm.cu's kernels: {100 * ms / busy:.2f} % {ms:.3f} ms/{unit} "
          f"x{sum(r[1] for r in gemm):g} in {len(gemm)} kernels", flush=True)


def profile_train(dev, card: str, content, batches, cap: int) -> None:
    """The train step by device kernel: PROFILE_STEPS steps on distinct
    batches after as many warm-up steps."""
    _, state, step = train_setup(dev, content, cap)
    run = lambda part: [step(state, device_batch(ids, lm, cap, dev)).item()
                        for ids, lm in part]
    run(batches[:PROFILE_STEPS])
    profiled(lambda: run(batches[PROFILE_STEPS:2 * PROFILE_STEPS]),
             PROFILE_STEPS, f"train step B={TRAIN_B} bf16, dropout {DROP}, "
             f"dedup cap {cap}, {PROFILE_STEPS} steps", "step", card)


def profile_vision_encode(dev, card: str) -> None:
    """The vision catalog encode by device kernel: PROFILE_STEPS chunks of
    V_CHUNK images after one warm-up chunk."""
    model = build_vision_model(dev, V_ITEMS_FULL)
    content_fn = pool_content(image_pool(dev))
    timed_encode(model, V_CHUNK - 1, content_fn)
    profiled(lambda: timed_encode(model, PROFILE_STEPS * V_CHUNK - 1,
                                  content_fn),
             PROFILE_STEPS, f"vision catalog encode, Swin-T bf16, "
             f"{PROFILE_STEPS} chunks of {V_CHUNK} images", "chunk", card)


def profile_vision_recommend(dev, card: str) -> None:
    """The vision recommend by device kernel, for the smallest and the
    largest request batch: V_PROFILE_REQUESTS calls after as many warm-up
    calls, against a table of V_ITEMS_CUT + 1 random rows (the table's
    values do not change the work)."""
    rng = np.random.default_rng(SEED + 8)
    model = build_vision_model(dev, V_ITEMS_CUT)
    table = torch.randn(V_ITEMS_CUT + 1, V_D, device=dev)
    retriever = Retriever(model, table, max_seq_len=V_L,
                          batch_sizes=REQUEST_BATCHES)
    for B in (REQUEST_BATCHES[0], REQUEST_BATCHES[-1]):
        hist = vision_histories(rng, B, V_ITEMS_CUT)
        run = lambda: [retriever.recommend(hist, top_k=TOP_K)
                       for _ in range(V_PROFILE_REQUESTS)]
        run()
        profiled(run, V_PROFILE_REQUESTS, f"vision recommend B={B} "
                 f"top_k={TOP_K} L={V_L} D={V_D}, {V_ITEMS_CUT + 1} rows, "
                 f"{V_PROFILE_REQUESTS} requests", "request", card)


def vision_histories(rng, B: int, item_num: int) -> list:
    return [rng.integers(1, item_num + 1, size=int(
        rng.integers(1, V_L + 6))).tolist() for _ in range(B)]


def vision_kernel_cases(dev):
    """The Swin kernels at each Swin-T stage's shapes for one encode chunk
    of V_CHUNK images, and the user tower's kernels at D = V_D for the
    largest and the smallest request batch; bfloat16 first (the serving
    path's dtype), then float32. Inputs come from a seeded generator on
    the card (a stage's map is 154 M elements)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device=dev) * scale
    T = WINDOW * WINDOW
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag, it = tag_of(dt), size_of(dt)
        for C, nh, side in SWIN_STAGES:
            nW = (side // WINDOW) ** 2
            windows = V_CHUNK * nW
            x = g(V_CHUNK, side, side, C).to(dt)
            ws = (g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
                  g(C, C, scale=C ** -0.5), g(C, scale=0.1))
            rel = g(1, nh, T, T, scale=0.5)
            biases = [("P=1", rel)]
            if nW > 1:      # a shifted block: the mask of -100, per window
                mask = torch.from_numpy(_shift_mask(
                    side, side, WINDOW, WINDOW // 2)).to(dev)
                biases.append((f"P={nW}", rel + mask[:, None]))
            where = f"N={V_CHUNK} {side}x{side} C={C} nh={nh} {tag}"
            # bf16: the yardstick, the same products through torch.matmul
            yard = (lambda x=x, ws=ws, nh=nh, dt=dt: attention_products(
                window_partition(x, WINDOW), ws[0].to(dt), ws[2].to(dt), nh)
            ) if dt == torch.bfloat16 else None
            for ptag, bias in biases:
                cases.append((
                    "fused_mha_proj_band", f"{ptag} {where}", dt,
                    lambda x=x, b=bias, ws=ws, nh=nh: fused_mha_proj_band(
                        x, b, *ws, n_heads=nh, window=WINDOW),
                    lambda x=x, b=bias, ws=ws, nh=nh:
                        fused_mha_proj_band_plain(x, b, *ws, n_heads=nh,
                                                  window=WINDOW),
                    win_attn_work(windows, T, C, nh, bias.shape[0], it),
                    None, *([yard] if yard and ptag == "P=1" else [])))
            wins, bias = window_partition(x, WINDOW), biases[-1][1]
            cases.append((
                "fused_mha_proj",
                f"{biases[-1][0]} B={windows} T={T} C={C} nh={nh} {tag}", dt,
                lambda x=wins, b=bias, ws=ws, nh=nh: fused_mha_proj(
                    x, b, *ws, n_heads=nh),
                lambda x=wins, b=bias, ws=ws, nh=nh: fused_mha_proj_plain(
                    x, b, *ws, n_heads=nh),
                win_attn_work(windows, T, C, nh, bias.shape[0], it), None))
            M, Fw = V_CHUNK * side * side, 4 * C
            x2 = x.reshape(M, C)
            mlp = (g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1),
                   g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1))
            ln = (1.0 + g(C, scale=0.1), g(C, scale=0.1))
            # DropPath's factor: an image kept (1 / 0.9) or dropped (0)
            keep = (torch.rand(V_CHUNK, generator=gen, device=dev) < 0.9)
            scale = (keep.float() / 0.9).repeat_interleave(side * side)
            shape = f"M={M} C={C} F={Fw} gelu {tag}"
            yard = (lambda x=x2, mlp=mlp, dt=dt: mlp_products(
                x, mlp[0].to(dt), mlp[2].to(dt))
            ) if dt == torch.bfloat16 else None
            for stag, sc in (("unit", None), ("scaled", scale)):
                cases.append((
                    "fused_mlp_res", f"{stag} {shape}", dt,
                    lambda x=x2, sc=sc, mlp=mlp, ln=ln: fused_mlp_res(
                        x, sc, *mlp, ln=ln, eps=1e-5),
                    lambda x=x2, sc=sc, mlp=mlp, ln=ln: fused_mlp_res_plain(
                        x, sc, *mlp, ln=ln, eps=1e-5),
                    mlp_work(M, C, Fw, it, scale=sc is not None), None,
                    *([yard] if yard and sc is None else [])))
            for ltag, lnp in (("LN", ln), ("no LN", None)):
                cases.append((
                    "fused_mlp", f"{ltag} {shape}", dt,
                    lambda x=x2, mlp=mlp, lnp=lnp: fused_mlp(
                        x, *mlp, ln=lnp, eps=1e-5),
                    lambda x=x2, mlp=mlp, lnp=lnp: fused_mlp_plain(
                        x, *mlp, ln=lnp, eps=1e-5),
                    mlp_work(M, C, Fw, it), None))
    rng = np.random.default_rng(SEED + 6)
    for dt in (torch.bfloat16, torch.float32):
        tag, it = tag_of(dt), size_of(dt)
        # SASRec at the vision flagship: B histories of L = 10, 2 heads of
        # 1024, and its tails at C = 2048, F = 8192
        nh = USER_HEADS
        for B in (REQUEST_BATCHES[-1], REQUEST_BATCHES[0]):
            qkv = g(B, V_L, 3 * V_D).to(dt)
            bias = causal_additive_mask(
                torch.from_numpy(left_padded_mask(rng, B, V_L)).to(dev))
            cases.append((
                "fused_mha", f"bias B={B} T={V_L} nh={nh} dh={V_D // nh} "
                f"{tag}", dt,
                lambda q=qkv, b=bias: fused_mha(q, bias=b, n_heads=nh),
                lambda q=qkv, b=bias: fused_mha_plain(q, bias=b, n_heads=nh),
                mha_work(B, V_L, nh, V_D // nh, it, bias.numel()),
                sdpa_call(qkv, nh, bias.to(dt))))
            cases += tail_cases(g, dev, dt, B * V_L, V_D, 4 * V_D, 1e-6,
                                "relu", "SASRec")
    return cases


def vision_backward_cases(dev, images: int):
    """gradient_cases tuples for the vision train step's kernels: the four
    backward kernels at each Swin-T stage's shapes for `images` images
    (band with one bias and with a bias per window, window layout; the
    residual MLP unit and scaled, the bare MLP with and without its
    LayerNorm), and SASRec's attention backward (heads of V_D / 2) and
    post-LN tails at C = V_D for V_TRAIN_B users, dropout 0 and DROP; bfloat16 first (the train step's dtype),
    then float32. Operands come from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    g = lambda *s, scale=1.0, dt=torch.float32: (torch.randn(
        *s, generator=gen, device=dev) * scale).to(dt)
    T = WINDOW * WINDOW
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag, it = tag_of(dt), size_of(dt)
        for C, nh, side in SWIN_STAGES:
            nW = (side // WINDOW) ** 2
            windows = images * nW
            ws = [g(C, 3 * C, scale=C ** -0.5), g(3 * C, scale=0.1),
                  g(C, C, scale=C ** -0.5), g(C, scale=0.1)]
            rel = g(1, nh, T, T, scale=0.5)
            biases = [("P=1", rel)]
            if nW > 1:      # a shifted block: the mask of -100, per window
                mask = torch.from_numpy(_shift_mask(
                    side, side, WINDOW, WINDOW // 2)).to(dev)
                biases.append((f"P={nW}", rel + mask[:, None]))
            where = f"N={images} {side}x{side} C={C} nh={nh} {tag}"
            for ptag, bias in biases:
                cases.append((
                    None, "fused_mha_proj_band_bwd", f"{ptag} {where}", dt,
                    [g(images, side, side, C, dt=dt), bias] + ws,
                    g(images, side, side, C, dt=dt),
                    lambda *a, nh=nh: fused_mha_proj_band(
                        *a, n_heads=nh, window=WINDOW),
                    lambda *a, nh=nh: fused_mha_proj_band_plain(
                        *a, n_heads=nh, window=WINDOW),
                    win_attn_bwd_work(windows, T, C, nh, bias.shape[0], it),
                    None))
            ptag, bias = biases[-1]
            cases.append((
                None, "fused_mha_proj_bwd",
                f"{ptag} B={windows} T={T} C={C} nh={nh} {tag}", dt,
                [g(windows, T, C, dt=dt), bias] + ws, g(windows, T, C, dt=dt),
                lambda *a, nh=nh: fused_mha_proj(*a, n_heads=nh),
                lambda *a, nh=nh: fused_mha_proj_plain(*a, n_heads=nh),
                win_attn_bwd_work(windows, T, C, nh, bias.shape[0], it),
                None))
            M, Fw = images * side * side, 4 * C
            mlp = [g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1),
                   g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1)]
            ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
            # DropPath's factor: an image kept (1 / 0.9) or dropped (0)
            keep = (torch.rand(images, generator=gen, device=dev) < 0.9)
            scale = (keep.float() / 0.9).repeat_interleave(side * side)
            shape = f"M={M} C={C} F={Fw} gelu {tag}"
            for stag, sc in (("unit", None), ("scaled", scale)):
                cases.append((
                    None, "fused_mlp_res_bwd", f"{stag} {shape}", dt,
                    [g(M, C, dt=dt)] + mlp + ln, g(M, C, dt=dt),
                    lambda *a, sc=sc: fused_mlp_res(
                        a[0], sc, *a[1:5], ln=a[5:], eps=1e-5),
                    lambda *a, sc=sc: fused_mlp_res_plain(
                        a[0], sc, *a[1:5], ln=a[5:], eps=1e-5),
                    premlp_bwd_work(M, C, Fw, it, scale=sc is not None),
                    None))
            for ltag, lnp in (("LN", ln), ("no LN", [])):
                cases.append((
                    None, "fused_mlp_bwd", f"{ltag} {shape}", dt,
                    [g(M, C, dt=dt)] + mlp + lnp, g(M, C, dt=dt),
                    lambda *a: fused_mlp(*a[:5], ln=a[5:] or None, eps=1e-5),
                    lambda *a: fused_mlp_plain(*a[:5], ln=a[5:] or None,
                                               eps=1e-5),
                    premlp_bwd_work(M, C, Fw, it), None))
    rng = np.random.default_rng(SEED + 9)
    M, C, Fw = V_TRAIN_B * V_L, V_D, 4 * V_D
    for dt in (torch.bfloat16, torch.float32):
        for p in (0.0, DROP):
            tag, it = f"{tag_of(dt)} drop={p}", size_of(dt)
            kw = dict(eps=1e-6, drop_rate=p,
                      seed=int(rng.integers(1, 2 ** 31 - 1)))
            ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
            # SASRec's attention at the vision flagship: 2 heads of 1024
            bias = causal_additive_mask(torch.from_numpy(
                bench_log_mask(rng, V_TRAIN_B, V_L)).to(dev))
            qkv = g(V_TRAIN_B, V_L, 3 * C, dt=dt)
            dout = g(V_TRAIN_B, V_L, C, dt=dt)
            cases.append((
                None, "fused_mha_bwd",
                f"bias B={V_TRAIN_B} T={V_L} nh={USER_HEADS} "
                f"dh={C // USER_HEADS} {tag}", dt,
                [qkv], dout,
                lambda q, b=bias, kw=kw: fused_mha(
                    q, bias=b, n_heads=USER_HEADS, drop_rate=kw["drop_rate"],
                    seed=kw["seed"]),
                lambda q, b=bias, kw=kw: fused_mha_plain(
                    q, bias=b, n_heads=USER_HEADS, drop_rate=kw["drop_rate"],
                    seed=kw["seed"]),
                mha_bwd_work(V_TRAIN_B, V_L, USER_HEADS, C // USER_HEADS, it,
                             bias.numel()), None,
                sdpa_backward(qkv, USER_HEADS, bias, dout, kw["drop_rate"])))
            cases.append((
                "fused_proj_resln_res", "fused_proj_resln_bwd",
                f"SASRec M={M} C={C} {tag}", dt,
                [g(M, C, dt=dt), g(M, C, dt=dt), g(C, C, scale=C ** -0.5),
                 torch.zeros(C, device=dev)] + ln, g(M, C, dt=dt),
                lambda *a, kw=kw: fused_proj_resln(*a[:4], ln=a[4:], **kw),
                lambda *a, kw=kw: fused_proj_resln_plain(*a[:4], ln=a[4:],
                                                         **kw),
                proj_bwd_work(M, C, it), proj_work(M, C, it, saved=1), None,
                proj_yardstick))
            cases.append((
                "fused_mlp_resln_res", "fused_mlp_resln_bwd",
                f"SASRec M={M} C={C} F={Fw} relu {tag}", dt,
                [g(M, C, dt=dt), g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1),
                 g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1)] + ln,
                g(M, C, dt=dt),
                lambda *a, kw=kw: fused_mlp_resln(*a[:5], ln=a[5:],
                                                  act="relu", **kw),
                lambda *a, kw=kw: fused_mlp_resln_plain(
                    *a[:5], ln=a[5:], act="relu", **kw),
                mlp_bwd_work(M, C, Fw, it),
                mlp_work(M, C, Fw, it, saved=True), None, tail_yardstick,
                (lambda *a, kw=kw: relu_at_kink(*a, **kw))
                if dt == torch.float32 else None))
    return cases


def gemm_phase(dev, card: str, images: int, titles: int) -> dict:
    """gemm() (csrc/gemm.cu, bf16) at the main paths' largest products
    (bench_gemm.product_cases), beside torch.matmul of the same operands
    (the product alone; the port never calls it for these) and gemm_plain
    (its plain version): the three largest products of the Swin-T stage-0
    band backward for `images` images (M = images x 56 x 56 rows, C = 96:
    the recomputed qkv = x wqkv + bqkv, dwqkv = xᵀ dqkv and dx = dqkv
    wqkvᵀ), held against the library (torch.addmm, the one call computing
    x wqkv + bqkv, and torch.matmul), then the four products of the text
    FFN tail's backward (M = `titles` x 30 rows, C = 512, F = 2048: dw2 =
    cast(gelu(h))ᵀ dz, dh = (dz w2ᵀ) gelu'(h), dw1 = xᵀ dh, dx = dh w1ᵀ +
    dyp) with their epilogues, held against gemm_plain (no one PyTorch call
    computes them); each fatal above GRAD_TOL (bf16) of max(1, the largest
    value). Then the float32 body (3xTF32) at the float32 `recommend`
    tails' products at D = 2048 and the text encode's projection
    (bench_gemm.f32_product_cases), against gemm_plain, fatal above
    GRAD_TOL (float32) of the scale, beside torch.matmul float32. Times,
    TFLOP/s and bounds; returns the "gemm" row, the stage-0 qkv its
    headline."""
    dt, tol = torch.bfloat16, GRAD_TOL[torch.bfloat16]
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    g = lambda *s, scale=1.0, d=dt: (torch.randn(*s, generator=gen,
                                                 device=dev) * scale).to(d)
    code = lib.dtype_code(g(1))
    results = {}
    for p in product_cases(g, images, titles, mlp=False):
        matmul = p.matmul or p.library   # without an epilogue they are one
        kern = lambda: gemm(*p.args, code, **p.kw)
        plain = lambda: gemm_plain(*p.args, **p.kw)
        # the stage-0 products against the library's, the text products
        # (whose epilogues no library call has) against the plain version
        got = kern()
        want = p.library() if p.library else plain()
        err, scale = _rel_err(got, want)
        del got, want
        ms = cuda_ms(kern, reps=VB_REPS)
        plain_ms = cuda_ms(plain, reps=VB_REPS)
        library_ms = cuda_ms(p.library, reps=VB_REPS) if p.library else None
        matmul_ms = (cuda_ms(matmul, reps=VB_REPS) if matmul is not p.library
                     else library_ms)
        work = (p.flops, p.nbytes)
        bound_ms, bound_by = bound_of(work, dt)
        also = ("" if p.library is None or matmul is p.library else
                f"; library call torch.addmm {library_ms:.4f} ms "
                f"({ms / library_ms:.2f}x)")
        print(f"gemm [{p.label} bf16]: {ms:.4f} ms, "
              f"{p.flops / ms / 1e9:.1f} TFLOP/s; torch.matmul of the same "
              f"operands {matmul_ms:.4f} ms ({ms / matmul_ms:.2f}x){also}; "
              f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by}; error {err:.3e} on a scale of {scale:.3g} (tol "
              f"{tol:g} of the scale) [{card}]", flush=True)
        require(math.isfinite(err) and err <= tol * scale,
                f"gemm [{p.label}]: error {err} above {tol} x {scale}")
        _record(results, "gemm", err / scale, ms, plain_ms, work, dt,
                library_ms)
    # float32 (3xTF32): the products of SASRec's tails at D = 2048 for
    # `recommend` at B = 64 and 1 and of the text encode's projection,
    # against their plain version, beside torch.matmul float32 (TF32 off,
    # set here)
    torch.backends.cuda.matmul.allow_tf32 = False
    dt, tol = torch.float32, GRAD_TOL[torch.float32]
    code = lib.dtype_code(g(1, d=dt))
    for p in f32_product_cases(lambda *s, scale=1.0: g(*s, scale=scale,
                                                        d=dt)):
        kern = lambda: gemm(*p.args, code, **p.kw)
        plain = lambda: gemm_plain(*p.args, **p.kw)
        err, scale = _rel_err(kern(), plain())
        ms = cuda_ms(kern, reps=VB_REPS)
        plain_ms = cuda_ms(plain, reps=VB_REPS)
        library_ms = cuda_ms(p.library, reps=VB_REPS) if p.library else None
        matmul_ms = cuda_ms(p.matmul, reps=VB_REPS)
        work = (p.flops, p.nbytes)
        print(f"gemm [{p.label} f32]: {ms:.4f} ms, "
              f"{p.flops / ms / 1e9:.1f} TFLOP/s; torch.matmul float32 of "
              f"the same operands {matmul_ms:.4f} ms "
              f"({p.flops / matmul_ms / 1e9:.1f} TFLOP/s, {ms / matmul_ms:.2f}"
              f"x)" + ("" if library_ms is None else
                       f"; library call {library_ms:.4f} ms")
              + f"; plain {plain_ms:.4f} ms; bound "
              f"{bound_text(work, dt, True)}; error {err:.3e} on "
              f"a scale of {scale:.3g} (tol {tol:g} of the scale) [{card}]",
              flush=True)
        require(math.isfinite(err) and err <= tol * scale,
                f"gemm [{p.label} f32]: error {err} above {tol} x {scale}")
        _record(results, "gemm", err / scale, ms, plain_ms, work, dt,
                library_ms, True)
    return results


def sdpa_grad_calls(qkv, n_heads, bias, dout, trainable=True):
    """F.scaled_dot_product_attention with the (P, 1 or nh, T or 1, T) bias
    repeated to B rows in qkv's dtype as an attn_mask, which requires a
    gradient when `trainable`: (its forward, its backward alone on a kept
    graph, its forward and backward), the library calls that compute
    fused_mha's output, dqkv and (trainable) per-row dbias. A yardstick
    only."""
    B, T, H3 = qkv.shape
    leaf = qkv.detach().requires_grad_(True)
    mask = bias.detach().to(qkv.dtype).repeat(B // bias.shape[0], 1, 1, 1)
    mask.requires_grad_(trainable)
    wrt = (leaf, mask) if trainable else (leaf,)
    heads = lambda t: t.reshape(B, T, n_heads, -1).transpose(1, 2)
    d = heads(dout)

    def forward():
        return F.scaled_dot_product_attention(
            *(heads(t) for t in leaf.split(H3 // 3, dim=-1)), attn_mask=mask)

    out = forward()
    return (forward,
            lambda: torch.autograd.grad(out, wrt, d, retain_graph=True),
            lambda: torch.autograd.grad(forward(), wrt, d))


def dbias_phase(dev, card: str, images: int) -> dict:
    """fused_mha's dbias edition at the window attention of every Swin-T
    stage for `images` images (B = images x nW rows of T = 49, heads of
    32): one bias for every row (P = 1) and, for the shifted blocks of
    stages 0-2, a bias per window (P = nW, the shift mask's -100 on some
    pairs); bfloat16 first (the train step's dtype), then float32; dropout
    0 and DROP. dqkv and dbias against autograd of the plain version, and a
    second run to the bit; the backward's time (autograd, dbias cast
    included), the plain version's, the fixed-order sum's alone and, at
    dropout 0, F.scaled_dot_product_attention's backward (the library
    column) and both sides' forward and backward."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    g = lambda *s, scale=1.0, dt=torch.float32: (torch.randn(
        *s, generator=gen, device=dev) * scale).to(dt)
    rng = np.random.default_rng(SEED + 14)
    T = WINDOW * WINDOW
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        tag, it = tag_of(dt), size_of(dt)
        for C, nh, side in SWIN_STAGES:
            nW, dh = (side // WINDOW) ** 2, C // nh
            B = images * nW
            rel = g(1, nh, T, T, scale=0.5)
            biases = [rel]
            if nW > 1:
                mask = torch.from_numpy(_shift_mask(
                    side, side, WINDOW, WINDOW // 2)).to(dev)
                biases.append(rel + mask[:, None])
            for bias in biases:
                P = bias.shape[0]
                for p in (0.0, DROP):
                    label = (f"P={P} B={B} T={T} nh={nh} dh={dh} {tag} "
                             f"drop={p}")
                    seed = int(rng.integers(1, 2 ** 31 - 1))
                    qkv, dout = g(B, T, 3 * C, dt=dt), g(B, T, C, dt=dt)
                    kern, plain = (lambda q, b, fn=fn, p=p, s=seed: fn(
                        q, bias=b, n_heads=nh, drop_rate=p, seed=s)
                        for fn in (fused_mha, fused_mha_plain))
                    lk, lp = _leaves([qkv, bias]), _leaves([qkv, bias])
                    out_k, out_p = kern(*lk), plain(*lp)
                    before = fused_mha_bwd_dbias.launches
                    grad_k = lambda: torch.autograd.grad(out_k, lk, dout,
                                                         retain_graph=True)
                    got, again = grad_k(), grad_k()
                    want = torch.autograd.grad(out_p, lp, dout,
                                               retain_graph=True)
                    torch.cuda.synchronize()
                    require(fused_mha_bwd_dbias.launches == before + 2,
                            f"fused_mha_bwd_dbias {label}: not launched")
                    require(all(torch.equal(a, b) for a, b in
                                zip(got, again)),
                            f"fused_mha_bwd_dbias {label}: two runs differ")
                    worst = _worst_err((out_k, *got), (out_p, *want),
                                       f"fused_mha_bwd_dbias {label}")
                    del again, want
                    ms = cuda_ms(grad_k, reps=VB_REPS)
                    plain_ms = cuda_ms(lambda: torch.autograd.grad(
                        out_p, lp, dout, retain_graph=True), reps=VB_REPS)
                    chunks = dbias_chunks(B, T, nh, dh, P, lib.dtype_code(qkv))
                    part = torch.zeros(chunks * nh * P * T * T, device=dev)
                    summed = torch.empty(P, nh, T, T, device=dev)
                    sum_ms = cuda_ms(lambda: sum_partials(part, summed,
                                                          chunks),
                                     reps=VB_REPS)
                    del part, summed
                    work = mha_dbias_work(B, T, nh, dh, it, P)
                    bound_ms, bound_by = bound_of(work, dt)
                    line = (f"backward fused_mha_bwd_dbias [{label}]: "
                            f"max_abs_err {worst[1]:.3e} on a scale of "
                            f"{worst[2]:.3g} (tol {GRAD_TOL[dt]:g} of the "
                            f"scale), the same bits on a second run; "
                            f"backward {ms:.4f} ms ({chunks} chunks, the "
                            f"fixed-order sum {sum_ms:.4f} ms of it), plain "
                            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                            f"{bound_by}")
                    library_ms = None
                    if p == 0.0:
                        sdpa = sdpa_grad_calls(qkv, nh, bias, dout)
                        library_ms = cuda_ms(sdpa[1], reps=VB_REPS)
                        fwd = [cuda_ms(f, reps=VB_REPS) for f in (
                            lambda: kern(qkv, bias), lambda: plain(qkv, bias),
                            sdpa[0])]
                        fwd_bound = bound_of(mha_work(B, T, nh, dh, it,
                                                      P * nh * T * T), dt)
                        both = [cuda_ms(f, reps=VB_REPS) for f in (
                            lambda: torch.autograd.grad(kern(*lk), lk, dout),
                            sdpa[2])]
                        del sdpa
                        line += (f"; library call F.scaled_dot_product_"
                                 f"attention backward {library_ms:.4f} ms; "
                                 f"forward (fused_mha, no graph): kernel "
                                 f"{fwd[0]:.4f} ms, plain {fwd[1]:.4f} ms, "
                                 f"library {fwd[2]:.4f} ms, bound "
                                 f"{fwd_bound[0]:.4f} ms by {fwd_bound[1]}; "
                                 f"forward and backward: kernels "
                                 f"{both[0]:.4f} ms, library {both[1]:.4f} "
                                 f"ms")
                    print(f"{line} [{card}]", flush=True)
                    require(worst[0] <= GRAD_TOL[dt],
                            f"fused_mha_bwd_dbias {label}: error {worst[1]} "
                            f"above {GRAD_TOL[dt]} x {worst[2]}")
                    _record(results, "fused_mha_bwd_dbias", worst[1], ms,
                            plain_ms, work, dt, library_ms)
                    del lk, lp, out_k, out_p, got
    return results


def vision_train_config(cap: int, chunk: int,
                        compute_dtype: str = "bfloat16") -> SimpleNamespace:
    cfg = vision_config()
    cfg.__dict__.update(loss="inbatch_ce", compute_dtype=compute_dtype,
                        lr=V_LR, l2_weight=0.0, fine_tune_lr=V_FT_LR,
                        fine_tune_l2_weight=0.0, dedup_cap=cap,
                        encoder_chunk=chunk)
    return cfg


def vision_batches(rng, n: int, zipf: bool) -> list:
    """n host batches as bench.py _gen_raw draws them for the vision
    flagship (bench.py:89-98): Zipf(1.2) ids capped at the catalog's size
    ("vision_morec_zipf") or uniform ids ("vision_morec") in all
    V_TRAIN_B x (V_L + 1) slots, then the log mask."""
    out = []
    for _ in range(n):
        shape = (V_TRAIN_B, V_L + 1)
        ids = (np.minimum(rng.zipf(ZIPF_A, size=shape), V_ITEMS_FULL) if zipf
               else rng.integers(1, V_ITEMS_FULL + 1, size=shape))
        out.append((ids.astype(np.int64),
                    bench_log_mask(rng, V_TRAIN_B, V_L)))
    return out


def vision_device_batch(ids, lm, cap: int, pool: np.ndarray, dev) -> dict:
    """A host batch with its images, moved to the device: with a dedup cap
    the unique ids (np.unique, padded to cap) and their images
    (bench.py:229-230, pool[uniq % POOL]); with cap 0 an image for every
    slot."""
    t = lambda a: torch.from_numpy(a).to(dev)
    batch = {"ids": t(ids), "log_mask": t(lm)}
    if not cap:
        batch["content"] = t(pool[ids.reshape(-1) % len(pool)])
        return batch
    packed = dedup_pack(ids, cap)
    require(packed is not None, f"a batch holds more than {cap} items")
    batch.update(uniq_ids=t(packed[0]), inverse=t(packed[1]),
                 uniq_content=t(pool[packed[0] % len(pool)]))
    return batch


def vision_train_setup(dev, cfg, kernels: str = "band",
                       swin_drop: float = 0.0):
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    model = build_vision_model(dev, V_ITEMS_FULL, kernels, dt, swin_drop)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg, log_pop=log_popularity(dev))
    return model, state, step


def vision_train_run(dev, card: str, pool, batches, cap: int, chunk: int,
                     fixed: int, timed: int, what: str,
                     kernels: str = "band", pallas: bool = False,
                     swin_drop: float = 0.0) -> dict:
    """`fixed` steps on batches[0] (the loss must fall), then `timed` steps
    on the next batches, each packed and copied to the device inside its
    timed step; `pallas` takes the CE kernels, `swin_drop` is Swin's hidden
    and attention-probability dropout. Returns the launch counts of the
    whole run."""
    cfg = vision_train_config(cap, chunk)
    cfg.use_pallas = pallas
    model, state, step = vision_train_setup(dev, cfg, kernels, swin_drop)
    images = cap or V_TRAIN_B * (V_L + 1)
    first = vision_device_batch(*batches[0], cap, pool, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(state, first).item() for _ in range(fixed)]
    walls = []
    for ids, lm in batches[1:timed + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(state, vision_device_batch(ids, lm, cap, pool,
                                               dev)).item()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launched = counts()
    print(f"gemm launches a vision train step [{what}]: "
          f"{launched['gemm'] / (fixed + len(walls)):g}", flush=True)
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    if fixed > 2:
        require(losses[fixed - 1] < losses[0],
                f"{what}: the loss did not fall on a fixed batch: "
                f"{losses[:fixed]}")
    p50 = statistics.median(walls)
    swin = f", Swin dropouts {swin_drop}" if swin_drop else ""
    print(f"vision train step [{what}] B={V_TRAIN_B} L={V_L} D={V_D} Swin-T "
          f"bf16, DropPath 0.1, dropout {DROP}{swin}, {images} images a step, "
          f"encoder_chunk {chunk}: {fixed} steps on one batch, loss "
          f"{losses[0]:.5f} -> {losses[fixed - 1]:.5f}; then {len(walls)} "
          f"distinct batches: p50 {p50:.3f} ms (min {min(walls):.3f}, max "
          f"{max(walls):.3f}), {V_TRAIN_B / p50 * 1e3:.2f} samples/s, "
          f"{images / p50 * 1e3:.1f} images/s through the tower, last loss "
          f"{losses[-1]:.5f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "a parameter is not finite after training")
    return launched


def vision_train_path(dev, card: str, pool: np.ndarray) -> dict:
    """The bf16 vision train step at bench.py's two traffics: Zipf ids with
    dedup at encoder_chunk 0 and at cap // 3, then uniform ids without
    dedup (an image in every slot) in V_NODEDUP_CHUNKS chunks; last, two
    Zipf steps under the "windows" kernel selection. Returns the launch
    counts of the first run and of the last."""
    rng = np.random.default_rng(SEED + 10)
    zipf = vision_batches(rng, V_TIMED_STEPS + 1, True)
    most = max(len(np.unique(ids)) for ids, _ in zipf)
    cap = -(-most // V_CAP_QUANTUM) * V_CAP_QUANTUM
    print(f"vision train: {len(zipf)} Zipf({ZIPF_A}) batches, at most {most} "
          f"unique items, dedup cap {cap}", flush=True)
    launched = vision_train_run(dev, card, pool, zipf, cap, 0, V_FIXED_STEPS,
                                V_TIMED_STEPS, "zipf, dedup")
    print(f"vision training launches {launched}", flush=True)
    for n in VISION_TRAIN_KERNELS:
        require(launched[n] > 0, f"{n} never launched in vision training")
    torch.cuda.empty_cache()
    vision_train_run(dev, card, pool, zipf, cap, cap // 3, V_CHUNKED_FIXED,
                     V_CHUNKED_TIMED, "zipf, dedup, chunked")
    torch.cuda.empty_cache()
    slots = V_TRAIN_B * (V_L + 1)
    vision_train_run(dev, card, pool, vision_batches(rng, 2, False), 0,
                     slots // V_NODEDUP_CHUNKS, 1, 1, "uniform, no dedup")
    torch.cuda.empty_cache()
    windows = vision_train_run(dev, card, pool, zipf, cap, 0, 1, 1,
                               "zipf, dedup, 'windows' kernels", "windows")
    print(f"vision training launches under 'windows' {windows}", flush=True)
    for n in VISION_WINDOWS_TRAIN_KERNELS:
        require(windows[n] > 0, f"{n} never launched by the 'windows' "
                f"train step")
    torch.cuda.empty_cache()
    return launched, windows


def vision_grad_check(dev, card: str, pool: np.ndarray,
                      swin_drop: float = 0.0) -> None:
    """One float32 step in training mode (DropPath 0.1 and dropout drawn
    from the same seed on both sides) on V_CHECK_USERS users: on the card
    under both kernel selections, and on a CPU copy of the model through the
    plain versions. The loss and every gradient agree, and the "windows"
    step went through its kernels. With `swin_drop` (Swin's hidden and
    attention-probability dropout) both selections take the same kernels,
    so the card runs once, and that step must have taken the dropout
    path's kernels and none of the kernel pairs."""
    rng = np.random.default_rng(SEED + 11)
    ids, lm = vision_batches(rng, 1, True)[0]
    ids, lm = ids[:V_CHECK_USERS], lm[:V_CHECK_USERS]
    cap = -(-len(np.unique(ids)) // 4) * 4
    cfg = vision_train_config(cap, 0, "float32")
    selections = ("band",) if swin_drop else ("band", "windows")
    runs, launched = {}, None
    for run, where, kernels in ([(k, dev, k) for k in selections]
                                + [("plain", torch.device("cpu"), "band")]):
        model = build_vision_model(dev, V_ITEMS_FULL, kernels, None,
                                   swin_drop).to(where)
        state = make_train_state(model, cfg, param_labels(model), seed=SEED)
        step = make_train_step(cfg, log_pop=log_popularity(where))
        reset_counts()
        relu_in = []
        t0 = time.perf_counter()
        with relu_inputs(relu_in):
            loss = step(state, vision_device_batch(ids, lm, cap, pool,
                                                   where)).item()
        runs[run] = (loss, time.perf_counter() - t0, {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            relu_in)
        if run == selections[-1]:
            launched = counts()
    lp, sp, gp, hp = runs["plain"]
    top = max(want.abs().max().item() for want in gp.values())
    what = f", Swin dropouts {swin_drop}" if swin_drop else ""
    for kernels in selections:
        lk, sk, gk, hk = runs[kernels]
        loss_err = abs(lk - lp) / abs(lp)
        kinks, kink_note = kink_units(hk, hp)
        worst, table, worst_name = (-1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), None
        raw = (-1.0, None)
        for n, want in gp.items():
            scale = max(want.abs().max().item(), GRAD_FLOOR * top)
            diff = (gk[n] - want).abs()
            raw = max(raw, (diff.max().item() / scale, n))
            if n in kinks:
                diff = diff[..., ~kinks[n]]
            err = diff.max().item()
            if err / scale >= worst[0]:
                worst, worst_name = (err / scale, err, scale), n
            if n.endswith("relative_position_bias_table"):
                table = max(table, (err / scale, err, scale))
        print(f"vision gradient check ['{kernels}'{what}]: f32 step on "
              f"{V_CHECK_USERS} users ({cap} images), card {sk:.2f} s vs CPU "
              f"plain path {sp:.2f} s: loss {lk:.6f} vs {lp:.6f}, rel err "
              f"{loss_err:.3e} (tol {V_STEP_LOSS_TOL:g}); largest gradient "
              f"error {worst[1]:.3e} on a scale of {worst[2]:.3e} in "
              f"{worst_name} (tol {V_STEP_GRAD_TOL:g} of the scale; largest "
              f"gradient {top:.3e}) over {len(gp)} parameters [{card}]",
              flush=True)
        print(f"vision gradient check ['{kernels}'{what}]: {kink_note}; with "
              f"their columns the largest error is {raw[0]:.3e} of the scale "
              f"in {raw[1]}", flush=True)
        print(f"vision gradient check ['{kernels}'{what}]: "
              f"relative_position_bias_table gradients (12 tables): largest "
              f"error {table[1]:.3e} on a scale of {table[2]:.3e}",
              flush=True)
        require(math.isfinite(loss_err) and loss_err <= V_STEP_LOSS_TOL,
                "vision train-step loss disagrees with the plain path")
        require(worst[0] <= V_STEP_GRAD_TOL,
                f"gradient of {worst_name} disagrees with the plain path")
    if swin_drop:
        check_dropout_launches(launched, 1, "the float32 train step")
        return
    for n in VISION_WINDOWS_TRAIN_KERNELS:
        require(launched[n] > 0, f"{n} never launched by the 'windows' "
                f"float32 train step")


@contextlib.contextmanager
def relu_inputs(record: list):
    """Appends to `record`, in block order, the float32 input of every
    SASRec FFN's ReLU (x @ w1 + b1, on the host) that runs inside."""
    inner = sasrec.fused_mlp_resln

    def spy(x, w1, b1, *args, **kwargs):
        with torch.no_grad():
            h = x.float().reshape(-1, w1.shape[0]) @ w1.float() + b1.float()
        record.append(h.cpu())
        return inner(x, w1, b1, *args, **kwargs)

    sasrec.fused_mlp_resln = spy
    try:
        yield
    finally:
        sasrec.fused_mlp_resln = inner


def kink_units(card: list, plain: list) -> tuple:
    """The SASRec ReLU units at the kink (see V_KINK): {name of a w_1 weight
    or bias: bool mask over its output units}, and a line that says how
    many there are."""
    require(len(card) == len(plain) == BLOCKS,
            f"{len(card)} and {len(plain)} SASRec FFNs recorded, not {BLOCKS}")
    kinks, notes = {}, []
    for i, (hk, hp) in enumerate(zip(card, plain)):
        margin = V_KINK * (hk - hp).abs().max().item()
        units = (hp.abs() <= margin).any(0)
        flips = ((hk > 0) != (hp > 0)).sum().item()
        require(units.float().mean().item() <= V_KINK_SHARE,
                f"SASRec block {i}: {int(units.sum())} of {units.numel()} "
                f"ReLU units within {margin:.2e} of the kink")
        for p in ("weight", "bias"):
            kinks[f"user_encoder.block_{i}.w_1.{p}"] = units
        notes.append(f"block {i}: {int(units.sum())} of {units.numel()} "
                     f"within {margin:.2e} ({flips} pre-activations of "
                     f"opposite signs)")
    return kinks, ("SASRec ReLU units left out at the kink: "
                   + "; ".join(notes))


def check_dropout_launches(launched: dict, steps: int, what: str) -> None:
    """`steps` vision train steps with Swin's dropouts launched each kernel
    of VISION_DROPOUT_STEP that many times a step, and no kernel of the
    two selections' pairs."""
    for n, per_step in VISION_DROPOUT_STEP.items():
        require(launched[n] == per_step * steps,
                f"{what}: {n} launched {launched[n]} times in {steps} "
                f"steps, not {per_step} a step")
    for n in VISION_DROPOUT_SKIPS:
        require(launched[n] == 0, f"{what}: {n} launched {launched[n]} "
                f"times")


def vision_dropout_train_path(dev, card: str, pool: np.ndarray) -> dict:
    """The bf16 vision train step with Swin's hidden and attention-
    probability dropout at V_SWIN_DROP (and DropPath, dropout as phase 11)
    on the Zipf batches with dedup: at encoder_chunk 0, V_DROP_FIXED steps
    on one batch (the loss must fall) then V_DROP_TIMED timed steps; then
    V_DROP_CHUNKED steps at encoder_chunk cap // 3. Every step at
    encoder_chunk 0 launches fused_mha 14 times forward and 14 backward (12
    Swin blocks through the dbias edition, SASRec's 2 through the plain
    backward) and no kernel of the two selections' pairs. Returns the launch
    counts of the encoder_chunk 0 run."""
    rng = np.random.default_rng(SEED + 10)
    zipf = vision_batches(rng, V_TIMED_STEPS + 1, True)
    most = max(len(np.unique(ids)) for ids, _ in zipf)
    cap = -(-most // V_CAP_QUANTUM) * V_CAP_QUANTUM
    launched = vision_train_run(dev, card, pool, zipf, cap, 0, V_DROP_FIXED,
                                V_DROP_TIMED, "zipf, dedup, Swin dropouts",
                                swin_drop=V_SWIN_DROP)
    print(f"vision dropout training launches {launched}", flush=True)
    check_dropout_launches(launched, V_DROP_FIXED + V_DROP_TIMED,
                           "the vision dropout train step")
    torch.cuda.empty_cache()
    vision_train_run(dev, card, pool, zipf, cap, cap // 3, 1,
                     V_DROP_CHUNKED - 1, "zipf, dedup, chunked, Swin dropouts",
                     swin_drop=V_SWIN_DROP)
    torch.cuda.empty_cache()
    return launched


def profile_vision_train(dev, card: str) -> None:
    """The vision train step (Zipf ids, dedup, encoder_chunk 0) by device
    kernel, without and with Swin's dropouts: PROFILE_STEPS steps on
    distinct batches after as many warm-up steps."""
    rng = np.random.default_rng(SEED + 10)
    pool = image_pool(dev).cpu().numpy()
    batches = vision_batches(rng, 2 * PROFILE_STEPS, True)
    most = max(len(np.unique(ids)) for ids, _ in batches)
    cap = -(-most // V_CAP_QUANTUM) * V_CAP_QUANTUM
    for swin_drop in (0.0, V_SWIN_DROP):
        _, state, step = vision_train_setup(dev, vision_train_config(cap, 0),
                                            swin_drop=swin_drop)
        run = lambda part: [step(state, vision_device_batch(
            ids, lm, cap, pool, dev)).item() for ids, lm in part]
        run(batches[:PROFILE_STEPS])
        profiled(lambda: run(batches[PROFILE_STEPS:]), PROFILE_STEPS,
                 f"vision train step B={V_TRAIN_B} Swin-T bf16, DropPath "
                 f"0.1, dropout {DROP}, Swin dropouts {swin_drop}, dedup cap "
                 f"{cap}, encoder_chunk 0, {PROFILE_STEPS} steps", "step",
                 card)
        del state, step
        torch.cuda.empty_cache()


def vision_config() -> SimpleNamespace:
    """The vision flagship with the JAX Config's field names."""
    return SimpleNamespace(item_tower="modal", user_tower="sasrec",
                           stage="end2end", embedding_dim=V_D,
                           num_attention_heads=USER_HEADS,
                           transformer_block=BLOCKS, max_seq_len=V_L,
                           drop_rate=DROP)


def build_vision_model(dev, item_num: int, kernels: str = "band",
                       compute_dtype=torch.bfloat16, swin_drop: float = 0.0):
    """Swin-T at full width and depth under the classifier to V_D, and
    SASRec at V_D; weights from the seed. `swin_drop` sets Swin's hidden
    and attention-probability dropout."""
    scfg = SwinConfig(hidden_dropout_prob=swin_drop,
                      attention_probs_dropout_prob=swin_drop)
    tower = VisionTower(SwinModel(scfg, kernels=kernels, device=dev), "swin",
                        V_D, scfg.num_features, compute_dtype=compute_dtype,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    return make_model(vision_config(), item_num, tower, device=dev,
                      generator=gen)


def image_pool(dev) -> torch.Tensor:
    """POOL uint8 images on the card, as bench.py draws its pool."""
    gen = torch.Generator(device=dev).manual_seed(7)
    return torch.randint(0, 256, (POOL, IMAGE, IMAGE, 3), generator=gen,
                         device=dev, dtype=torch.uint8)


def pool_content(pool):
    """content_fn of the catalog: item i shows image i % POOL."""
    return lambda ids: pool[torch.from_numpy(ids % POOL).to(pool.device)]


def timed_encode(model, item_num, content_fn, chunk=None) -> tuple:
    """(table, seconds) of a catalog encode in chunks of V_CHUNK images."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, item_num, None, V_D,
                                     batch_size=chunk or V_CHUNK,
                                     content_fn=content_fn)
    torch.cuda.synchronize()
    return table, time.perf_counter() - t0


def vision_serve_path(dev, card: str) -> tuple:
    """Launch counts of the vision main path (encode and recommend) and of
    the 'windows' sub-catalog encode after it."""
    rng = np.random.default_rng(SEED + 8)
    pool = image_pool(dev)
    content_fn = pool_content(pool)
    model = build_vision_model(dev, V_ITEMS_FULL)

    # a probe decides the catalog: one warm-up chunk, then V_PROBE_CHUNKS
    n_probe = V_PROBE_CHUNKS * V_CHUNK
    timed_encode(model, V_CHUNK - 1, content_fn)
    _, probe_s = timed_encode(model, n_probe - 1, content_fn)
    full_s = probe_s / n_probe * (V_ITEMS_FULL + 1)
    item_num = (V_ITEMS_FULL if full_s <= V_ENCODE_LIMIT_S else V_ITEMS_CUT)
    print(f"vision probe: {n_probe} images in {probe_s:.3f} s, so "
          f"{V_ITEMS_FULL + 1} items would take {full_s:.1f} s against the "
          f"{V_ENCODE_LIMIT_S:.0f} s allowed: encoding {item_num + 1} items, "
          f"every row through the tower", flush=True)
    requests = {B: vision_histories(rng, B, item_num)
                for B in REQUEST_BATCHES}
    sub_hist = vision_histories(rng, 64, V_SUB_ITEMS - 1)

    reset_counts()
    table, encode_s = timed_encode(model, item_num, content_fn)
    after_encode = counts()
    retriever = Retriever(model, table, max_seq_len=V_L,
                          batch_sizes=REQUEST_BATCHES)
    results = {B: retriever.recommend(h, top_k=TOP_K)
               for B, h in requests.items()}
    after_recommend = counts()
    # the other kernel selection, float32, through the same entry point
    windows = build_vision_model(dev, V_SUB_ITEMS - 1, "windows", None)
    windows.load_state_dict(model.state_dict())
    table_w, _ = timed_encode(windows, V_SUB_ITEMS - 1, content_fn,
                              V_SUB_ITEMS)
    final = counts()

    print(f"vision launches after encode {after_encode}, after recommend "
          f"{after_recommend}, after the 'windows' sub-catalog {final}",
          flush=True)
    for n in VISION_ENCODE_KERNELS:
        require(after_encode[n] > 0, f"{n} never launched in the encode")
    for n in VISION_RECOMMEND_KERNELS:
        require(after_recommend[n] > after_encode[n],
                f"{n} never launched in recommend")
    for n in VISION_WINDOWS_KERNELS:
        require(final[n] > 0, f"{n} never launched by the 'windows' "
                f"selection")
    require(tuple(table.shape) == (item_num + 1, V_D), f"table {table.shape}")
    require(bool(torch.isfinite(table).all()), "table not finite")
    with torch.no_grad():
        zero = model.encoder(torch.zeros(1, IMAGE, IMAGE, 3, device=dev))
    pad_err = (table[0] - zero[0].float()).abs().max().item()
    shown_err = (table[0] - table[POOL]).abs().max().item()
    print(f"row 0 against the tower's output for a zero image: max_abs_err "
          f"{pad_err:.3e} (tol {V_PAD_TOL:g}); against item {POOL}, which "
          f"shows the same pool image: {shown_err:.3e}", flush=True)
    require(pad_err <= V_PAD_TOL, "row 0 is not the zero image's embedding")
    require(shown_err > V_PAD_TOL, "row 0 went through as its pool image")
    for B, (ids, vals) in results.items():
        require(ids.shape == (B, TOP_K), f"B={B}: ids {ids.shape}")
        require(np.isfinite(vals).all(), f"B={B}: scores not finite")
        require((np.diff(vals, axis=1) <= 0).all(), f"B={B}: not sorted")
        check_results(ids, requests[B], V_L)

    p50 = {}
    for B, h in requests.items():
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            retriever.recommend(h, top_k=TOP_K)   # returns host arrays
            walls.append((time.perf_counter() - t0) * 1e3)
        p50[B] = statistics.median(walls[5:])
    print(f"vision catalog encode: {item_num + 1} images (Swin-T, bf16, "
          f"chunks of {V_CHUNK}) in {encode_s:.3f} s, "
          f"{(item_num + 1) / encode_s:.1f} images/s [{card}]", flush=True)
    for B, ms in p50.items():
        print(f"vision recommend B={B} top_k={TOP_K} L={V_L} D={V_D}: p50 "
              f"{ms:.3f} ms over 20 requests [{card}]", flush=True)

    vision_sub_catalog_check(dev, model, content_fn, table_w, sub_hist)
    return after_recommend, {n: final[n] - after_recommend[n] for n in final}


def vision_sub_catalog_check(dev, model, content_fn, table_w, hist) -> None:
    """The first V_SUB_ITEMS items in float32: the band selection on the
    card against the 'windows' selection's table and against the plain
    path (the same model and wrappers on the CPU)."""
    n = V_SUB_ITEMS - 1
    f32 = copy.deepcopy(model)
    f32.encoder.compute_dtype = None
    table_k, _ = timed_encode(f32, n, content_fn, V_SUB_ITEMS)
    sel_err = (table_k - table_w).abs().max().item()
    serve = lambda m, t: Retriever(m, t, max_seq_len=V_L,
                                   batch_sizes=(64,)).recommend(hist, TOP_K)
    ids_k, vals_k = serve(f32, table_k)
    cpu_model = f32.cpu()
    t0 = time.perf_counter()
    table_p = Retriever.encode_catalog(
        cpu_model, n, None, V_D, batch_size=64,
        content_fn=lambda ids: content_fn(ids).cpu())
    ids_p, vals_p = serve(cpu_model, table_p)
    cpu_s = time.perf_counter() - t0
    table_err = (table_k.cpu() - table_p).abs().max().item()
    scale = np.maximum(1.0, np.abs(vals_p))
    score_err = float((np.abs(vals_k - vals_p) / scale).max())
    mismatch = np.argwhere(ids_k != ids_p)
    print(f"vision sub-catalog {V_SUB_ITEMS} items, f32: 'band' against "
          f"'windows' table max_abs_err {sel_err:.3e} (tol "
          f"{V_SELECTION_TOL:g}); against the CPU plain path table "
          f"max_abs_err {table_err:.3e} (tol {V_TABLE_TOL:g}), score rel "
          f"err {score_err:.3e} (tol {V_SCORE_TOL:g}), {len(mismatch)} of "
          f"{ids_k.size} ids differ; the plain path took {cpu_s:.1f} s",
          flush=True)
    require(sel_err <= V_SELECTION_TOL, "the kernel selections disagree")
    require(table_err <= V_TABLE_TOL, "vision sub-catalog table disagrees")
    require(score_err <= V_SCORE_TOL, "vision sub-catalog scores disagree")
    check_ties(mismatch, vals_p, scale, V_SCORE_TOL)
    check_results(ids_k, hist, V_L)


def ce_inputs(gen, rng, case, dt, dev) -> tuple:
    """fused_ce's operands for one CE case: W ranks' batches drawn as
    bench.py draws them (Zipf or uniform ids, the 90 % log mask), random
    log popularity per item, embeddings from the seeded card generator
    (logits of a few units); the rows are rank `rank`'s users."""
    _, B, Lc, Dc, W, rank, zipf = case
    S = Lc + 1
    ids = (np.minimum(rng.zipf(ZIPF_A, size=(W * B, S)), ITEM_NUM) if zipf
           else rng.integers(1, ITEM_NUM + 1, size=(W * B, S)))
    lm = bench_log_mask(rng, W * B, Lc)
    pop = rng.uniform(0.01, 1.0, ITEM_NUM + 1)
    pop[0] = 1.0
    sd = 2.0 * Dc ** -0.25
    u = torch.randn(B, Lc, Dc, generator=gen, device=dev) * sd
    cand = torch.randn(W * B, S, Dc, generator=gen, device=dev) * sd
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    own = slice(rank * B, (rank + 1) * B)
    colmask = np.concatenate([lm, np.ones((W * B, 1), np.float32)], axis=1)
    return (u.to(dt), cand.to(dt), t(ids[own]), t(lm[own]), t(ids),
            t(colmask), t(np.log(pop).astype(np.float32)[ids]),
            rank * B * S)


def peak_gib(fn) -> float:
    """Device memory ``fn()`` takes at its peak above what was allocated
    before it, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def ce_case(results, card, case, dt, args, reps) -> None:
    """One CE case: loss and gradients of the kernels against autograd of
    the plain version, then the forward and backward times of both."""
    what, B, Lc, Dc, W, rank, _ = case
    u, cand, rest = args[0], args[1], args[2:]
    M, N = B * Lc, cand.shape[0] * cand.shape[1]
    lk, lp = _leaves([u, cand]), _leaves([u, cand])
    out_k, out_p = fused_ce(*lk, *rest), inbatch_ce_candidates(*lp, *rest)
    got = torch.autograd.grad(out_k, lk, retain_graph=True)
    want = torch.autograd.grad(out_p, lp, retain_graph=True)
    torch.cuda.synchronize()
    loss_abs = abs(out_k.item() - out_p.item())
    loss_err = loss_abs / abs(out_p.item())
    worst = (0.0, 0.0, 1.0)
    for a, b in zip(got, want):
        require(a.shape == b.shape and a.dtype == b.dtype == dt,
                f"{what}: gradient {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        require(math.isfinite(err) and scale > 0, f"{what}: gradients")
        worst = max(worst, (err / scale, err, scale))
    ms = cuda_ms(lambda: fused_ce(u, cand, *rest), reps)
    plain_ms = cuda_ms(lambda: inbatch_ce_candidates(u, cand, *rest), reps)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_k, lk,
                                                 retain_graph=True), reps)
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(out_p, lp,
                                                    retain_graph=True), reps)
    it, id_elems = size_of(dt), rest[0].numel()
    work, work_bwd = (ce_work(M, N, Dc, it, id_elems),
                      ce_bwd_work(M, N, Dc, it, id_elems))
    label = (f"{what} M={M} N={N} D={Dc} W={W} label_off={rest[-1]} "
             f"{tag_of(dt)}")
    print(f"kernel fused_inbatch_ce [{label}]: loss {out_k.item():.6f} vs "
          f"plain {out_p.item():.6f}, rel err {loss_err:.3e} (tol "
          f"{CE_LOSS_TOL[dt]:g}); gradients max_abs_err {worst[1]:.3e} on a "
          f"scale of {worst[2]:.3e} (tol {CE_GRAD_TOL[dt]:g} of the scale); "
          f"forward {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_of(work, dt)[0]:.4f} ms by {bound_of(work, dt)[1]}; "
          f"backward {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
          f"{bound_of(work_bwd, dt)[0]:.4f} ms by {bound_of(work_bwd, dt)[1]}"
          f" [{card}]", flush=True)
    require(loss_err <= CE_LOSS_TOL[dt], f"{label}: loss disagrees")
    require(worst[0] <= CE_GRAD_TOL[dt], f"{label}: gradients disagree")
    _record(results, "fused_inbatch_ce", loss_abs, ms, plain_ms, work, dt)
    _record(results, "fused_inbatch_ce_bwd", worst[1], bwd_ms, bwd_plain,
            work_bwd, dt)


def ce_grads(fn, args) -> tuple:
    """du and dcand of the CE ``fn`` on fused_ce's operands ``args``."""
    leaves = _leaves(args[:2])
    return torch.autograd.grad(fn(*leaves, *args[2:]), leaves)


def ce_kernel_phase(dev, card: str) -> dict:
    """The in-batch CE kernels at the text, IDRec and vision steps' shapes
    and the gathered text step's, in float32 and bfloat16; then the wide
    gathered IDRec case with the peak device memory of a forward and
    backward through the kernels and through the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    results = {}
    for case in CE_CASES + (CE_WIDE,):
        for dt in (torch.float32, torch.bfloat16):
            args = ce_inputs(gen, rng, case, dt, dev)
            ce_case(results, card, case, dt, args,
                    FEW_REPS if case is CE_WIDE else KERNEL_REPS)
            if case is CE_WIDE:
                peaks = [peak_gib(lambda fn=fn: ce_grads(fn, args))
                         for fn in (fused_ce, inbatch_ce_candidates)]
                print(f"wide case {CE_WIDE[0]} W={CE_WIDE[4]} "
                      f"{tag_of(dt)}: peak device memory of a forward and "
                      f"backward above its inputs: kernels {peaks[0]:.3f} "
                      f"GiB, plain version {peaks[1]:.3f} GiB [{card}]",
                      flush=True)
            del args
    return results


def timed_steps(step, state, first, batches, to_device) -> tuple:
    """(losses, walls): PALLAS_WARM_STEPS steps on the device batch
    ``first``, then one timed step on each host batch, packed and copied to
    the device inside its timed step."""
    losses = [step(state, first).item() for _ in range(PALLAS_WARM_STEPS)]
    walls = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, to_device(*b)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    return losses, walls


def idrec_config(pallas: bool) -> SimpleNamespace:
    """bench.py GEOM["idrec"]: the ID table of ITEM_NUM + 1 rows at D under
    SASRec, lr 1e-4, bf16 compute, dropout 0.1."""
    return SimpleNamespace(item_tower="id", user_tower="sasrec",
                           stage="end2end", embedding_dim=D,
                           num_attention_heads=USER_HEADS,
                           transformer_block=BLOCKS, max_seq_len=L,
                           drop_rate=DROP, loss="inbatch_ce",
                           compute_dtype="bfloat16", lr=LR, l2_weight=0.0,
                           fine_tune_lr=FT_LR, fine_tune_l2_weight=0.0,
                           use_pallas=pallas)


def idrec_run(dev, card, batches, pallas: bool) -> tuple:
    """The IDRec step with use_pallas off or on: (first loss, p50 ms)."""
    cfg = idrec_config(pallas)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    model = make_model(cfg, ITEM_NUM, device=dev, generator=gen)
    state = make_train_state(model, cfg, seed=SEED)
    step = make_train_step(cfg, log_pop=log_popularity(dev))
    t = lambda a: torch.from_numpy(a).to(dev)
    to_device = lambda ids, lm: {"ids": t(ids), "log_mask": t(lm)}
    losses, walls = timed_steps(step, state, to_device(*batches[0]),
                                batches[1:], to_device)
    p50 = statistics.median(walls)
    print(f"IDRec train step B={IDREC_B} L={L} D={D} bf16, {ITEM_NUM + 1} "
          f"rows, use_pallas {pallas}: first loss {losses[0]:.6f}, p50 "
          f"{p50:.3f} ms over {len(walls)} distinct batches (min "
          f"{min(walls):.3f}, max {max(walls):.3f}), "
          f"{IDREC_B / p50 * 1e3:.1f} samples/s [{card}]", flush=True)
    return losses[0], p50


def pallas_train_path(dev, card: str, content, batches, cap: int,
                      composition: tuple, pool: np.ndarray) -> dict:
    """The use_pallas train steps: the text flagship on the training
    phase's batches and dedup cap (its first loss and step p50 beside the
    composition's, `composition`), the IDRec step with use_pallas off and
    on, two vision Zipf steps; every step launches the CE kernels once
    forward and once backward. Returns the launch counts."""
    reset_counts()
    cfg = train_config(cap)
    cfg.use_pallas = True
    model = build_model(dev, cfg, seed=SEED + 3)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg, item_content=content,
                           log_pop=log_popularity(dev))
    losses, walls = timed_steps(
        step, state, device_batch(*batches[0], cap, dev),
        batches[1:TIMED_STEPS + 1], lambda i, m: device_batch(i, m, cap, dev))
    p50 = statistics.median(walls)
    first_err = abs(losses[0] - composition[0]) / abs(composition[0])
    print(f"train step B={TRAIN_B} L={L} bf16, dropout {DROP}, dedup cap "
          f"{cap}, use_pallas: p50 {p50:.3f} ms over {len(walls)} distinct "
          f"batches (min {min(walls):.3f}, max {max(walls):.3f}), "
          f"{TRAIN_B / p50 * 1e3:.1f} samples/s; the composition's p50 "
          f"{composition[1]:.3f} ms; first loss {losses[0]:.6f} vs the "
          f"composition's {composition[0]:.6f} (rel err {first_err:.3e}, "
          f"tol {CE_LOSS_TOL[torch.bfloat16]:g}) [{card}]", flush=True)
    require(first_err <= CE_LOSS_TOL[torch.bfloat16],
            "the use_pallas step's first loss disagrees")
    n_steps = len(losses)
    text_gemm = counts()["gemm"]
    print(f"gemm launches a use_pallas text train step: "
          f"{text_gemm / n_steps:g}", flush=True)
    require(text_gemm == TEXT_GEMM_STEP * n_steps,
            f"gemm launched {text_gemm} times in {n_steps} use_pallas text "
            f"steps, not {TEXT_GEMM_STEP} a step")
    del model, state, step
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 13)
    ids_b = [(rng.integers(1, ITEM_NUM + 1, size=(IDREC_B, L + 1)),
              bench_log_mask(rng, IDREC_B)) for _ in range(TIMED_STEPS + 1)]
    off = idrec_run(dev, card, ids_b, False)
    on = idrec_run(dev, card, ids_b, True)
    idrec_err = abs(on[0] - off[0]) / abs(off[0])
    print(f"IDRec use_pallas: p50 {on[1]:.3f} ms against {off[1]:.3f} ms "
          f"without; first loss rel err {idrec_err:.3e}", flush=True)
    require(idrec_err <= CE_LOSS_TOL[torch.bfloat16],
            "the IDRec use_pallas step's first loss disagrees")
    idrec_steps = 2 * (PALLAS_WARM_STEPS + len(ids_b) - 1)
    print(f"gemm launches an IDRec train step: "
          f"{(counts()['gemm'] - text_gemm) / idrec_steps:g}", flush=True)
    n_steps += PALLAS_WARM_STEPS + TIMED_STEPS
    torch.cuda.empty_cache()

    launched = counts()     # vision_train_run counts from 0 again
    zipf = vision_batches(np.random.default_rng(SEED + 10),
                          V_TIMED_STEPS + 1, True)
    most = max(len(np.unique(ids)) for ids, _ in zipf)
    v_cap = -(-most // V_CAP_QUANTUM) * V_CAP_QUANTUM
    vision = vision_train_run(dev, card, pool, zipf, v_cap, 0, 1, 1,
                              "zipf, dedup, use_pallas", pallas=True)
    n_steps += 2
    torch.cuda.empty_cache()
    launched = {n: launched[n] + vision[n] for n in launched}
    print(f"use_pallas training launches {launched} over {n_steps} steps",
          flush=True)
    for n in PALLAS_KERNELS:
        require(launched[n] == n_steps,
                f"{n} launched {launched[n]} times in {n_steps} steps")
    return launched


def dp_path(dev, card: str, content, batches, cap: int) -> dict:
    """The data-parallel step at world size 1: NCCL through a FileStore in
    a temporary directory; DP_STEPS gather_negatives + use_pallas text
    steps, whose losses must equal the single-process use_pallas steps' on
    the same batches, weights and seeds. Returns the launch counts of the
    data-parallel steps."""
    cfg = train_config(cap)
    cfg.use_pallas = cfg.gather_negatives = True
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("single", "data-parallel"):
            if run == "data-parallel":
                mesh.init_distributed(0, 1, store=torch.distributed.FileStore(
                    os.path.join(tmp, "store"), 1))
                reset_counts()
            model = build_model(dev, cfg, seed=SEED + 3)
            state = make_train_state(model, cfg, param_labels(model),
                                     seed=SEED)
            step = make_train_step(cfg, item_content=content,
                                   log_pop=log_popularity(dev))
            runs[run] = [step(state, device_batch(*b, cap, dev)).item()
                         for b in batches[1:DP_STEPS + 1]]
            del model, state, step
        launched = counts()
        torch.distributed.destroy_process_group()
    err = max(abs(a - b) / abs(b)
              for a, b in zip(runs["data-parallel"], runs["single"]))
    print(f"data-parallel: NCCL at world size 1, {DP_STEPS} gather_negatives "
          f"+ use_pallas steps: losses {runs['data-parallel']} against the "
          f"single process's {runs['single']}, rel err {err:.3e} (tol "
          f"{DP_LOSS_TOL:g}); launches {launched} [{card}]", flush=True)
    require(err <= DP_LOSS_TOL, "the data-parallel losses disagree")
    for n in PALLAS_KERNELS:
        require(launched[n] == DP_STEPS, f"{n} launched {launched[n]} times "
                f"in {DP_STEPS} data-parallel steps")
    return launched


def merge(kernels: dict, more: dict) -> None:
    """Adds a phase's per-kernel results: a kernel seen before keeps its
    headline times and takes the worse error."""
    for name, r in more.items():
        if name in kernels:
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               r["max_abs_err"])
        else:
            kernels[name] = r


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the train step, the vision "
                             "catalog encode and recommend and the vision "
                             "train step by device kernel (torch.profiler), "
                             "after the card and build phases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on the "
              "GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    card = card_info()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    path = lib.library_path()
    lib.library()
    print(f"phase build: {path.name} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    content = torch.from_numpy(
        catalog(np.random.default_rng(SEED + 1), ITEM_NUM)).to(dev)
    batches = train_batches(np.random.default_rng(SEED + 4),
                            TIMED_STEPS + 1)
    cap = dedup_cap(batches)
    if args.profile:
        profile_train(dev, card, content, batches, cap)
        profile_vision_encode(dev, card)
        profile_vision_recommend(dev, card)
        profile_vision_train(dev, card)
        return 0

    with phase("kernels"):
        kernels = kernel_phase(dev, card, kernel_cases(
            np.random.default_rng(SEED), dev))
    with phase("backward kernels"):
        kernels.update(backward_phase(dev, card, cap))
    with phase("ce kernels"):
        kernels.update(ce_kernel_phase(dev, card))
    torch.cuda.empty_cache()
    with phase("serving"):
        served = serve_path(dev, card, content)
    with phase("training"):
        model, trained, composition = train_path(dev, card, content, batches,
                                                 cap)
    with phase("gradient check"):
        grad_check(dev, model, content, batches[0])
    del model
    torch.cuda.empty_cache()
    with phase("vision kernels"):
        vision = kernel_phase(dev, card, vision_kernel_cases(dev),
                              reps=FEW_REPS)
    merge(kernels, vision)
    torch.cuda.empty_cache()
    with phase("vision serving"):
        seen, windows = vision_serve_path(dev, card)
    torch.cuda.empty_cache()
    pool = image_pool(dev).cpu().numpy()
    with phase("vision backward kernels"):
        torch.cuda.reset_peak_memory_stats()
        merge(kernels, gradient_cases(
            vision_backward_cases(dev, V_BWD_IMAGES), card, reps=VB_REPS))
        print(f"vision backward kernels: {V_BWD_IMAGES} images a case (a "
              f"Zipf batch's dedup capacity), peak device memory with the "
              f"plain versions' autograd "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        torch.cuda.empty_cache()
        merge(kernels, gemm_phase(dev, card, V_BWD_IMAGES, cap))
    torch.cuda.empty_cache()
    with phase("dbias kernels"):
        merge(kernels, dbias_phase(dev, card, V_BWD_IMAGES))
    torch.cuda.empty_cache()
    with phase("vision training"):
        vtrained, vwindows = vision_train_path(dev, card, pool)
    with phase("vision gradient check"):
        vision_grad_check(dev, card, pool)
    torch.cuda.empty_cache()
    with phase("vision dropout training"):
        vdropped = vision_dropout_train_path(dev, card, pool)
    with phase("vision dropout gradient check"):
        vision_grad_check(dev, card, pool, V_SWIN_DROP)
    torch.cuda.empty_cache()
    with phase("pallas training"):
        pallas = pallas_train_path(dev, card, content, batches, cap,
                                   composition, pool)
        model = build_model(dev, train_config(cap), seed=SEED + 3)
        grad_check(dev, model, content, batches[0], pallas=True)
        del model
    torch.cuda.empty_cache()
    with phase("data-parallel"):
        parallel = dp_path(dev, card, content, batches, cap)

    # launches: every main path's count, each taken from 0; the nine keys
    # after it say which path launched how many
    paths = {"launches_serve": served, "launches_train": trained,
             "launches_vision": seen, "launches_windows": windows,
             "launches_vision_train": vtrained,
             "launches_windows_train": vwindows,
             "launches_vision_dropout": vdropped,
             "launches_pallas_train": pallas, "launches_dp": parallel}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": CSRC + SOURCES[n][0],
         "replaces": PALLAS + SOURCES[n][1],
         "launches": sum(c[n] for c in paths.values()),
         **{k: c[n] for k, c in paths.items()},
         **kernels[n], **({"bodies": sorted(WRAPPERS[n].bodies)}
            if hasattr(WRAPPERS[n], "bodies") else {})}
        for n in WRAPPERS]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
