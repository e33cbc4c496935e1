"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the flagship widths with random weights
drawn from a seeded generator, through the kernels built from
idvs/morec_tpu_torch/csrc by nvcc on first use: end2end text MoRec
(BERT-small item tower, SASRec user tower, a 100_001-item catalog), serving
(catalog encode, recommend) and training (the bf16 train step with
dropout); end2end vision MoRec (Swin-T item tower at full width and
depth, SASRec at D = 2048), serving and training; the use_pallas train
step (the in-batch CE kernels) of text MoRec, IDRec and vision MoRec; the
data-parallel step with gather_negatives; BCE with sampled negatives and
the DSSM two-tower (text MoRec, a 600_001-user table); the two-stage
cached-embedding towers and ID+modality fusion (text and vision); the
other vision encoders (ResNet-50 with its BatchNorm, ViT-MAE-B/16,
BEiT-B/16, CLIP-B/32) under SASRec; the text encoder zoo (OPT-125M and
DeBERTa-base item towers); pretrained vision checkpoints and a variants/
launcher file run through grid_launch. Phases, each fatal on failure:

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
   with a mask that needs no gradient (the library column); then both
   post-LN tails' backward on both routes of resln_bwd_plan (the fused
   wgmma kernels of resln_bwd_wg.cu and the products route) at the text
   step's BERT and SASRec shapes and IDRec's, bf16, dropout 0 and 0.1,
   each against autograd of the plain version, with event and device
   time, bound, plain and torch.matmul of the same products
   (tail_bwd_routes; the kernels line takes the fused route's row at the
   BERT shape); fused_mha's float32 backward must have run on its
   tensor-core body (BWD_BODIES: mha_bwd_tf32_kernel, 3xTF32), as in
   phases 10, 16 and 22;
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
   every training-edition and backward kernel launched, gemm 18 times a
   step, the tails' backward through their fused kernels and none of the
   products route's row kernels (the wrappers' bodies), every parameter
   finite (phases 11, 14 and 17 print gemm's
   launches a step too);
7. gradient check: one float32 step without dropout on 8 users, on the card
   and through the plain path on a CPU copy of the model: the loss and
   every parameter's gradient agree, the columns of SASRec's ReLU units
   whose pre-activation sits within 10x the two paths' difference of 0
   left out (at most 1 % of a block's units), as phase 12 does, and so
   every float32 gradient check of a model with SASRec (phases 14, 20-25);
8. vision kernels: the windowed attention (band layout with one bias and
   with a bias per window, window layout) and the pre-LN MLP (with and
   without its LayerNorm, with the residual, unit and scaled) against their
   plain versions at each Swin-T stage's shapes for one encode chunk
   (beside the yardstick: the same products through torch.matmul,
   bench_swin's, in the row's dtype; the float32 rows with one bias or the
   unit residual also with device time beside the yardstick's, their
   bounds at 3xTF32's rate), and the post-LN tails and the attention at SASRec's D =
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
   seconds, recommend p50 per batch. Every float32 part of the vision
   phases (both sub-catalogs, the gradient checks of phases 12 and 18, the
   two-stage sub-cache of phase 22) and the text zoo's float32 encodes
   must have run the window attention and the pre-LN MLP through their
   float32 bodies on the tensor cores and no other (F32_FWD_BODIES:
   win_attn_tf32_kernel, premlp_tf32_kernel, 3xTF32), read from the
   wrappers' bodies;
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
    through torch.matmul; the float32 windowed attention's and SASRec's
    backward through mha_bwd_tf32_kernel); then the pre-LN MLP's backward
    at each Swin-T stage through the route premlp_bwd_plan picks
    (premlp_bwd_mma_kernel at stages 0-2, premlp_bwd_wg_kernel at stage 3)
    and through the products route, both routes' times (CUDA events and
    device time) and their gradients against each other, and at stage 3 the wg kernel alone
    (premlp_bwd_gdh) against its plain version, with its bound; then
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
    path launched, the residual MLP's backward through
    premlp_bwd_mma_kernel and, at stage 3, premlp_bwd_wg_kernel;
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
    the float32 cases through mha_bwd_tf32_kernel;
17. vision dropout training (run after phase 12): the counters set to 0,
    the bf16 train step of phase 11 with Swin's hidden and attention-
    probability dropout at 0.1: 4 steps on one batch (the loss must fall),
    6 timed steps, then 2 steps at encoder_chunk 96; every step at
    encoder_chunk 0 launched fused_mha 14 times forward and backward (12
    Swin blocks through the dbias edition), fused_mlp in every Swin block,
    and no kernel of the two selections' pairs;
18. vision dropout gradient check: phase 12's float32 step with Swin's
    dropouts at 0.1, on the card and on the CPU plain path;
19. runner (last): the training and evaluation loop (train/runner.py) in
    a temporary directory, the counters set to 0 before each part: IDRec
    through the CLI (run.main; 20_000 users drawn as the quickstart draws
    them over 100_000 items in groups of 100, bench.py GEOM["idrec"]'s D
    512, L 20, B 256, 5 epochs, saving on a better valid HR@10, then
    --mode test on the best epoch-N.pt), which must beat the untrained
    model's valid HR@10; text MoRec at the flagship width through Trainer
    (BERT-small from its config, 8_000 users over the 100_000 items,
    B 128, bf16, dedup, use_pallas; one epoch, the full-catalog eval, the
    save, a fresh Trainer in test mode); vision MoRec through Trainer
    (Swin-T from the CLI's load_encoder, SASRec at D 2048, an MKV store of
    512 images written by the phase, read through the native transform;
    2 epochs, dedup cap 576 in chunks of 96, the eval, the save, a fresh
    Trainer in test mode, whose eval is repeated under the "windows"
    kernel selection); then each of the three again with BCE (--loss bce)
    and with DSSM (--loss bce --user_tower dssm --neg_num 1 --dnn_layers
    0), the reference launchers' flags: IDRec through the CLI for 5 epochs
    each, text for one epoch, vision for one (DSSM: 96 users a step, two
    chunks of 96 images, no dedup); every reloaded checkpoint's valid
    evaluation must equal the in-memory one of its epoch in every bit,
    and every kernel of each part's training and evaluation must have
    launched (IDRec's DSSM has no kernel on its path: no SASRec, no
    encoder). Then three parts of ROADMAP A4, each printing its HR@10 and
    nDCG@10 beside the untrained model's: text two-stage through
    Trainer(cfg, encoder_bundle=..., tokenizer=...) (train_bert_lyr_8's
    flags, the frozen BERT-small caching the 100_000 titles, one epoch, a
    test-mode reload that caches anew), vision two-stage through the CLI
    (hm_swin_tiny_lyr_8's flags over the MKV store, 2 epochs, --mode
    test), and text MoRec with the CAT fusion tower (BCE, one epoch).
    It prints train samples/s, eval users/s, catalog encode
    items/s, checkpoint bytes and save/load seconds, HR@10 and nDCG@10 and
    the launches in training and in evaluation of each part;
20. bce (run after phase 7): BCE with sampled negatives on the text
    flagship, bf16 with dropout: the training phase's batches with one
    negative at each valid transition's slot (BCETrainBatcher's rule),
    the positives and negatives deduplicated together under a cap taken
    from the batches; the counters set to 0, 10 steps on one batch (the
    loss must fall), 10 timed steps (p50, samples/s, peak memory, each
    text-step kernel's launches a step, every one launched), then the
    float32 gradient check of phase 7 on 8 users' BCE batch;
21. dssm: the DSSM two-tower of variants/bce_text/main-end2end(DSSM)
    (B 128, D 512, neg_num 1, dnn_layers 0) over BERT-small and a user
    table of 600_001 x 512: the counters set to 0, 10 steps on one batch
    (the loss must fall), 10 timed steps (p50, samples/s, peak memory,
    launches a step, every BERT kernel of the text step launched); the
    float32 gradient check at dnn_layers 0 and 2; the catalog encoded
    (float32) and recommend_users at B = 1 and 64 (p50), its ids and
    scores against a float32 plain scoring of the same table on the CPU;
22. two_stage (after phase 21): the two-stage towers of
    variants/bce_*/main-2stage(SASRec) and id_plus_mo-2stage. Text: the
    counters set to 0, the runner's catalog cache (Trainer._encode_catalog)
    through a frozen BERT at BERT-base's published geometry (12 layers,
    C 768, 12 heads, F 3072; random weights) over the 100_001 titles in
    float32 (seconds, items/s, its launches: the tails at C = 768), 256
    rows against the CPU plain path; then train_bert_lyr_8's bf16 step
    (BCE, B 128, D 512, dnn_layers 8, l2 0.01; the head and SASRec in
    float32 on the bf16 copies, as JAX runs it): the counters set to 0, 10
    steps on one batch (the loss must fall), 10 timed steps (p50,
    samples/s, peak memory, launches a step, every SASRec training kernel
    launched), the float32 gradient check on 8 users, the trained head's
    catalog encode and recommend at B = 1 and 64 (p50), 256 rows of the
    table and every request's ids and scores against the CPU plain path;
    then train_bert_cat's first grid point (cat, mo_dnn_layers 4,
    dnn_layers 2, B 64) on the same cache, 10 + 5 steps and its gradient
    check. Vision: the Swin-T cache (bf16) of 16_385 items drawn from the
    image pool, as wide as the tower's output (ROADMAP C9), a float32
    sub-cache of 16 images against the CPU plain path; then
    hm_swin_tiny_lyr_8's step (B 64, dnn_layers 8) and
    train_swin_tiny_add_m8's (add, mo_dnn_layers 8, dnn_layers 2), 5 + 5
    and 5 + 3 steps, with the same checks; the phase's float32 SASRec
    backward ran on mha_bwd_tf32_kernel (fused_mha_bwd's bodies, from
    none);
23. fusion: id_plus_mo-end2end's towers. Phase 20's BCE text step with
    modal_id_add and with modal_id_cat (an ID table beside BERT-small:
    p50, peak memory, launches with scatter_add_rows, the float32 gradient
    check), then train_swin_tiny_add.py's vision step at B 16 (Swin-T bf16
    beside an ID table, SASRec D 512): 3 steps on one batch, every vision
    step kernel launched, and a float32 gradient check on 2 users;
24. accumulation (after phase 7): the text flagship's bf16 step with
    accumulation_step 2, one warm window, then the counters set to 0 and
    four micro-steps on the training phase's batches: the parameters keep their bits after
    micro-steps 1 and 3, and after 2 and 4 are the bits torch.optim.AdamW
    makes on the card from the window's mean gradient; the micro-steps'
    times; then a float32 window of two micro-steps (4 users each) against
    the CPU plain path (the mean gradient, phase 7's rule);
25. special (after phase 19): cold and new-item evaluation of the runner's
    trained text and vision MoRec (its in-batch CE parts' checkpoints, at
    the flagship widths), the counters set to 0: text through
    Trainer.test() (256 cold users, 256 new users whose targets are 64 new
    titles in TEXT/news.tsv that no behaviour holds), vision through the
    CLI (--mode test; 96 and 96 users, 16 new images in a second MKV store,
    --new_image_store); every kernel of each evaluation launched inside
    it; cold and new users/s and the new-item encode's items/s; then the
    same evaluation in float32 on the card and on a CPU copy through the
    plain versions (the card's table, 8 of its vision rows re-encoded on
    the CPU): the new items' embeddings within TABLE_TOL / V_TABLE_TOL,
    HR@10 as hit counts within two users;
26. resnet (after phase 25): ResNet-50 MoRec as the three
    train_resnet50.py launchers configure it (224 x 224 images, D 512,
    the Config's SASRec, bf16, dropout 0.1, lr 1e-4, l2 0.01), the
    counters set to 0: a catalog encode of 2 048 images (images/s),
    recommend p50 at B = 1 and 64, the train step at 16 users on Zipf ids
    with dedup (p50, samples/s, images/s, peak memory; every running
    average moved and finite) and the reckoning of the launchers' 64 users
    from its memory an image; then the three launchers through the CLI
    (in-batch CE and BCE at 16 users a step, DSSM at 64) on the runner's
    MKV store, one epoch and a --mode test reload each (the reload's valid
    evaluation bit-equal, every SASRec kernel launched); last a float32
    step on 2 users against a CPU copy: the loss and the 106 running
    averages within 1e-5, the head's and SASRec's gradients as phase 12
    holds them, the body's reported (Z_BODY);
27. vit: ViT-MAE-B/16, BEiT-B/16 and CLIP-B/32 at their default widths
    under the same SASRec, the counters set to 0: each one's catalog
    encode (images/s) and bf16 train steps at 16 users; every launch of
    fused_mlp, fused_mlp_res, the MLP backward and the wg route; then
    their MLP kernels against the plain versions at each one's shapes
    (the encode chunk's fused_mlp_res, BEiT's fused_mlp, the training
    forward with save_h and its backward; gelu and quick_gelu), beside
    the two products through torch.matmul, with rows 5-6's tolerances;
    last CLIP's float32 step against a CPU copy (quick_gelu's backward);
28. text_zoo (after 27): the text encoder zoo, OPT-125M and DeBERTa-base at
    their published geometries (a directory holding each one's
    config.json alone, read by runner.load_encoder; weights drawn from the
    seed) under the flagship's SASRec: rows 5-6 at the towers' editions
    (OPT's encode chunk through fused_mlp_res unit ReLU, the training FFN
    through fused_mlp with save_h, OPT's with its LayerNorm and ReLU,
    DeBERTa's without, GELU; C 768, F 3072, bf16 and float32) and their
    backward against the plain versions (a ReLU's plain version takes the
    kernel's branch at the kink, premlp_at_kink), the backward's wg route
    against its products route, scatter_add_rows into the 50 272-row
    table; the counters set to 0 before each path: OPT-125M's float32
    catalog encode (100 001 items if a probe says 30 s suffice, else
    16 385) and recommend at B = 1, 8, 64, a 2 048-item sub-catalog
    against a CPU copy; its bf16 train step on the training phase's
    batches (20 steps on one, 10 timed) and a float32 step on 4 users
    against a CPU copy whose ReLU FFNs take the card's branch where their
    own h lies within rounding of 0 (opt_ffn_branches); DeBERTa-base's
    encode of 16 385 items, 10 train steps and its float32 check. The
    float32 rows' bounds are at 3xTF32's rate. Its rows join the kernels
    line under their edition's name ("fused_mlp (opt train)"), each with
    its path's launches;
29. vision_ckpt (last): pretrained vision checkpoints and the reference's
    launcher, the counters set to 0: a Swin-T drawn from the seed written
    in HF's layout (the published config.json of
    microsoft/swin-tiny-patch4-window7-224, pytorch_model.bin by
    torch.save) and a ResNet-50 as a torchvision .pth (running averages,
    num_batches_tracked and a 1000-class fc), read back through
    runner.load_encoder to the drawn tensors bit for bit; the tower
    loaded from the directory encodes a chunk of 512 images of 224 x 224
    (bf16, rows 6-7) to the bits of the tower it came from; then
    grid_launch runs variants/inbatch_sasrec_e2e_vision/train_swin_tiny.py
    (read_variant, never imported) through the port's CLI with the runner
    phase's generated data, the checkpoint directory, one epoch, 8 users a
    step and freeze_paras_before 100: the 100 frozen parameters keep the
    checkpoint's bits, every other one of the encoder moves, and every
    kernel of the vision step and evaluation launched.

Prints each phase's seconds and a JSON line of per-kernel results (launches
on the main paths, in all and by path: text serving, training, BCE and
DSSM training, the two-stage caches (2E), the two-stage text and vision
steps (2T, 2V), the fusion text and vision steps (FT, FV), vision
serving, the "windows" sub-catalog, vision
training, the "windows" train step, the vision dropout step, the
use_pallas steps, the data-parallel steps, the runner, the accumulated
micro-steps, the cold and new-item evaluations, the ResNet-50 and the ViT
paths, OPT-125M's serving and training, DeBERTa-base's encode and
training, the vision checkpoints and launcher phase; error
and time against the plain version, the least time the card could take for
the same work (float32 rows that launched gemm.cu, whose products run as
3xTF32, and the vision and ViT phases' and the text zoo's float32 rows,
at that rate, 165 TFLOP/s), the time of the one PyTorch call that
computes the same function where there is one, and for the tails and
gemm the device kernels their launches in this run took, "bodies", as
their plans name them), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero, with no result, when no GPU
is visible.

    python3 chip_smoke.py --profile

runs only the card and build phases and a torch.profiler split by device
kernel of the train step, of the vision catalog encode, of the vision
recommend at batches of 1 and 64 and of the vision train step without and
with Swin's dropouts (wall and device-busy ms, each kernel's share,
fused_mha's kernels and the pre-LN MLP backward's even outside the top
rows, gemm.cu's sum and colsum_kernel's), and prints no result line;
--profile text the text train step alone, --profile vision the vision
train step alone, --profile bce_dssm the BCE and DSSM train steps of
phases 20 and 21 alone, --profile two_stage phase 22's two-stage text
step and a chunk of its BERT-base cache alone.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from idvs.morec_tpu_torch import quickstart, run
from idvs.morec_tpu_torch.convert import to_checkpoint
from idvs.morec_tpu_torch.launcher import grid_launch, read_variant
from idvs.morec_tpu_torch.config import Config, parse_args
from idvs.morec_tpu_torch.data.imagestore import write_mkv
from idvs.morec_tpu_torch.data.loader import sample_negatives
from idvs.morec_tpu_torch.bench_gemm import f32_product_cases, product_cases
from idvs.morec_tpu_torch.bench_swin import (CORE, attention_products,
                                             device_ms, mlp_products)
from idvs.morec_tpu_torch.bench_swin import mlp_bwd_work as premlp_bwd_work
from idvs.morec_tpu_torch.bench_tail import (bwd_yardstick, proj_products,
                                             tail_products)
from idvs.morec_tpu_torch.measure import bound_of, cuda_ms
from idvs.morec_tpu_torch.models.bert import BertConfig, BertModel
from idvs.morec_tpu_torch.models import opt as opt_mod
from idvs.morec_tpu_torch.models import sasrec
from idvs.morec_tpu_torch.models.layers import init_parameters
from idvs.morec_tpu_torch.models.resnet import ResNet, resnet_param_order
from idvs.morec_tpu_torch.models.model import make_model
from idvs.morec_tpu_torch.models.swin import (SwinBlock, SwinConfig,
                                              SwinModel, _shift_mask,
                                              swin_param_order)
from idvs.morec_tpu_torch.models.text_tower import TextTower
from idvs.morec_tpu_torch.models.vision_tower import (VisionTower,
                                                      build_vision_tower)
from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.attention import (
    BWD_BODIES, FWD_BODIES, dbias_chunks, fused_mha, fused_mha_bwd,
    fused_mha_bwd_dbias,
    fused_mha_plain, fused_mha_proj, fused_mha_proj_band,
    fused_mha_proj_band_bwd, fused_mha_proj_band_plain, fused_mha_proj_bwd,
    fused_mha_proj_plain, sum_partials, WIN_BODIES, window_partition)
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import (
    scatter_add_rows, scatter_add_rows_plain)
from idvs.morec_tpu_torch.ops.cuda.gemm import (BODIES as GEMM_BODIES, gemm,
                                                gemm_plain)
from idvs.morec_tpu_torch.ops.cuda.inbatch_ce import (fused_ce,
                                                      fused_inbatch_ce,
                                                      fused_inbatch_ce_bwd)
from idvs.morec_tpu_torch.ops.cuda.mlp import (PRE_BODIES, fused_mlp,
                                               fused_mlp_bwd,
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
                                               premlp_bwd_gdh,
                                               premlp_bwd_gdh_plain,
                                               premlp_bwd_h,
                                               premlp_bwd_plan,
                                               premlp_kink_census,
                                               PREMLP_BWD_ROUTES,
                                               RESLN_BWD_ROUTES, relu_kink,
                                               resln_bwd_plan)
from idvs.morec_tpu_torch.ops import dropout
from idvs.morec_tpu_torch.ops.losses import inbatch_ce_candidates
from idvs.morec_tpu_torch.ops.masking import causal_additive_mask
from idvs.morec_tpu_torch.parallel import mesh
from idvs.morec_tpu_torch.serve import Retriever
from idvs.morec_tpu_torch.train import runner, special_eval
from idvs.morec_tpu_torch.train.evaluate import eval_mode
from idvs.morec_tpu_torch.train.state import (make_optimizer,
                                              make_train_state, param_labels)
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
# gradient accumulation: the text step's accumulation_step, and its
# micro-steps on the card (two windows)
ACC_STEPS, ACC_MICRO = 2, 4
PROFILE_STEPS, PROFILE_ROWS = 5, 12   # --profile: steps traced, rows shown
# --profile: kernels shown even outside the top rows: fused_mha's, and the
# pre-LN MLP backward's on its three routes (premlp_bwd.cu,
# premlp_bwd_wg.cu, gemm.cu's A pre-pass, the column sums)
PROFILE_WATCH = ("::mha_", "premlp_bwd_mma_kernel", "premlp_bwd_wg_kernel",
                 "group_sums_kernel",
                 "::act_cast_kernel", "::colsum_kernel", "::ln_rows_kernel",
                 "ln_bwd_rows_kernel", "ln_colsums_kernel")
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
# BCE with sampled negatives (text MoRec): steps on one batch before the
# timed steps on the train batches
BCE_FIXED = 10
# DSSM text MoRec (variants/bce_text/main-end2end(DSSM)/train_bert_base.py:
# B 128, D 512, neg_num 1, dnn_layers 0, l2_weight and fine_tune_l2_weight
# 0.01; MIND-large's 60w users, mind_60w_users.tsv): steps on one batch,
# request batches of recommend_users
DSSM_USERS, DSSM_NEG, DSSM_FIXED, DSSM_L2 = 600_000, 1, 10, 0.01
DSSM_REQUESTS = (1, 64)
# ID+modality fusion and the two-stage towers (ROADMAP A4).
# variants/bce_text/main-2stage(SASRec)/train_bert_lyr_8.py: BCE, B 128, D
# 512, dnn_layers 8, L 20, drop 0.1, lr 1e-4, l2_weight 0.01, bf16; its
# frozen tower at BERT-base's published geometry (BertConfig's defaults:
# 12 layers, hidden 768, 12 heads, F 3072) caches the catalog in float32.
# Steps on one batch, timed steps, cache rows held on the CPU plain path.
TS_DNN, TS_L2 = 8, 0.01
TS_FIXED, TS_TIMED, TS_CHECK_ROWS = 10, 10, 256
# id_plus_mo-2stage/train_bert_cat.py's first grid point on the same cache
TS_CAT = dict(item_tower="modal_id_cat", mo_dnn_layers=4, dnn_layers=2,
              batch_size=64)
TS_CAT_TIMED = 5
# bce_vision/main-2stage(SASRec)/hm_swin_tiny_lyr_8.py (D 512, B 64,
# dnn_layers 8, L 20) and id_plus_mo-2stage/train_swin_tiny_add_m8.py (add,
# mo_dnn_layers 8, dnn_layers 2): a Swin-T cache (bf16, as the vision
# encode runs) over the vision serving phase's cut catalog, fewer steps;
# images of the float32 sub-cache held on the CPU plain path
TV_ITEMS = V_ITEMS_CUT
TV_FIXED, TV_TIMED, TV_CHECK_ROWS = 5, 5, 16
TV_ADD = dict(item_tower="modal_id_add", mo_dnn_layers=8, dnn_layers=2)
# bce_vision/id_plus_mo-end2end/train_swin_tiny_add.py (D 512, L 20, lr and
# fine_tune_lr 1e-4, both l2 0.01, bf16) cut to B 16: steps on one batch
FV_B, FV_STEPS = 16, 3
# the float32 cache against the CPU plain path: twelve BERT layers at C =
# 768 (3xTF32 against the CPU's float32 sums, about 1e-5 a layer) on the
# final LayerNorm's O(1) outputs
TS_CACHE_TOL = 1e-3
# the two-stage steps' kernels: SASRec's training editions (in float32:
# the BCE branch hands SASRec the head's float32 embeddings, as JAX does)
TS_TRAIN_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_proj_resln_res",
                    "fused_proj_resln_bwd", "fused_mlp_resln_res",
                    "fused_mlp_resln_bwd", "gemm")
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
# The other encoders' float32 step, card vs CPU: the loss (relative) and
# the BatchNorm running averages after it (0.1 of float32 batch statistics
# over the step's images, sums of up to 6.7 M values in other orders,
# relative to max(1, |value|)) within the CPU parity tests' 1e-5; the
# gradients as the vision check holds them. Through ResNet-50's 53
# BatchNorms cuDNN's float32 convolutions and the CPU's differ at
# SASRec's input about 13 times as much as through CLIP (6.4e-5 against
# 4.9e-6 at its FFN's pre-activations on an H100), so V_KINK
# times that covers about 3 % of the units over the check's 40 rows: the
# ResNet check leaves out up to Z_KINK_SHARE of them.
Z_LOSS_TOL = Z_STATS_TOL = 1e-5
Z_KINK_SHARE = 5e-2
# Z_BODY: the ResNet body's gradients (its convolutions and BatchNorms; the
# fc head and SASRec are held) are printed, not held: the float32 backward
# of a drawn ResNet-50 through batch statistics is ill-conditioned, the
# CPU's own float32 gradients of this step lie up to 19 % (median 2.6 %)
# of a tensor's scale from the CPU's float64 ones in layer4 (the same
# step run both ways on the CPU), where the loss and the running averages
# agree to 2e-7 and 3e-6. The CPU parity tests hold the body's gradients
# against JAX's in float64.
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
# recommend_users against the plain scoring on the CPU: the same float32
# user vectors and table, each score a 512-term float32 sum in another
# order (about 1e-7 of the row's largest score); ids may swap only inside
# such a tie
DSSM_SCORE_TOL = 1e-5

CSRC, PALLAS = "idvs/morec_tpu_torch/csrc/", "idvs/morec_tpu/ops/pallas/"
SOURCES = {
    "fused_mha": ("fused_mha.cu", "attention.py:143"),
    "fused_mha_bwd": ("fused_mha.cu", "attention.py:179"),
    "fused_mha_bwd_dbias": ("fused_mha.cu", "attention.py:179"),
    "fused_proj_resln": ("proj_resln.cu", "mlp.py:715"),
    "fused_proj_resln_res": ("proj_resln.cu", "mlp.py:709"),
    "fused_proj_resln_bwd": ("resln_bwd_wg.cu", "mlp.py:723"),
    "fused_mlp_resln": ("mlp_resln.cu", "mlp.py:432"),
    "fused_mlp_resln_res": ("mlp_resln.cu", "mlp.py:424"),
    "fused_mlp_resln_bwd": ("resln_bwd_wg.cu", "mlp.py:444"),
    "scatter_add_rows": ("embed_scatter.cu", "embed_scatter.py:66"),
    "fused_mha_proj_band": ("win_attn.cu", "attention.py:860"),
    "fused_mha_proj": ("win_attn.cu", "attention.py:530"),
    "fused_mlp_res": ("premlp.cu", "mlp.py:105"),
    "fused_mlp": ("premlp.cu", "mlp.py:105"),
    "fused_mha_proj_band_bwd": ("win_attn_bwd.cu", "attention.py:873"),
    "fused_mha_proj_bwd": ("win_attn_bwd.cu", "attention.py:597"),
    "fused_mlp_res_bwd": ("premlp_bwd.cu", "mlp.py:134"),
    "fused_mlp_bwd": ("premlp_bwd.cu", "mlp.py:134"),
    "premlp_bwd_gdh": ("premlp_bwd_wg.cu", "mlp.py:134"),
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
            "premlp_bwd_gdh": premlp_bwd_gdh,
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
# the float32 forward bodies on the tensor cores (3xTF32) that the float32
# text-zoo encode, the float32 vision sub-catalogs and sub-cache and the
# float32 vision gradient checks must launch, by wrapper
F32_FWD_BODIES = {"fused_mlp": PRE_BODIES[torch.float32],
                  "fused_mlp_res": PRE_BODIES[torch.float32],
                  "fused_mha_proj": WIN_BODIES[torch.float32],
                  "fused_mha_proj_band": WIN_BODIES[torch.float32]}
# float32 kernel rows printed with device time beside the library call's
# or the yardstick's (the serving paths' float32 kernels), and those of
# YARD_DEVICE_ROWS that carry a yardstick (the Swin-T stage rows with one
# bias or the unit residual, OPT's encode chunk: torch.matmul of the same
# products in float32 with TF32 off)
DEVICE_ROWS = ("fused_mha", "fused_mlp_resln")
YARD_DEVICE_ROWS = ("fused_mha_proj_band", "fused_mlp_res")
TRAIN_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_proj_resln_res",
                 "fused_proj_resln_bwd", "fused_mlp_resln_res",
                 "fused_mlp_resln_bwd", "scatter_add_rows", "gemm")
VISION_ENCODE_KERNELS = ("fused_mha_proj_band", "fused_mlp_res")
VISION_RECOMMEND_KERNELS = ("fused_mha", "fused_proj_resln",
                            "fused_mlp_resln", "gemm")
VISION_WINDOWS_KERNELS = ("fused_mha_proj", "fused_mlp")
VISION_TRAIN_KERNELS = ("fused_mha_proj_band", "fused_mha_proj_band_bwd",
                        "fused_mlp_res", "fused_mlp_res_bwd",
                        "premlp_bwd_gdh", "fused_mha",
                        "fused_mha_bwd", "fused_proj_resln_res",
                        "fused_proj_resln_bwd", "fused_mlp_resln_res",
                        "fused_mlp_resln_bwd", "gemm")
VISION_WINDOWS_TRAIN_KERNELS = ("fused_mha_proj", "fused_mha_proj_bwd",
                                "fused_mlp", "fused_mlp_bwd", "gemm")
PALLAS_KERNELS = ("fused_inbatch_ce", "fused_inbatch_ce_bwd")
# backward rows whose attention core's device time phase 10 prints
WINDOW_BWD = ("fused_mha_proj_band_bwd", "fused_mha_proj_bwd")
# gemm launches a text train step: BERT's 4 and SASRec's 2 layers, each a
# projection tail's backward (dW on the fused route) and an FFN tail's
# (dW1 and dW2)
TEXT_GEMM_STEP = 18
# the products route's row kernels, which the text step's tails no longer
# launch
TAIL_ROW_KERNELS = ("ln_bwd_rows_kernel", "act_cast_kernel", "colsum_kernel")
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


def require_bwd_body(names, what: str) -> None:
    """Fails unless each wrapper of `names` launched the float32 backward
    body on the tensor cores (BWD_BODIES) in `what`; prints their bodies."""
    for n in names:
        seen = sorted(WRAPPERS[n].bodies)
        print(f"{what}: {n} bodies {seen}", flush=True)
        require(BWD_BODIES[torch.float32] in seen,
                f"{what}: {n} launched no {BWD_BODIES[torch.float32]}")


def clear_f32_bodies() -> None:
    """Empties the bodies of the wrappers of F32_FWD_BODIES, before a
    float32 part whose kernels require_f32_bodies then checks."""
    for n in F32_FWD_BODIES:
        WRAPPERS[n].bodies = set()


def require_f32_bodies(names, what: str) -> None:
    """Fails unless each wrapper of `names` launched its float32 body on
    the tensor cores (F32_FWD_BODIES) in `what`, and no other; prints
    their bodies."""
    for n in names:
        seen = sorted(WRAPPERS[n].bodies)
        print(f"{what}: {n} bodies {seen}", flush=True)
        require(seen == [F32_FWD_BODIES[n]],
                f"{what}: {n} launched {seen}, not {F32_FWD_BODIES[n]}")


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


def kernel_phase(dev, card: str, cases, reps: int = KERNEL_REPS,
                 f32_tf32x3: bool = False) -> dict:
    """Holds each case's kernel against its plain version and times both
    (and the library call, where there is one). A case may carry an eighth
    element, a factory of the yardstick: a function running the same
    products through torch.matmul, timed and printed beside the kernel
    (never a library column: no one call computes the function). The
    float32 rows of DEVICE_ROWS (and of YARD_DEVICE_ROWS with a yardstick)
    also print device time (the
    profiler's sum over the call's kernels) beside the library call's or
    the yardstick's, and the share of the bound that device time reaches:
    at a request's shapes the event time is mostly the host's.
    f32_tf32x3: every float32 case's bound at 3xTF32's rate, the card's
    float32 products on the tensor cores (gemm.cu's), whatever body the
    kernel runs; else only where the call launched gemm.cu (gemm_ran)."""
    results = {}
    for name, label, dt, run_kernel, run_plain, work, library, *more in cases:
        got, tf32x3 = gemm_ran(run_kernel, dt)
        tf32x3 = tf32x3 or (f32_tf32x3 and dt == torch.float32)
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
        if dt == torch.float32 and (name in DEVICE_ROWS or (
                name in YARD_DEVICE_ROWS and products is not None)):
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
    if not ms or math.isnan(ms):
        return "; device time not recorded by the profiler"
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


def tail_bwd_routes(dev, card: str, titles: int) -> dict:
    """The post-LN tails' backward on both routes of resln_bwd_plan at the
    text step's BERT (`titles` titles of TITLE_LEN) and SASRec (TRAIN_B
    users of L) shapes and IDRec's SASRec (IDREC_B users), bf16, dropout 0
    and DROP: each route's call alone (RESLN_BWD_ROUTES: the fused kernel
    and gemm.cu's weight products, or the row pass and gemm.cu's
    products) on the saved tensors of the kernels' training forward, held
    against autograd of the plain version at GRAD_TOL, with CUDA-event and
    device time, the bound of the backward's work, the plain version's
    backward and the yardstick torch.matmul of the same products (event
    and device time). Returns the fused route's records at the BERT
    shape, dropout DROP, for the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device=dev) * scale
    bf, code, C = torch.bfloat16, lib.DTYPE_CODES[torch.bfloat16], HIDDEN
    records = {}
    for who, M, act, eps in (("BERT", titles * TITLE_LEN, "gelu", 1e-12),
                             ("SASRec", TRAIN_B * L, "relu", 1e-6),
                             ("IDRec", IDREC_B * L, "relu", 1e-6)):
        for p in (0.0, DROP):
            seed = 1000 + int(p * 10)
            drop = dropout.kernel_args(p, seed if p else None)
            for tail in ("mlp", "proj"):
                name = f"fused_{tail}_resln_bwd"
                x, dout = g(M, C).to(bf), g(M, C).to(bf)
                ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
                if tail == "mlp":
                    ops = [g(C, FFN, scale=C ** -0.5), g(FFN, scale=0.1),
                           g(FFN, C, scale=FFN ** -0.5), g(C, scale=0.1)]
                    plain = lambda *a: fused_mlp_resln_plain(
                        *a[:5], ln=a[5:], eps=eps, act=act, drop_rate=p,
                        seed=seed)
                    w = [t.to(bf).contiguous() for t in ops]
                    _, ypre, h = fused_mlp_resln_res(
                        x, *w, *ln, eps=eps, act=act, drop=drop, code=code)
                    args = (x, w[0], w[2], ln[0], ypre, h, dout, eps, act,
                            drop, code)
                    work, F = mlp_bwd_work(M, C, FFN, 2), FFN
                else:
                    ops = [g(M, C).to(bf), g(C, C, scale=C ** -0.5),
                           g(C, scale=0.1)]
                    plain = lambda *a: fused_proj_resln_plain(
                        *a[:4], ln=a[4:], eps=eps, drop_rate=p, seed=seed)
                    w = ops[1].to(bf).contiguous()
                    _, ypre = fused_proj_resln_res(
                        x, ops[0], w, ops[2].to(bf), *ln, eps=eps, drop=drop,
                        code=code)
                    args = (x, w, ln[0], ypre, dout, eps, drop, code)
                    work, F = proj_bwd_work(M, C, 2), None
                lp = _leaves([x, *ops, *ln])
                out_p = plain(*lp)
                want = torch.autograd.grad(out_p, lp, dout, retain_graph=True)
                plain_ms = cuda_ms(lambda: torch.autograd.grad(
                    out_p, lp, dout, retain_graph=True), reps=FEW_REPS)
                yard = bwd_yardstick(M, C, F, bf, g)
                yard_ms = (cuda_ms(yard, reps=FEW_REPS),
                           device_ms(yard, FEW_REPS)[0])
                del yard
                bound_ms, bound_by = bound_of(work, bf)
                where = (f"{who} M={M} C={C}" + (f" F={FFN} {act}" if F
                                                 else "") + f" bf16 drop={p}")
                plan = resln_bwd_plan(tail, C, M, bf)
                times = {}
                for route, fn in RESLN_BWD_ROUTES[tail].items():
                    got = fn(*args)
                    torch.cuda.synchronize()
                    worst = _worst_err([a.to(b.dtype) for a, b in
                                        zip(got, want)], want,
                                       f"{name} {route} {where}")
                    del got
                    times[route] = (cuda_ms(lambda: fn(*args), reps=FEW_REPS),
                                    device_ms(lambda: fn(*args),
                                              FEW_REPS)[0], worst)
                    require(worst[0] <= GRAD_TOL[bf], f"{name} {route} "
                            f"{where}: error {worst[1]} above "
                            f"{GRAD_TOL[bf]} x {worst[2]}")
                print(f"tail backward routes {name} [{where}]: the plan "
                      f"takes {plan['route']}; " + ", ".join(
                          f"{r} {ms:.4f} ms ({dms:.4f} ms device, "
                          f"max_abs_err {wst[1]:.3e} on a scale of "
                          f"{wst[2]:.3g})"
                          for r, (ms, dms, wst) in times.items())
                      + f"; bound {bound_ms:.4f} ms by {bound_by}, plain "
                      f"{plain_ms:.4f} ms, torch.matmul of the same "
                      f"products {yard_ms[0]:.4f} ms ({yard_ms[1]:.4f} ms "
                      f"device) [{card}]", flush=True)
                require(plan["route"] == "fused", f"{name} {where}: the plan "
                        f"takes {plan['route']}")
                if who == "BERT" and p == DROP:
                    records[name] = dict(
                        max_abs_err=max(t[2][1] for t in times.values()),
                        ms=times["fused"][0], plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None)
                del lp, out_p, want, args, ypre, x, dout
                torch.cuda.empty_cache()
    return records


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
    torch.cuda.empty_cache()
    for name, record in tail_bwd_routes(dev, card, titles).items():
        # the bf16 text step's route is the headline; the worst error of
        # every case stays
        record["max_abs_err"] = max(record["max_abs_err"],
                                    results[name]["max_abs_err"])
        results[name] = record
    torch.cuda.empty_cache()
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


def model_config(**train) -> Config:
    """The flagship configuration; the train step's fields (and another
    user tower's) as keyword arguments."""
    return Config(**{**dict(item_tower="modal", user_tower="sasrec",
                            stage="end2end", embedding_dim=D,
                            num_attention_heads=USER_HEADS,
                            transformer_block=BLOCKS, max_seq_len=L,
                            drop_rate=DROP), **train})


def build_model(dev, cfg, seed: int = SEED, user_num: int = 0):
    bcfg = BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                      num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                      intermediate_size=FFN, max_position_embeddings=512,
                      hidden_dropout_prob=cfg.drop_rate,
                      attention_probs_dropout_prob=cfg.drop_rate)
    encoder = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                        word_embedding_dim=HIDDEN, pooling="cls",
                        attr_lengths=(TITLE_LEN,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_model(cfg, ITEM_NUM, encoder, user_num=user_num, device=dev,
                      generator=gen)


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


def train_setup(dev, content, cap: int, pallas: bool = False):
    """(model, train state, step) of the flagship bf16 train step, the CE
    through its kernels when `pallas`."""
    cfg = train_config(cap)
    cfg.use_pallas = pallas
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

    tails = (fused_mlp_resln_bwd, fused_proj_resln_bwd)
    earlier = [w.bodies for w in tails]
    for w in tails:
        w.bodies = set()
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
          f"(BERT's and SASRec's post-LN tails: 1 a projection tail, 2 an "
          f"FFN tail)", flush=True)
    require(launched["gemm"] == TEXT_GEMM_STEP * steps,
            f"gemm launched {launched['gemm']} times in {steps} text steps, "
            f"not {TEXT_GEMM_STEP} a step")
    for n in TRAIN_KERNELS:
        require(launched[n] > 0, f"{n} never launched in training")
    seen = [w.bodies for w in tails]
    for w, before, now in zip(tails, earlier, seen):
        w.bodies = before | now
    print(f"the text step's tails' backward device kernels: FFN "
          f"{sorted(seen[0])}, projection {sorted(seen[1])}", flush=True)
    for tail, now in zip(("mlp", "proj"), seen):
        require(f"{tail}_resln_bwd_wg_kernel" in now,
                f"the text step's {tail} tail backward never took "
                f"{tail}_resln_bwd_wg_kernel")
        require(not set(TAIL_ROW_KERNELS) & now,
                f"the text step's {tail} tail backward launched "
                f"{sorted(set(TAIL_ROW_KERNELS) & now)}")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "a parameter is not finite after training")
    return model, launched, (losses[0], p50)


def sasrec_blocks(model) -> int:
    """The model's SASRec blocks (a DSSM user tower has none)."""
    return model.user_encoder.n_layers if model.user_tower == "sasrec" else 0


def card_and_plain(dev, model, cfg, content, batch_of,
                   log_pop: bool = True) -> list:
    """One float32 step of ``cfg`` without dropout (eval mode) on the card
    through the kernels, and on a CPU copy of the model through the plain
    versions: [(loss, seconds, gradients, launches, SASRec ReLU inputs,
    SASRec blocks)] of the card's run, then the CPU's. batch_of(device)
    builds the step's batch there, or a list of batches, one a micro-step
    of an accumulation window (``cfg.accumulation_step`` of them: the
    gradients are then the window's mean, the loss the last micro-step's);
    content None where it travels with the batch."""
    runs = []
    for where in (dev, torch.device("cpu")):
        m = copy.deepcopy(model).to(where)
        state = make_train_state(m, cfg, param_labels(m))
        m.eval()
        step = make_train_step(
            cfg, item_content=None if content is None else content.to(where),
            log_pop=log_popularity(where) if log_pop else None)
        batches = batch_of(where)
        batches = batches if isinstance(batches, list) else [batches]
        before = counts()
        relu_in = []
        t0 = time.perf_counter()
        with relu_inputs(relu_in):
            for b in batches:
                loss = step(state, b).item()
        runs.append((loss, time.perf_counter() - t0,
                     {n: p.grad.detach().cpu()
                      for n, p in m.named_parameters()},
                     {n: c - before[n] for n, c in counts().items()},
                     relu_in, sasrec_blocks(m)))
        del m, state
    return runs


def same_step(runs: list, what: str, grad_tol: float = STEP_GRAD_TOL
              ) -> None:
    """The card's loss and every gradient against the CPU plain path's,
    within STEP_LOSS_TOL and grad_tol (GRAD_FLOOR's scale); with SASRec,
    the columns of its ReLU units at the kink left out (V_KINK, as the
    vision checks do; kink_units)."""
    (lk, sk, gk, _, hk, blocks), (lp, sp, gp, _, hp, _) = runs
    loss_err = abs(lk - lp) / abs(lp)
    top = max(want.abs().max().item() for want in gp.values())
    kinks, kink_note = kink_units(hk, hp, blocks) if blocks else ({}, None)
    worst, worst_name = (-1.0, 0.0, 0.0), None
    raw = (-1.0, None)
    for n, want in gp.items():
        scale = max(want.abs().max().item(), GRAD_FLOOR * top)
        diff = (gk[n] - want).abs()
        raw = max(raw, (diff.max().item() / scale, n))
        if n in kinks:
            diff = diff[..., ~kinks[n]]
        err = diff.max().item() if diff.numel() else 0.0
        if err / scale >= worst[0]:
            worst, worst_name = (err / scale, err, scale), n
    print(f"{what}, card {sk:.2f} s vs CPU plain path {sp:.2f} s: loss "
          f"{lk:.6f} vs {lp:.6f}, rel err {loss_err:.3e} (tol "
          f"{STEP_LOSS_TOL:g}); largest gradient error {worst[1]:.3e} on a "
          f"scale of {worst[2]:.3e} in {worst_name} (tol {grad_tol:g} "
          f"of the scale; largest gradient {top:.3e}) over {len(gp)} "
          f"parameters", flush=True)
    if kink_note:
        print(f"{what}: {kink_note}; with their columns the largest error "
              f"is {raw[0]:.3e} of the scale in {raw[1]}", flush=True)
    require(math.isfinite(loss_err) and loss_err <= STEP_LOSS_TOL,
            f"{what}: the loss disagrees with the plain path")
    require(worst[0] <= grad_tol,
            f"{what}: the gradient of {worst_name} disagrees with the plain "
            f"path")


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
    runs = card_and_plain(dev, model, cfg, content,
                          lambda where: device_batch(ids, lm, cap, where))
    if pallas:
        for n in PALLAS_KERNELS:
            require(runs[0][3][n] == 1,
                    f"{n} not launched once by the use_pallas step")
    same_step(runs, f"gradient check{' [use_pallas]' if pallas else ''}: "
                    f"f32 step on {CHECK_USERS} users ({cap} titles)")


def accumulation_path(dev, card: str, content, batches, cap: int) -> dict:
    """The text flagship's bf16 train step (dropout, dedup) with
    accumulation_step ACC_STEPS: one window on batches[0] to warm up (a
    fresh model's first steps allocate), then, the counters set to 0,
    ACC_MICRO timed micro-steps on distinct batches: after a micro-step
    that ends no window every parameter keeps its bits; after one that
    ends a window every parameter is the bits torch.optim.AdamW makes on
    the card from the window's mean gradient (a twin optimizer over a copy
    of the parameters and of the optimizer's state, in step with it). Then the float32 gradient
    check of one window of two micro-steps, CHECK_USERS / 2 users each
    (the rows of phase 7's check, so as many SASRec ReLU units may sit at
    the kink), against the CPU plain path (the mean gradient; same_step's
    rule).
    Returns the launches of the bf16 micro-steps."""
    cfg = train_config(cap)
    cfg.accumulation_step = ACC_STEPS
    model = build_model(dev, cfg, seed=SEED + 3)
    labels = param_labels(model)
    state = make_train_state(model, cfg, labels, seed=SEED)
    step = make_train_step(cfg, item_content=content,
                           log_pop=log_popularity(dev))
    for _ in range(ACC_STEPS):
        step(state, device_batch(*batches[0], cap, dev))
    twin = copy.deepcopy(model)
    twin_opt = make_optimizer(cfg, twin, labels)
    # a copy: loading keeps the tensors it is given, and both step them
    twin_opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    params = dict(model.named_parameters())
    twins = dict(twin.named_parameters())
    reset_counts()
    walls, losses = [], []
    for i, (ids, lm) in enumerate(batches[1:ACC_MICRO + 1]):
        before = {n: p.detach().clone() for n, p in params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, device_batch(ids, lm, cap, dev)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
        require(math.isfinite(losses[-1]), "an accumulation loss is not "
                "finite")
        if (i + 1) % ACC_STEPS:
            moved = [n for n, p in params.items()
                     if not torch.equal(p, before[n])]
            require(not moved, f"accumulation micro-step {i + 1} moved "
                    f"{moved[:3]}")
            continue
        for n, p in twins.items():
            p.grad = params[n].grad
        twin_opt.step()
        off = [n for n, p in params.items() if not torch.equal(p, twins[n])]
        require(not off, f"accumulation micro-step {i + 1}: the update of "
                f"{off[:3]} is not AdamW's on the window's mean gradient")
    launched = counts()
    print(f"accumulation: text step B={TRAIN_B} L={L} bf16, dropout {DROP}, "
          f"dedup cap {cap}, accumulation_step {ACC_STEPS}: {ACC_MICRO} "
          f"micro-steps, ms " + ", ".join(f"{w:.3f}" for w in walls)
          + f" (mean {statistics.mean(walls):.3f}); losses "
          + ", ".join(f"{x:.5f}" for x in losses) + "; parameters the same "
          f"bits after micro-steps 1 and 3, AdamW's bits on the mean "
          f"gradient after 2 and 4 [{card}]", flush=True)
    require_launched(launched, TRAIN_KERNELS, "accumulation")
    del twin, twin_opt
    ids, lm = batches[0]
    half = CHECK_USERS // 2
    halves = [(ids[i:i + half], lm[i:i + half]) for i in (0, half)]
    ccap = -(-max(len(np.unique(h[0])) for h in halves) // 8) * 8
    ccfg = train_config(ccap, "float32")
    ccfg.accumulation_step = len(halves)
    same_step(card_and_plain(
        dev, model, ccfg, content,
        lambda where: [device_batch(i, m, ccap, where) for i, m in halves]),
        f"accumulation gradient check: f32 window of {len(halves)} "
        f"micro-steps on {half} users each ({ccap} titles)")
    return launched


def bce_batches(rng, batches) -> list:
    """(pos, neg, log_mask) host batches: the train batches' ids and masks
    with one negative at each valid transition's slot, drawn by
    BCETrainBatcher's rule (uniform over the catalog, none of the user's
    items; the last slot and the masked slots 0)."""
    out = []
    for ids, lm in batches:
        draws = sample_negatives(rng, ids, ITEM_NUM)[:, :, 0]
        neg = np.zeros_like(ids)
        neg[:, :-1] = np.where(lm != 0, draws, 0)
        out.append((ids, neg, lm))
    return out


def bce_unique(pos, neg) -> int:
    return len(np.unique(np.concatenate([pos.ravel(), neg.ravel()])))


def bce_device_batch(pos, neg, lm, cap: int, dev) -> dict:
    """A BCE host batch, its positives and negatives deduplicated together
    (one dedup_pack, as the runner packs them), on the device."""
    packed = dedup_pack(np.concatenate([pos.ravel(), neg.ravel()]), cap)
    require(packed is not None, f"a BCE batch holds more than {cap} items")
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"ids": t(pos), "neg_ids": t(neg), "log_mask": t(lm),
            "uniq_ids": t(packed[0]), "inverse": t(packed[1])}


def step_launches(launched: dict, steps: int) -> dict:
    """Launches a step of the text step's kernels (TPU rows 1-4)."""
    return {n: launched[n] / steps for n in TRAIN_KERNELS}


def bce_setup(dev, content, batches, item_tower: str = "modal") -> tuple:
    """(model, train state, step, BCE host batches, dedup cap) of the text
    flagship's bf16 BCE step on the train batches, over the item tower
    `item_tower` (ID+modality fusion: an ID table beside BERT); the cap is
    the most unique titles of a batch, rounded up to 256."""
    bb = bce_batches(np.random.default_rng(SEED + 30), batches)
    cap = -(-max(bce_unique(p, n) for p, n, _ in bb) // 256) * 256
    cfg = train_config(cap)
    cfg.loss, cfg.item_tower = "bce", item_tower
    model = build_model(dev, cfg, seed=SEED + 30)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    return (model, state, make_train_step(cfg, item_content=content), bb,
            cap)


def bce_path(dev, card: str, content, batches,
             item_tower: str = "modal") -> dict:
    """BCE with sampled negatives (text MoRec, bf16, dropout) over the item
    tower `item_tower`: BCE_FIXED steps on one batch (the loss must fall),
    then a timed step on each further batch; every kernel of the text step
    launched; then the float32 gradient check on CHECK_USERS users.
    Returns the launches."""
    model, state, step, bb, cap = bce_setup(dev, content, batches,
                                            item_tower)
    tag = "" if item_tower == "modal" else f" [{item_tower}]"
    pos_u = [len(np.unique(p)) for p, _, _ in bb]
    print(f"bce{tag}: {TRAIN_B} users a step, {int(bb[0][2].sum())} "
          f"negatives in the first batch; unique items a batch: positives "
          f"{min(pos_u)}-{max(pos_u)}, positives and negatives "
          f"{min(bce_unique(p, n) for p, n, _ in bb)}-"
          f"{max(bce_unique(p, n) for p, n, _ in bb)}; cap {cap}, BERT rows "
          f"M = {cap * TITLE_LEN} (the in-batch CE step's "
          f"{dedup_cap(batches) * TITLE_LEN})", flush=True)
    fixed = bce_device_batch(*bb[0], cap, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(state, fixed).item() for _ in range(BCE_FIXED)]
    walls = []
    for b in bb[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, bce_device_batch(*b, cap, dev)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    steps = BCE_FIXED + len(walls)
    p50 = statistics.median(walls)
    print(f"bce{tag} train step B={TRAIN_B} L={L} bf16, dropout {DROP}, "
          f"dedup cap {cap}: loss on one batch {losses[0]:.5f} -> "
          f"{losses[BCE_FIXED - 1]:.5f}; p50 {p50:.3f} ms over {len(walls)} "
          f"distinct batches (min {min(walls):.3f}, max {max(walls):.3f}), "
          f"{TRAIN_B / p50 * 1e3:.1f} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"bce{tag} launches a step: {step_launches(launched, steps)}",
          flush=True)
    require(all(math.isfinite(x) for x in losses), "a BCE loss is not finite")
    require(losses[BCE_FIXED - 1] < losses[0],
            "the BCE loss did not fall on a fixed batch")
    require_launched(launched, TRAIN_KERNELS, f"bce{tag} training")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "a parameter is not finite after BCE training")
    pos, neg, lm = (a[:CHECK_USERS] for a in bb[0])
    ccap = -(-bce_unique(pos, neg) // 8) * 8
    ccfg = train_config(ccap, "float32")
    ccfg.loss, ccfg.item_tower = "bce", item_tower
    same_step(card_and_plain(
        dev, model, ccfg, content,
        lambda where: bce_device_batch(pos, neg, lm, ccap, where),
        log_pop=False),
        f"bce{tag} gradient check: f32 step on {CHECK_USERS} users ({ccap} "
        f"titles)")
    return launched


def dssm_config(dnn_layers: int = 0, compute_dtype: str = "bfloat16"):
    """The DSSM reference launcher's configuration (variants/bce_text/
    main-end2end(DSSM)/train_bert_base.py: D 512, neg_num 1, dnn_layers 0,
    B 128, lr 1e-4 and 5e-5, weight decay 0.01 in both groups) over the
    flagship's BERT-small."""
    return model_config(user_tower="dssm", loss="bce", neg_num=DSSM_NEG,
                        dnn_layers=dnn_layers, compute_dtype=compute_dtype,
                        lr=LR, l2_weight=DSSM_L2, fine_tune_lr=FT_LR,
                        fine_tune_l2_weight=DSSM_L2)


def dssm_batches(rng, n: int, B: int = TRAIN_B) -> list:
    """(users, items, labels) host batches: uniform user ids, a Zipf(1.2)
    positive and DSSM_NEG negatives drawn by DSSMTrainBatcher's rule
    (uniform over the catalog, not the positive)."""
    out = []
    for _ in range(n):
        pos = np.minimum(rng.zipf(ZIPF_A, size=(B, 1)), ITEM_NUM)
        # the user's row: its positive, padded with 0 (one draw a slot but
        # the last)
        seq = np.concatenate([pos, np.zeros_like(pos)], axis=1)
        negs = sample_negatives(rng, seq, ITEM_NUM,
                                neg_per_pos=DSSM_NEG)[:, 0, :]
        items = np.concatenate([pos, negs], axis=1)
        labels = np.zeros(items.shape, np.float32)
        labels[:, 0] = 1.0
        out.append((rng.integers(1, DSSM_USERS + 1, size=B), items, labels))
    return out


def dssm_device_batch(users, items, labels, dev) -> dict:
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"users": t(users), "items": t(items), "labels": t(labels)}


def dssm_setup(dev, content, rng, n: int) -> tuple:
    """(model, train state, step, n host batches) of the bf16 DSSM step
    (dssm_config, a user table of DSSM_USERS rows)."""
    cfg = dssm_config()
    model = build_model(dev, cfg, seed=SEED + 40, user_num=DSSM_USERS)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    return (model, state, make_train_step(cfg, item_content=content),
            dssm_batches(rng, n))


def dssm_path(dev, card: str, content) -> dict:
    """DSSM text MoRec (BERT-small item tower, a user table of DSSM_USERS
    rows, bf16, dropout): DSSM_FIXED steps on one batch (the loss must
    fall), then TIMED_STEPS timed steps; every BERT kernel of the text step
    launched; the float32 gradient check at dnn_layers 0 and 2; the catalog
    encoded and recommend_users at B = 1 and 64 against a float32 plain
    scoring of the same table. Returns the train steps' launches."""
    rng = np.random.default_rng(SEED + 40)
    model, state, step, batches = dssm_setup(dev, content, rng,
                                             TIMED_STEPS + 1)
    table_bytes = model.user_embedding.weight.numel() * 4
    fixed = dssm_device_batch(*batches[0], dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(state, fixed).item() for _ in range(DSSM_FIXED)]
    walls = []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, dssm_device_batch(*b, dev)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    steps = DSSM_FIXED + len(walls)
    p50 = statistics.median(walls)
    print(f"dssm train step B={TRAIN_B} (1 + {DSSM_NEG} titles a user) "
          f"bf16, dropout {DROP}, user table {DSSM_USERS + 1} x {D} "
          f"({table_bytes / 2 ** 30:.2f} GiB float32, with AdamW's moments "
          f"{3 * table_bytes / 2 ** 30:.2f}): loss on one batch "
          f"{losses[0]:.5f} -> {losses[DSSM_FIXED - 1]:.5f}; p50 {p50:.3f} "
          f"ms over {len(walls)} distinct batches (min {min(walls):.3f}, max "
          f"{max(walls):.3f}), {TRAIN_B / p50 * 1e3:.1f} samples/s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB [{card}]", flush=True)
    print(f"dssm launches a step: {step_launches(launched, steps)}",
          flush=True)
    require(all(math.isfinite(x) for x in losses),
            "a DSSM loss is not finite")
    require(losses[DSSM_FIXED - 1] < losses[0],
            "the DSSM loss did not fall on a fixed batch")
    require_launched(launched, TRAIN_KERNELS, "dssm training")
    del state, step
    torch.cuda.empty_cache()

    users, items, labels = (a[:CHECK_USERS] for a in batches[0])
    for layers in (0, 2):
        m = model if layers == 0 else build_model(
            dev, dssm_config(layers), seed=SEED + 41, user_num=DSSM_USERS)
        same_step(card_and_plain(
            dev, m, dssm_config(layers, "float32"), content,
            lambda where: dssm_device_batch(users, items, labels, where),
            log_pop=False),
            f"dssm gradient check (dnn_layers {layers}): f32 step on "
            f"{CHECK_USERS} users ({CHECK_USERS * (1 + DSSM_NEG)} titles)")
        del m
    torch.cuda.empty_cache()
    recommend_users_check(dev, card, model, content, rng)
    return launched


def recommend_users_check(dev, card: str, model, content, rng) -> None:
    """The catalog through the model's item tower (float32, as served),
    then recommend_users at each of DSSM_REQUESTS: p50 over 20 requests,
    and the results against a float32 plain scoring of the same table on
    the CPU (the user tower's vectors there, scores by torch.matmul, the
    padding column at -inf, topk)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, ITEM_NUM, content, D,
                                     batch_size=ENCODE_BATCH)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    require(bool(torch.isfinite(table).all()), "DSSM table not finite")
    engine = Retriever(model, table, batch_sizes=DSSM_REQUESTS)
    towers = copy.deepcopy(
        torch.nn.ModuleDict({"e": model.user_embedding,
                             "m": model.user_mlp})).cpu().eval()
    table_c = table.cpu()
    print(f"dssm catalog encode: {ITEM_NUM + 1} items in {encode_s:.3f} s "
          f"[{card}]", flush=True)
    for B in DSSM_REQUESTS:
        users = rng.integers(1, DSSM_USERS + 1, size=B).tolist()
        ids, vals = engine.recommend_users(users, TOP_K)
        with torch.no_grad():
            uvec = towers["m"](towers["e"](torch.tensor(users)))
        scores = uvec @ table_c.T
        scores[:, 0] = -torch.inf
        vals_p, ids_p = (a.numpy() for a in torch.topk(scores, TOP_K, dim=1))
        scale = np.abs(vals_p).max(axis=1, keepdims=True)
        err = float((np.abs(vals - vals_p) / scale).max())
        mismatch = np.argwhere(ids != ids_p)
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            engine.recommend_users(users, TOP_K)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"recommend_users B={B} top_k={TOP_K}: p50 "
              f"{statistics.median(walls[5:]):.3f} ms over 20 requests; "
              f"against the plain scoring: score err {err:.3e} of the row's "
              f"largest |score| (tol {DSSM_SCORE_TOL:g}), {len(mismatch)} of "
              f"{ids.size} ids differ [{card}]", flush=True)
        require(ids.shape == (B, TOP_K) and (ids != 0).all(),
                f"recommend_users B={B}: ids {ids.shape} or the padding id")
        require(err <= DSSM_SCORE_TOL,
                f"recommend_users B={B}: scores disagree")
        check_ties(mismatch, vals_p, np.broadcast_to(scale, vals_p.shape),
                   DSSM_SCORE_TOL)


def add_counts(*launched) -> dict:
    return {n: sum(c[n] for c in launched) for n in WRAPPERS}


def smoke_log() -> logging.Logger:
    """The runner's logger for a Trainer the smoke drives by hand: warnings
    only, to the console."""
    log = logging.getLogger("chip_smoke")
    log.setLevel(logging.WARNING)
    return log


def two_stage_config(compute_dtype: str = "bfloat16", **kw) -> Config:
    """train_bert_lyr_8.py's configuration (hm_swin_tiny_lyr_8.py's with
    modality vision and B 64), the fields of `kw` over it."""
    return Config(**{**dict(
        item_tower="modal", user_tower="sasrec", stage="two_stage",
        loss="bce", embedding_dim=D, num_attention_heads=USER_HEADS,
        transformer_block=BLOCKS, max_seq_len=L, drop_rate=DROP,
        dnn_layers=TS_DNN, lr=LR, l2_weight=TS_L2,
        fine_tune_l2_weight=TS_L2, batch_size=TRAIN_B,
        compute_dtype=compute_dtype, item_emb_batch_size=ENCODE_BATCH),
        **kw})


def encode_cache(dev, card: str, cfg, bundle, content_for, item_num: int,
                 what: str) -> tuple:
    """(cache, launches) of the runner's two-stage catalog cache
    (Trainer._encode_catalog: the bundle's frozen tower over ids
    0..item_num in chunks of cfg.item_emb_batch_size), the counters from
    0; its seconds and items/s."""
    tr = runner.Trainer(cfg, smoke_log(), smoke_log(), device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = tr._encode_catalog(bundle, content_for, item_num)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts()
    print(f"two_stage cache [{what}]: {item_num + 1} items x "
          f"{cache.shape[1]} float32 in {secs:.3f} s, "
          f"{(item_num + 1) / secs:.1f} items/s, chunks of "
          f"{cfg.item_emb_batch_size}; launches "
          f"{ {n: c for n, c in launched.items() if c} } [{card}]",
          flush=True)
    require(tuple(cache.shape) == (item_num + 1, cfg.word_embedding_dim),
            f"the {what} cache is {tuple(cache.shape)}")
    require(bool(torch.isfinite(cache).all()) and not cache[0].any(),
            f"the {what} cache is not finite or its padding row not zero")
    return cache, launched


def bce_host_batches(rng, n: int, B: int, item_num: int) -> list:
    """n BCE host batches (pos, neg, log mask) of B users: Zipf(1.2) ids
    capped at item_num in the L + 1 slots, bench_log_mask's mask, one
    negative at each valid transition's slot (BCETrainBatcher's rule)."""
    out = []
    for _ in range(n):
        ids = np.minimum(rng.zipf(ZIPF_A, size=(B, L + 1)),
                         item_num).astype(np.int64)
        lm = bench_log_mask(rng, B)
        draws = sample_negatives(rng, ids, item_num)[:, :, 0]
        neg = np.zeros_like(ids)
        neg[:, :-1] = np.where(lm != 0, draws, 0)
        out.append((ids, neg, lm))
    return out


def two_stage_train(dev, card: str, cfg, cache, bb, fixed: int, timed: int,
                    what: str, item_num: int) -> tuple:
    """The bf16 two-stage step (the head on the float32 cache, the bf16
    parameter copies meeting it in float32; SASRec on the head's float32
    embeddings, as JAX runs the BCE branch): the counters set to 0, `fixed`
    steps on bb[0] (the loss must fall), then `timed` steps on the next
    batches, each deduplicated (positives and negatives together) and
    copied inside its timed step (the mean loss of the last third of the
    fixed steps below the first third's); every SASRec training kernel
    launched.
    Returns (model, launches)."""
    cap = -(-max(bce_unique(p, n) for p, n, _ in bb) // 256) * 256
    cfg = dataclasses.replace(cfg, dedup_items=True, dedup_cap=cap)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    model = make_model(cfg, item_num, device=dev, generator=gen)
    state = make_train_state(model, cfg, None, seed=SEED)
    step = make_train_step(cfg, item_content=cache)
    B = len(bb[0][0])
    first = bce_device_batch(*bb[0], cap, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(state, first).item() for _ in range(fixed)]
    walls = []
    for b in bb[1:timed + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, bce_device_batch(*b, cap, dev)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    steps = fixed + len(walls)
    p50 = statistics.median(walls)
    print(f"two_stage train [{what}]: {cfg.item_tower}, B={B} L={L} D={D} "
          f"dnn_layers {cfg.dnn_layers} mo_dnn_layers {cfg.mo_dnn_layers}, "
          f"{cache.shape[1]}-wide cache, bf16 parameter copies (the head and "
          f"SASRec in float32), dropout {DROP}, dedup cap {cap}: loss on one "
          f"batch {losses[0]:.5f} -> {losses[fixed - 1]:.5f}; p50 "
          f"{p50:.3f} ms over {len(walls)} distinct batches (min "
          f"{min(walls):.3f}, max {max(walls):.3f}), "
          f"{B / p50 * 1e3:.1f} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"two_stage train [{what}] launches a step: "
          f"{ {n: launched[n] / steps for n in TS_TRAIN_KERNELS} }",
          flush=True)
    require(all(math.isfinite(x) for x in losses),
            f"two_stage [{what}]: a loss is not finite")
    q = max(1, fixed // 3)
    require(statistics.mean(losses[fixed - q:fixed])
            < statistics.mean(losses[:q]),
            f"two_stage [{what}]: the loss did not fall on a fixed batch: "
            f"{losses[:fixed]}")
    require_launched(launched, TS_TRAIN_KERNELS, f"two_stage [{what}]")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"two_stage [{what}]: a parameter is not finite")
    return model, launched


def two_stage_grad_check(dev, model, cfg, cache, batch, what: str) -> None:
    """One float32 step without dropout on CHECK_USERS users of `batch`, on
    the card and on a CPU copy of the model and cache through the plain
    versions: the loss and every gradient agree."""
    pos, neg, lm = (a[:CHECK_USERS] for a in batch)
    cap = -(-bce_unique(pos, neg) // 8) * 8
    ccfg = dataclasses.replace(cfg, compute_dtype="float32", dedup_items=True,
                               dedup_cap=cap)
    same_step(card_and_plain(
        dev, model, ccfg, cache,
        lambda where: bce_device_batch(pos, neg, lm, cap, where),
        log_pop=False),
        f"two_stage gradient check [{what}]: f32 step on {CHECK_USERS} users "
        f"({cap} items)")


def head_serve_check(dev, card: str, model, cache, item_num: int, rng,
                     what: str) -> None:
    """The trained head's catalog encode (float32, as served) and
    recommend at B = 1 and 64 (p50 over 20 requests): TS_CHECK_ROWS rows
    of the table, and every request's ids and scores, against the float32
    plain path on a CPU copy of the model, cache and table. (The vision
    catalog shows each pool image on TV_ITEMS / POOL items, whose equal
    scores tie: there ids swap inside ties.)"""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, item_num, cache, D,
                                     batch_size=ENCODE_BATCH)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    require(bool(torch.isfinite(table).all()), f"{what}: table not finite")
    cpu = copy.deepcopy(model).cpu().eval()
    sub = rng.choice(np.arange(1, item_num + 1), TS_CHECK_ROWS,
                     replace=False)
    with torch.no_grad():
        want = cpu.item_embs(torch.from_numpy(sub),
                             cache[torch.from_numpy(sub).to(dev)].cpu())
    table_err = (table[torch.from_numpy(sub).to(dev)].cpu()
                 - want).abs().max().item()
    engine = Retriever(model, table, max_seq_len=L)
    plain = Retriever(cpu, table.cpu(), max_seq_len=L)
    print(f"two_stage serve [{what}]: the head's catalog encode, "
          f"{item_num + 1} items in {encode_s:.3f} s; {TS_CHECK_ROWS} rows "
          f"against the CPU plain path: max abs err {table_err:.3e} (tol "
          f"{TABLE_TOL:g}) [{card}]", flush=True)
    require(table_err <= TABLE_TOL, f"{what}: the head's table disagrees "
            f"with the plain path")
    for B in (1, 64):
        hist = histories(rng, B, item_num)
        ids, vals = engine.recommend(hist, TOP_K)
        ids_p, vals_p = plain.recommend(hist, TOP_K)
        scale = np.maximum(1.0, np.abs(vals_p))
        err = float((np.abs(vals - vals_p) / scale).max())
        mismatch = np.argwhere(ids != ids_p)
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            engine.recommend(hist, TOP_K)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"two_stage recommend [{what}] B={B} top_k={TOP_K}: p50 "
              f"{statistics.median(walls[5:]):.3f} ms over 20 requests; "
              f"against the plain path: score err {err:.3e} (tol "
              f"{SCORE_TOL:g}), {len(mismatch)} of {ids.size} ids differ "
              f"[{card}]", flush=True)
        check_results(ids, hist)
        require(err <= SCORE_TOL, f"{what}: recommend B={B} scores disagree")
        check_ties(mismatch, vals_p, scale, SCORE_TOL)


def two_stage_text(dev, card: str, content, batches) -> tuple:
    """Text two-stage: the BERT-base cache of the catalog (float32,
    TS_CHECK_ROWS rows held on the CPU plain path), then train_bert_lyr_8's
    step (timed, gradient check, the head's encode and recommend against
    the plain path) and train_bert_cat's first grid point on the same
    cache. Returns (the cache's launches, the steps')."""
    bcfg = BertConfig(hidden_dropout_prob=DROP,
                      attention_probs_dropout_prob=DROP)
    tower = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                      word_embedding_dim=bcfg.hidden_size, pooling="cls",
                      attr_lengths=(TITLE_LEN,), project=False, device=dev)
    cfg = two_stage_config()
    cache, cached = encode_cache(
        dev, card, cfg, (tower, None, set(), bcfg.hidden_size),
        lambda ids: content[torch.from_numpy(ids).to(dev)], ITEM_NUM,
        f"text, BERT-base C={bcfg.hidden_size} F={bcfg.intermediate_size} "
        f"{bcfg.num_hidden_layers} layers")
    require_launched(cached, SERVE_KERNELS, "the text cache")
    rng = np.random.default_rng(SEED + 40)
    rows = torch.from_numpy(rng.choice(np.arange(1, ITEM_NUM + 1),
                                       TS_CHECK_ROWS, replace=False)).to(dev)
    cpu = copy.deepcopy(tower).cpu().eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(content[rows].cpu())
    err = (cache[rows].cpu() - want).abs().max().item()
    print(f"two_stage cache [text]: {TS_CHECK_ROWS} rows against the CPU "
          f"plain path ({time.perf_counter() - t0:.1f} s): max abs err "
          f"{err:.3e} (tol {TS_CACHE_TOL:g}; largest |value| "
          f"{want.abs().max().item():.3e}) [{card}]", flush=True)
    require(err <= TS_CACHE_TOL, "the text cache disagrees with the plain "
            "path")
    del tower, cpu
    torch.cuda.empty_cache()
    bb = bce_batches(np.random.default_rng(SEED + 41), batches)
    model, plain = two_stage_train(dev, card, cfg, cache, bb, TS_FIXED,
                                   TS_TIMED, "text", ITEM_NUM)
    two_stage_grad_check(dev, model, cfg, cache, bb[0], "text")
    head_serve_check(dev, card, model, cache, ITEM_NUM, rng, "text")
    del model
    ccfg = dataclasses.replace(cfg, **TS_CAT)
    cbb = [tuple(a[:ccfg.batch_size] for a in b) for b in bb]
    model, cat = two_stage_train(dev, card, ccfg, cache, cbb, TS_FIXED,
                                 TS_CAT_TIMED, "text, fused cat", ITEM_NUM)
    two_stage_grad_check(dev, model, ccfg, cache, cbb[0], "text, fused cat")
    return cached, add_counts(plain, cat)


def two_stage_vision(dev, card: str) -> tuple:
    """Vision two-stage: the Swin-T cache (bf16) of TV_ITEMS items drawn from
    the image pool, as wide as the tower's output (C9), a float32 sub-cache
    held on the CPU plain path; then hm_swin_tiny_lyr_8's step and
    train_swin_tiny_add_m8's (fewer steps, gradient checks, the head's
    encode and recommend against the plain path). Returns (the cache's
    launches, the steps')."""
    pool = image_pool(dev)
    scfg = SwinConfig()
    tower = VisionTower(SwinModel(scfg, device=dev), "swin", D,
                        scfg.num_features, project=False,
                        compute_dtype=torch.bfloat16, device=dev)
    cfg = two_stage_config(modality="vision", batch_size=V_TRAIN_B)
    cache, cached = encode_cache(
        dev, card, cfg, (tower, None, set(), scfg.num_features),
        pool_content(pool), TV_ITEMS, "vision, Swin-T bf16")
    require(cfg.word_embedding_dim == D != scfg.num_features,
            "the vision cache is not as wide as the tower's output (C9)")
    require_launched(cached, VISION_ENCODE_KERNELS, "the vision cache")
    rng = np.random.default_rng(SEED + 43)
    ids = rng.choice(np.arange(1, TV_ITEMS + 1), TV_CHECK_ROWS, replace=False)
    images = pool[torch.from_numpy(ids % POOL).to(dev)]
    tower.compute_dtype = None
    clear_f32_bodies()
    with torch.no_grad(), eval_mode(tower):
        f32 = tower(images)
        require_f32_bodies(VISION_ENCODE_KERNELS,
                           "the two_stage float32 vision sub-cache")
        cpu = copy.deepcopy(tower).cpu()
        want = cpu(images.cpu())
    err = (f32.cpu() - want).abs().max().item()
    bf = (cache[torch.from_numpy(ids).to(dev)] - f32).abs().max().item()
    print(f"two_stage cache [vision]: a float32 sub-cache of {TV_CHECK_ROWS} "
          f"images, card against the CPU plain path: max abs err {err:.3e} "
          f"(tol {V_TABLE_TOL:g}); the bf16 cache's rows against it: max abs "
          f"difference {bf:.3e} (largest |value| "
          f"{want.abs().max().item():.3e}) [{card}]", flush=True)
    require(err <= V_TABLE_TOL, "the vision sub-cache disagrees with the "
            "plain path")
    del tower, cpu
    torch.cuda.empty_cache()
    bb = bce_host_batches(np.random.default_rng(SEED + 44), TV_TIMED + 1,
                          V_TRAIN_B, TV_ITEMS)
    model, plain = two_stage_train(dev, card, cfg, cache, bb, TV_FIXED,
                                   TV_TIMED, "vision", TV_ITEMS)
    two_stage_grad_check(dev, model, cfg, cache, bb[0], "vision")
    head_serve_check(dev, card, model, cache, TV_ITEMS, rng, "vision")
    del model
    acfg = dataclasses.replace(cfg, **TV_ADD)
    model, add = two_stage_train(dev, card, acfg, cache, bb, TV_FIXED, 3,
                                 "vision, fused add", TV_ITEMS)
    two_stage_grad_check(dev, model, acfg, cache, bb[0], "vision, fused add")
    return cached, add_counts(plain, add)


def fusion_vision_config(compute_dtype: str = "bfloat16") -> Config:
    """train_swin_tiny_add.py's configuration at FV_B users a step."""
    return Config(item_tower="modal_id_add", user_tower="sasrec",
                  stage="end2end", modality="vision", loss="bce",
                  embedding_dim=D, num_attention_heads=USER_HEADS,
                  transformer_block=BLOCKS, max_seq_len=L, drop_rate=DROP,
                  lr=V_LR, fine_tune_lr=V_FT_LR, l2_weight=TS_L2,
                  fine_tune_l2_weight=TS_L2, batch_size=FV_B,
                  compute_dtype=compute_dtype)


def image_bce_batch(pos, neg, lm, cap: int, pool: np.ndarray, dev) -> dict:
    """A BCE host batch, its positives and negatives deduplicated together,
    with the unique items' images (pool[id % POOL]), on the device."""
    packed = dedup_pack(np.concatenate([pos.ravel(), neg.ravel()]), cap)
    require(packed is not None, f"a BCE batch holds more than {cap} items")
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"ids": t(pos), "neg_ids": t(neg), "log_mask": t(lm),
            "uniq_ids": t(packed[0]), "inverse": t(packed[1]),
            "uniq_content": t(pool[packed[0] % len(pool)])}


def fusion_vision(dev, card: str, pool: np.ndarray) -> dict:
    """train_swin_tiny_add.py's bf16 step (Swin-T beside an ID table of
    TV_ITEMS, SASRec at D 512) at B = FV_B: the counters set to 0, FV_STEPS
    steps on one batch, every vision-step kernel launched; then a float32
    gradient check on V_CHECK_USERS users of short histories. Returns the
    launches."""
    cfg = fusion_vision_config()
    pos, neg, lm = bce_host_batches(np.random.default_rng(SEED + 46), 1, FV_B,
                                    TV_ITEMS)[0]
    cap = -(-bce_unique(pos, neg) // V_CAP_QUANTUM) * V_CAP_QUANTUM
    scfg = SwinConfig()
    tower = VisionTower(SwinModel(scfg, device=dev), "swin", D,
                        scfg.num_features, compute_dtype=torch.bfloat16,
                        device=dev)
    model = make_model(cfg, TV_ITEMS, tower, device=dev, generator=torch.
                       Generator(device=dev).manual_seed(SEED + 45))
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg)
    batch = image_bce_batch(pos, neg, lm, cap, pool, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for _ in range(FV_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, batch).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    print(f"fusion [vision, modal_id_add] train step B={FV_B} L={L} D={D} "
          f"Swin-T bf16 beside an ID table of {TV_ITEMS + 1} rows, dropout "
          f"{DROP}, DropPath 0.1, {cap} images a step (positives and "
          f"negatives deduplicated): {FV_STEPS} steps on one batch, losses "
          f"{[round(x, 5) for x in losses]}, p50 of the last "
          f"{FV_STEPS - 1} {statistics.median(walls[1:]):.3f} ms (the first "
          f"{walls[0]:.3f}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"a step { {n: launched[n] / FV_STEPS for n in VISION_TRAIN_KERNELS} } "
          f"[{card}]", flush=True)
    require(all(math.isfinite(x) for x in losses),
            "fusion [vision]: a loss is not finite")
    require_launched(launched, VISION_TRAIN_KERNELS, "fusion [vision]")
    # the check: two users of five transitions each, float32 images
    n = V_CHECK_USERS
    cpos, clm = pos[:n].copy(), lm[:n].copy()
    cpos[:, :-6], clm[:, :-5] = 0, 0.0
    cneg = np.zeros_like(cpos)
    cneg[:, :-1] = np.where(clm != 0, neg[:n, :-1], 0)
    ccap = -(-bce_unique(cpos, cneg) // 4) * 4
    model.encoder.compute_dtype = None
    same_step(card_and_plain(
        dev, model, fusion_vision_config("float32"), None,
        lambda where: image_bce_batch(cpos, cneg, clm, ccap, pool, where),
        log_pop=False),
        f"fusion gradient check [vision, modal_id_add]: f32 step on {n} users "
        f"({ccap} images)", V_STEP_GRAD_TOL)
    return launched


def profiled(run, n: int, what: str, unit: str, card: str) -> None:
    """torch.profiler split of ``run()`` by device kernel, reported per
    ``unit`` (``run`` covers n of them): the wall and device-busy time and
    each kernel's share of the busy time (user annotations left out); the
    top PROFILE_ROWS kernels, the rest in one line, then each kernel of
    PROFILE_WATCH (fused_mha's, the pre-LN MLP backward's) among the rest
    on a line of its own, and last the sum of gemm.cu's kernels
    (PROFILE_GEMM) and the column sums' (colsum_kernel)."""
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
        if any(w in name for w in PROFILE_WATCH):
            print(f"    of which {100 * ms / busy:6.2f} % {ms:8.3f} "
                  f"ms/{unit} x{count:<5g} {name[:100]}", flush=True)
    gemm = [r for r in rows if any(k in r[2] for k in PROFILE_GEMM)]
    ms = sum(r[0] for r in gemm)
    print(f"  gemm.cu's kernels: {100 * ms / busy:.2f} % {ms:.3f} ms/{unit} "
          f"x{sum(r[1] for r in gemm):g} in {len(gemm)} kernels", flush=True)
    sums = [r for r in rows if "::colsum_kernel" in r[2]]
    print(f"  colsum_kernel: {100 * sum(r[0] for r in sums) / busy:.2f} % "
          f"{sum(r[0] for r in sums):.3f} ms/{unit} "
          f"x{sum(r[1] for r in sums):g}", flush=True)


def profile_train(dev, card: str, content, batches, cap: int) -> None:
    """The train step by device kernel, with the in-batch CE's
    composition and under use_pallas (the CE kernels): PROFILE_STEPS steps
    on distinct batches after as many warm-up steps, each."""
    for pallas in (False, True):
        _, state, step = train_setup(dev, content, cap, pallas)
        run = lambda part: [step(state, device_batch(ids, lm, cap,
                                                     dev)).item()
                            for ids, lm in part]
        run(batches[:PROFILE_STEPS])
        profiled(lambda: run(batches[PROFILE_STEPS:2 * PROFILE_STEPS]),
                 PROFILE_STEPS, f"train step B={TRAIN_B} bf16, dropout "
                 f"{DROP}, dedup cap {cap}, use_pallas {pallas}, "
                 f"{PROFILE_STEPS} steps", "step", card)
        del state, step
        torch.cuda.empty_cache()


def profile_bce_dssm(dev, card: str, content, batches) -> None:
    """The BCE step (phase "bce") and the DSSM step (phase "dssm") by
    device kernel: PROFILE_STEPS steps on distinct batches after as many
    warm-up steps, each."""
    _, state, step, bb, cap = bce_setup(dev, content, batches)
    run = lambda part: [step(state, bce_device_batch(*b, cap, dev)).item()
                        for b in part]
    run(bb[:PROFILE_STEPS])
    profiled(lambda: run(bb[PROFILE_STEPS:2 * PROFILE_STEPS]), PROFILE_STEPS,
             f"BCE train step B={TRAIN_B} bf16, dropout {DROP}, dedup cap "
             f"{cap}, {PROFILE_STEPS} steps", "step", card)
    del state, step
    torch.cuda.empty_cache()
    _, state, step, db = dssm_setup(dev, content,
                                    np.random.default_rng(SEED + 40),
                                    2 * PROFILE_STEPS)
    run = lambda part: [step(state, dssm_device_batch(*b, dev)).item()
                        for b in part]
    run(db[:PROFILE_STEPS])
    profiled(lambda: run(db[PROFILE_STEPS:]), PROFILE_STEPS,
             f"DSSM train step B={TRAIN_B} bf16, dropout {DROP}, user table "
             f"{DSSM_USERS + 1} x {D}, {PROFILE_STEPS} steps", "step", card)
    del state, step
    torch.cuda.empty_cache()


def profile_two_stage(dev, card: str, content, batches) -> None:
    """The two-stage text step of phase "two_stage" (train_bert_lyr_8's
    head and SASRec, on a float32 cache of BERT-base's width drawn at
    random: the step's work does not depend on the cache's values) and a
    chunk of the BERT-base cache encode, by device kernel: PROFILE_STEPS
    steps (chunks) after as many warm-up ones."""
    bcfg = BertConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    cache = torch.randn(ITEM_NUM + 1, bcfg.hidden_size, generator=gen,
                        device=dev)
    cache[0] = 0.0
    bb = bce_batches(np.random.default_rng(SEED + 41), batches)
    cap = -(-max(bce_unique(p, n) for p, n, _ in bb) // 256) * 256
    cfg = two_stage_config(word_embedding_dim=bcfg.hidden_size,
                           dedup_items=True, dedup_cap=cap)
    model = make_model(cfg, ITEM_NUM, device=dev, generator=gen)
    state = make_train_state(model, cfg, None, seed=SEED)
    step = make_train_step(cfg, item_content=cache)
    run = lambda part: [step(state, bce_device_batch(*b, cap, dev)).item()
                        for b in part]
    run(bb[:PROFILE_STEPS])
    profiled(lambda: run(bb[PROFILE_STEPS:2 * PROFILE_STEPS]), PROFILE_STEPS,
             f"two-stage text train step B={TRAIN_B} bf16 copies, dnn_layers "
             f"{TS_DNN}, dropout {DROP}, dedup cap {cap}, {PROFILE_STEPS} "
             f"steps", "step", card)
    del model, state, step
    torch.cuda.empty_cache()
    tower = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                      word_embedding_dim=bcfg.hidden_size,
                      attr_lengths=(TITLE_LEN,), project=False, device=dev)
    init_parameters(tower, gen)
    tower.eval()
    chunks = [content[i * ENCODE_BATCH:(i + 1) * ENCODE_BATCH]
              for i in range(2 * PROFILE_STEPS)]
    with torch.no_grad():
        [tower(c) for c in chunks[:PROFILE_STEPS]]
        profiled(lambda: [tower(c) for c in chunks[PROFILE_STEPS:]],
                 PROFILE_STEPS, f"two-stage text cache, BERT-base float32, "
                 f"chunks of {ENCODE_BATCH} titles", "chunk", card)


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
            # the yardstick, the same products through torch.matmul in
            # the case's dtype (float32 with TF32 off)
            yard = (lambda x=x, ws=ws, nh=nh, dt=dt: attention_products(
                window_partition(x, WINDOW), ws[0].to(dt), ws[2].to(dt), nh))
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
                x, mlp[0].to(dt), mlp[2].to(dt)))
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


def gdh_work(M, C, F, it=2):
    # h and dg; reads xn, dy, w1, w2, b1; writes g, dh and the two column
    # sums (float)
    return 4 * M * C * F, (2 * M * C + 2 * C * F + F + 2 * M * F) * it + 4 * (
        C + F)


def premlp_bwd_routes(dev, card: str, images: int) -> dict:
    """The pre-LN MLP's backward at each Swin-T stage for `images`
    images, bf16, with DropPath's row scale: the route premlp_bwd_plan
    picks (premlp_bwd_mma_kernel's "fused" at stages 0-2,
    premlp_bwd_wg_kernel's "wg" at stage 3) and the products route, each
    call alone (PREMLP_BWD_ROUTES: the kernel and gemm.cu's products, or
    gemm.cu's five products around the row passes), CUDA-event and device
    time, their gradients against each other at GRAD_TOL (each route is
    held against autograd of the plain version in the cases before).
    Where the plan takes "wg", the kernel alone (premlp_bwd_gdh: g, dh,
    db1 and db2 of the row pass's xn and dy) against premlp_bwd_gdh_plain
    at GRAD_TOL, with event and device time, its bound, the plain
    version's time and the torch.matmul yardstick of its two products.
    Returns that row for the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device=dev) * scale
    bf = torch.bfloat16
    records = {}
    for C, _, side in SWIN_STAGES:
        M, Fw = images * side * side, 4 * C
        k = premlp_bwd_plan(C, M, bf)
        where = f"scaled M={M} C={C} F={Fw} gelu bf16"
        routes = (k["route"], "products")
        x2, dout = g(M, C).to(bf), g(M, C).to(bf)
        w1, b1, w2 = (g(C, Fw, scale=C ** -0.5).to(bf),
                      g(Fw, scale=0.1).to(bf), g(Fw, C, scale=Fw ** -0.5).to(bf))
        ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
        keep = (torch.rand(images, generator=gen, device=dev) < 0.9)
        scale = (keep.float() / 0.9).repeat_interleave(side * side)
        ops = (x2, dout, scale, w1, b1, w2, ln, None, 1e-5, "gelu", True,
               lib.DTYPE_CODES[bf])
        got = {r: PREMLP_BWD_ROUTES[r](*ops) for r in routes}
        torch.cuda.synchronize()
        worst = _worst_err(got[k["route"]], got["products"],
                           f"premlp_bwd routes {where}")
        del got
        times = {}
        for r in routes:
            fn = lambda r=r: PREMLP_BWD_ROUTES[r](*ops)
            times[r] = (cuda_ms(fn, reps=VB_REPS), device_ms(
                fn, VB_REPS, expect=(k["kernels"][0],)
                if r == k["route"] else ())[0])
        plan = {n: v for n, v in k.items()
                if n not in ("route", "kernels", "blocks", "per", "groups")}
        print(f"premlp_bwd routes [{where}]: the plan takes {k['route']} "
              f"{plan}; " + ", ".join(f"{r} {ms:.4f} ms ({dev_ms:.4f} ms "
                                      f"device)"
                                      for r, (ms, dev_ms) in times.items())
              + f"; {k['route']} against products max_abs_err "
              f"{worst[1]:.3e} on a scale of {worst[2]:.3g} [{card}]",
              flush=True)
        require(worst[0] <= GRAD_TOL[bf], f"premlp_bwd routes {where}: "
                f"error {worst[1]} above {GRAD_TOL[bf]} x {worst[2]}")
        if k["route"] == "wg":
            records["premlp_bwd_gdh"] = gdh_case(card, where, x2, dout,
                                                 scale, w1, b1, w2, ln)
        del x2, dout, ops
    return records


def gdh_case(card: str, where: str, x2, dout, scale, w1, b1, w2, ln) -> dict:
    """premlp_bwd_gdh (premlp_bwd_wg_kernel and its fixed-order sums) on
    the wg route's xn = cast(LN(x)) and dy = cast(s dout) against
    premlp_bwd_gdh_plain at GRAD_TOL; event and device time (the kernel's
    own beside), bound, plain and the torch.matmul yardstick of h = xn w1
    and dg = dy w2ᵀ. Returns the kernels line's row."""
    bf, C = torch.bfloat16, x2.shape[1]
    M, Fw = x2.shape[0], w1.shape[1]
    xn = F.layer_norm(x2.float(), (C,), ln[0], ln[1], 1e-5).to(bf)
    dy = (dout.float() * scale[:, None]).to(bf)
    run = lambda: premlp_bwd_gdh(xn, dy, w1, b1, w2, None, "gelu")
    plain = lambda: premlp_bwd_gdh_plain(xn, dy, w1, b1, w2, None, "gelu")
    yard = lambda: (xn @ w1, dy @ w2.t())
    worst = _worst_err(run(), plain(), f"premlp_bwd_gdh {where}")
    ms, plain_ms = cuda_ms(run, reps=VB_REPS), cuda_ms(plain, reps=VB_REPS)
    # ten calls a trace, after device_ms's warm-up call (PERF.md §7)
    dev_ms, by_kernel = device_ms(run, 10, expect=("premlp_bwd_wg_kernel",))
    own = sum(v for n, v in by_kernel.items() if "premlp_bwd_wg_kernel" in n)
    yard_ms = (cuda_ms(yard, reps=VB_REPS), device_ms(yard, VB_REPS)[0])
    work = gdh_work(M, C, Fw)
    bound_ms, bound_by = bound_of(work, bf)
    print(f"kernel premlp_bwd_gdh [{where}]: max_abs_err {worst[1]:.3e} on a "
          f"scale of {worst[2]:.3g} (tol {GRAD_TOL[bf]:g} of it), kernel "
          f"{ms:.4f} ms ({dev_ms:.4f} ms device, premlp_bwd_wg_kernel "
          f"{own:.4f}, {own and work[0] / own / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, the two products through torch.matmul "
          f"{yard_ms[0]:.4f} ms ({yard_ms[1]:.4f} ms device), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f} % of "
          f"it reached in event time) [{card}]", flush=True)
    require(worst[0] <= GRAD_TOL[bf], f"premlp_bwd_gdh {where}: error "
            f"{worst[1]} above {GRAD_TOL[bf]} x {worst[2]}")
    return dict(max_abs_err=worst[1], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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
                        compute_dtype: str = "bfloat16") -> Config:
    return dataclasses.replace(
        vision_config(), loss="inbatch_ce", compute_dtype=compute_dtype,
        lr=V_LR, l2_weight=0.0, fine_tune_lr=V_FT_LR,
        fine_tune_l2_weight=0.0, dedup_cap=cap, encoder_chunk=chunk)


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
    earlier, fused_mlp_res_bwd.bodies = fused_mlp_res_bwd.bodies, set()
    launched = vision_train_run(dev, card, pool, zipf, cap, 0, V_FIXED_STEPS,
                                V_TIMED_STEPS, "zipf, dedup")
    seen = fused_mlp_res_bwd.bodies
    fused_mlp_res_bwd.bodies = earlier | seen
    print(f"vision training launches {launched}; the MLP backward's device "
          f"kernels {sorted(seen)}", flush=True)
    for body in ("premlp_bwd_mma_kernel", "premlp_bwd_wg_kernel"):
        require(body in seen, f"the vision train step's MLP backward never "
                f"took {body}")
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
    for n in VISION_WINDOWS_TRAIN_KERNELS + ("premlp_bwd_gdh",):
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
        clear_f32_bodies()
        relu_in = []
        t0 = time.perf_counter()
        with relu_inputs(relu_in):
            loss = step(state, vision_device_batch(ids, lm, cap, pool,
                                                   where)).item()
        if where.type == "cuda":
            require_f32_bodies(
                ("fused_mlp",) if swin_drop else VISION_ENCODE_KERNELS
                if kernels == "band" else VISION_WINDOWS_KERNELS,
                f"the float32 vision gradient check, {kernels}")
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
        kinks, kink_note = kink_units(hk, hp, sasrec_blocks(model))
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


def kink_units(card: list, plain: list, blocks: int,
               share: float = V_KINK_SHARE) -> tuple:
    """The ReLU units at the kink (see V_KINK) of a model's `blocks` SASRec
    blocks, from the FFN inputs that relu_inputs recorded on each side (in
    block order, `blocks` of them a step; a unit at the kink in any step
    counts), at most `share` of a block's: {name of a w_1 weight or bias:
    bool mask over its output units}, and a line that says how many there
    are."""
    require(len(card) == len(plain) and len(card) % blocks == 0
            and len(card) > 0,
            f"{len(card)} and {len(plain)} SASRec FFNs recorded, not a "
            f"multiple of the model's {blocks} blocks")
    units, margins, flips = [None] * blocks, [0.0] * blocks, [0] * blocks
    for i, (hk, hp) in enumerate(zip(card, plain)):
        b = i % blocks
        margin = V_KINK * (hk - hp).abs().max().item()
        near = (hp.abs() <= margin).any(0)
        units[b] = near if units[b] is None else units[b] | near
        margins[b] = max(margins[b], margin)
        flips[b] += ((hk > 0) != (hp > 0)).sum().item()
    kinks, notes = {}, []
    for b in range(blocks):
        require(units[b].float().mean().item() <= share,
                f"SASRec block {b}: {int(units[b].sum())} of "
                f"{units[b].numel()} ReLU units within {margins[b]:.2e} of "
                f"the kink")
        for p in ("weight", "bias"):
            kinks[f"user_encoder.block_{b}.w_1.{p}"] = units[b]
        notes.append(f"block {b}: {int(units[b].sum())} of "
                     f"{units[b].numel()} within {margins[b]:.2e} "
                     f"({flips[b]} pre-activations of opposite signs)")
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
    # stage 3's two blocks take the wg route in bf16
    require(launched["premlp_bwd_gdh"] == 2 * (V_DROP_FIXED + V_DROP_TIMED),
            f"the vision dropout train step launched premlp_bwd_gdh "
            f"{launched['premlp_bwd_gdh']} times")
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


def vision_config() -> Config:
    """The vision flagship."""
    return Config(item_tower="modal", user_tower="sasrec", stage="end2end",
                  modality="vision", embedding_dim=V_D,
                  num_attention_heads=USER_HEADS, transformer_block=BLOCKS,
                  max_seq_len=V_L, drop_rate=DROP)


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
    clear_f32_bodies()
    table_w, _ = timed_encode(windows, V_SUB_ITEMS - 1, content_fn,
                              V_SUB_ITEMS)
    final = counts()
    require_f32_bodies(VISION_WINDOWS_KERNELS,
                       "the float32 'windows' sub-catalog")

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
    clear_f32_bodies()
    table_k, _ = timed_encode(f32, n, content_fn, V_SUB_ITEMS)
    require_f32_bodies(VISION_ENCODE_KERNELS, "the float32 'band' sub-catalog")
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
    # a second run gives the same bits: no atomics, fixed-order sums
    again = fused_ce(*lk, *rest)
    require(torch.equal(again, out_k) and all(
        torch.equal(a, b) for a, b in zip(
            torch.autograd.grad(again, lk), got)),
        f"{what}: two runs of the CE kernels differ")
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
    # float32 runs its products as 3xTF32 on the tensor cores
    tf32x3 = dt == torch.float32
    label = (f"{what} M={M} N={N} D={Dc} W={W} label_off={rest[-1]} "
             f"{tag_of(dt)}")
    print(f"kernel fused_inbatch_ce [{label}]: loss {out_k.item():.6f} vs "
          f"plain {out_p.item():.6f}, rel err {loss_err:.3e} (tol "
          f"{CE_LOSS_TOL[dt]:g}); gradients max_abs_err {worst[1]:.3e} on a "
          f"scale of {worst[2]:.3e} (tol {CE_GRAD_TOL[dt]:g} of the scale); "
          f"two runs bit-equal; forward {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_text(work, dt, tf32x3)}; backward "
          f"{bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
          f"{bound_text(work_bwd, dt, tf32x3)} [{card}]", flush=True)
    require(loss_err <= CE_LOSS_TOL[dt], f"{label}: loss disagrees")
    require(worst[0] <= CE_GRAD_TOL[dt], f"{label}: gradients disagree")
    _record(results, "fused_inbatch_ce", loss_abs, ms, plain_ms, work, dt,
            tf32x3=tf32x3)
    _record(results, "fused_inbatch_ce_bwd", worst[1], bwd_ms, bwd_plain,
            work_bwd, dt, tf32x3=tf32x3)


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


def idrec_config(pallas: bool) -> Config:
    """bench.py GEOM["idrec"]: the ID table of ITEM_NUM + 1 rows at D under
    SASRec, lr 1e-4, bf16 compute, dropout 0.1."""
    return Config(item_tower="id", user_tower="sasrec", stage="end2end",
                  embedding_dim=D, num_attention_heads=USER_HEADS,
                  transformer_block=BLOCKS, max_seq_len=L, drop_rate=DROP,
                  loss="inbatch_ce", compute_dtype="bfloat16", lr=LR,
                  l2_weight=0.0, fine_tune_lr=FT_LR, fine_tune_l2_weight=0.0,
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
    print(f"use_pallas steps beside the composition's: text p50 {p50:.3f} "
          f"ms against {composition[1]:.3f} ms, IDRec {on[1]:.3f} ms "
          f"against {off[1]:.3f} ms [{card}]", flush=True)
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


# -- the runner phase (train/runner.py, run.py) --------------------------------
# IDRec through the CLI: users drawn as the quickstart draws them (each
# user's items within one group of R_GROUP), at bench.py GEOM["idrec"]'s
# width (D, L, IDREC_B, BLOCKS), the quickstart's lr
R_USERS, R_GROUP, R_LENGTHS, R_LR = 20_000, 100, (6, 24), 1e-3
# each IDRec part's (items, epochs), chosen so that its valid HR@10 beats
# the untrained model's: the in-batch CE over ITEM_NUM items first rises
# at the third epoch (an item seen about 3 times an epoch, PERF.md §6);
# BCE moves an ID row only where it is a positive or a sampled negative,
# and over ITEM_NUM items stays at the untrained model's few hits in 5
# epochs, so it runs over R_BCE_ITEMS items (about 150 sightings an item
# an epoch); DSSM beats it after one epoch
R_BCE_ITEMS = 2_000
R_IDREC = {"": (ITEM_NUM, 5), "BCE": (R_BCE_ITEMS, 3), "DSSM": (ITEM_NUM, 1)}
# text MoRec at the flagship width through Trainer: each user's 12-13
# items a slice of one permutation of the catalog, so every item is read
# and the catalog keeps its ITEM_NUM items; an item's title shares its
# group's words
RT_USERS, RT_GROUP, RT_GROUP_WORDS = 8_000, 100, 12
# DSSM trains on a user's every (user, item) pair, about 10 a user: the
# text and vision DSSM parts' epochs are cut to their in-batch CE part's
# number of steps
RT_DSSM_STEPS = -(-RT_USERS // TRAIN_B)
# vision MoRec: a store of RV_ITEMS images of RV_SIDE px (resized to
# IMAGE), groups of RV_GROUP items, RV_USERS users; the dedup cap holds a
# batch's every item, encoded in chunks of V_CAP_QUANTUM
RV_ITEMS, RV_SIDE, RV_GROUP, RV_USERS, RV_EPOCHS = 512, 256, 32, 384, 2
RV_CAP = 6 * V_CAP_QUANTUM
# the special phase (cold and new users of the runner's text and vision
# parts): text cold and new users and new titles; vision cold and new
# users and new images (a second MKV store); vision catalog rows
# re-encoded on the CPU
RS_USERS, RS_NEW = 256, 64
RSV_USERS, RSV_NEW, RS_SUB = 96, 16, 8
# the kernels each part must launch, in its training and in its evaluation
RUNNER_EVAL_KERNELS = ("fused_mha", "fused_proj_resln", "fused_mlp_resln",
                       "gemm")
IDREC_TRAIN_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_proj_resln_res",
                       "fused_proj_resln_bwd", "fused_mlp_resln_res",
                       "fused_mlp_resln_bwd", "gemm")
# the BCE and DSSM parts: the flags the reference launchers of
# variants/bce_*/main-end2end and main-end2end(DSSM) add to the in-batch
# CE part's (loss, user tower, neg_num 1, dnn_layers 0)
R_VARIANTS = {"": {}, "BCE": dict(loss="bce"),
              "DSSM": dict(loss="bce", user_tower="dssm", neg_num=1,
                           dnn_layers=0)}
# text MoRec's ID+modality fusion part: id_plus_mo-end2end's BCE with the
# CAT tower (ROADMAP A4)
R_TEXT_VARIANTS = {**R_VARIANTS,
                   "CAT": dict(loss="bce", item_tower="modal_id_cat")}
# vision DSSM: users a step, their (1 + neg_num) images two encoder chunks
RV_DSSM_B = V_CAP_QUANTUM
RV_DSSM_STEPS = -(-RV_USERS // V_TRAIN_B)
# the Swin tower's training kernels (vision DSSM has no SASRec)
SWIN_TRAIN_KERNELS = ("fused_mha_proj_band", "fused_mha_proj_band_bwd",
                      "fused_mlp_res", "fused_mlp_res_bwd", "premlp_bwd_gdh",
                      "gemm")


class RunnerWatch:
    """Watches the port's runner from outside while the CLI or a Trainer
    runs: the Trainers made, their train steps' losses, the launches
    inside evaluations (run_eval) and outside them, and each checkpoint
    save and load (seconds, bytes). Launch counts start from 0 when the
    watch starts."""

    def __init__(self):
        self.trainers, self.saves, self.loads = [], [], []
        self.eval_launches = dict.fromkeys(WRAPPERS, 0)
        self.losses = {}        # id(trainer) -> its train steps' losses

    def __enter__(self):
        reset_counts()
        T = runner.Trainer
        self._saved = (T.__init__, T.run_eval, T._steps,
                       runner.save_checkpoint, runner.load_checkpoint)
        init, run_eval, steps, save, load = self._saved
        watch = self

        def init_(tr, *a, **k):
            init(tr, *a, **k)
            watch.trainers.append(tr)

        def steps_(tr, batches):
            out = steps(tr, batches)
            watch.losses.setdefault(id(tr), []).extend(out)
            return out

        def run_eval_(tr, *a, **k):
            before = counts()
            out = run_eval(tr, *a, **k)
            for n, c in counts().items():
                watch.eval_launches[n] += c - before[n]
            return out

        def timed(fn, into):
            def call(path_or_dir, *a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(path_or_dir, *a, **k)
                torch.cuda.synchronize()
                path = out if isinstance(out, str) else path_or_dir
                into.append((time.perf_counter() - t0,
                             os.path.getsize(path)))
                return out
            return call

        T.__init__, T.run_eval, T._steps = init_, run_eval_, steps_
        runner.save_checkpoint = timed(save, self.saves)
        runner.load_checkpoint = timed(load, self.loads)
        return self

    def __exit__(self, *exc):
        T = runner.Trainer
        (T.__init__, T.run_eval, T._steps, runner.save_checkpoint,
         runner.load_checkpoint) = self._saved

    def loss_fell(self, tr) -> tuple:
        """(mean loss of the first tenth of tr's train steps, of the last
        tenth)."""
        losses = self.losses[id(tr)]
        q = max(1, len(losses) // 10)
        return statistics.mean(losses[:q]), statistics.mean(losses[-q:])

    def launches(self) -> tuple:
        """(training launches, evaluation launches) since the start."""
        total = counts()
        return ({n: total[n] - self.eval_launches[n] for n in total},
                dict(self.eval_launches))


def require_launched(launched: dict, names, what: str) -> None:
    missing = [n for n in names if not launched[n]]
    require(not missing, f"{what}: {missing} never launched")


def report_runner(part: str, card: str, tr, watch: RunnerWatch,
                  ev: dict) -> None:
    """The part's numbers, each line beside the card."""
    s = tr.train_stats
    first, last = watch.loss_fell(tr)
    print(f"runner {part}: train {s['samples']} samples in {s['steps']} "
          f"steps, {s['seconds']:.3f} s, "
          f"{s['samples'] / s['seconds']:.1f} samples/s; loss, mean of the "
          f"first tenth of the steps {first:.5f}, of the last tenth "
          f"{last:.5f} [{card}]", flush=True)
    print(f"runner {part}: eval of the {ev['split']} split: catalog encode "
          f"{ev['items']} items in {ev['encode_s']:.3f} s, "
          f"{ev['items'] / ev['encode_s']:.1f} items/s; scoring "
          f"{ev['users']} users in {ev['score_s']:.3f} s, "
          f"{ev['users'] / ev['score_s']:.1f} users/s [{card}]", flush=True)
    for what, rows in (("save", watch.saves), ("load", watch.loads)):
        for sec, size in rows:
            print(f"runner {part}: checkpoint {what} {size} bytes in "
                  f"{sec:.3f} s [{card}]", flush=True)
    train, evals = watch.launches()
    print(f"runner {part}: launches in training "
          f"{ {n: c for n, c in train.items() if c} }, in evaluation "
          f"{ {n: c for n, c in evals.items() if c} }", flush=True)


def same_eval(got: dict, want: dict, what: str) -> None:
    """A reloaded checkpoint's evaluation against the in-memory one of the
    same epoch and split: every bit."""
    same = (got["split"] == want["split"] and got["hit"] == want["hit"]
            and got["ndcg"] == want["ndcg"]
            and np.array_equal(got["hits"], want["hits"])
            and np.array_equal(got["ndcgs"], want["ndcgs"]))
    print(f"{what}: the reloaded checkpoint's {got['split']} HR@10 "
          f"{got['hit']:.6f} nDCG@10 {got['ndcg']:.6f} against "
          f"{want['hit']:.6f} {want['ndcg']:.6f} in memory; every per-user "
          f"value equal: {same}", flush=True)
    require(same, f"{what}: the reloaded checkpoint evaluates otherwise")


def runner_idrec(dev, card: str, variant: str = "") -> dict:
    """IDRec through the CLI, with the flags of R_VARIANTS[variant], over
    R_IDREC[variant]'s items and epochs: the untrained model's valid
    HR@10, the epochs (save on a better HR@10), which must beat it, then a
    --mode test reload of the best epoch; its valid split evaluates to the
    run's bits. Returns the part's launches (DSSM's IDRec runs no kernel:
    no SASRec, no encoder)."""
    what = f"IDRec {variant}".strip()
    items, epochs = R_IDREC[variant]
    argv = ["--root_data_dir", "./", "--dataset", "IDREC", "--news",
            "news.tsv", "--behaviors", "behaviors.tsv", "--item_tower", "id",
            "--max_seq_len", str(L), "--embedding_dim", str(D),
            "--num_attention_heads", str(USER_HEADS), "--transformer_block",
            str(BLOCKS), "--batch_size", str(IDREC_B), "--lr", str(R_LR),
            "--drop_rate", str(DROP), "--epoch", str(epochs)]
    for k, v in R_VARIANTS[variant].items():
        argv += [f"--{k}", str(v)]
    quickstart.make_dataset("IDREC", n_users=R_USERS, n_items=items,
                            n_groups=items // R_GROUP, seed=SEED,
                            lengths=R_LENGTHS)
    untrained = runner.Trainer(parse_args(argv))
    untrained.load_data()
    untrained.build_model()
    hit0, ndcg0 = untrained.run_eval("valid")
    del untrained
    with RunnerWatch() as watch:
        best, best_epoch = run.main(argv)
        trained = watch.trainers[-1]
        hit, ndcg = run.main(argv + ["--mode", "test", "--load_ckpt_name",
                                     f"epoch-{best_epoch}.pt"])
        tested = watch.trainers[-1]
        tested.run_eval("valid")
    print(f"runner {what} (CLI): {trained.item_num} items, "
          f"{trained.batcher.n} samples, D {D}, L {L}, B {IDREC_B}, "
          f"{epochs} epochs: best valid HR@10 {best:.6f} at epoch "
          f"{best_epoch} (untrained {hit0:.6f}, nDCG@10 {ndcg0:.6f}); valid "
          f"by epoch { {e: (r['hit'], r['ndcg']) for e, r in trained.valid_results.items()} }; "
          f"test reload HR@10 {hit:.6f} nDCG@10 {ndcg:.6f} [{card}]",
          flush=True)
    report_runner(what, card, trained, watch,
                  trained.valid_results[best_epoch])
    first, last = watch.loss_fell(trained)
    require(last < first, f"{what}'s train loss did not fall")
    require(best > hit0, f"{what}'s best valid HR@10 does not beat the "
            f"untrained model's")
    same_eval(tested.last_eval, trained.valid_results[best_epoch],
              f"runner {what}")
    if variant != "DSSM":
        train, evals = watch.launches()
        require_launched(train, IDREC_TRAIN_KERNELS, f"{what} training")
        require_launched(evals, RUNNER_EVAL_KERNELS, f"{what} evaluation")
    return counts()


class WordTokenizer:
    """The HF tokenizer's call signature over titles of "w<k>" words: a
    CLS id, then word k's id k, padded with 0 (no files: the card's machine
    has no tokenizer files)."""

    def __call__(self, text, max_length, padding, truncation):
        ids = [101] + [int(w[1:]) for w in text.split()][:max_length - 1]
        n = len(ids)
        return {"input_ids": ids + [0] * (max_length - n),
                "attention_mask": [1] * n + [0] * (max_length - n)}


def text_runner_data(rng) -> None:
    """TEXT/news.tsv (ITEM_NUM titles: the group's RT_GROUP_WORDS words and
    a few of the item's own) and TEXT/behaviors.tsv (RT_USERS users, each a
    slice of one permutation of the items sorted into groups)."""
    os.makedirs("TEXT", exist_ok=True)
    n_groups = ITEM_NUM // RT_GROUP
    group_words = rng.integers(1000, VOCAB, size=(n_groups, RT_GROUP_WORDS))
    with open("TEXT/news.tsv", "w") as f:
        for k in range(1, ITEM_NUM + 1):
            g = (k - 1) // RT_GROUP
            own = rng.integers(1000, VOCAB, size=int(rng.integers(2, 10)))
            words = " ".join(f"w{w}" for w in (*group_words[g], *own))
            f.write(f"i{k}\t{words}\tabstract\n")
    # users take consecutive slices of the catalog shuffled within groups
    order = np.concatenate([1 + g * RT_GROUP + rng.permutation(RT_GROUP)
                            for g in rng.permutation(n_groups)])
    with open("TEXT/behaviors.tsv", "w") as f:
        for u, items in enumerate(np.array_split(order, RT_USERS)):
            f.write(f"u{u}\t" + " ".join(f"i{k}" for k in items) + "\n")


def cut_epochs(tr, steps: int) -> None:
    """Cuts each epoch of tr's batcher to its first `steps` batches."""
    epoch = tr.batcher.epoch
    tr.batcher.epoch = lambda e: itertools.islice(epoch(e), steps)


def text_trainer(dev, variant: str = "", **kw):
    """The text part's Trainer, data loaded and model built: the flagship
    widths with R_TEXT_VARIANTS[variant]'s flags and ``kw``, BERT-small
    from its config (random weights), the word tokenizer."""
    cfg = {**dict(root_data_dir="./", dataset="TEXT", news="news.tsv",
                  behaviors="behaviors.tsv", item_tower="modal",
                  bert_model_load="bert_small", max_seq_len=L,
                  embedding_dim=D, num_attention_heads=USER_HEADS,
                  transformer_block=BLOCKS, batch_size=TRAIN_B, lr=LR,
                  fine_tune_lr=FT_LR, drop_rate=DROP, dedup_items=True,
                  use_pallas=not variant, num_words_title=TITLE_LEN,
                  item_emb_batch_size=ENCODE_BATCH, epoch=1),
           **R_TEXT_VARIANTS[variant], **kw}
    bcfg = BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                      num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                      intermediate_size=FFN, max_position_embeddings=512,
                      hidden_dropout_prob=DROP,
                      attention_probs_dropout_prob=DROP)
    tower = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                      word_embedding_dim=HIDDEN, pooling="cls",
                      attr_lengths=(TITLE_LEN,), device=dev)
    tr = runner.Trainer(Config(**cfg), device=dev,
                        encoder_bundle=(tower, None, set(), HIDDEN),
                        tokenizer=WordTokenizer())
    tr.load_data()
    tr.build_model()
    return tr


def runner_text(dev, card: str, variant: str = "") -> dict:
    """Text MoRec at the flagship width through Trainer, with the flags of
    R_TEXT_VARIANTS[variant]: BERT-small from its config (random weights),
    SASRec D 512 (none under DSSM), bf16, dedup (not under DSSM, as in the
    JAX package), use_pallas for the in-batch CE; one epoch (DSSM's cut to
    RT_DSSM_STEPS steps), the valid eval over the whole catalog, the save,
    then a fresh Trainer in test mode whose valid eval is the run's
    bits. The fusion part ("CAT") also evaluates the untrained model."""
    what = f"text MoRec {variant}".strip()
    text_runner_data(np.random.default_rng(SEED + 20))

    def trainer(**kw):
        tr = text_trainer(dev, variant, **kw)
        if variant == "DSSM":
            cut_epochs(tr, RT_DSSM_STEPS)
        return tr

    with RunnerWatch() as watch:
        tr = trainer()
        untrained = tr.run_eval("valid") if variant == "CAT" else None
        best, best_epoch = tr.train()
        require(best_epoch == 1, f"{what} saved no checkpoint")
        te = trainer(mode="test", load_ckpt_name="epoch-1.pt")
        hit, ndcg = te.test()
        te.run_eval("valid")
    towers = ("BERT-small" + (" + an ID table, CAT" if variant == "CAT"
                              else "")
              + ("" if variant == "DSSM" else f" + SASRec D {D}"))
    cut = f" (an epoch of {RT_DSSM_STEPS} steps)" if variant == "DSSM" else ""
    print(f"runner {what}: {tr.item_num} items, {tr.batcher.n} samples{cut}, "
          f"{towers}, B {TRAIN_B}, bf16{'' if variant == 'DSSM' else ', dedup'}"
          f"{'' if variant else ', use_pallas'}: valid HR@10 {best:.6f} "
          f"nDCG@10 {tr.valid_results[1]['ndcg']:.6f}"
          + ("" if untrained is None else
             f" (untrained HR@10 {untrained[0]:.6f} nDCG@10 "
             f"{untrained[1]:.6f})")
          + f"; test reload HR@10 {hit:.6f} nDCG@10 {ndcg:.6f} [{card}]",
          flush=True)
    report_runner(what, card, tr, watch, tr.valid_results[1])
    require(tr.item_num == ITEM_NUM, "the text catalog lost items")
    same_eval(te.last_eval, tr.valid_results[1], f"runner {what}")
    train, evals = watch.launches()
    require_launched(train, TRAIN_KERNELS + (() if variant
                                             else PALLAS_KERNELS),
                     f"{what} training")
    require_launched(evals, RUNNER_EVAL_KERNELS, f"{what} evaluation")
    return counts()


def vision_runner_data(rng) -> None:
    """VISION/images.tsv, VISION/images.mkv (RV_ITEMS uint8 images of
    RV_SIDE px) and VISION/behaviors.tsv (RV_USERS users within groups of
    RV_GROUP items)."""
    os.makedirs("VISION", exist_ok=True)
    with open("VISION/images.tsv", "w") as f:
        f.writelines(f"v{k}\tx\n" for k in range(1, RV_ITEMS + 1))
    write_mkv("VISION/images.mkv", (
        (str(k).encode(), rng.integers(0, 256, (RV_SIDE, RV_SIDE, 3),
                                       dtype=np.uint8))
        for k in range(1, RV_ITEMS + 1)))
    with open("VISION/behaviors.tsv", "w") as f:
        for u in range(RV_USERS):
            g = u % (RV_ITEMS // RV_GROUP)
            items = 1 + g * RV_GROUP + rng.choice(
                RV_GROUP, size=int(rng.integers(6, 14)), replace=False)
            f.write(f"u{u}\t" + " ".join(f"v{k}" for k in items) + "\n")


def set_swin_kernels(model, kernels: str) -> None:
    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.kernels = kernels


def vision_runner_flags(variant: str = "") -> dict:
    """The vision part's configuration, R_VARIANTS[variant]'s flags
    added."""
    return dict(root_data_dir="./", dataset="VISION", news="images.tsv",
                behaviors="behaviors.tsv", image_store="images.mkv",
                image_resize=IMAGE, modality="vision", item_tower="modal",
                cv_model_load="swin_tiny", max_seq_len=V_L,
                embedding_dim=V_D, num_attention_heads=USER_HEADS,
                transformer_block=BLOCKS, lr=V_LR, fine_tune_lr=V_FT_LR,
                drop_rate=DROP, dedup_items=True, dedup_cap=RV_CAP,
                encoder_chunk=V_CAP_QUANTUM,
                item_emb_batch_size=ENCODE_BATCH,
                epoch=1 if variant else RV_EPOCHS,
                batch_size=RV_DSSM_B if variant == "DSSM" else V_TRAIN_B,
                **R_VARIANTS[variant])


def runner_vision(dev, card: str, variant: str = "") -> dict:
    """Vision MoRec through Trainer, with the flags of R_VARIANTS[variant]:
    Swin-T from its config (the CLI's load_encoder) under SASRec at V_D
    (none under DSSM) over an MKV store, images from the store through the
    native transform, chunks of V_CAP_QUANTUM images; RV_EPOCHS epochs for
    the in-batch CE (dedup), one for BCE (dedup over the positives and
    negatives) and DSSM (RV_DSSM_B users a step, no dedup, an epoch cut
    to RV_DSSM_STEPS steps); the full eval, the save, a fresh Trainer in
    test mode whose valid eval is the run's bits, and for the in-batch CE
    that eval again with the "windows" kernel selection."""
    what = f"vision MoRec {variant}".strip()
    vision_runner_data(np.random.default_rng(SEED + 21))
    cfg = vision_runner_flags(variant)

    def trainer(**kw):
        c = Config(**cfg, **kw)
        tr = runner.Trainer(c, device=dev,
                            encoder_bundle=runner.load_encoder(c, dev))
        tr.load_data()
        tr.build_model()
        if variant == "DSSM":
            cut_epochs(tr, RV_DSSM_STEPS)
        return tr

    with RunnerWatch() as watch:
        tr = trainer()
        best, best_epoch = tr.train()
        require(best_epoch > 0, f"{what} saved no checkpoint")
        te = trainer(mode="test", load_ckpt_name=f"epoch-{best_epoch}.pt")
        hit, ndcg = te.test()
        te.run_eval("valid")
        band = te.last_eval
        if not variant:
            set_swin_kernels(te.model, "windows")
            te.run_eval("valid")
            windows = te.last_eval
            set_swin_kernels(te.model, "band")
    towers = "Swin-T" + ("" if variant == "DSSM" else f" + SASRec D {V_D}")
    cut = f" (an epoch of {RV_DSSM_STEPS} steps)" if variant == "DSSM" else ""
    print(f"runner {what}: {tr.item_num} items, {tr.batcher.n} samples{cut}, "
          f"{towers}, B {cfg['batch_size']}, bf16, chunks of {V_CAP_QUANTUM}: best "
          f"valid HR@10 {best:.6f} at epoch {best_epoch}; test reload HR@10 "
          f"{hit:.6f} nDCG@10 {ndcg:.6f} [{card}]", flush=True)
    report_runner(what, card, tr, watch, tr.valid_results[best_epoch])
    same_eval(band, tr.valid_results[best_epoch], f"runner {what}")
    train, evals = watch.launches()
    if variant == "DSSM":
        require_launched(train, SWIN_TRAIN_KERNELS, f"{what} training")
        require_launched(evals, VISION_ENCODE_KERNELS, f"{what} evaluation")
        return counts()
    require_launched(train, VISION_TRAIN_KERNELS, f"{what} training")
    require_launched(evals, VISION_ENCODE_KERNELS + RUNNER_EVAL_KERNELS,
                     f"{what} evaluation")
    if not variant:
        print(f"runner {what}: valid under \"windows\" HR@10 "
              f"{windows['hit']:.6f} nDCG@10 {windows['ndcg']:.6f} [{card}]",
              flush=True)
        # HR@10 as hit counts: a float difference of two fractions of n
        # can round one ulp above 2 / n when exactly two users differ
        n = band["users"]
        require(abs(round(windows["hit"] * n) - round(band["hit"] * n)) <= 2
                and abs(windows["ndcg"] - band["ndcg"]) <= 2 / n,
                "the two kernel selections evaluate apart")
        require_launched(evals, VISION_WINDOWS_KERNELS,
                         f"{what} evaluation")
    return counts()


def runner_two_stage_text(dev, card: str) -> dict:
    """Text two-stage through Trainer(cfg, encoder_bundle=...,
    tokenizer=...), train_bert_lyr_8.py's flags (BCE, dnn_layers 8, l2
    0.01) over the text part's data: the frozen BERT-small tower
    (project=False) caches the 100_000 titles, the untrained head's valid
    HR@10, one epoch, the save, then a fresh Trainer in test mode (its own
    cache, drawn from the seed again) whose valid eval is the run's
    bits."""
    what = "text two-stage"
    text_runner_data(np.random.default_rng(SEED + 20))
    cfg = dict(root_data_dir="./", dataset="TEXT", news="news.tsv",
               behaviors="behaviors.tsv", item_tower="modal",
               stage="two_stage", loss="bce", dnn_layers=TS_DNN,
               l2_weight=TS_L2, fine_tune_l2_weight=TS_L2,
               bert_model_load="bert_small", max_seq_len=L, embedding_dim=D,
               num_attention_heads=USER_HEADS, transformer_block=BLOCKS,
               batch_size=TRAIN_B, lr=LR, drop_rate=DROP, dedup_items=True,
               num_words_title=TITLE_LEN, item_emb_batch_size=ENCODE_BATCH,
               epoch=1)

    def trainer(**kw):
        bcfg = BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                          num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                          intermediate_size=FFN, max_position_embeddings=512)
        tower = TextTower(BertModel(bcfg, device=dev), embedding_dim=D,
                          word_embedding_dim=HIDDEN, pooling="cls",
                          attr_lengths=(TITLE_LEN,), project=False,
                          device=dev)
        tr = runner.Trainer(Config(**cfg, **kw), device=dev,
                            encoder_bundle=(tower, None, set(), HIDDEN),
                            tokenizer=WordTokenizer())
        tr.load_data()
        tr.build_model()
        return tr

    with RunnerWatch() as watch:
        tr = trainer()
        hit0, ndcg0 = tr.run_eval("valid")
        best, best_epoch = tr.train()
        require(best_epoch == 1, f"{what} saved no checkpoint")
        te = trainer(mode="test", load_ckpt_name="epoch-1.pt")
        hit, ndcg = te.test()
        te.run_eval("valid")
    print(f"runner {what}: {tr.item_num} items cached {HIDDEN} wide by "
          f"BERT-small, {tr.batcher.n} samples, the head (dnn_layers "
          f"{TS_DNN}) + SASRec D {D}, B {TRAIN_B}, bf16, dedup: valid HR@10 "
          f"{best:.6f} nDCG@10 {tr.valid_results[1]['ndcg']:.6f} (untrained "
          f"HR@10 {hit0:.6f} nDCG@10 {ndcg0:.6f}); test reload HR@10 "
          f"{hit:.6f} nDCG@10 {ndcg:.6f} [{card}]", flush=True)
    report_runner(what, card, tr, watch, tr.valid_results[1])
    require(tr.item_num == ITEM_NUM and tr.encoder_bundle is None,
            f"{what}: the catalog lost items or the encoder was kept")
    same_eval(te.last_eval, tr.valid_results[1], f"runner {what}")
    train, evals = watch.launches()
    require_launched(train, TS_TRAIN_KERNELS, f"{what} training")
    require_launched(evals, RUNNER_EVAL_KERNELS, f"{what} evaluation")
    return counts()


def runner_two_stage_vision(dev, card: str) -> dict:
    """Vision two-stage through the CLI (run.main), hm_swin_tiny_lyr_8.py's
    flags (BCE, Swin-T frozen, dnn_layers 8, D 512, B 64, l2 0.01) over the
    vision part's MKV store: the untrained head's valid HR@10 (a Trainer of
    the same flags), RV_EPOCHS epochs, then --mode test on the best
    epoch-N.pt, whose valid eval is the run's bits."""
    what = "vision two-stage (CLI)"
    vision_runner_data(np.random.default_rng(SEED + 21))
    flags = dict(root_data_dir="./", dataset="VISION", news="images.tsv",
                 behaviors="behaviors.tsv", image_store="images.mkv",
                 image_resize=IMAGE, modality="vision", item_tower="modal",
                 stage="two_stage", loss="bce", cv_model_load="swin_tiny",
                 freeze_paras_before=10000, dnn_layers=TS_DNN, max_seq_len=L,
                 embedding_dim=D, num_attention_heads=USER_HEADS,
                 transformer_block=BLOCKS, batch_size=V_TRAIN_B, lr=V_LR,
                 l2_weight=TS_L2, fine_tune_l2_weight=TS_L2, drop_rate=DROP,
                 dedup_items=True, item_emb_batch_size=ENCODE_BATCH,
                 epoch=RV_EPOCHS)
    argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    untrained = runner.Trainer(parse_args(argv), smoke_log(), smoke_log())
    untrained.encoder_bundle = runner.load_encoder(untrained.cfg,
                                                   untrained.device)
    untrained.load_data()
    untrained.build_model()
    hit0, ndcg0 = untrained.run_eval("valid")
    del untrained
    with RunnerWatch() as watch:
        best, best_epoch = run.main(argv)
        trained = watch.trainers[-1]
        hit, ndcg = run.main(argv + ["--mode", "test", "--load_ckpt_name",
                                     f"epoch-{best_epoch}.pt"])
        tested = watch.trainers[-1]
        tested.run_eval("valid")
    print(f"runner {what}: {trained.item_num} items cached "
          f"{trained.item_content.shape[1]} wide by Swin-T (bf16), "
          f"{trained.batcher.n} samples, the head + SASRec D {D}, B "
          f"{V_TRAIN_B}, {RV_EPOCHS} epochs: best valid HR@10 {best:.6f} at "
          f"epoch {best_epoch} (untrained {hit0:.6f}, nDCG@10 {ndcg0:.6f}); "
          f"test reload HR@10 {hit:.6f} nDCG@10 {ndcg:.6f} [{card}]",
          flush=True)
    require(best_epoch > 0, f"{what} saved no checkpoint")
    require(trained.cfg.word_embedding_dim == D,
            f"{what}: the cache is not as wide as the tower's output (C9)")
    report_runner(what, card, trained, watch,
                  trained.valid_results[best_epoch])
    same_eval(tested.last_eval, trained.valid_results[best_epoch],
              f"runner {what}")
    train, evals = watch.launches()
    require_launched(train, VISION_ENCODE_KERNELS + TS_TRAIN_KERNELS,
                     f"{what} training")
    require_launched(evals, RUNNER_EVAL_KERNELS, f"{what} evaluation")
    return counts()


def runner_path(dev, card: str, kept: dict) -> dict:
    """The runner phase, each part in a temporary directory (data, logs and
    checkpoints there): IDRec through the CLI, text and vision MoRec
    through Trainer, each with the in-batch CE, BCE and DSSM
    (R_VARIANTS); then text two-stage through Trainer, vision two-stage
    through the CLI and text MoRec with the CAT fusion tower. The text and
    vision in-batch CE parts' directories stay, in kept["text"] and
    kept["vision"], for the special phase; the caller removes them. Returns
    the launches of all twelve."""
    launched = dict.fromkeys(WRAPPERS, 0)
    here = os.getcwd()
    parts = [(part, (variant,)) for part in (runner_idrec, runner_text,
                                            runner_vision)
             for variant in R_VARIANTS]
    parts += [(runner_two_stage_text, ()), (runner_two_stage_vision, ()),
              (runner_text, ("CAT",))]
    keep = {(runner_text, ("",)): "text", (runner_vision, ("",)): "vision"}
    for part, args in parts:
        tmp = tempfile.mkdtemp()
        os.chdir(tmp)
        try:
            got = part(dev, card, *args)
        finally:
            os.chdir(here)
            if (part, args) in keep:
                kept[keep[part, args]] = tmp
            else:
                shutil.rmtree(tmp)
        for n in launched:
            launched[n] += got[n]
        torch.cuda.empty_cache()
    return launched


@contextlib.contextmanager
def special_watch(launched: dict, trainers: list):
    """Counts into `launched` the launches inside every
    Trainer.run_special_eval that runs in the block, and appends each
    trainer that ran one to `trainers`."""
    inner = runner.Trainer.run_special_eval

    def counted(tr):
        before = counts()
        out = inner(tr)
        for n, c in counts().items():
            launched[n] += c - before[n]
        trainers.append(tr)
        return out

    runner.Trainer.run_special_eval = counted
    try:
        yield
    finally:
        runner.Trainer.run_special_eval = inner


def special_files(dataset: str, rng, users: int, n_new: int, keep: int,
                  new_name) -> None:
    """<dataset>/cold.tsv: the first `users` users' sequences (at most
    `keep` items); <dataset>/new.tsv: the next `users` users' inputs (at
    most keep - 1 items) and one of `n_new` new items, new_name(k) for k in
    1..n_new, drawn for each."""
    with open(f"{dataset}/behaviors.tsv") as f:
        rows = [ln.split("\t")[1].split(" ") for ln in f.read().split("\n")
                if ln]
    require(len(rows) >= 2 * users, f"{dataset}: fewer than {2 * users} "
            f"users")
    with open(f"{dataset}/cold.tsv", "w") as f:
        f.writelines(f"c{u}\t{' '.join(r[-keep:])}\n"
                     for u, r in enumerate(rows[:users]))
    with open(f"{dataset}/new.tsv", "w") as f:
        f.writelines(
            f"n{u}\t{' '.join(r[-keep:-1])} "
            f"{new_name(int(rng.integers(1, n_new + 1)))}\n"
            for u, r in enumerate(rows[users:2 * users]))


def report_special(what: str, card: str, tr) -> None:
    got = tr.special_results
    for split in ("cold", "new"):
        r = got[split]
        print(f"special {what}: {split} HR@10 {r['hit']:.6f} nDCG@10 "
              f"{r['ndcg']:.6f} over {r['users']} users in "
              f"{r['seconds']:.3f} s, {r['users_per_s']:.1f} users/s "
              f"[{card}]", flush=True)
    r = got["new"]
    print(f"special {what}: new-item encode {r['items']} items in "
          f"{r['encode_s']:.3f} s, {r['items_per_s']:.1f} items/s [{card}]",
          flush=True)


def special_on_cpu(dev, tr, what: str, tol: float, sub: int = 0) -> None:
    """The trainer's cold and new evaluation again on a CPU copy of its
    model through the plain versions, in float32 on both sides (the card's
    again where its run was bf16): the card's catalog table (its first
    `sub` rows besides re-encoded on the CPU within `tol`), the new items'
    embeddings within `tol`, the cold and new HR@10 as hit counts within
    two users and nDCG@10 within 2 / users."""
    cfg = tr.cfg
    base = os.path.join(cfg.root_data_dir, cfg.dataset)
    dic, n2i = tr._before_catalog(base)
    sc, hc, sn, hn, new_content = runner.read_behaviors_special(
        os.path.join(base, cfg.cold_behaviors),
        os.path.join(base, cfg.new_behaviors), tr.bd.item_name_to_id, dic,
        n2i, True)
    content = tr._new_item_content(base, new_content)
    images = cfg.modality == "vision"
    fn = tr.vision_pipe.images_for if images else None
    encoder = tr.model.encoder
    dtype = encoder.compute_dtype if images else None
    if images:
        encoder.compute_dtype = None
    try:
        table = runner.compute_item_embeddings(
            tr.model, tr.item_num, tr.item_content, cfg.embedding_dim,
            cfg.item_emb_batch_size, content_fn=fn)
        card_new = special_eval.encode_new_items(
            tr.model, content, cfg.item_emb_batch_size, images)
        card = (special_eval.eval_cold(tr.model, table, sc, hc,
                                       cfg.max_seq_len, cfg.eval_batch_size,
                                       per_user=True),
                special_eval.eval_new(tr.model, table, card_new, sn, hn,
                                      cfg.max_seq_len, cfg.eval_batch_size,
                                      per_user=True))
    finally:
        if images:
            encoder.compute_dtype = dtype
    m = copy.deepcopy(tr.model).cpu()
    if images:
        m.encoder.compute_dtype = None
    t0 = time.perf_counter()
    table = table.cpu()
    if sub:
        ids = np.arange(sub)
        with torch.no_grad(), eval_mode(m):
            rows = m.item_embs(torch.from_numpy(ids),
                               torch.from_numpy(fn(ids)))
        err = (rows - table[:sub]).abs().max().item()
        print(f"special {what}: the card's float32 table, rows 0-{sub - 1} "
              f"re-encoded on the CPU: largest error {err:.3e} (tol "
              f"{tol:g})", flush=True)
        require(err <= tol, f"special {what}: the card's table disagrees "
                f"with the plain path")
    plain_new = special_eval.encode_new_items(m, content,
                                              cfg.item_emb_batch_size, images)
    err = (plain_new - card_new.cpu()).abs().max().item()
    plain = (special_eval.eval_cold(m, table, sc, hc, cfg.max_seq_len,
                                    cfg.eval_batch_size, per_user=True),
             special_eval.eval_new(m, table, plain_new, sn, hn,
                                   cfg.max_seq_len, cfg.eval_batch_size,
                                   per_user=True))
    print(f"special {what}: CPU plain path {time.perf_counter() - t0:.1f} s; "
          f"the new items' embeddings, largest error {err:.3e} (tol "
          f"{tol:g})", flush=True)
    require(err <= tol, f"special {what}: the new items' embeddings "
            f"disagree with the plain path")
    for split, (hk, nk, hits_k, _), (hp, np_, hits_p, _) in zip(
            ("cold", "new"), card, plain):
        n = len(hits_p)
        print(f"special {what}: {split} float32 HR@10 {hk:.6f} nDCG@10 "
              f"{nk:.6f} on the card, {hp:.6f} {np_:.6f} on the CPU, "
              f"{int((hits_k != hits_p).sum())} of {n} users' hits differ",
              flush=True)
        require(abs(round(hk * n) - round(hp * n)) <= 2
                and abs(nk - np_) <= 2 / n,
                f"special {what}: the {split} evaluation disagrees with "
                f"the plain path")


def special_path(dev, card: str, kept: dict) -> dict:
    """Cold and new-item evaluation (ROADMAP A5) of the runner's trained
    in-batch CE models at the flagship widths, in their directories
    (runner_path's kept), the counters set to 0: text MoRec (BERT-small +
    SASRec D 512, L 20) through Trainer.test() in test mode on the saved
    epoch-1.pt, its RS_NEW new titles appended to TEXT/news.tsv, which no
    behaviour holds; vision MoRec (Swin-T + SASRec D 2048, L 10) through
    the CLI (--mode test on the best checkpoint), its RSV_NEW new images in
    a second MKV store (--new_image_store) listed in their own manifest
    (--new_items). Every kernel of the evaluation launched inside it (and
    Swin's band-path forward ones for vision); users/s of each evaluation
    and items/s of the new-item encode; each evaluation held against a CPU
    copy (special_on_cpu). Returns the launches inside the two special
    evaluations."""
    launched, trainers = dict.fromkeys(WRAPPERS, 0), []
    here = os.getcwd()
    rng = np.random.default_rng(SEED + 50)
    try:
        os.chdir(kept["text"])
        with open("TEXT/news.tsv", "a") as f:
            f.writelines(f"i{ITEM_NUM + k}\t"
                         + " ".join(f"w{w}" for w in rng.integers(
                             1000, VOCAB, size=int(rng.integers(4, 20))))
                         + "\tabstract\n" for k in range(1, RS_NEW + 1))
        special_files("TEXT", rng, RS_USERS, RS_NEW, L + 1,
                      lambda k: f"i{ITEM_NUM + k}")
        te = text_trainer(dev, mode="test", load_ckpt_name="epoch-1.pt",
                          cold_behaviors="cold.tsv", new_behaviors="new.tsv")
        require(runner.get_checkpoint(te.model_dir, "epoch-1.pt"),
                "special: the text part's epoch-1.pt is gone")
        reset_counts()
        with special_watch(launched, trainers):
            te.test()
        require(trainers == [te], "text: Trainer.test() ran no special eval")
        text_launched = dict(launched)
        report_special("text MoRec", card, te)
        require_launched(text_launched, RUNNER_EVAL_KERNELS,
                         "special text evaluation")
        special_on_cpu(dev, te, "text MoRec", TABLE_TOL)
        del te
        torch.cuda.empty_cache()

        os.chdir(kept["vision"])
        keys = range(RV_ITEMS + 1, RV_ITEMS + RSV_NEW + 1)
        write_mkv("VISION/new.mkv", (
            (str(k).encode(), rng.integers(0, 256, (RV_SIDE, RV_SIDE, 3),
                                           dtype=np.uint8)) for k in keys))
        with open("VISION/all_images.tsv", "w") as f:
            f.writelines(f"v{k}\tx\n" for k in range(1, keys[-1] + 1))
        special_files("VISION", rng, RSV_USERS, RSV_NEW, V_L + 1,
                      lambda k: f"v{RV_ITEMS + k}")
        flags = {**vision_runner_flags(), "mode": "test",
                 "load_ckpt_name": "latest", "cold_behaviors": "cold.tsv",
                 "new_behaviors": "new.tsv", "new_items": "all_images.tsv",
                 "new_image_store": "new.mkv"}
        argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
        require(runner.latest_checkpoint(parse_args(argv).model_dir()),
                "special: the vision part saved no checkpoint")
        with special_watch(launched, trainers):
            run.main(argv)
        require(len(trainers) == 2, "vision: the CLI ran no special eval")
        tv = trainers[-1]
        vision_launched = {n: launched[n] - text_launched[n]
                           for n in launched}
        report_special("vision MoRec (CLI)", card, tv)
        require_launched(vision_launched,
                         VISION_ENCODE_KERNELS + RUNNER_EVAL_KERNELS,
                         "special vision evaluation")
        special_on_cpu(dev, tv, "vision MoRec", V_TABLE_TOL, RS_SUB)
    finally:
        os.chdir(here)
        for d in kept.values():
            shutil.rmtree(d, ignore_errors=True)
    print(f"special launches {launched}", flush=True)
    return launched


# -- the other vision encoders (ROADMAP A7): ResNet-50 and three ViTs --------
# variants/*/train_resnet50.py (in-batch CE, BCE, DSSM): 224 x 224 images,
# embedding_dim 512, the Config's SASRec (2 blocks of 2 heads, L 20),
# dropout 0.1, lr and fine_tune_lr 1e-4, l2 0.01 in both groups; bf16
Z_D, Z_L = 512, 20
Z_LAUNCHER = dict(lr=1e-4, fine_tune_lr=1e-4, l2_weight=0.01,
                  fine_tune_l2_weight=0.01, drop_rate=DROP)
Z_ENCODE_CHUNKS = 4         # catalog encode: chunks of ENCODE_BATCH images
Z_REQUESTS = (1, 64)
Z_CHECK_USERS = 2           # users of the float32 step against the CPU
# users a ResNet-50 train step: the launchers' 64 (1 344 slots) do not fit
# one card without encoder chunks, which BatchNorm rules out (the phase
# prints the reckoning); Zipf ids with dedup as bench.py's vision traffic
R50_USERS, R50_FIXED, R50_TIMED = 16, 2, 5
# the runner part: the three launchers through the CLI on the vision
# runner's data, one epoch each; CE and BCE at R50_USERS users a step
# (without dedup, as the launchers), DSSM at the launchers' 64 (2 images a
# user)
R50_RUNNER = {"": dict(batch_size=R50_USERS),
              "BCE": dict(loss="bce", batch_size=R50_USERS),
              "DSSM": dict(loss="bce", user_tower="dssm", neg_num=1,
                           dnn_layers=0, batch_size=64)}
# ViT-MAE-B/16, BEiT-B/16 and CLIP-B/32 at their default widths under the
# same SASRec: (tokens an image in training, the MLP's activation)
VITS = {"vit_mae": (1 + 49, "gelu"), "beit": (197, "gelu"),
        "clip": (50, "quick_gelu")}
VIT_USERS, VIT_FIXED, VIT_TIMED = 16, 2, 3
# the SASRec kernels of a train step and of an encode or request
Z_TRAIN_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_proj_resln_res",
                   "fused_proj_resln_bwd", "fused_mlp_resln_res",
                   "fused_mlp_resln_bwd")
Z_SERVE_KERNELS = ("fused_mha", "fused_proj_resln", "fused_mlp_resln")
# the ViTs' MLP on the way: fused_mlp (training, and BEiT's encode),
# fused_mlp_res (MAE's and CLIP's encode), the backward's wg route at
# C = 768 (premlp_bwd_gdh)
VIT_KERNELS = ("fused_mlp", "fused_mlp_bwd", "premlp_bwd_gdh")


def zoo_config(name: str, compute_dtype: str = "bfloat16", **kw) -> Config:
    return Config(item_tower="modal", user_tower="sasrec", stage="end2end",
                  modality="vision", cv_model_load=name, embedding_dim=Z_D,
                  max_seq_len=Z_L, loss="inbatch_ce",
                  compute_dtype=compute_dtype, **Z_LAUNCHER, **kw)


def zoo_model(dev, cfg):
    """The encoder of cfg.cv_model_load at its default geometry
    (build_vision_tower) under SASRec; weights from the seed."""
    tower = build_vision_tower(cfg, device=dev)[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    return make_model(cfg, V_ITEMS_FULL, tower, device=dev, generator=gen)


def zoo_batches(rng, n: int, users: int) -> tuple:
    """n host batches of `users` users as bench.py draws the vision
    traffic (Zipf(1.2) ids, its log mask) at L = Z_L, and the dedup cap
    that holds each one's unique items (rounded up to V_CAP_QUANTUM)."""
    out = [(np.minimum(rng.zipf(ZIPF_A, size=(users, Z_L + 1)),
                       V_ITEMS_FULL).astype(np.int64),
            bench_log_mask(rng, users, Z_L)) for _ in range(n)]
    most = max(len(np.unique(ids)) for ids, _ in out)
    return out, -(-most // V_CAP_QUANTUM) * V_CAP_QUANTUM


def zoo_encode(model, card: str, content_fn, what: str) -> torch.Tensor:
    """A catalog of Z_ENCODE_CHUNKS chunks (after one warm chunk): the
    table, finite, and its items/s."""
    items = Z_ENCODE_CHUNKS * ENCODE_BATCH
    Retriever.encode_catalog(model, ENCODE_BATCH - 1, None, Z_D,
                             batch_size=ENCODE_BATCH, content_fn=content_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, items - 1, None, Z_D,
                                     batch_size=ENCODE_BATCH,
                                     content_fn=content_fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(tuple(table.shape) == (items, Z_D)
            and bool(torch.isfinite(table).all()),
            f"{what}: catalog table {tuple(table.shape)} not finite")
    print(f"{what} catalog encode: {items} images (224 x 224, bf16, chunks "
          f"of {ENCODE_BATCH}) in {seconds:.3f} s, {items / seconds:.1f} "
          f"images/s [{card}]", flush=True)
    return table


def zoo_train(dev, card: str, cfg, pool, users: int, fixed: int, timed: int,
              what: str) -> tuple:
    """`fixed` steps on one batch, then `timed` steps on distinct batches,
    each packed and copied inside its timed step: the losses (finite;
    their gradients are held in zoo_check), p50, samples/s, images/s, peak
    device memory. Returns (model, images a step, peak bytes, bytes before
    the first step)."""
    batches, cap = zoo_batches(np.random.default_rng(SEED + 32),
                               timed + 1, users)
    cfg = dataclasses.replace(cfg, dedup_cap=cap)
    model = zoo_model(dev, cfg)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg, log_pop=log_popularity(dev))
    first = vision_device_batch(*batches[0], cap, pool, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, first).item() for _ in range(fixed)]
    walls = []
    for ids, lm in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, vision_device_batch(ids, lm, cap, pool,
                                                      dev)).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), f"{what}: a loss is not "
            f"finite: {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"{what}: a parameter is not finite after training")
    p50 = statistics.median(walls)
    print(f"{what} train step: B={users} L={Z_L} D={Z_D} bf16, dropout "
          f"{DROP}, Zipf ids, dedup cap {cap} images: {fixed} steps on one "
          f"batch, loss {losses[0]:.5f} -> {losses[fixed - 1]:.5f}; then "
          f"{timed} distinct batches: p50 {p50:.3f} ms (min {min(walls):.3f}, "
          f"max {max(walls):.3f}), {users / p50 * 1e3:.2f} samples/s, "
          f"{cap / p50 * 1e3:.1f} images/s through the tower, peak device "
          f"memory {peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    return model, cap, peak, base


def resnet_serve(dev, card: str, content_fn) -> None:
    """ResNet-50 MoRec's catalog encode and recommend p50 at B = 1 and
    64."""
    model = zoo_model(dev, zoo_config("resnet50"))
    table = zoo_encode(model, card, content_fn, "resnet50")
    rng = np.random.default_rng(SEED + 33)
    requests = {B: vision_histories(rng, B, table.shape[0] - 1)
                for B in Z_REQUESTS}
    engine = Retriever(model, table, max_seq_len=Z_L,
                       batch_sizes=Z_REQUESTS)
    for B, h in requests.items():
        ids, vals = engine.recommend(h, top_k=TOP_K)
        require(ids.shape == (B, TOP_K) and np.isfinite(vals).all(),
                f"resnet50 recommend B={B}: {ids.shape}")
        check_results(ids, h, Z_L)
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            engine.recommend(h, top_k=TOP_K)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"resnet50 recommend B={B} top_k={TOP_K} L={Z_L} D={Z_D}: p50 "
              f"{statistics.median(walls[5:]):.3f} ms over 20 requests "
              f"[{card}]", flush=True)


def running_stats(model) -> dict:
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith((".mean", ".var"))}


def zoo_check(dev, card: str, name: str, pool) -> None:
    """One float32 step in training mode on Z_CHECK_USERS users (dropout
    drawn from the same seed on both sides) on the card and through the
    plain path on a CPU copy of the model: the loss and, for a ResNet,
    every BatchNorm running average after the step within the CPU parity
    tests' 1e-5, and every gradient by the vision gradient check's rule
    and tolerance (for a ResNet: the SASRec kink share up to Z_KINK_SHARE,
    the body's gradients reported, Z_BODY)."""
    ids, lm = zoo_batches(np.random.default_rng(SEED + 34), 1,
                          Z_CHECK_USERS)[0][0]
    cap = -(-len(np.unique(ids)) // 4) * 4
    cfg = zoo_config(name, "float32", dedup_cap=cap)
    runs = []
    for where in (dev, torch.device("cpu")):
        model = zoo_model(dev, cfg).to(where)
        state = make_train_state(model, cfg, param_labels(model), seed=SEED)
        step = make_train_step(cfg, log_pop=log_popularity(where))
        relu_in = []
        t0 = time.perf_counter()
        with relu_inputs(relu_in):
            loss = step(state, vision_device_batch(ids, lm, cap, pool,
                                                   where)).item()
        runs.append((loss, time.perf_counter() - t0, {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            relu_in, {n: b.cpu() for n, b in running_stats(model).items()}))
    (lk, sk, gk, hk, bk), (lp, sp, gp, hp, bp) = runs
    loss_err = abs(lk - lp) / abs(lp)
    top = max(g.abs().max().item() for g in gp.values())
    kinks, kink_note = kink_units(hk, hp, BLOCKS,
                                  Z_KINK_SHARE if bp else V_KINK_SHARE)
    worst, worst_name = (-1.0, 0.0, 0.0), None
    body, body_name = -1.0, ""
    for n, want in gp.items():
        scale = max(want.abs().max().item(), GRAD_FLOOR * top)
        diff = (gk[n] - want).abs()
        if n in kinks:
            diff = diff[..., ~kinks[n]]
        if bp and n.startswith("encoder.net.") and ".fc." not in n:
            # a ResNet's body: reported, not held (Z_BODY)
            body, body_name = max((body, body_name),
                                  (diff.max().item() / scale, n))
        elif diff.max().item() / scale >= worst[0]:
            worst, worst_name = (diff.max().item() / scale,
                                 diff.max().item(), scale), n
    stats_err = max([((bk[n] - b).abs() / b.abs().clamp_min(1.0)).max()
                     .item() for n, b in bp.items()] or [0.0])
    print(f"{name} float32 step on {Z_CHECK_USERS} users ({cap} images), "
          f"card {sk:.2f} s vs CPU plain path {sp:.2f} s: loss {lk:.7f} vs "
          f"{lp:.7f}, rel err {loss_err:.3e} (tol {Z_LOSS_TOL:g}); "
          f"largest gradient error {worst[1]:.3e} on a scale of "
          f"{worst[2]:.3e} in {worst_name} (tol {V_STEP_GRAD_TOL:g}); "
          f"{len(bp)} running averages, largest error {stats_err:.3e} (tol "
          f"{Z_STATS_TOL:g}); {kink_note}"
          + (f"; the ResNet body's gradients (not held, Z_BODY): largest "
             f"error {body:.3e} of the scale in {body_name}" if bp else "")
          + f" [{card}]", flush=True)
    require(math.isfinite(loss_err) and loss_err <= Z_LOSS_TOL,
            f"{name}: the float32 loss disagrees with the CPU")
    require(worst[0] <= V_STEP_GRAD_TOL, f"{name}: the gradient of "
            f"{worst_name} disagrees with the CPU")
    require(stats_err <= Z_STATS_TOL, f"{name}: a running average "
            f"disagrees with the CPU")


def resnet_runner(dev, card: str) -> dict:
    """The three train_resnet50.py launchers through the CLI (run.main) on
    the vision runner's data (an MKV store of RV_ITEMS images), one epoch
    each, then --mode test on the saved epoch: the reload's valid
    evaluation is the run's in every bit, the running means moved; every
    SASRec kernel of training and evaluation launched (DSSM has no SASRec:
    none). Returns the three parts' launches."""
    here = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="smoke_resnet_")
    launched = []
    try:
        os.chdir(tmp)
        vision_runner_data(np.random.default_rng(SEED + 21))
        for variant, kw in R50_RUNNER.items():
            what = f"resnet50 {variant or 'CE'}"
            flags = {**vision_runner_flags(), **Z_LAUNCHER, **kw,
                     "cv_model_load": "resnet50", "embedding_dim": Z_D,
                     "max_seq_len": Z_L, "dedup_items": False,
                     "encoder_chunk": 0, "epoch": 1,
                     "label_screen": what.replace(" ", "_")}
            argv = [f"--{k}={v}" for k, v in flags.items()]
            with RunnerWatch() as watch:
                best, best_epoch = run.main(argv)
                require(best_epoch == 1, f"runner {what} saved no "
                        f"checkpoint")
                hit, ndcg = run.main(argv + ["--mode=test",
                                             "--load_ckpt_name=epoch-1.pt"])
                tr, te = watch.trainers
                te.run_eval("valid")
            same_eval(te.last_eval, tr.valid_results[1], f"runner {what}")
            print(f"runner {what}: {tr.item_num} items, B "
                  f"{flags['batch_size']}, ResNet-50 bf16: valid HR@10 "
                  f"{best:.6f}; test reload HR@10 {hit:.6f} nDCG@10 "
                  f"{ndcg:.6f} [{card}]", flush=True)
            report_runner(what, card, tr, watch, tr.valid_results[1])
            means = [b for n, b in running_stats(tr.model).items()
                     if n.endswith(".mean")]
            require(all(bool(b.any()) for b in means),
                    f"runner {what}: a running mean never moved")
            train, evals = watch.launches()
            if variant != "DSSM":
                require_launched(train, Z_TRAIN_KERNELS, f"runner {what} "
                                 f"training")
                require_launched(evals, Z_SERVE_KERNELS, f"runner {what} "
                                 f"evaluation")
            launched.append(counts())
    finally:
        os.chdir(here)
        shutil.rmtree(tmp, ignore_errors=True)
    return add_counts(*launched)


def resnet_path(dev, card: str, pool: np.ndarray) -> dict:
    """Phase "resnet": ResNet-50 MoRec at full width, the counters set to 0
    first: the catalog encode and recommend, the bf16 train step (the
    running averages moved and finite), the reckoning of the launchers'
    batch, the runner's three launchers; then a float32 step against the
    CPU. Returns the launches of the main path."""
    content_fn = pool_content(torch.from_numpy(pool).to(dev))
    reset_counts()
    resnet_serve(dev, card, content_fn)
    served = counts()
    require_launched(served, Z_SERVE_KERNELS, "resnet50 serving")
    torch.cuda.empty_cache()
    cfg = zoo_config("resnet50")
    model, images, peak, base = zoo_train(dev, card, cfg, pool, R50_USERS,
                                          R50_FIXED, R50_TIMED, "resnet50")
    stats = running_stats(model)
    moved = sum(not torch.equal(b, torch.zeros_like(b)
                                if n.endswith(".mean") else
                                torch.ones_like(b))
                for n, b in stats.items())
    require(all(bool(torch.isfinite(b).all()) for b in stats.values())
            and moved == len(stats), f"resnet50: {len(stats) - moved} of "
            f"{len(stats)} running averages never moved or not finite")
    # the launchers' batch: 64 users x (L + 1) slots, without dedup as they
    # run, and with dedup on this traffic
    slots = 64 * (Z_L + 1)
    _, cap64 = zoo_batches(np.random.default_rng(SEED + 35), 4, 64)
    per = (peak - base) / images
    print(f"resnet50 memory: {(peak - base) / 2 ** 30:.2f} GiB of "
          f"activations for {images} images, {per / 2 ** 20:.1f} MiB an "
          f"image; the launchers' B 64 would hold {slots} images "
          f"({slots * per / 2 ** 30:.1f} GiB) without dedup and {cap64} "
          f"with it ({cap64 * per / 2 ** 30:.1f} GiB), beside "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f} "
          f"GiB on the card: the smoke trains {R50_USERS} users a step "
          f"[{card}]", flush=True)
    trained = counts()
    require_launched({n: trained[n] - served[n] for n in trained},
                     Z_TRAIN_KERNELS, "resnet50 training")
    del model
    torch.cuda.empty_cache()
    ran = resnet_runner(dev, card)
    launched = add_counts(trained, ran)
    torch.cuda.empty_cache()
    zoo_check(dev, card, "resnet50", pool)
    return launched


def vit_kernel_cases(dev, images: dict) -> tuple:
    """kernel_phase and gradient_cases tuples of the ViTs' MLP at each
    encoder's shapes, bfloat16: the training forward (fused_mlp, save_h)
    and its backward at the train step's images, and the encode's edition
    (fused_mlp_res; BEiT's fused_mlp) for a chunk of ENCODE_BATCH images;
    C 768, F 3072, each encoder's activation."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    g = lambda *s, scale=1.0, dt=torch.float32: (torch.randn(
        *s, generator=gen, device=dev) * scale).to(dt)
    C, Fw, dt = 768, 3072, torch.bfloat16
    fwd, bwd = [], []
    for name, (tokens, act) in VITS.items():
        mlp = [g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1),
               g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1)]
        ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
        enc = 197 if name == "beit" else tokens
        M = ENCODE_BATCH * enc
        x = g(M, C, dt=dt)
        label = f"{name} encode M={M} C={C} F={Fw} {act} bf16"
        yard = (lambda x=x, mlp=mlp: mlp_products(x, mlp[0].to(dt),
                                                  mlp[2].to(dt)))
        if name == "beit":
            fwd.append(("fused_mlp", label, dt,
                        lambda x=x, mlp=mlp, ln=ln, act=act: fused_mlp(
                            x, *mlp, ln=ln, eps=1e-12, act=act),
                        lambda x=x, mlp=mlp, ln=ln, act=act: fused_mlp_plain(
                            x, *mlp, ln=ln, eps=1e-12, act=act),
                        mlp_work(M, C, Fw, 2), None, yard))
        else:
            fwd.append(("fused_mlp_res", f"unit {label}", dt,
                        lambda x=x, mlp=mlp, ln=ln, act=act: fused_mlp_res(
                            x, None, *mlp, ln=ln, eps=1e-6, act=act),
                        lambda x=x, mlp=mlp, ln=ln, act=act:
                            fused_mlp_res_plain(x, None, *mlp, ln=ln,
                                                eps=1e-6, act=act),
                        mlp_work(M, C, Fw, 2), None, yard))
        M = images[name] * tokens
        x = g(M, C, dt=dt)
        label = f"{name} train M={M} C={C} F={Fw} {act} bf16"
        fwd.append(("fused_mlp", f"save_h {label}", dt,
                    lambda x=x, mlp=mlp, ln=ln, act=act: fused_mlp(
                        x, *mlp, ln=ln, eps=1e-6, act=act, save_h=True),
                    lambda x=x, mlp=mlp, ln=ln, act=act: fused_mlp_plain(
                        x, *mlp, ln=ln, eps=1e-6, act=act, save_h=True),
                    mlp_work(M, C, Fw, 2, saved=True), None,
                    lambda x=x, mlp=mlp: mlp_products(x, mlp[0].to(dt),
                                                      mlp[2].to(dt))))
        bwd.append((None, "fused_mlp_bwd", f"save_h {label}", dt,
                    [x] + mlp + ln, g(M, C, dt=dt),
                    lambda *a, act=act: fused_mlp(
                        *a[:5], ln=a[5:], eps=1e-6, act=act, save_h=True),
                    lambda *a, act=act: fused_mlp_plain(
                        *a[:5], ln=a[5:], eps=1e-6, act=act, save_h=True),
                    premlp_bwd_work(M, C, Fw, 2), None))
    return fwd, bwd


def vit_path(dev, card: str, pool: np.ndarray) -> tuple:
    """Phase "vit": ViT-MAE-B/16, BEiT-B/16 and CLIP-B/32 at their default
    widths under SASRec, the counters set to 0 first: each one's catalog
    encode and bf16 train steps; then their MLP kernels against the plain
    versions at each one's shapes (forward, training forward, backward),
    and CLIP's float32 step against the CPU (quick_gelu's backward).
    Returns (the main path's launches, the kernel results)."""
    content_fn = pool_content(torch.from_numpy(pool).to(dev))
    images = {}
    reset_counts()
    for name in VITS:
        model = zoo_model(dev, zoo_config(name))
        zoo_encode(model, card, content_fn, name)
        del model
        torch.cuda.empty_cache()
        model, images[name], _, _ = zoo_train(
            dev, card, zoo_config(name), pool, VIT_USERS, VIT_FIXED,
            VIT_TIMED, name)
        del model
        torch.cuda.empty_cache()
    launched = counts()
    print(f"vit launches {launched}", flush=True)
    require_launched(launched, VIT_KERNELS + ("fused_mlp_res",)
                     + Z_TRAIN_KERNELS, "vit")
    fwd, bwd = vit_kernel_cases(dev, images)
    kernels = kernel_phase(dev, card, fwd, reps=FEW_REPS, f32_tf32x3=True)
    merge(kernels, gradient_cases(bwd, card, reps=VB_REPS))
    del fwd, bwd
    torch.cuda.empty_cache()
    zoo_check(dev, card, "clip", pool)
    return launched, kernels


# The text encoder zoo (ROADMAP A7b): OPT-125M and DeBERTa-base at their
# published geometries (the keys of their published config.json: hidden
# 768, 12 layers of 12 heads, FFN 3072, vocab 50 272 / 50 265), weights
# drawn from the seed, built through runner.load_encoder from a model
# directory that holds that config.json alone, under the flagship's SASRec
# (D 512, L 20): serving in float32, training the flagship's bf16 step on
# its traffic (B 128, Zipf ids, dedup). A title of TITLE_LEN tokens drawn
# over each tower's vocabulary.
TZ_CONFIGS = {
    "opt-125m": dict(model_type="opt", vocab_size=50272, hidden_size=768,
                     num_hidden_layers=12, num_attention_heads=12,
                     ffn_dim=3072, max_position_embeddings=2048,
                     do_layer_norm_before=True, word_embed_proj_dim=768,
                     dropout=0.1, attention_dropout=0.0,
                     activation_function="relu", pad_token_id=1),
    "deberta-base": dict(model_type="deberta", vocab_size=50265,
                         hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, intermediate_size=3072,
                         max_position_embeddings=512,
                         max_relative_positions=-1, relative_attention=True,
                         pos_att_type="c2p|p2c", position_biased_input=False,
                         type_vocab_size=0, layer_norm_eps=1e-7,
                         hidden_dropout_prob=0.1,
                         attention_probs_dropout_prob=0.1, pad_token_id=0)}
TZ_C, TZ_F = 768, 3072
TZ_ENCODE_LIMIT_S = 30.0    # the full catalog only if it encodes this fast
TZ_PROBE_CHUNKS = 2
TZ_ITEMS_CUT = V_ITEMS_CUT
TZ_SUB_ITEMS = SUB_ITEMS    # sub-catalog held against the plain path
TZ_OPT_FIXED, TZ_OPT_TIMED = FIXED_STEPS, TIMED_STEPS
TZ_DEBERTA_STEPS = 10
TZ_CHECK_USERS = 4          # users of each float32 gradient check
# the towers' kernels: the OPT encode's FFN (fused_mlp_res, unit), the
# training FFN of both (fused_mlp with save_h; its backward, on the wg
# route in bf16), the word tables' gradient; SASRec's kernels beside them
TZ_OPT_ENCODE_KERNELS = ("fused_mlp_res",)
TZ_TRAIN_KERNELS = ("fused_mlp", "fused_mlp_bwd", "premlp_bwd_gdh",
                    "scatter_add_rows") + TRAIN_KERNELS
TZ_DEBERTA_ENCODE_KERNELS = ("fused_mlp",)


def text_zoo_dir(root: str) -> str:
    """A pretrained_models_dir holding each tower's config.json alone."""
    for name, conf in TZ_CONFIGS.items():
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, "config.json"), "w") as f:
            json.dump(conf, f)
    return root


def text_zoo_config(root: str, name: str, **train) -> Config:
    return model_config(modality="text", bert_model_load=name,
                        pretrained_models_dir=root,
                        num_words_title=TITLE_LEN, **train)


def text_zoo_model(dev, cfg, seed: int):
    """The tower of cfg.bert_model_load through runner.load_encoder (no
    weights there: drawn from the seed with the rest) under SASRec."""
    tower, state, frozen, width = runner.load_encoder(cfg, dev)
    require(state is None and width == TZ_C and len(frozen) == 0,
            f"{cfg.bert_model_load}: bundle {width} wide, frozen "
            f"{len(frozen)}, weights {state is not None}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_model(cfg, ITEM_NUM, tower, device=dev, generator=gen)


def text_zoo_kernel_cases(dev, titles: int) -> tuple:
    """kernel_phase and gradient_cases tuples of rows 5-6 at the towers'
    editions, C 768, F 3072, bf16 and float32: OPT's encode chunk
    (fused_mlp_res unit, ReLU, ENCODE_BATCH titles), the training FFN of
    OPT (fused_mlp with its LayerNorm, ReLU, save_h) and of DeBERTa
    (fused_mlp without one, exact GELU, save_h) at `titles` titles; each
    group named for the kernels line. A float32 ReLU backward's plain
    version takes the kernel's branch at the kink (premlp_at_kink)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    g = lambda *s, scale=1.0, dt=torch.float32: (torch.randn(
        *s, generator=gen, device=dev) * scale).to(dt)
    C, Fw = TZ_C, TZ_F
    fwd = {"opt encode": [], "opt train": [], "deberta train": []}
    bwd = {"opt train": [], "deberta train": []}
    for dt in (torch.bfloat16, torch.float32):
        tag, it = tag_of(dt), size_of(dt)
        mlp = [g(C, Fw, scale=C ** -0.5), g(Fw, scale=0.1),
               g(Fw, C, scale=Fw ** -0.5), g(C, scale=0.1)]
        ln = [1.0 + g(C, scale=0.1), g(C, scale=0.1)]
        M = ENCODE_BATCH * TITLE_LEN
        x = g(M, C, dt=dt)
        fwd["opt encode"].append((
            "fused_mlp_res", f"OPT encode unit M={M} C={C} F={Fw} relu {tag}",
            dt, lambda x=x, mlp=mlp, ln=ln: fused_mlp_res(
                x, None, *mlp, ln=ln, eps=1e-5, act="relu"),
            lambda x=x, mlp=mlp, ln=ln: fused_mlp_res_plain(
                x, None, *mlp, ln=ln, eps=1e-5, act="relu"),
            mlp_work(M, C, Fw, it), None,
            lambda x=x, mlp=mlp, dt=dt: mlp_products(x, mlp[0].to(dt),
                                                     mlp[2].to(dt))))
        M = titles * TITLE_LEN
        for who, lnw, act in (("opt train", ln, "relu"),
                              ("deberta train", None, "gelu")):
            x = g(M, C, dt=dt)
            label = (f"{'OPT' if who[0] == 'o' else 'DeBERTa'} train save_h "
                     f"{'LN' if lnw else 'no LN'} M={M} C={C} F={Fw} {act} "
                     f"{tag}")
            kw = dict(ln=lnw, eps=1e-5, act=act, save_h=True)
            fwd[who].append((
                "fused_mlp", label, dt,
                lambda x=x, mlp=mlp, kw=kw: fused_mlp(x, *mlp, **kw),
                lambda x=x, mlp=mlp, kw=kw: fused_mlp_plain(x, *mlp, **kw),
                mlp_work(M, C, Fw, it, saved=True), None,
                lambda x=x, mlp=mlp, dt=dt: mlp_products(
                    x, mlp[0].to(dt), mlp[2].to(dt))))
            kink = None
            if act == "relu":
                kink = lambda *a: premlp_at_kink(*a, save_h=True)
            bwd[who].append((
                None, "fused_mlp_bwd", label, dt, [x] + mlp + (lnw or []),
                g(M, C, dt=dt),
                lambda *a, act=act: fused_mlp(*a[:5], ln=a[5:] or None,
                                              eps=1e-5, act=act, save_h=True),
                lambda *a, act=act: fused_mlp_plain(
                    *a[:5], ln=a[5:] or None, eps=1e-5, act=act,
                    save_h=True),
                premlp_bwd_work(M, C, Fw, it), None, None, None, kink))
    fwd["opt encode"].reverse()     # the headline: the served float32
    return fwd, bwd


def premlp_at_kink(x, w1, b1, w2, b2, *ln, save_h: bool):
    """The ReLU pre-LN MLP's plain version that the kernel is held to
    (relu_at_kink's rule for rows 5-6): fused_mlp_plain with ReLU's branch
    taken from the h of the card's backward (premlp_bwd_h) where the plain
    h lies within rounding of 0 (relu_kink: float32's sums, and in bf16
    the roundings of the normalised x, which two LayerNorms may round
    apart), and a line that says at how many pre-activations, how many of
    them on the other side; premlp_kink_census raises past its caps."""
    lnp = ln or None
    with torch.no_grad():
        h_k = premlp_bwd_h(x, w1, b1, w2, b2, ln=lnp, eps=1e-5, act="relu",
                           save_h=save_h)
    n, marked, flips = premlp_kink_census(x, w1, b1, h_k, ln=lnp, eps=1e-5)
    return (lambda *a: fused_mlp_plain(*a[:5], ln=a[5:] or None, eps=1e-5,
                                       act="relu", save_h=save_h,
                                       kink_from=h_k),
            f"ReLU's branch from the kernel's h at {marked} of {n} "
            f"pre-activations within rounding of 0, {flips} of them on the "
            f"other side")


def text_zoo_routes(dev, card: str, titles: int) -> None:
    """The training FFN's backward of OPT (LN, ReLU, save_h) and DeBERTa
    (no LN, GELU, save_h) at `titles` titles, bf16, through the route
    premlp_bwd_plan picks (wg at C = 768) and through the products route,
    each alone (PREMLP_BWD_ROUTES), CUDA-event and device time, their
    gradients against each other at GRAD_TOL."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    g = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                          device=dev) * scale
    bf, C, Fw = torch.bfloat16, TZ_C, TZ_F
    M = titles * TITLE_LEN
    k = premlp_bwd_plan(C, M, bf)
    require(k["route"] == "wg", f"premlp_bwd_plan takes {k['route']} at "
            f"C={C} M={M}")
    for who, ln, act in (("OPT", True, "relu"), ("DeBERTa", False, "gelu")):
        x2, dout = g(M, C).to(bf), g(M, C).to(bf)
        w1, b1 = g(C, Fw, scale=C ** -0.5).to(bf), g(Fw, scale=0.1).to(bf)
        w2, b2 = g(Fw, C, scale=Fw ** -0.5).to(bf), g(C, scale=0.1).to(bf)
        lnp = [1.0 + g(C, scale=0.1), g(C, scale=0.1)] if ln else None
        h = premlp_bwd_h(x2, w1, b1, w2, b2, ln=lnp, eps=1e-5, act=act,
                         save_h=True)
        ops = (x2, dout, None, w1, b1, w2, lnp or [None, None], h, 1e-5,
               act, False, lib.DTYPE_CODES[bf])
        routes = (k["route"], "products")
        got = {r: PREMLP_BWD_ROUTES[r](*ops) for r in routes}
        torch.cuda.synchronize()
        where = (f"{who} train save_h {'LN' if ln else 'no LN'} M={M} C={C} "
                 f"F={Fw} {act} bf16")
        worst = _worst_err([t for t in got[k["route"]] if t is not None],
                           [t for t in got["products"] if t is not None],
                           f"premlp_bwd routes {where}")
        del got
        times = {}
        for r in routes:
            fn = lambda r=r: PREMLP_BWD_ROUTES[r](*ops)
            times[r] = (cuda_ms(fn, reps=VB_REPS), device_ms(
                fn, VB_REPS, expect=(k["kernels"][0],)
                if r == k["route"] else ())[0])
        print(f"premlp_bwd routes [{where}]: " + ", ".join(
            f"{r} {ms:.4f} ms ({dev_ms:.4f} ms device)"
            for r, (ms, dev_ms) in times.items())
            + f"; {k['route']} against products max_abs_err {worst[1]:.3e} "
            f"on a scale of {worst[2]:.3g}, bound "
            f"{bound_text(premlp_bwd_work(M, C, Fw, 2), bf, False)} "
            f"[{card}]", flush=True)
        require(worst[0] <= GRAD_TOL[bf], f"premlp_bwd routes {where}: "
                f"error {worst[1]} above {GRAD_TOL[bf]} x {worst[2]}")
        del x2, dout, ops, h


def text_zoo_scatter(dev, card: str, titles: int) -> dict:
    """scatter_add_rows into OPT-125M's 50 272 x 768 word table from a
    train step's tokens (`titles` titles of TITLE_LEN, Zipf ids), bf16 and
    float32, against its plain version, beside index_add_. Returns the
    kernels line's row."""
    rng = np.random.default_rng(SEED + 42)
    V = TZ_CONFIGS["opt-125m"]["vocab_size"]
    M, results = titles * TITLE_LEN, {}
    for dt in (torch.bfloat16, torch.float32):
        ids = torch.from_numpy(np.minimum(rng.zipf(ZIPF_A, M), V) - 1
                               ).to(dev)
        dx = torch.from_numpy(rng.standard_normal((M, TZ_C)).astype(
            np.float32)).to(dev, dt)
        got = scatter_add_rows(ids, dx, V)
        want = scatter_add_rows_plain(ids, dx, V)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype == dt,
                f"scatter_add_rows V={V}: {got.shape}/{got.dtype}")
        err, scale = _rel_err(got, want)
        del got, want
        ms = cuda_ms(lambda: scatter_add_rows(ids, dx, V))
        plain_ms = cuda_ms(lambda: scatter_add_rows_plain(ids, dx, V))
        table = torch.zeros(V, TZ_C, dtype=dt, device=dev)
        library_ms = cuda_ms(lambda: table.index_add_(0, ids, dx))
        del table
        work = scatter_work(M, TZ_C, V, size_of(dt))
        bound_ms, bound_by = bound_of(work, dt)
        tol = SCATTER_TOL[dt]
        print(f"kernel scatter_add_rows [OPT word table M={M} V={V} "
              f"D={TZ_C} Zipf ids {tag_of(dt)}]: max_abs_err {err:.3e} on a "
              f"scale of {scale:.3g} (tol {tol:g} of the scale), kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library call "
              f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} [{card}]", flush=True)
        require(math.isfinite(err) and err <= tol * scale,
                f"scatter_add_rows V={V}: error {err} above {tol} x {scale}")
        _record(results, "scatter_add_rows", err, ms, plain_ms, work, dt,
                library_ms)
    return results["scatter_add_rows"]


def text_catalog(rng, item_num: int, vocab: int, pad: int) -> np.ndarray:
    """catalog's packed title rows over a tower's vocabulary (ids from 3,
    its pad id on the padding)."""
    lens = rng.integers(5, TITLE_LEN + 1, size=item_num + 1)
    att = (np.arange(TITLE_LEN)[None, :] < lens[:, None]).astype(np.int64)
    att[0] = 0
    ids = np.where(att == 1, rng.integers(3, vocab, size=att.shape), pad)
    return np.concatenate([ids, att], axis=1)


def text_zoo_encode(model, card: str, content, what: str,
                    items=None) -> tuple:
    """The catalog encode (float32, chunks of ENCODE_BATCH), the launch
    counters set to 0 just before it: `items` items, or when None the full
    catalog if a probe of TZ_PROBE_CHUNKS chunks says it takes at most
    TZ_ENCODE_LIMIT_S, else TZ_ITEMS_CUT. Returns (table, items, the
    encode's launches)."""
    n, note = items, ""
    if n is None:
        probe = TZ_PROBE_CHUNKS * ENCODE_BATCH
        for _ in range(2):      # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Retriever.encode_catalog(model, probe - 1, content[:probe], D,
                                     batch_size=ENCODE_BATCH)
            torch.cuda.synchronize()
        guess = (time.perf_counter() - t0) * (ITEM_NUM + 1) / probe
        n = ITEM_NUM if guess <= TZ_ENCODE_LIMIT_S else TZ_ITEMS_CUT
        note = (f" (the probe's estimate for {ITEM_NUM + 1}: {guess:.1f} "
                f"s)")
    torch.cuda.synchronize()
    reset_counts()
    clear_f32_bodies()
    t0 = time.perf_counter()
    table = Retriever.encode_catalog(model, n, content[:n + 1], D,
                                     batch_size=ENCODE_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    require_f32_bodies([w for w in ("fused_mlp", "fused_mlp_res")
                        if launched[w]], f"the {what} float32 encode")
    require(tuple(table.shape) == (n + 1, D)
            and bool(torch.isfinite(table).all()),
            f"{what}: table {tuple(table.shape)} not finite")
    print(f"{what} catalog encode: {n + 1} items{note}, float32, chunks "
          f"of {ENCODE_BATCH} titles of {TITLE_LEN} tokens, in "
          f"{seconds:.3f} s, {(n + 1) / seconds:.1f} items/s, launches "
          f"{ {k: v for k, v in launched.items() if v} } [{card}]",
          flush=True)
    return table, n, launched


def text_zoo_serve(dev, card: str, root: str, content) -> dict:
    """OPT-125M serving, the counters set to 0 just before the catalog
    encode: the encode, recommend at REQUEST_BATCHES (p50), every kernel of
    the path launched,
    no padding or history id served; then a TZ_SUB_ITEMS sub-catalog
    against the plain path on a CPU copy (sub_catalog_check's rule).
    Returns the path's launches."""
    rng = np.random.default_rng(SEED + 43)
    model = text_zoo_model(dev, text_zoo_config(root, "opt-125m"),
                           SEED + 44)
    table, n, encoded = text_zoo_encode(model, card, content, "opt-125m")
    requests = {B: histories(rng, B, n) for B in REQUEST_BATCHES}
    engine = Retriever(model, table, max_seq_len=L,
                       batch_sizes=REQUEST_BATCHES)
    results = {B: engine.recommend(h, top_k=TOP_K)
               for B, h in requests.items()}
    launched = counts()
    print(f"opt-125m serving launches after encode {encoded}, after "
          f"recommend {launched}", flush=True)
    require_launched(encoded, TZ_OPT_ENCODE_KERNELS, "opt-125m encode")
    require_launched({w: launched[w] - encoded[w] for w in launched},
                     SERVE_KERNELS, "opt-125m recommend")
    for B, (ids, vals) in results.items():
        require(ids.shape == (B, TOP_K) and np.isfinite(vals).all(),
                f"opt-125m recommend B={B}: {ids.shape}")
        check_results(ids, requests[B])
    for B, h in requests.items():
        walls = []
        for _ in range(25):
            t0 = time.perf_counter()
            engine.recommend(h, top_k=TOP_K)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"opt-125m recommend B={B} top_k={TOP_K}: p50 "
              f"{statistics.median(walls[5:]):.3f} ms over 20 requests "
              f"[{card}]", flush=True)
    del engine, table
    torch.cuda.empty_cache()
    sub = TZ_SUB_ITEMS - 1
    hist = histories(rng, 64, sub)
    table_k = Retriever.encode_catalog(model, sub, content[:sub + 1], D,
                                       batch_size=ENCODE_BATCH)
    ids_k, vals_k = Retriever(model, table_k, max_seq_len=L,
                              batch_sizes=(64,)).recommend(hist, TOP_K)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    table_p = Retriever.encode_catalog(cpu_model, sub,
                                       content[:sub + 1].cpu(), D,
                                       batch_size=ENCODE_BATCH)
    ids_p, vals_p = Retriever(cpu_model, table_p, max_seq_len=L,
                              batch_sizes=(64,)).recommend(hist, TOP_K)
    table_err = (table_k.cpu() - table_p).abs().max().item()
    scale = np.maximum(1.0, np.abs(vals_p))
    score_err = float((np.abs(vals_k - vals_p) / scale).max())
    mismatch = np.argwhere(ids_k != ids_p)
    print(f"opt-125m sub-catalog {TZ_SUB_ITEMS} items: table max_abs_err "
          f"{table_err:.3e} (tol {TABLE_TOL:g}), score rel err "
          f"{score_err:.3e} (tol {SCORE_TOL:g}), {len(mismatch)} of "
          f"{ids_k.size} ids differ; plain CPU path took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(table_err <= TABLE_TOL, "opt-125m sub-catalog table disagrees")
    require(score_err <= SCORE_TOL, "opt-125m sub-catalog scores disagree")
    check_ties(mismatch, vals_p, scale, SCORE_TOL)
    check_results(ids_k, hist)
    return launched


def text_zoo_train(dev, card: str, cfg, content, batches, cap: int,
                   fixed: int, timed: int, what: str) -> tuple:
    """The flagship's bf16 step with the tower of cfg: `fixed` steps on
    batches[0] (the loss must fall: the mean of the last half below the
    first half's), then `timed` steps on the next batches (p50, samples/s),
    peak memory, every parameter finite. Returns (model, launches), the
    counters set to 0 just before the first step."""
    model = text_zoo_model(dev, cfg, SEED + 45)
    state = make_train_state(model, cfg, param_labels(model), seed=SEED)
    step = make_train_step(cfg, item_content=content,
                           log_pop=log_popularity(dev))
    first = device_batch(*batches[0], cap, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, losses = [], []
    for i in range(fixed + timed):
        b = first if i < fixed else batches[1 + i - fixed]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = b if i < fixed else device_batch(*b, cap, dev)
        losses.append(step(state, batch).item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    half = fixed // 2
    head = statistics.mean(losses[:half])
    tail = statistics.mean(losses[half:fixed])
    p50 = statistics.median(walls[fixed:] if timed else walls[1:])
    print(f"{what} train step B={TRAIN_B} L={L} bf16, dropout {DROP}, dedup "
          f"cap {cap} ({cap * TITLE_LEN} tokens): {fixed} steps on one "
          f"batch, loss mean of the first {half} {head:.5f}, of the last "
          f"{fixed - half} {tail:.5f}; p50 {p50:.3f} ms over "
          f"{timed or fixed - 1} {'distinct batches' if timed else 'steps'}"
          f" (min {min(walls[1:]):.3f}, max {max(walls[1:]):.3f}), "
          f"{TRAIN_B / p50 * 1e3:.1f} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    print(f"{what} training launches {launched}", flush=True)
    require(all(math.isfinite(x) for x in losses), f"{what}: a loss is not "
            f"finite: {losses}")
    require(tail < head, f"{what}: the loss did not fall on a fixed batch")
    require_launched(launched, TZ_TRAIN_KERNELS, f"{what} training")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"{what}: a parameter is not finite after training")
    return model, launched


@contextlib.contextmanager
def opt_ffn_branches(card_h: list, census: list):
    """OPT's FFN in a float32 check, one spy for both sides of
    card_and_plain (the card's step runs first). On the card it appends to
    card_h, call by call, the h whose sign takes ReLU's branch in the
    card's backward (premlp_bwd_h). On the CPU the FFN of the same call
    runs as its plain version with that branch where its own h lies
    within float32's rounding of 0 (kink_from), its own elsewhere; it
    appends premlp_kink_census's counts, which raises past its caps."""
    inner = opt_mod.pre_ln_mlp

    def spy(x, ln, fc1, fc2, *, act="gelu", residual=False, save_h=True):
        ops = (fc1.weight, fc1.bias, fc2.weight, fc2.bias)
        kw = dict(ln=(ln.weight, ln.bias), eps=ln.eps)
        if x.device.type != "cpu":
            with torch.no_grad():
                card_h.append(premlp_bwd_h(
                    x, *ops, act=act, save_h=save_h and not residual,
                    **kw).cpu())
            return inner(x, ln, fc1, fc2, act=act, residual=residual,
                         save_h=save_h)
        h_card = card_h[len(census)]
        census.append(premlp_kink_census(x, *ops[:2], h_card, **kw))
        if residual:
            return fused_mlp_res_plain(x, None, *ops, act=act,
                                       kink_from=h_card, **kw)
        return fused_mlp_plain(x, *ops, act=act, save_h=save_h,
                               kink_from=h_card, **kw)

    opt_mod.pre_ln_mlp = spy
    try:
        yield
    finally:
        opt_mod.pre_ln_mlp = inner


def text_zoo_check(dev, model, cfg, content, batch, what: str,
                   relu_ffn: bool) -> None:
    """One float32 step of cfg's model without dropout (eval mode) on
    TZ_CHECK_USERS users, on the card and through the plain path on a CPU
    copy (card_and_plain, same_step's rule; SASRec's ReLU units at the kink
    left out); with relu_ffn, OPT's FFN on the CPU takes the card's ReLU
    branch at its kink (opt_ffn_branches)."""
    ids, lm = batch[0][:TZ_CHECK_USERS], batch[1][:TZ_CHECK_USERS]
    cap = -(-len(np.unique(ids)) // 8) * 8
    cfg = dataclasses.replace(cfg, compute_dtype="float32", dedup_cap=cap)
    card_h, census = [], []
    with (opt_ffn_branches(card_h, census) if relu_ffn
          else contextlib.nullcontext()):
        runs = card_and_plain(dev, model, cfg, content,
                              lambda where: device_batch(ids, lm, cap, where))
    same_step(runs, f"{what} gradient check: f32 step on {TZ_CHECK_USERS} "
                    f"users ({cap} titles)")
    if relu_ffn:
        require(len(census) == len(card_h) > 0,
                f"{what}: {len(card_h)} FFN calls on the card, "
                f"{len(census)} on the CPU")
        n, marked, flips = (sum(c[i] for c in census) for i in range(3))
        print(f"{what} gradient check: the CPU took the card's ReLU branch "
              f"in its {len(census)} FFN calls at {marked} of {n} "
              f"pre-activations within float32's rounding of 0, {flips} of "
              f"them on the other side", flush=True)


TZ_TRAIN = dict(loss="inbatch_ce", compute_dtype="bfloat16", lr=LR,
                l2_weight=0.0, fine_tune_lr=FT_LR, fine_tune_l2_weight=0.0)
# the kernels line's rows of this phase: (edition group) -> the path whose
# launches they count
TZ_ROW_PATHS = {"opt encode": "launches_opt_serve",
                "opt train": "launches_opt_train",
                "deberta train": "launches_deberta_train"}


def text_zoo_path(dev, card: str, batches, cap: int) -> tuple:
    """Phase "text_zoo": rows 4-6 at the towers' editions and shapes
    against their plain versions (and the wg route against the products
    route), OPT-125M's serving and training, its float32 check, then
    DeBERTa-base's encode, training and float32 check; each path driven
    with the counters set to 0 just before it and read just after.
    Returns ({path: launches}, {row name: kernels line row})."""
    rng = np.random.default_rng(SEED + 47)
    root = text_zoo_dir(tempfile.mkdtemp(prefix="smoke_text_zoo_"))
    rows, paths = {}, {}
    try:
        fwd, bwd = text_zoo_kernel_cases(dev, cap)
        for group, cases in fwd.items():
            for n, r in kernel_phase(dev, card, cases, reps=FEW_REPS,
                                     f32_tf32x3=True).items():
                rows[f"{n} ({group})"] = dict(r, wrapper=n, group=group)
        for group, cases in bwd.items():
            for n, r in gradient_cases(cases, card, reps=VB_REPS).items():
                rows[f"{n} ({group})"] = dict(r, wrapper=n, group=group)
        del fwd, bwd
        torch.cuda.empty_cache()
        text_zoo_routes(dev, card, cap)
        rows["scatter_add_rows (opt train)"] = dict(
            text_zoo_scatter(dev, card, cap), wrapper="scatter_add_rows",
            group="opt train")
        torch.cuda.empty_cache()
        opt = TZ_CONFIGS["opt-125m"]
        content = torch.from_numpy(text_catalog(
            rng, ITEM_NUM, opt["vocab_size"], opt["pad_token_id"])).to(dev)
        paths["launches_opt_serve"] = text_zoo_serve(dev, card, root,
                                                     content)
        torch.cuda.empty_cache()
        cfg = text_zoo_config(root, "opt-125m", dedup_cap=cap, **TZ_TRAIN)
        model, paths["launches_opt_train"] = text_zoo_train(
            dev, card, cfg, content, batches, cap, TZ_OPT_FIXED,
            TZ_OPT_TIMED, "opt-125m")
        text_zoo_check(dev, model, cfg, content, batches[0], "opt-125m",
                       relu_ffn=True)
        del model, content
        torch.cuda.empty_cache()
        deb = TZ_CONFIGS["deberta-base"]
        content = torch.from_numpy(text_catalog(
            rng, ITEM_NUM, deb["vocab_size"], deb["pad_token_id"])).to(dev)
        model = text_zoo_model(dev, text_zoo_config(root, "deberta-base"),
                               SEED + 48)
        paths["launches_deberta_encode"] = text_zoo_encode(
            model, card, content, "deberta-base", items=TZ_ITEMS_CUT)[2]
        require_launched(paths["launches_deberta_encode"],
                         TZ_DEBERTA_ENCODE_KERNELS, "deberta-base encode")
        del model
        torch.cuda.empty_cache()
        cfg = text_zoo_config(root, "deberta-base", dedup_cap=cap,
                              **TZ_TRAIN)
        model, paths["launches_deberta_train"] = text_zoo_train(
            dev, card, cfg, content, batches, cap, TZ_DEBERTA_STEPS, 0,
            "deberta-base")
        text_zoo_check(dev, model, cfg, content, batches[0],
                       "deberta-base", relu_ffn=False)
        del model, content
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, r in rows.items():
        r["launches"] = paths[TZ_ROW_PATHS[r.pop("group")]][r["wrapper"]]
    return paths, rows


# vision_ckpt (phase 29): Swin-T's published config.json
# (microsoft/swin-tiny-patch4-window7-224) as HF writes it, the parameters
# the reference's index freezes (the patch embedding, stages 0 and 1, the
# first blocks of stage 2), the launcher file run through grid_launch, its
# users a step (its 64 would encode 1 344 images a step: no dedup there)
VC_SWIN_T = dict(model_type="swin", architectures=[
    "SwinForImageClassification"], image_size=224, patch_size=4,
    num_channels=3, embed_dim=96, depths=[2, 2, 6, 2],
    num_heads=[3, 6, 12, 24], window_size=7, mlp_ratio=4.0, qkv_bias=True,
    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    drop_path_rate=0.1, hidden_act="gelu", use_absolute_embeddings=False,
    patch_norm=True, layer_norm_eps=1e-5, initializer_range=0.02,
    encoder_stride=32)
VC_FREEZE = 100
VC_VARIANT = "variants/inbatch_sasrec_e2e_vision/train_swin_tiny.py"
VC_TRAIN_B = 8


def torchvision_resnet(net, rng) -> dict:
    """A torchvision ResNet's state_dict from the port's ResNet
    (convert.to_checkpoint), with each BatchNorm's num_batches_tracked and
    a 1000-class fc drawn from rng (the converter leaves both out)."""
    out = to_checkpoint(net, resnet_param_order(net.arch))
    for name in [k for k in out if k.endswith(".running_var")]:
        out[name[:-len("running_var")] + "num_batches_tracked"] = (
            torch.tensor(1000))
    width = net.fc.weight.shape[0]
    out["fc.weight"] = torch.from_numpy(rng.standard_normal(
        (1000, width)).astype(np.float32))
    out["fc.bias"] = torch.zeros(1000)
    return out


def same_net_state(state: dict, net, what: str) -> None:
    """The converted checkpoint is the net's state_dict bit for bit, but
    the keys the net draws on load (a ResNet's fc)."""
    drawn = tuple(getattr(net, "drawn_on_load", ()))
    want = {k: v for k, v in net.state_dict().items()
            if not k.startswith(drawn)}
    require(set(state) == set(want), f"{what}: the converted checkpoint "
            f"holds {len(state)} tensors, the net {len(want)}")
    bad = [k for k, v in want.items()
           if not torch.equal(state[k], v.detach().cpu())]
    require(not bad, f"{what}: {len(bad)} tensors differ after the round "
            f"trip, e.g. {bad[:3]}")


def vision_ckpt_path(dev, card: str, pool: np.ndarray) -> dict:
    """Phase 29: pretrained vision checkpoints and the launcher on the
    card, in a temporary directory, the counters set to 0 first. A Swin-T
    drawn from the seed is written in HF's layout (VC_SWIN_T's config.json,
    pytorch_model.bin by torch.save) and a ResNet-50 (running averages
    drawn too) as a torchvision .pth; runner.load_encoder reads both back
    to the drawn tensors bit for bit, and the tower loaded from the
    directory encodes a chunk of the pool's 224 x 224 images (bf16) to the
    bits of the tower it came from. Then grid_launch runs
    train_swin_tiny.py (read_variant, not imported) through the port's CLI
    with the runner phase's generated data, the checkpoint directory,
    epoch 1, VC_TRAIN_B users a step and freeze_paras_before VC_FREEZE:
    every frozen parameter keeps the checkpoint's bits, every other one of
    the encoder moves, and every kernel of the vision step and evaluation
    launched."""
    here, variant = os.getcwd(), os.path.abspath(VC_VARIANT)
    tmp = tempfile.mkdtemp()
    os.chdir(tmp)
    try:
        reset_counts()
        models = os.path.join(tmp, "pretrained")
        os.makedirs(os.path.join(models, "swin_tiny"))
        with open(os.path.join(models, "swin_tiny", "config.json"),
                  "w") as f:
            json.dump(VC_SWIN_T, f)
        cfg = Config(item_tower="modal", modality="vision",
                     cv_model_load="swin_tiny", pretrained_models_dir=models,
                     embedding_dim=V_D, compute_dtype="bfloat16",
                     freeze_paras_before=VC_FREEZE)
        src, state, _, width = runner.load_encoder(cfg, dev)
        require(state is None and width == 768
                and src.net.cfg == SwinConfig(),
                "config.json alone: Swin-T's geometry, weights drawn")
        init_parameters(src, torch.Generator(device=dev).manual_seed(
            SEED + 29))
        rnet = ResNet("resnet50", V_D, device=dev)
        init_parameters(rnet, torch.Generator(device=dev).manual_seed(
            SEED + 30))
        rng = np.random.default_rng(SEED + 29)
        with torch.no_grad():
            for name, b in rnet.named_buffers():
                b.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, b.shape) if name.endswith(".var") else
                    rng.normal(0.0, 0.5, b.shape)).float())
        t0 = time.perf_counter()
        swin_bin = os.path.join(models, "swin_tiny", "pytorch_model.bin")
        torch.save(to_checkpoint(src.net, swin_param_order(src.net.cfg)),
                   swin_bin)
        torch.save(torchvision_resnet(rnet, rng),
                   os.path.join(models, "resnet50.pth"))
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        tower, state, frozen, width = runner.load_encoder(cfg, dev)
        rcfg = copy.copy(cfg)
        rcfg.cv_model_load = "resnet50"
        _, rstate, rfrozen, rwidth = runner.load_encoder(rcfg, dev)
        read = time.perf_counter() - t0
        require(width == 768 and len(frozen) == VC_FREEZE
                and rwidth == V_D and len(rfrozen) == VC_FREEZE,
                "the bundles' widths and frozen sets")
        same_net_state(state, src.net, "Swin-T from pytorch_model.bin")
        same_net_state(rstate, rnet, "ResNet-50 from resnet50.pth")
        init_parameters(tower, torch.Generator(device=dev).manual_seed(
            SEED + 31))
        runner.load_net_state(tower.net, state)
        tower.classifier.load_state_dict(src.classifier.state_dict())
        images = torch.from_numpy(pool[:V_CHUNK]).to(dev)
        before = counts()
        with torch.no_grad(), eval_mode(src), eval_mode(tower):
            want, got = src(images), tower(images)
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and torch.equal(got, want)
                and bool(torch.isfinite(got).all()),
                "the tower loaded from the checkpoint encodes apart from "
                "the one it came from")
        encoded = {n: c - before[n] for n, c in counts().items()}
        require_launched(encoded, VISION_ENCODE_KERNELS,
                         "vision_ckpt encode")
        print(f"vision_ckpt: Swin-T in HF's layout "
              f"({os.path.getsize(swin_bin) / 2 ** 20:.1f} MiB) and "
              f"ResNet-50 as a torchvision .pth written in {written:.2f} s, "
              f"read back through load_encoder in {read:.2f} s, every "
              f"tensor bit-equal; a chunk of {V_CHUNK} images encoded by "
              f"the loaded tower bit-equal (bf16) [{card}]", flush=True)
        del src, tower, rnet, images, want, got
        torch.cuda.empty_cache()

        base, grid, zipped = read_variant(variant)
        require(base["cv_model_load"] == "swin_tiny" and zipped is None,
                f"{VC_VARIANT}: unexpected dicts")
        vision_runner_data(np.random.default_rng(SEED + 21))
        base.update(root_data_dir="./", dataset="VISION", news="images.tsv",
                    behaviors="behaviors.tsv", image_store="images.mkv",
                    pretrained_models_dir=models, epoch=1,
                    freeze_paras_before=VC_FREEZE)
        grid.update(batch_size=[VC_TRAIN_B])
        t0 = time.perf_counter()
        with RunnerWatch() as watch:
            (flags, (best, best_epoch)), = grid_launch(base, grid,
                                                       zipped=zipped)
        seconds = time.perf_counter() - t0
        tr, = watch.trainers
        net = tr.model.encoder.net
        names = {"encoder.net." + k for k, _ in net.named_parameters()}
        require(frozen <= names and len(frozen) == VC_FREEZE,
                "the frozen set names the encoder's parameters")
        kept = {"encoder.net." + k for k, p in net.named_parameters()
                if torch.equal(p.detach().cpu(), state[k])}
        require(kept == frozen, f"the frozen parameters keep the "
                f"checkpoint's bits and no other does: {len(frozen - kept)} "
                f"frozen moved, {len(kept - frozen)} others did not")
        moved = len(names) - len(kept)
        train, evals = watch.launches()
        require_launched(train, VISION_TRAIN_KERNELS, "vision_ckpt training")
        require_launched(evals, VISION_ENCODE_KERNELS + RUNNER_EVAL_KERNELS,
                         "vision_ckpt evaluation")
        print(f"vision_ckpt: grid_launch over {VC_VARIANT} "
              f"(label_screen {flags['label_screen']}): Swin-T from the "
              f"checkpoint, SASRec D {flags['embedding_dim']}, "
              f"{tr.batcher.n} samples, B {VC_TRAIN_B}, bf16, one epoch in "
              f"{seconds:.1f} s; valid HR@10 {best:.6f} at epoch "
              f"{best_epoch}; {VC_FREEZE} frozen parameters bit-unchanged, "
              f"the other {moved} of the encoder moved [{card}]",
              flush=True)
        return counts()
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)


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
    parser.add_argument("--profile", nargs="?", const="all",
                        choices=("all", "text", "vision", "bce_dssm",
                                 "two_stage"),
                        help="only profile the train step, the vision "
                             "catalog encode and recommend and the vision "
                             "train step by device kernel (torch.profiler), "
                             "after the card and build phases; 'text': the "
                             "text train step alone; 'vision': the vision "
                             "train step alone; 'bce_dssm': the BCE and "
                             "DSSM train steps alone; 'two_stage': the "
                             "two-stage text step and a chunk of its "
                             "BERT-base cache alone")
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
    if args.profile == "vision":
        profile_vision_train(dev, card)
        return 0
    if args.profile == "bce_dssm":
        profile_bce_dssm(dev, card, content, batches)
        return 0
    if args.profile == "two_stage":
        profile_two_stage(dev, card, content, batches)
        return 0
    if args.profile:
        profile_train(dev, card, content, batches, cap)
        if args.profile == "text":
            return 0
        profile_vision_encode(dev, card)
        profile_vision_recommend(dev, card)
        profile_vision_train(dev, card)
        return 0

    with phase("kernels"):
        kernels = kernel_phase(dev, card, kernel_cases(
            np.random.default_rng(SEED), dev))
    with phase("backward kernels"):
        kernels.update(backward_phase(dev, card, cap))
        require_bwd_body(("fused_mha_bwd",), "backward kernels")
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
    with phase("accumulation"):
        accumulated = accumulation_path(dev, card, content, batches, cap)
    torch.cuda.empty_cache()
    with phase("bce"):
        bce = bce_path(dev, card, content, batches)
    torch.cuda.empty_cache()
    with phase("dssm"):
        dssm = dssm_path(dev, card, content)
    torch.cuda.empty_cache()
    with phase("two_stage"):
        # the float32 SASRec of the two-stage steps: its backward's bodies
        # from none, then merged back for the kernels line
        earlier, fused_mha_bwd.bodies = fused_mha_bwd.bodies, set()
        cached_text, two_text = two_stage_text(dev, card, content, batches)
        torch.cuda.empty_cache()
        cached_vision, two_vision = two_stage_vision(dev, card)
        require_bwd_body(("fused_mha_bwd",), "two_stage")
        fused_mha_bwd.bodies |= earlier
    torch.cuda.empty_cache()
    pool = image_pool(dev).cpu().numpy()
    with phase("fusion"):
        fusion_text = add_counts(*(bce_path(dev, card, content, batches, t)
                                   for t in ("modal_id_add", "modal_id_cat")))
        torch.cuda.empty_cache()
        fusion_images = fusion_vision(dev, card, pool)
    torch.cuda.empty_cache()
    with phase("vision kernels"):
        vision = kernel_phase(dev, card, vision_kernel_cases(dev),
                              reps=FEW_REPS, f32_tf32x3=True)
    merge(kernels, vision)
    torch.cuda.empty_cache()
    with phase("vision serving"):
        seen, windows = vision_serve_path(dev, card)
    torch.cuda.empty_cache()
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
        merge(kernels, premlp_bwd_routes(dev, card, V_BWD_IMAGES))
        torch.cuda.empty_cache()
        merge(kernels, gemm_phase(dev, card, V_BWD_IMAGES, cap))
        require_bwd_body(("fused_mha_proj_band_bwd", "fused_mha_proj_bwd",
                          "fused_mha_bwd"), "vision backward kernels")
    torch.cuda.empty_cache()
    with phase("dbias kernels"):
        merge(kernels, dbias_phase(dev, card, V_BWD_IMAGES))
        require_bwd_body(("fused_mha_bwd_dbias",), "dbias kernels")
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
    torch.cuda.empty_cache()
    kept = {}
    with phase("runner"):
        ran = runner_path(dev, card, kept)
    torch.cuda.empty_cache()
    with phase("special"):
        special = special_path(dev, card, kept)
    torch.cuda.empty_cache()
    with phase("resnet"):
        resnet = resnet_path(dev, card, pool)
    torch.cuda.empty_cache()
    with phase("vit"):
        vit, vit_kernels = vit_path(dev, card, pool)
    merge(kernels, vit_kernels)
    torch.cuda.empty_cache()
    with phase("text_zoo"):
        text_zoo, zoo_rows = text_zoo_path(dev, card, batches, cap)
    torch.cuda.empty_cache()
    with phase("vision_ckpt"):
        vision_ckpt = vision_ckpt_path(dev, card, pool)

    # launches: every main path's count, each taken from 0; the
    # twenty-six keys after it say which path launched how many (2E: the
    # two-stage caches, text and vision; 2T / 2V: the two-stage steps; FT /
    # FV: the fusion steps)
    paths = {"launches_serve": served, "launches_train": trained,
             "launches_bce": bce, "launches_dssm": dssm,
             "launches_2E": add_counts(cached_text, cached_vision),
             "launches_2T": two_text, "launches_2V": two_vision,
             "launches_FT": fusion_text, "launches_FV": fusion_images,
             "launches_vision": seen, "launches_windows": windows,
             "launches_vision_train": vtrained,
             "launches_windows_train": vwindows,
             "launches_vision_dropout": vdropped,
             "launches_pallas_train": pallas, "launches_dp": parallel,
             "launches_runner": ran, "launches_accumulation": accumulated,
             "launches_special": special, "launches_resnet": resnet,
             "launches_vit": vit, "launches_vision_ckpt": vision_ckpt,
             **text_zoo}
    line = {"kernels": [
        {"name": n, "route": "cuda", "source": CSRC + SOURCES[n][0],
         "replaces": PALLAS + SOURCES[n][1],
         "launches": sum(c[n] for c in paths.values()),
         **{k: c[n] for k, c in paths.items()},
         **kernels[n], **({"bodies": sorted(WRAPPERS[n].bodies)}
            if hasattr(WRAPPERS[n], "bodies") else {})}
        for n in WRAPPERS] + [
        # the text zoo's editions (phase 28), each with its path's launches
        {"name": n, "route": "cuda", "source": CSRC + SOURCES[w][0],
         "replaces": PALLAS + SOURCES[w][1], **r}
        for n, r in zoo_rows.items() for w in (r.pop("wrapper"),)]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
