"""idvs.morec_tpu_torch -- the PyTorch/CUDA port of idvs.morec_tpu.

The JAX package beside it stays the reference. This package mirrors its
layout (models/, ops/, ops/cuda/ for ops/pallas/, train/, serve.py) and
imports torch, never jax. Each kernel the JAX package wrote in Pallas for
the TPU is a CUDA C++ kernel for Hopper (sm_90a) under csrc/, built by nvcc
on first use (ops/cuda/lib.py); its wrapper runs a plain PyTorch version of
the same function for tensors on the CPU.

Ported so far: end2end text MoRec (BERT item tower), end2end vision MoRec
(Swin item tower) and IDRec under the SASRec user tower, served (catalog
encode, top-k retrieval) and trained (the in-batch CE step, its loss as a
composition or, under use_pallas, through the CE kernels; on one process
or data-parallel under a torch.distributed group, parallel/, with
gather_negatives).
"""
