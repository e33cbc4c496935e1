"""Builds the port's CUDA kernels from ``csrc/`` and binds them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all at once, and links them into one shared library with a
plain C interface, under ``idvs/morec_tpu_torch/_build/``,
named by a hash of the sources and flags: the first call in a fresh checkout
builds it, later calls load it. Nothing is built when the module is imported,
so the package imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# compute-dtype codes of the C entry points (common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory one block may use on sm_90 (common.cuh kMaxSmem)
MAX_SMEM = 232448

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _U = ctypes.c_float, ctypes.c_uint
_DROP = [_U, _U, _F]   # drop_key, drop_thresh, drop_scale (dropout.cuh)
_SIGNATURES = {
    # qkv, bias, out, B, T, nh, dh, mode, P, bias_sp, bias_sh, scale, drop,
    # dtype, stream
    "idvs_fused_mha_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _F]
                          + _DROP + [_I, _P],
    # qkv, bias, dout, dqkv, then as the forward
    "idvs_fused_mha_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL,
                           _F] + _DROP + [_I, _P],
    # qkv, bias, dout, dqkv, part, B, T, nh, dh, P, chunks, bias_sp, bias_sh,
    # scale, drop, dtype, stream
    "idvs_fused_mha_bwd_dbias": [_P] * 5 + [_I] * 6 + [_LL, _LL, _F] + _DROP
                                + [_I, _P],
    # T, dh, edition, dtype -> shared memory bytes of a block
    "idvs_fused_mha_smem": [_I] * 4,
    # B, T, nh, dh, P, dtype -> the dbias edition's chunks
    "idvs_fused_mha_dbias_chunks": [_I] * 6,
    # part, out, nb, E, stream
    "idvs_sum_partials": [_P, _P, _I, _I, _P],
    # x, res, w, b, gamma, beta, out, ypre, M, C, eps, drop, rows,
    # threads, smem, dtype, stream
    "idvs_proj_resln_fwd": [_P] * 8 + [_I, _I, _F] + _DROP
                           + [_I, _I, _LL, _I, _P],
    # x, w1, b1, w2, b2, gamma, beta, out, ypre, h, M, C, F, eps, act, drop,
    # rows, f_chunk, threads, smem, dtype, stream
    "idvs_mlp_resln_fwd": [_P] * 10 + [_I, _I, _I, _F, _I] + _DROP
                          + [_I, _I, _I, _LL, _I, _P],
    # y, b, res, gamma, beta, out, ypre, M, C, eps, drop, dtype, stream
    "idvs_post_ln_rows": [_P] * 7 + [_I, _I, _F] + _DROP + [_I, _P],
    # x, res, w, b, gamma, beta, out, ypre, ws, splits, M, C, eps, drop,
    # dtype, stream
    "idvs_proj_resln_products": [_P] * 9 + [_I, _I, _I, _F] + _DROP
                                + [_I, _P],
    # ypre, dout, gamma, dres, dyp, dz, part, sums, nb, M, C, eps, drop,
    # dtype, stream
    "idvs_resln_bwd_rows": [_P] * 8 + [_I, _I, _I, _F] + _DROP + [_I, _P],
    # ypre, dout, gamma, h, w1, w2, dz, g, dh, dx, part, part2, sums, M, C,
    # F, eps, act, drop, per, rows, chunk, threads, smem, dtype, stream
    "idvs_mlp_resln_bwd_wg": [_P] * 13 + [_I, _I, _I, _F, _I] + _DROP
                             + [_I] * 4 + [_LL, _I, _P],
    # ypre, dout, gamma, w, dz, dres, dx, part, part2, sums, M, C, eps,
    # drop, per, rows, chunk, threads, smem, dtype, stream
    "idvs_proj_resln_bwd_wg": [_P] * 10 + [_I, _I, _F] + _DROP
                              + [_I] * 4 + [_LL, _I, _P],
    # x, part, out, nb, M, N, dtype, stream
    "idvs_colsum": [_P] * 3 + [_I] * 4 + [_P],
    # A, B, out, add, gate, bias, ws, M, N, K, sam, sak, sbk, sbn, splits,
    # pro_act, gate_act, out_act, out_f32, a_f32, gate_f32, dtype, stream
    "idvs_gemm": [_P] * 7 + [_I] * 3 + [_LL] * 4 + [_I] * 8 + [_P],
    # M, N, K, dtype, max_depth -> the K slices of idvs_gemm
    "idvs_gemm_splits": [_I] * 5,
    # src, dst, n, act, src_f32, stream
    "idvs_gemm_act_cast": [_P, _P, _LL, _I, _I, _P],
    # ids, dx, counts, table, out, M, D, V, dtype, stream
    "idvs_scatter_add_rows": [_P] * 5 + [_I] * 4 + [_P],
    # x, bias, wqkv, bqkv, wo, bo, ctx, out, windows, T, C, nh, P, bias_sp,
    # bias_sh, band, w, nwc, nwr, scale, G, HG, t_pad, dh_pad, warps_m,
    # warps_n, passes, smem, dtype, stream
    "idvs_win_attn_fwd": [_P] * 8 + [_I] * 5 + [_LL, _LL] + [_I] * 4
                         + [_F] + [_I] * 7 + [_LL, _I, _P],
    # x, w1, b1, w2, b2, gamma, beta, scale, out, h, M, C, F, eps, act,
    # res, rows, f_chunk, threads, smem, dtype, stream
    "idvs_premlp_fwd": [_P] * 10 + [_I] * 3 + [_F] + [_I] * 5
                       + [_LL, _I, _P],
    # x, gamma, beta, xn, stats, dout, scale, dy, M, C, eps, dtype, stream
    "idvs_premlp_ln_rows": [_P] * 8 + [_I, _I, _F, _I, _P],
    # x, dxn, gamma, stats, dout, dx, part, sums, nb, M, C, dtype, stream
    "idvs_premlp_ln_bwd": [_P] * 8 + [_I] * 4 + [_P],
    # x, dout, scale, gamma, beta, w1, b1, w2, hsave, dx, xn, dy, g, dh,
    # part, part2, sums, M, C, F, eps, act, res, per, rows, f_chunk,
    # threads, smem, dtype, stream
    "idvs_premlp_bwd": [_P] * 17 + [_I] * 3 + [_F] + [_I] * 6
                       + [_LL, _I, _P],
    # xn, dy, w1, b1, w2, hsave, g, dh, part, part2, sums, M, C, F, act,
    # per, rows, f_tile, stages, threads, producer_regs, consumer_regs,
    # smem, dtype, stream
    "idvs_premlp_bwd_wg": [_P] * 11 + [_I] * 11 + [_LL, _I, _P],
    # qkv, bias, dctx, dqkv, ctx, part, dbias, windows, T, nh, dh, P,
    # chunks, bias_sp, bias_sh, band, w, nwc, nwr, scale, dtype, stream
    "idvs_win_attn_bwd": [_P] * 7 + [_I] * 6 + [_LL, _LL] + [_I] * 4
                         + [_F, _I, _P],
    # windows, T, nh, dh, P, dtype -> the attention core's chunks
    "idvs_win_attn_bwd_chunks": [_I] * 6,
    # u, cand, ids, cand_ids, colmask, logpop, part, ce, m, l, M, N, D, L,
    # S, label_off, per, splits, smem, dtype, stream
    "idvs_inbatch_ce_fwd": [_P] * 10 + [_I] * 8 + [_LL, _I, _P],
    # u, cand, ids, cand_ids, colmask, logpop, m, l, ws, du, dcand, part_u,
    # part_c, M, N, D, L, S, label_off, dc, per_u, splits_u, per_c,
    # splits_c, smem, dtype, stream
    "idvs_inbatch_ce_bwd": [_P] * 13 + [_I] * 11 + [_LL, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def library_path() -> Path:
    """Path of the built library, building it first if it is missing."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in cu + cuh:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libidvs_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
    try:
        # one nvcc per source, all at once, then one link: the build takes
        # the slowest source's time, not the sum
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(cu, objs)]
        logs = [(p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src.name}:\n{log}" for src, (log, rc) in zip(cu, logs)
                  if rc != 0]
        if not failed:
            done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                failed = [f"link:\n{done.stdout}\n{done.stderr}"]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.idvs_cuda_error_string.argtypes = [ctypes.c_int]
            lib.idvs_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_device(*tensors: torch.Tensor) -> None:
    """The library's own CUDA runtime launches on device 0."""
    for t in tensors:
        if t.device.type != "cuda" or t.device.index not in (None, 0):
            raise ValueError(f"kernel operands must be on cuda:0, got "
                             f"{t.device}")


def check_aligned(*tensors: torch.Tensor) -> None:
    """The epilogue kernels move 4-element vectors: 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raises if a kernel entry point reported a CUDA error."""
    if err != 0:
        text = library().idvs_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
