"""``gemm_plain`` (ops/cuda/gemm.py), the contract of csrc/gemm.cu in PyTorch
ops, against the JAX package's own pieces of the same products: ``_dot``,
``_act_f32`` and ``_dact_f32`` of idvs/morec_tpu/ops/pallas/mlp.py, composed
as ``_bwd_post_kernel`` (:485-494) and ``_bwd_proj_kernel`` (:759-762)
compose them, and as ``_bwd_kernel`` recomputes h. The same numpy inputs,
at small odd shapes, in every stride layout the port's call sites give the
kernel and with each epilogue.

Tolerances: float32 1e-5 of the largest value (sums in another order);
bfloat16 one bf16 rounding of the output (2^-7 of each value) and 2^-10 of
the largest value where a sum that cancels sits near a rounding edge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from idvs.morec_tpu.ops.pallas.mlp import _act_f32, _dact_f32, _dot
from idvs.morec_tpu_torch.ops.cuda import gemm as gemm_mod
from idvs.morec_tpu_torch.ops.cuda.gemm import gemm, gemm_plain

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [(7, 9, 13), (33, 17, 40), (1, 24, 3)]   # (M, N, K)
# A(m, k) and B(k, n) in the layouts of the call sites: A k-contiguous with
# B n-contiguous (x w), with B k-contiguous (dz wᵀ), and A m-contiguous
# with B n-contiguous (xᵀ dz)
LAYOUTS = ("kn", "kk", "mn")


def _operand(rng, rows, cols, dtype):
    """An (rows, cols) array in the compute dtype, as numpy float32 values
    both frameworks hold exactly."""
    a = rng.standard_normal((rows, cols)).astype(np.float32)
    return torch.from_numpy(a).to(dtype).float().numpy()


def _layout(layout, a, b):
    """The torch operands and strides of A (M, K) and B (K, N) stored in
    `layout`, and the JAX arrays with the contracting dims of ``_dot``."""
    M, K = a.shape
    N = b.shape[1]
    if layout[0] == "k":          # A stored (M, K)
        ta, sa, ja, ca = a, (K, 1), a, 1
    else:                          # A stored (K, M): xᵀ
        ta, sa, ja, ca = a.T.copy(), (1, M), a.T.copy(), 0
    if layout[1] == "n":          # B stored (K, N)
        tb, sb, jb, cb = b, (N, 1), b, 0
    else:                          # B stored (N, K): wᵀ
        tb, sb, jb, cb = b.T.copy(), (1, K), b.T.copy(), 1
    return (ta, sa, tb, sb), (ja, ca, jb, cb)


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _assert_close(got, want, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    if name == "f32":
        tol = 1e-5 * scale
    else:
        tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -10 * scale
    assert np.all(np.abs(got - want) <= tol), float(
        np.abs(got - want).max())


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_product_matches_dot(M, N, K, layout, name):
    """The bare product in each layout: dW = xᵀ dz, dx = dz Wᵀ, x W."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(M * 100 + K)
    a, b = _operand(rng, M, K, dt), _operand(rng, K, N, dt)
    (ta, sa, tb, sb), (ja, ca, jb, cb) = _layout(layout, a, b)
    got = gemm_plain(_torch(ta, dt), _torch(tb, dt), M, N, K, sa, sb)
    want = _dot(jnp.asarray(ja, jdt), jnp.asarray(jb, jdt), ca,
                cb).astype(jdt)
    assert got.dtype == dt
    _assert_close(got, want, name)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
def test_dw2_of_the_recomputed_activation(act, name):
    """dW2 = cast(act(h))ᵀ dz (mlp.py:485-487) with h (rows, F) in the
    compute dtype and, as the pre-LN backward recomputes it, in float32:
    A is h m-contiguous through pro_act."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(3)
    rows, F, C = 37, 24, 9
    dz = _operand(rng, rows, C, dt)
    for h_dt in {dt, torch.float32}:
        h = _operand(rng, rows, F, h_dt)
        got = gemm_plain(_torch(h, h_dt), _torch(dz, dt), F, C, rows,
                         (1, F), (C, 1), act=act, pro_act=True, dtype=dt)
        g = _act_f32(jnp.asarray(h), act).astype(jdt)
        want = _dot(g, jnp.asarray(dz, jdt), 0, 0).astype(jdt)
        _assert_close(got, want, name)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
@pytest.mark.parametrize("gate_f32", [False, True])
def test_dh_gated_by_the_activation_derivative(gate_f32, act, name):
    """dh = cast((dz W2ᵀ) * act'(h)) (mlp.py:488-489), h in the compute
    dtype or float32: the gate epilogue over the k-contiguous layout."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(4)
    rows, C, F = 21, 16, 11
    dz, w2 = _operand(rng, rows, C, dt), _operand(rng, F, C, dt)
    h_dt = torch.float32 if gate_f32 else dt
    h = _operand(rng, rows, F, h_dt)
    got = gemm_plain(_torch(dz, dt), _torch(w2, dt), rows, F, C, (C, 1),
                     (1, C), gate=_torch(h, h_dt), act=act)
    dg = _dot(jnp.asarray(dz, jdt), jnp.asarray(w2, jdt), 1, 1)
    want = (dg * _dact_f32(jnp.asarray(h), act)).astype(jdt)
    _assert_close(got, want, name)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dx_adds_the_float_residual(name):
    """dx = dh W1ᵀ + dyp (mlp.py:493-494): the float addend epilogue."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(5)
    rows, F, C = 19, 40, 13
    dh, w1 = _operand(rng, rows, F, dt), _operand(rng, C, F, dt)
    dyp = rng.standard_normal((rows, C)).astype(np.float32)
    got = gemm_plain(_torch(dh, dt), _torch(w1, dt), rows, C, F, (F, 1),
                     (1, F), add=torch.from_numpy(dyp))
    want = (_dot(jnp.asarray(dh, jdt), jnp.asarray(w1, jdt), 1, 1)
            + jnp.asarray(dyp)).astype(jdt)
    _assert_close(got, want, name)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_recomputed_h_with_bias_in_float(name):
    """h = xn W1 + b1 in float32 (the pre-LN backward's recompute, mlp.py
    _bwd_kernel after :134): the bias epilogue with out_f32."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(6)
    rows, C, F = 27, 8, 36
    xn, w1 = _operand(rng, rows, C, dt), _operand(rng, C, F, dt)
    b1 = _operand(rng, 1, F, dt)[0]
    got = gemm_plain(_torch(xn, dt), _torch(w1, dt), rows, F, C, (C, 1),
                     (F, 1), bias=_torch(b1, dt), out_f32=True)
    assert got.dtype == torch.float32
    want = (_dot(jnp.asarray(xn, jdt), jnp.asarray(w1, jdt), 1, 0)
            + jnp.asarray(b1, jdt).astype(jnp.float32))
    _assert_close(got, want, "f32")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_proj_backward_products(name):
    """_bwd_proj_kernel's pair (mlp.py:759-762): dW = xᵀ dproj and dx =
    dproj Wᵀ, both cast to the compute dtype."""
    dt, jdt = DTYPES[name]
    rng = np.random.default_rng(7)
    rows, C = 45, 24
    x, dproj = _operand(rng, rows, C, dt), _operand(rng, rows, C, dt)
    w = _operand(rng, C, C, dt)
    got_dw = gemm_plain(_torch(x, dt), _torch(dproj, dt), C, C, rows,
                        (1, C), (C, 1))
    got_dx = gemm_plain(_torch(dproj, dt), _torch(w, dt), rows, C, C,
                        (C, 1), (1, C))
    jx, jd, jw = (jnp.asarray(v, jdt) for v in (x, dproj, w))
    _assert_close(got_dw, _dot(jx, jd, 0, 0).astype(jdt), name)
    _assert_close(got_dx, _dot(jd, jw, 1, 1).astype(jdt), name)


def test_gemm_on_the_cpu_is_the_plain_version():
    """gemm() runs gemm_plain for CPU tensors and counts no launch."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    gate = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    before = gemm.launches
    got = gemm(a, b, 5, 8, 16, (16, 1), (8, 1), 0, gate=gate, act="relu")
    want = gemm_plain(a, b, 5, 8, 16, (16, 1), (8, 1), gate=gate,
                      act="relu")
    assert torch.equal(got, want) and gemm.launches == before
    assert gemm_mod.ACTS == {"gelu": 1, "relu": 2, "quick_gelu": 3}
