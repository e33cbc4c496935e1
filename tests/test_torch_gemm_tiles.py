"""The tensor-core product (csrc/gemm.cu, bf16) at the edges of its tiling,
and the scatter-add (csrc/embed_scatter.cu) at its edges, against their
plain versions on the card. Every test needs an NVIDIA GPU and skips
without one. On the card (no jax there, so without the repo's conftest):

    python -m pytest tests/test_torch_gemm_tiles.py -q --noconftest

gemm: each stride layout (A k- or m-contiguous, B k- or n-contiguous), M
and N on both sides of the 128-row tile and of a 16-row fragment, K from
a part of one 32-deep step to many split slices, deep and wide products
as the text FFN's, each epilogue, the A prologue (a pre-pass) from bf16
and from float, the same bits on two runs, and the operands the kernel
refuses. Tolerance: one bf16 rounding of the output
(2^-7 of each value) and 2^-10 of the largest value, where both sides'
float sums (in other orders) sit near a rounding edge; float32 outputs
2^-10 of the largest value. The float32 body (3xTF32) likewise at its
tiles' edges, each epilogue, the prologue on the float, rows that are not
16-byte aligned (through the C entry), the depth bound and the same bits
on two runs, within 1e-5 of the largest value (float32's rounding in
another order).
"""

import numpy as np
import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda import lib
from idvs.morec_tpu_torch.ops.cuda.embed_scatter import (
    scatter_add_rows, scatter_add_rows_plain)
from idvs.morec_tpu_torch.ops.cuda.gemm import gemm, gemm_plain, splits_of

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
MNS = (1, 7, 16, 17, 96, 127, 128, 129, 288)
KS = (8, 24, 96, 3137, 40000)
LAYOUTS = ("kn", "kk", "mn", "mk")


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _up8(n):
    return -(-n // 8) * 8


def _stored(gen, rows, cols, dtype):
    """A (rows, cols) operand in a buffer whose rows are padded to a
    multiple of 8 elements (the padding holds noise), and its row stride."""
    ld = _up8(cols)
    buf = torch.randn(rows, ld, generator=gen, device="cuda").to(dtype)
    return buf, ld


def _operands(gen, layout, M, N, K, a_dtype=BF16):
    """A (M, K) and B (K, N) stored in `layout` with their strides."""
    if layout[0] == "k":
        A, ld = _stored(gen, M, K, a_dtype)
        sa = (ld, 1)
    else:
        A, ld = _stored(gen, K, M, a_dtype)
        sa = (1, ld)
    if layout[1] == "n":
        B, ld = _stored(gen, K, N, BF16)
        sb = (ld, 1)
    else:
        B, ld = _stored(gen, N, K, BF16)
        sb = (1, ld)
    return A, sa, B, sb


def _assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    rounded = got.dtype == BF16
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    tol = 2.0 ** -10 * scale + (2.0 ** -7 * want.abs() if rounded else 0.0)
    err = (got - want).abs() - tol
    assert torch.isfinite(got).all() and err.max().item() <= 0, (
        (got - want).abs().max().item(), scale)


def _check(gen, layout, M, N, K, **kw):
    A, sa, B, sb = _operands(gen, layout, M, N, K,
                             kw.pop("a_dtype", BF16))
    code = lib.DTYPE_CODES[BF16]
    before = gemm.launches
    got = gemm(A, B, M, N, K, sa, sb, code, dtype=BF16, **kw)
    assert gemm.launches == before + 1
    _assert_close(got, gemm_plain(A, B, M, N, K, sa, sb, dtype=BF16, **kw))


@pytest.mark.parametrize("N", MNS)
@pytest.mark.parametrize("M", MNS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_product_at_the_tile_edges(layout, M, N):
    """The bare product at every M x N on both sides of the tiles, each K
    (one split and many)."""
    gen = torch.Generator(device="cuda").manual_seed(M * 1000 + N)
    for K in KS:
        _check(gen, layout, M, N, K)


EPILOGUES = ["bias", "add", "gate_gelu", "gate_relu", "gate_quick_gelu",
             "gate_f32", "out_f32", "bias_out_f32"]


def _epilogue(gen, epilogue, M, N):
    """gemm's keyword arguments for one epilogue at (M, N)."""
    g = lambda *s, dt=BF16: torch.randn(*s, generator=gen,
                                        device="cuda").to(dt)
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = g(N)
    if epilogue == "add":
        kw["add"] = g(M, N, dt=torch.float32)
    if epilogue.startswith("gate"):
        kw["act"] = epilogue[5:] if epilogue != "gate_f32" else "gelu"
        kw["gate"] = g(M, N, dt=torch.float32 if epilogue == "gate_f32"
                       else BF16)
    if "out_f32" in epilogue:
        kw["out_f32"] = True
    return kw


@pytest.mark.parametrize("K", (24, 3137))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_epilogues(epilogue, layout, K):
    """Each epilogue on the float tile the accumulators leave (M and N
    odd, so the 8-column pieces take their element-by-element edge) and
    through the split's second pass."""
    gen = torch.Generator(device="cuda").manual_seed(K)
    for M, N in ((129, 17), (288, 96), (33, 288)):
        _check(gen, layout, M, N, K, **_epilogue(gen, epilogue, M, N))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("epilogue", ["none"] + EPILOGUES)
def test_text_ffn_shapes(layout, epilogue):
    """Deep and wide products as the text FFN's backward has them (N a
    multiple of the tile and not, and no multiple of 8; M at the edges of
    the row tile; one split and many)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for M, N, K in ((129, 512, 512), (7, 777, 3137), (300, 1031, 600),
                    (96, 2048, 40000)):
        _check(gen, layout, M, N, K, **_epilogue(gen, epilogue, M, N))


@pytest.mark.parametrize("a_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_activation_prologue(layout, act, a_dtype):
    """cast(act(A)) by the pre-pass, A in bf16 or float (dW2 =
    cast(act(h))ᵀ dz), at edges of the tiles and of the 8-element chunk,
    and the cast of a float A alone."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for M, N, K in ((384, 96, 3137), (7, 17, 24), (129, 129, 40000),
                    (2048, 512, 2000)):
        _check(gen, layout, M, N, K, act=act, pro_act=True, a_dtype=a_dtype)
    _check(gen, layout, 17, 9, 96, a_dtype=torch.float32)   # a cast only


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_runs_give_the_same_bits(layout):
    """Split over K, the slices are added in a fixed order."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    code = lib.DTYPE_CODES[BF16]
    for M, N, K in ((96, 288, 40000), (288, 96, 3137), (17, 129, 40000),
                    (96, 2048, 40000)):
        A, sa, B, sb = _operands(gen, layout, M, N, K)
        assert splits_of(M, N, K, code) > 1
        one = gemm(A, B, M, N, K, sa, sb, code)
        two = gemm(A, B, M, N, K, sa, sb, code)
        torch.cuda.synchronize()
        assert torch.equal(one, two)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_refuses_rows_that_are_not_16_byte_aligned(dtype):
    """A base off 16 bytes, a row stride that is no multiple of 8, or no
    stride of 1 raises before any launch."""
    code = lib.DTYPE_CODES[dtype]
    A = torch.zeros(64 * 40 + 8, device="cuda", dtype=dtype)
    B = torch.zeros(40, 64, device="cuda", dtype=dtype)
    before = gemm.launches
    for a, sa in ((A[1:], (40, 1)), (A, (36, 1)), (A, (1, 1)),
                  (A, (40, 8))):
        with pytest.raises(ValueError, match="16-byte"):
            gemm(a, B, 64, 64, 36, sa, (64, 1), code)
    with pytest.raises(ValueError, match="operand B"):
        gemm(A, B, 64, 60, 36, (40, 1), (60, 1), code)
    assert gemm.launches == before


def test_float32_edition_unchanged():
    """The float32 body (3xTF32 on the tensor cores, 128 x 128 tiles 16
    floats deep a stage) at edges of its tiles, within float32's rounding
    of the plain version (1e-5 of the largest value, as when it ran on the
    FMA units)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    code = lib.DTYPE_CODES[torch.float32]
    for layout in LAYOUTS:
        for M, N, K in ((129, 17, 3137), (7, 288, 24)):
            A, sa, B, sb = _operands(gen, layout, M, N, K, torch.float32)
            B = B.float()
            got = gemm(A, B, M, N, K, sa, sb, code)
            want = gemm_plain(A, B, M, N, K, sa, sb)
            torch.cuda.synchronize()
            scale = max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= 1e-5 * scale


F32 = torch.float32
F32_TOL = 1e-5      # of max(1, the largest value), test_float32_edition_...


def _check_f32(gen, layout, M, N, K, **kw):
    """The float32 body against gemm_plain, every operand in float32."""
    A, sa, B, sb = _operands(gen, layout, M, N, K, F32)
    B = B.float()
    before = gemm.launches
    got = gemm(A, B, M, N, K, sa, sb, lib.DTYPE_CODES[F32], **kw)
    assert gemm.launches == before + 1
    want = gemm_plain(A, B, M, N, K, sa, sb, **kw)
    torch.cuda.synchronize()
    assert got.dtype == F32 and got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= F32_TOL * scale


@pytest.mark.parametrize("N", (1, 17, 128, 129, 288))
@pytest.mark.parametrize("M", (1, 7, 16, 127, 129))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_float32_body_at_the_tile_edges(layout, M, N):
    """M and N on both sides of the 128-row tile and of a 16-row fragment,
    K from part of one 16-deep stage to many split slices."""
    gen = torch.Generator(device="cuda").manual_seed(M * 1000 + N + 1)
    for K in (5, 16, 24, 3137):
        _check_f32(gen, layout, M, N, K)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_float32_epilogues(layout, epilogue):
    """Each epilogue in float32 (bias and gate in float), one split and
    several."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    for M, N, K in ((129, 17, 24), (288, 96, 3137), (33, 288, 600)):
        kw = {k: (v.float() if torch.is_tensor(v) else v)
              for k, v in _epilogue(gen, epilogue, M, N).items()}
        _check_f32(gen, layout, M, N, K, **kw)


@pytest.mark.parametrize("act", ["gelu", "relu", "quick_gelu"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_float32_prologue(layout, act):
    """act(A) on the float in the body, before the split (the float32
    C = 2048 tail's cast(act(h)) w2), at the tiles' edges."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for M, N, K in ((640, 2048, 8192), (10, 2048, 8192), (7, 17, 24),
                    (129, 129, 3137)):
        _check_f32(gen, layout, M, N, K, act=act, pro_act=True)


def _c_gemm(A, B, M, N, K, sa, sb, out, ws=None, splits=1):
    """idvs_gemm itself in float32, past the wrapper's checks."""
    return lib.library().idvs_gemm(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), None, None, None,
        None if ws is None else ws.data_ptr(), M, N, K, *sa, *sb, splits, 0,
        1, 0, 1, 1, 0, lib.DTYPE_CODES[F32], lib.stream_handle(A))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_float32_c_entry_refuses_rows_that_are_not_16_byte_aligned(layout):
    """The C entry takes float operands whose rows start 16-byte aligned
    and refuses others (a base 4 bytes past 16, a row stride that is no
    multiple of 4 floats), as it does bf16 ones."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    M, N, K = 129, 17, 3137
    A, sa, B, sb = _operands(gen, layout, M, N, K, F32)
    B = B.float()
    out = torch.empty(M, N, device="cuda")
    assert _c_gemm(A, B, M, N, K, sa, sb, out) == 0
    want = gemm_plain(A, B, M, N, K, sa, sb)
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (out - want).abs().max().item() <= F32_TOL * scale
    shifted = lambda t: torch.empty(t.numel() + 1, device="cuda")[1:]
    odd = lambda s: tuple(x - 1 if x > 1 else x for x in s)
    for args in ((shifted(A), B, sa, sb), (A, shifted(B), sa, sb),
                 (A, B, odd(sa), sb), (A, B, sa, odd(sb))):
        assert _c_gemm(*args[:2], M, N, K, *args[2:], out) != 0


@pytest.mark.parametrize("M", (1, 10, 640))
def test_float32_bounds_its_tensor_core_depth(M):
    """max_depth bounds the float32 body's slices too: the C = 2048 tail's
    dense1 in training, h = x w1 + b1 at K = 2048 in slices of at most 512
    added in float, within 2^-20 of mean |h| of the float64 sum (as the
    bf16 body's, tests/test_torch_mlp_resln_tiles.py)."""
    C, F, depth = 2048, 8192, 512
    code = lib.DTYPE_CODES[F32]
    assert splits_of(M, F, C, code, depth) >= C // depth
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = 2.0 * torch.randn(M, C, generator=gen, device="cuda")
    w1 = torch.randn(C, F, generator=gen, device="cuda") * C ** -0.5
    b1 = 0.1 * torch.randn(F, generator=gen, device="cuda")
    h = gemm(x, w1, M, F, C, (C, 1), (F, 1), code, bias=b1, out_f32=True,
             max_depth=depth)
    exact = x.double() @ w1.double() + b1.double()
    torch.cuda.synchronize()
    err = (h.double() - exact).abs().mean().item()
    assert err <= 2.0 ** -20 * exact.abs().mean().item(), err


@pytest.mark.parametrize("layout", LAYOUTS)
def test_float32_two_runs_give_the_same_bits(layout):
    gen = torch.Generator(device="cuda").manual_seed(23)
    code = lib.DTYPE_CODES[F32]
    for M, N, K in ((96, 288, 40000), (17, 129, 3137)):
        A, sa, B, sb = _operands(gen, layout, M, N, K, F32)
        B = B.float()
        assert splits_of(M, N, K, code) > 1
        one = gemm(A, B, M, N, K, sa, sb, code)
        two = gemm(A, B, M, N, K, sa, sb, code)
        torch.cuda.synchronize()
        assert torch.equal(one, two)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("D", [8, 96, 512, 33])
@pytest.mark.parametrize("ids_of", ["none", "one", "every", "runs"])
def test_scatter_add_rows_edges(ids_of, D, dtype):
    """No ids (every row zero), every id the same (one hot row), ids that
    touch every row, and titles that end in runs of the padding id; D a
    multiple of 8 and not. Float atomics: float32 reassociation (1e-4 of
    the largest sum) or one bf16 rounding of the cast sum (1e-2)."""
    rng = np.random.default_rng(D)
    V = 1000
    ids = {"none": np.zeros(0, np.int64),
           "one": np.full(4000, 17, np.int64),
           "every": rng.permutation(np.repeat(np.arange(V), 3)),
           "runs": (rng.integers(1, V, size=(200, 30))
                    * (np.arange(30)[None] < rng.integers(
                        5, 31, size=200)[:, None])).reshape(-1)}[ids_of]
    ids = torch.from_numpy(ids).cuda()
    dx = torch.from_numpy(rng.standard_normal((ids.numel(), D)).astype(
        np.float32)).cuda().to(dtype)
    before = scatter_add_rows.launches
    got = scatter_add_rows(ids, dx, V)
    want = scatter_add_rows_plain(ids, dx, V)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert got.shape == (V, D) and got.dtype == dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    untouched = torch.ones(V, dtype=torch.bool, device="cuda")
    untouched[ids] = False
    assert (got[untouched] == 0).all()
