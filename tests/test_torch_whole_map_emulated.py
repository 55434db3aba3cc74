"""The CUDA source of kernels 9 and 10 (``xfmamba_tpu_torch/csrc/
scan_whole_map.cu``: the whole-map scan of few images, a block per image
and channel slab with every kind, the map slice staged on chip, lanes per
chain, the kinds' parts summed in shared memory in a fixed order, one
launch a call) run on the CPU.

g++ compiles the source against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles, ``cp.async`` and the
bulk copies as plain copies, ex2 as ``std::exp2``; the launches and the
inline PTX rewritten first), and the port's wrappers (`nk_scan_v1`,
`fused_cross_scan`) call it through ctypes on CPU tensors.  The results
are held against the plain twins (`nk_scan_v1_plain`,
`fused_cross_scan_plain`) and against the JAX package's Pallas kernels in
interpret mode (``nk_scan_call`` and ``_core_pallas_fwd_impl``, which runs
``selective_scan_pallas.fused_cross_scan``): K 1 row_f and 4 cross2d; N
1, 5 and 16; 1 and 3 images; a ragged channel slab (D 40); 7 x 7 and a
ragged 5 x 6 map; slabs of 32, 16 and 8 channels and the one-study slab
choice; the large-map plan at small maps, forced by a lowered
shared-memory budget, and its bands of positions (-m slow: 112 x 112 and
128 x 128 maps past the parts that fit at one channel); calls refused by
the wrappers' checks or by the C entry counting nothing; kernel 10's
bfloat16 rounding of each direction at
N 1; the fixed order of the sums, bit for bit on exact inputs; and two
runs bit for bit.  Tolerances: the kernel takes exp2 of log2(e)-scaled A
and a polynomial softplus where the twins take ``torch.exp`` and
``log1p``, so float32 differs from the twins in the last bits: 2e-5 of
each output's largest magnitude; a bfloat16 output, or a part rounded to
bfloat16, may round the other way (one step of 2^-8 more).  The JAX
tolerance is the JAX package's own tests' (2e-4).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.ops.selective_scan_pallas import _core_pallas_fwd_impl
from xfmamba_tpu.ops.vss_block_pallas import nk_scan_call
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import fused_cross_scan as fcs
from xfmamba_tpu_torch.ops import nk_scan_v1 as v1
from xfmamba_tpu_torch.ops import scan_whole_map as wm
from xfmamba_tpu_torch.ops.nk_scan import scan_mode_kinds
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "staging.cuh", "scan_whole_map.cu")
CROSS2D = scan_mode_kinds("cross2d")
ROW_F = ("row_f",)


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's, ex2,
    mma.cuh's PTX, cp.async and the bulk copies (a plain copy, their
    barrier's operations none) the emulator's, the global timer 0."""
    if name == "mma.cuh":
        for fn, body in (("void mma_bf16", "emu_mma(c, a, b, true);"),
                         ("void mma_tf32", "emu_mma(c, a, b, false);"),
                         ("uint32_t to_tf32", "return emu_to_tf32(v);"),
                         ("void cp_async16", "std::memcpy(dst, src, src_bytes); std::memset("
                          "static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);"),
                         ("void cp_async_wait", "")):
            text = re.sub(rf"({re.escape(fn)}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
                          flags=re.S)
        text = re.sub(r"(void cp_async_commit\(\) \{).*?\}", r"\1 }", text)
        text = re.sub(r"__device__ __forceinline__ void ldmatrix_x4\(.*?\n\}\n", "", text,
                      flags=re.S)
    text = re.sub(r"(float fast_exp2\(float x\) \{).*?\n\}", r"\1 return std::exp2(x); }", text,
                  flags=re.S)
    text = re.sub(r"(long long stage_clock\(\) \{).*?\n\}", r"\1 return 0; }", text,
                  flags=re.S)
    for fn, body in (("void stage_bar_init", ""), ("void stage_bar_arrive", ""),
                     ("void stage_bar_wait", ""),
                     ("void stage_bulk_copy", "std::memcpy(dst, src, bytes);")):
        text = re.sub(rf"({re.escape(fn)}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
                      flags=re.S)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                  r"float* \1 = emu_smem;", text)
    return re.sub(r"(\w+)\s*<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text, flags=re.S)


def _check(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: status {status}")


@pytest.fixture(scope="module")
def emulated():
    """The emulated library, built once into the port's build directory
    (keyed on the sources and the stubs), bound as `build.library`, with
    the wrappers' CPU dispatch switched to the launch path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    texts = {n: (build.CSRC_DIR / n).read_text() for n in SOURCES}
    key = hashlib.sha256("".join(texts.values()).encode() + b"".join(
        p.read_bytes() for p in sorted(STUBS.glob("*.h")))).hexdigest()[:16]
    out = build.BUILD_DIR / f"emulated_{key}"
    so = out / "libwhole_map_emulated.so"
    if not so.exists():
        # each process rewrites and compiles in its own directory, then
        # renames its library into place: test workers may build at once
        src = out / f"src.{os.getpid()}"
        src.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():
            (src / name).write_text(_rewrite(name, text))
        tmp = out / f"lib.{os.getpid()}.tmp"
        subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                        "-include", "cstring", "-I", str(STUBS), "-I", str(src), "-x", "c++",
                        str(src / "scan_whole_map.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_whole_map_scan", "xfm_whole_map_smem"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    wm._plan.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        for module in (v1, fcs):
            mp.setattr(module, "on_cpu", lambda *t: False)
            mp.setattr(module, "require_cuda", lambda *t: None)
        mp.setattr(wm, "require_cuda", lambda *t: None)
        mp.setattr(wm, "stream", lambda t: None)
        yield lib
    wm._plan.cache_clear()


@pytest.fixture
def plan(emulated, monkeypatch):
    """Force the plan: ``plan(slab)`` the whole plan at that slab; ``plan(
    slab, chunk, (K, L, N, dtype))`` the chunked plan with chunks of that
    many steps, the shared-memory budget lowered to what its blocks take,
    below what the whole plan's would; with ``band`` the budget holds the
    parts of that many positions only."""
    def force(slab, chunk=None, shape=None, band=None):
        wm._plan.cache_clear()
        monkeypatch.setattr(wm, "SLABS", (slab,))
        monkeypatch.setattr(wm, "CHUNK_SLABS", (slab,))
        if chunk is not None:
            K, L, N, dtype = shape
            bf16 = int(dtype == torch.bfloat16)
            budget = emulated.xfm_whole_map_smem(0, K, L, chunk, N, slab, band or L, bf16)
            assert emulated.xfm_whole_map_smem(1, K, L, L, N, slab, L, bf16) > budget
            monkeypatch.setattr(wm, "CHUNK", chunk)
            monkeypatch.setattr(wm, "WHOLE_MAP_SMEM", budget)
    monkeypatch.setattr(wm.scan_whole_map_cuda, "by_plan", {})
    yield force
    wm._plan.cache_clear()


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _k9_case(seed, n, H, W, D, kinds, N, dtype):
    """Kernel 9's arguments: decays A in [-e^1.5, -1] and biases near
    softplus^-1 of 0.01-0.1, as in a trained model."""
    g = torch.Generator().manual_seed(seed)
    K, L = len(kinds), H * W
    return (torch.randn(n, L, D, generator=g).to(dtype),
        (0.5 * torch.randn(n, L, K * D, generator=g)).to(dtype),
        torch.randn(n, L, K * N, generator=g).to(dtype),
        torch.randn(n, L, K * N, generator=g).to(dtype),
        -torch.exp(1.5 * torch.rand(K * N, D, generator=g)),
        torch.randn(K, D, generator=g), 0.5 * torch.randn(K, D, generator=g) - 3.0,
        H, W, kinds)


def _k10_case(seed, n, H, W, D, N, dtype):
    """Kernel 10's arguments, x and the projections in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.randn(n, H, W, D, generator=g)).to(dtype),
            (0.5 * torch.randn(n, H, W, 4, D, generator=g) - 3.0).to(dtype),
            torch.randn(n, H, W, 4, N, generator=g).to(dtype),
            torch.randn(n, H, W, 4, N, generator=g).to(dtype),
            -torch.exp(1.5 * torch.rand(4, D, N, generator=g)), torch.randn(4, D, generator=g),
            0.1 * torch.randn(4, D, generator=g))


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-5 + 2 ** -8


# (images, H, W, D, kinds, N, slab): D 40 leaves a ragged last slab at
# every width (8 of 32, 8 of 16; 5 slabs of 8)
K9_CASES = [
    (1, 7, 7, 40, ROW_F, 16, 8),       # ShallowFuse at one study
    (3, 7, 7, 40, CROSS2D, 16, 32),    # Cross_SS2Dv5 at one study
    (3, 5, 6, 40, CROSS2D, 5, 16),     # a ragged map, N padded to four lanes of 4
    (1, 5, 6, 40, ROW_F, 1, 32),       # one lane a chain
    (1, 7, 7, 40, CROSS2D, 1, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,H,W,D,kinds,N,slab", K9_CASES)
def test_emulated_kernel9_matches_plain(emulated, plan, dtype, n, H, W, D, kinds, N, slab):
    """Kernel 9 against `nk_scan_v1_plain`, one counted call each, in the
    whole plan at the slab asked for; two runs give the same bits."""
    plan(slab)
    args = _k9_case(n + H + D + N, n, H, W, D, kinds, N, dtype)
    before = v1.nk_scan_v1.launches
    got = v1.nk_scan_v1(*args)
    assert v1.nk_scan_v1.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, H * W, D)
    assert _rel(got, v1.nk_scan_v1_plain(*args)) < _tol(dtype)
    assert torch.equal(got, v1.nk_scan_v1(*args))
    assert wm.scan_whole_map_cuda.by_plan == {f"whole, slab {slab}": 2}


def test_emulated_kernel9_refuses_a_graph(emulated, plan):
    """Kernel 9 has no backward: while autograd records, an operand that
    requires a gradient is refused before the launch (Cross_SS2Dv5's
    output would otherwise reach autograd only through its gate z);
    under ``torch.no_grad()`` the same call runs."""
    plan(32)
    args = _k9_case(4, 3, 7, 7, 40, CROSS2D, 16, torch.float32)
    dts = args[1].clone().requires_grad_()
    before = v1.nk_scan_v1.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        v1.nk_scan_v1(args[0], dts, *args[2:])
    assert v1.nk_scan_v1.launches == before and wm.scan_whole_map_cuda.by_plan == {}
    with torch.no_grad():
        got = v1.nk_scan_v1(args[0], dts, *args[2:])
    assert _rel(got, v1.nk_scan_v1_plain(*args)) < _tol(torch.float32)


# (images, H, W, D, N, slab)
K10_CASES = [
    (2, 7, 7, 40, 1, 32),              # phase 8d's d_state-1 core, narrowed
    (1, 5, 6, 40, 16, 8),
    (3, 5, 6, 40, 5, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,H,W,D,N,slab", K10_CASES)
def test_emulated_kernel10_matches_plain(emulated, plan, dtype, n, H, W, D, N, slab):
    """Kernel 10 against `fused_cross_scan_plain` (each direction rounded
    to bfloat16 for N = 1 with bfloat16 input), float32 out; two runs give
    the same bits."""
    plan(slab)
    args = _k10_case(n + H + D + N, n, H, W, D, N, dtype)
    before = fcs.fused_cross_scan.launches
    got = fcs.fused_cross_scan(*args)
    assert fcs.fused_cross_scan.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, H, W, D)
    tol = _tol(dtype) if N == 1 else 2e-5
    assert _rel(got, fcs.fused_cross_scan_plain(*args)) < tol
    assert torch.equal(got, fcs.fused_cross_scan(*args))
    assert wm.scan_whole_map_cuda.by_plan == {f"whole, slab {slab}": 2}


def test_emulated_kernel10_rounds_each_direction(emulated, plan):
    """N = 1 with bfloat16 input: each direction's C h + D u is rounded to
    bfloat16 before the float32 merge, as the plain twin and the Pallas
    kernel do; with N > 1 the directions stay in float32."""
    plan(8)
    for N in (1, 4):
        args = list(_k10_case(70 + N, 2, 5, 6, 40, N, torch.bfloat16))
        got = fcs.fused_cross_scan(*args)
        exact = fcs.fused_cross_scan(*[a.float() for a in args[:4]], *args[4:])
        assert _rel(got, fcs.fused_cross_scan_plain(*args)) < (_tol(torch.bfloat16) if N == 1
                                                               else 2e-5)
        assert (_rel(got, exact) > 1e-4) == (N == 1)


@pytest.mark.parametrize("kernel,chunk,slab", [(9, 16, 8), (9, 7, 4), (10, 7, 2), (10, 5, 1)])
def test_emulated_large_map_plan(emulated, plan, kernel, chunk, slab):
    """The chunked plan (forced by a budget below the whole plan's block),
    its last chunk ragged, takes the whole plan's steps and sums: the same
    bits as the whole plan, and the plain twin's values."""
    if kernel == 9:
        dtype, N = torch.float32, 16
        args, fn, plain = _k9_case(80, 2, 5, 6, 40, CROSS2D, N, dtype), \
            v1.nk_scan_v1, v1.nk_scan_v1_plain
    else:
        dtype, N = torch.bfloat16, 1
        args, fn, plain = _k10_case(81, 2, 5, 6, 40, N, dtype), \
            fcs.fused_cross_scan, fcs.fused_cross_scan_plain
    plan(8)
    whole = fn(*args)
    plan(slab, chunk, (4, 30, N, dtype))
    got = fn(*args)
    assert torch.equal(got, whole)
    assert _rel(got, plain(*args)) < _tol(dtype)
    assert wm.scan_whole_map_cuda.by_plan == {
        "whole, slab 8": 1, f"chunked x{-(-30 // chunk)}, slab {slab}": 1}


def test_emulated_plan_at_the_model_maps(emulated):
    """One study's K=1 call (1, 49, 1536) spreads over 96 blocks of 16
    channels instead of 48 of 32, and 36 images of K=4 keep blocks of 32;
    every fusion call and kernel 10 at the 7 x 7 map take the whole plan,
    two blocks to an SM at most 113 KB; kernel 10's 28 x 28 and 56 x 56
    stage maps take the chunked plan."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert wm.whole_map_plan(1, 49, 1, 16, 1536, bf16) == (True, 16, 49, 49)
    assert wm.whole_map_plan(36, 49, 4, 16, 1536, bf16) == (True, 32, 49, 49)
    for n, K, N, D in ((1, 1, 16, 1536), (3, 4, 16, 1536), (1, 1, 16, 2048), (3, 4, 16, 2048),
                       (12, 1, 16, 1536), (36, 4, 16, 1536), (6, 4, 1, 1536)):
        for dtype in (bf16, f32):
            whole, slab, chunk, band = wm.whole_map_plan(n, 49, K, N, D, dtype)
            assert whole and chunk == band == 49
            smem = emulated.xfm_whole_map_smem(1, K, 49, 49, N, slab, 49, int(dtype == bf16))
            assert 2 * (smem + 1024) <= 228 * 1024
    for H, D in ((28, 384), (56, 192)):
        for N in (1, 16):
            whole, slab, chunk, band = wm.whole_map_plan(2, H * H, 4, N, D, f32)
            assert not whole and chunk == wm.CHUNK and band == H * H
            assert emulated.xfm_whole_map_smem(0, 4, H * H, chunk, N, slab, band, 0) <= \
                wm.WHOLE_MAP_SMEM


def _exact_k9(K):
    """Kernel 9 on inputs whose every step is exact in float32: delta 32
    (softplus is the identity past 20), A 0 (decay 1), u 1/32, B 1, so h
    counts the steps; C of +-2^24 and u * sum D = 1 make the sum's order
    show in its rounding."""
    n, H, W, D, N = 1, 5, 6, 8, 1
    L = H * W
    C = torch.tensor([2.0 ** 24, -(2.0 ** 24), 3.0, 2.0 ** 23][:K]).repeat_interleave(N)
    return (torch.full((n, L, D), 1 / 32), torch.full((n, L, K * D), 32.0),
            torch.ones(n, L, K * N), C.expand(n, L, K * N).contiguous(),
            torch.zeros(K * N, D), torch.cat([torch.full((1, D), 32.0), torch.zeros(K - 1, D)]),
            torch.zeros(K, D), H, W, CROSS2D[:K])


def test_emulated_sums_in_the_plain_order(emulated, plan):
    """On exact inputs, kernel 9 adds u * sum D and the kinds' parts in
    kind order and kernel 10 merges the directions as (p0 + p2) + (p1 +
    p3): the plain twins' bits; another order gives other bits."""
    plan(8)
    args = _exact_k9(4)
    want = v1.nk_scan_v1_plain(*args)
    assert torch.equal(v1.nk_scan_v1(*args), want)
    u = args[0]
    parts = [v1.nk_scan_v1_plain(u, args[1][..., 8 * k:8 * k + 8], args[2][..., k:k + 1],
                                 args[3][..., k:k + 1], args[4][k:k + 1],
                                 torch.zeros(1, 8), args[6][k:k + 1], 5, 6, (CROSS2D[k],))
             for k in range(4)]
    assert not torch.equal(((parts[0] + parts[1]) + (parts[2] + parts[3])) + u * 32, want)
    x = u.view(1, 5, 6, 8)
    dts = args[1].view(1, 5, 6, 4, 8)
    BC = torch.ones(1, 5, 6, 4, 1)
    Cs = args[3].view(1, 5, 6, 4, 1)
    cross = (x, dts, BC, Cs, torch.zeros(4, 8, 1), torch.zeros(4, 8), torch.zeros(4, 8))
    want = fcs.fused_cross_scan_plain(*cross)
    assert torch.equal(fcs.fused_cross_scan(*cross), want)
    p = [q.view(want.shape) for q in parts]
    assert not torch.equal(((p[0] + p[1]) + p[2]) + p[3], want)


def _jax_case(seed, B, H, W, D, K, N):
    rng = np.random.default_rng(seed)
    f, L = np.float32, H * W
    return dict(u=rng.standard_normal((B, L, D)).astype(f),
                dts=(0.3 * rng.standard_normal((B, L, K * D))).astype(f),
                Bs=rng.standard_normal((B, L, K * N)).astype(f),
                Cs=rng.standard_normal((B, L, K * N)).astype(f),
                A=-np.exp(0.5 * rng.standard_normal((K * N, D))).astype(f),
                Dvec=rng.standard_normal((K, D)).astype(f),
                bias=(0.1 * rng.standard_normal((K, D))).astype(f))


@pytest.mark.parametrize("B,H,W,D,kinds,N", [(3, 5, 6, 40, CROSS2D, 5), (1, 7, 7, 40, ROW_F, 16)])
def test_emulated_kernel9_matches_pallas_interpret(emulated, B, H, W, D, kinds, N):
    """`nk_scan_v1` against ``nk_scan_call(..., interpret=True)``, the v1
    Pallas kernel, float32."""
    ops = _jax_case(B + H + N, B, H, W, D, len(kinds), N)
    names = ("u", "dts", "Bs", "Cs", "A", "Dvec", "bias")
    want = nk_scan_call(*(jnp.asarray(ops[k]) for k in names), H, W, kinds, interpret=True)
    got = v1.nk_scan_v1(*(T(ops[k]) for k in names), H, W, kinds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("N", [1, 16])
def test_emulated_kernel10_matches_pallas_interpret(emulated, N):
    """`fused_cross_scan` against ``_core_pallas_fwd_impl(...,
    interpret=True)`` (the Pallas kernels ``_scan_kernel_n1`` / ``_scan_kernel``
    and their float32 merge), float32."""
    args = [a.numpy() for a in _k10_case(90 + N, 2, 5, 6, 40, N, torch.float32)]
    want = _core_pallas_fwd_impl(*map(jnp.asarray, args), interpret=True)
    got = fcs.fused_cross_scan(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_emulated_phase_clock_counts_nothing(emulated, plan):
    """``phase_ns`` launches with the phase clock on (the emulator's timer
    reads 0) and returns a block's mean time in each phase; it counts no
    launch and no plan."""
    plan(16)
    k9 = _k9_case(5, 1, 7, 7, 40, CROSS2D, 16, torch.float32)
    k10 = _k10_case(6, 1, 5, 6, 40, 1, torch.float32)
    before = v1.nk_scan_v1.launches, fcs.fused_cross_scan.launches
    for phases in (v1.nk_scan_v1_cuda(*k9, phase_ns=True),
                   fcs.fused_cross_scan_cuda(*k10, phase_ns=True)):
        assert phases == dict.fromkeys(wm.PHASES + ("block",), 0.0)
    assert (v1.nk_scan_v1.launches, fcs.fused_cross_scan.launches) == before
    assert wm.scan_whole_map_cuda.by_plan == {}


@pytest.mark.parametrize("kernel,chunk,slab,band", [(9, 7, 4, 8), (9, 16, 8, 11),
                                                    (10, 5, 1, 7), (10, 7, 2, 13)])
def test_emulated_banded_plan(emulated, plan, kernel, chunk, slab, band):
    """The chunked plan whose budget holds the parts of ``band`` positions
    only (forced at a 5 x 6 map): the block walks every traversal once a
    band and writes the band's y; the whole plan's bits."""
    if kernel == 9:
        dtype, N = torch.float32, 16
        args, fn = _k9_case(82, 2, 5, 6, 40, CROSS2D, N, dtype), v1.nk_scan_v1
    else:
        dtype, N = torch.bfloat16, 1
        args, fn = _k10_case(83, 2, 5, 6, 40, N, dtype), fcs.fused_cross_scan
    plan(8)
    whole = fn(*args)
    plan(slab, chunk, (4, 30, N, dtype), band)
    assert wm.whole_map_plan(2, 30, 4, N, 40, dtype) == (False, slab, chunk,
                                                         -(-30 // -(-30 // band)))
    assert torch.equal(fn(*args), whole)
    assert wm.scan_whole_map_cuda.by_plan == {
        "whole, slab 8": 1, f"chunked x{-(-30 // chunk)}, slab {slab}, {-(-30 // band)} bands": 1}


def test_emulated_plan_past_the_old_limit(emulated):
    """Maps whose parts of one channel do not fit in shared memory (kernel
    9 at 112 x 112, K 4, N 16; kernel 10 at 128 x 128, N 1) take the
    chunked plan at one channel in two bands; the earlier plan refused them."""
    for H, N in ((112, 16), (128, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            whole, slab, chunk, band = wm.whole_map_plan(1, H * H, 4, N, 192, dtype)
            assert (whole, slab, chunk, -(-H * H // band)) == (False, 1, wm.CHUNK, 2)
            assert emulated.xfm_whole_map_smem(0, 4, H * H, chunk, N, 1, band,
                                               int(dtype == torch.bfloat16)) <= wm.WHOLE_MAP_SMEM
            assert emulated.xfm_whole_map_smem(0, 4, H * H, chunk, N, 1, H * H, 0) > \
                wm.WHOLE_MAP_SMEM


@pytest.mark.slow
@pytest.mark.parametrize("kernel", [9, 10])
def test_emulated_map_past_the_accumulator(emulated, kernel):
    """Kernel 9 at 112 x 112 (K 4, N 16) and kernel 10 at 128 x 128 (N 1),
    past the maps whose parts fit in shared memory at one channel, in the
    plan the port picks (two bands at one channel), float32, against the
    plain twins (about 30 s each)."""
    if kernel == 9:
        args = _k9_case(84, 1, 112, 112, 2, CROSS2D, 16, torch.float32)
        fn, plain, L = v1.nk_scan_v1, v1.nk_scan_v1_plain, 112 * 112
    else:
        args = _k10_case(85, 1, 128, 128, 2, 1, torch.float32)
        fn, plain, L = fcs.fused_cross_scan, fcs.fused_cross_scan_plain, 128 * 128
    wm.scan_whole_map_cuda.by_plan.clear()
    got = fn(*args)
    assert _rel(got, plain(*args)) < _tol(torch.float32)
    assert wm.scan_whole_map_cuda.by_plan == {f"chunked x{-(-L // wm.CHUNK)}, slab 1, 2 bands": 1}


def test_emulated_refused_calls_count_nothing(emulated, plan, monkeypatch):
    """A call that the wrapper's checks refuse (Bs of another dtype, a
    d_state past 16) or that the C entry refuses (a slab of 64 channels)
    raises and adds nothing to ``nk_scan_v1.launches``,
    ``fused_cross_scan.launches`` or ``scan_whole_map_cuda.by_plan``; the
    same call with a valid plan counts one."""
    plan(8)
    k9 = list(_k9_case(86, 1, 5, 6, 40, CROSS2D, 4, torch.float32))
    k10 = list(_k10_case(87, 1, 5, 6, 40, 4, torch.float32))
    calls = ((v1.nk_scan_v1, k9, 2), (fcs.fused_cross_scan, k10, 2))

    def counts():
        return (v1.nk_scan_v1.launches, fcs.fused_cross_scan.launches,
                dict(wm.scan_whole_map_cuda.by_plan))

    before = counts()
    for fn, args, b in calls:
        bad = list(args)
        bad[b] = bad[b].double()
        with pytest.raises((TypeError, ValueError)):
            fn(*bad)
    with pytest.raises(ValueError):
        fcs.fused_cross_scan(*k10[:4], torch.zeros(4, 40, 17), *k10[5:])
    assert counts() == before
    with monkeypatch.context() as mp:
        mp.setattr(wm, "whole_map_plan", lambda n, L, *a: (True, 64, L, L))
        for fn, args, _ in calls:
            with pytest.raises(RuntimeError):
                fn(*args)
    assert counts() == before
    for fn, args, _ in calls:
        fn(*args)
    assert counts() == (before[0] + 1, before[1] + 1, {"whole, slab 8": 2})
