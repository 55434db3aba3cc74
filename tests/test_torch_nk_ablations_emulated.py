"""The CUDA source of kernels 17 and 18 (``xfmamba_tpu_torch/csrc/
nk_scan_ablations.cu``: the v4 and wide-state nk scans, a block per image
and channel slab with every kind, the map slice staged on chip, kernel 17 a
lane per (kind, channel, state) with the states summed by shuffles at
every step, kernel 18 a thread per (kind pair, channel) walking both chains
of the pair in one loop, the parts summed in shared memory in the plain
twins' order, one launch a call) run on the CPU.

g++ compiles the source against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles, ``cp.async`` and the
bulk copies as plain copies, ex2 as ``std::exp2``; the launches and the
inline PTX rewritten first), and the port's wrappers (`nk_scan_v4`,
`nk_scan_v3`) call it through ctypes on CPU tensors.  The results are held
against the plain twins (`nk_scan_v4_plain`, `nk_scan_v3_plain`) and
against the JAX package's Pallas kernels in interpret mode
(``nk_scan_call_v4`` / ``nk_scan_call_v3``): K 1 and 4 in the cross2d,
unidi and bidi modes; N 16 and odd; H != W; a ragged last slab (D 200);
the chunked plan, forced by a lowered shared-memory budget, its last chunk
ragged, and in bands of positions where the accumulator does not hold the
map (a 256 x 256 map in the plan the port picks, under ``slow``); both
dtypes; the fixed order of the kind sums, bit for bit on
exact inputs; and two runs bit for bit.  Tolerances: the kernels take exp2
of log2(e)-scaled A and a polynomial softplus where the twins take
``torch.exp`` and ``log1p``, and sum the states in another order, so
float32 differs from the twins in the last bits: 2e-5 of each output's
largest magnitude; bfloat16 5e-3.  The JAX tolerance is the JAX package's
own tests' (2e-4).
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

from xfmamba_tpu.ops.ablations.nk_scan_v4 import nk_scan_call_v4
from xfmamba_tpu.ops.ablations.nk_scan_wide import nk_scan_call_v3
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.ablations import ablation_scan as ab
from xfmamba_tpu_torch.ops.ablations import nk_scan_v4, nk_scan_wide
from xfmamba_tpu_torch.ops.nk_scan import scan_mode_kinds
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "staging.cuh", "nk_scan_ablations.cu")
CROSS2D = scan_mode_kinds("cross2d")
BIDI = scan_mode_kinds("bidi")
UNIDI = scan_mode_kinds("unidi")
ROW_F = ("row_f",)
# kernel -> (wrapper, its launch without the gate's checks, plain twin)
KERNELS = {"v4": (nk_scan_v4.nk_scan_v4, nk_scan_v4.nk_scan_v4_cuda, nk_scan_v4.nk_scan_v4_plain),
           "v3": (nk_scan_wide.nk_scan_v3, nk_scan_wide.nk_scan_v3_cuda,
                  nk_scan_wide.nk_scan_v3_plain)}


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's, ex2,
    cp.async and the bulk copies (a plain copy, their barrier's operations
    none) the emulator's, the global timer 0."""
    if name == "mma.cuh":
        for fn, body in (("void cp_async16", "std::memcpy(dst, src, src_bytes); std::memset("
                          "static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);"),
                         ("void cp_async_wait", "")):
            text = re.sub(rf"({re.escape(fn)}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
                          flags=re.S)
        text = re.sub(r"(void cp_async_commit\(\) \{).*?\}", r"\1 }", text)
        # the tensor-core helpers are not used here
        text = text[:text.index("__device__ __forceinline__ void ldmatrix_x4")] + "}\n"
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
    so = out / "libnk_ablations_emulated.so"
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
                        str(src / "nk_scan_ablations.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_nk_scan_v4", "xfm_nk_scan_v3", "xfm_nk_ablation_smem"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    ab._plan.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        for module in (nk_scan_v4, nk_scan_wide):
            mp.setattr(module, "on_cpu", lambda *t: False)
        mp.setattr(ab, "require_cuda", lambda *t: None)
        mp.setattr(ab, "stream", lambda t: None)
        yield lib
    ab._plan.cache_clear()


@pytest.fixture
def plan(emulated, monkeypatch):
    """Force a kernel's plan: ``plan(kernel, slab)`` the whole plan at that
    slab; ``plan(kernel, slab, chunk, (K, L, N, dtype))`` the chunked plan
    with chunks of that many steps, the shared-memory budget lowered to what
    its blocks take, below what the whole plan's would; with ``band`` the
    budget holds an accumulator of that many positions only, so that the
    block walks the map in bands."""
    def force(kernel, slab, chunk=None, shape=None, band=None):
        ab._plan.cache_clear()
        monkeypatch.setitem(ab.SLABS, kernel, (slab,))
        monkeypatch.setitem(ab.CHUNK_SLABS, kernel, (slab,))
        if chunk is not None:
            K, L, N, dtype = shape
            bf16 = int(dtype == torch.bfloat16)
            code = ab.KERNELS.index(kernel)
            budget = emulated.xfm_nk_ablation_smem(code, 0, K, L, chunk, N, slab, band or L, bf16)
            assert emulated.xfm_nk_ablation_smem(code, 1, K, L, L, N, slab, L, bf16) > budget
            monkeypatch.setattr(ab, "CHUNK", chunk)
            monkeypatch.setattr(ab, "ABLATION_SMEM", budget)
    monkeypatch.setattr(ab.ablation_scan_cuda, "by_plan", {})
    yield force
    ab._plan.cache_clear()


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _case(seed, n, H, W, D, kinds, N, dtype):
    """The nk contract's arguments: decays A in [-e^1.5, -1] and biases near
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


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 5e-3


# (images, H, W, D, kinds, N)
CASES = [
    (1, 7, 7, 40, ROW_F, 16),          # ShallowFuse at a narrow width
    (2, 5, 6, 40, CROSS2D, 16),        # Cross_SS2Dv5, H != W
    (1, 5, 6, 40, BIDI, 5),            # N padded to 8 lanes (17) or 16 states (18)
    (1, 3, 5, 200, UNIDI, 3),          # four forward chains alone; ragged last slab
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,H,W,D,kinds,N", CASES)
@pytest.mark.parametrize("kernel", ["v4", "v3"])
def test_emulated_kernel_matches_plain(emulated, plan, kernel, dtype, n, H, W, D, kinds, N):
    """Kernels 17 and 18 against their plain twins in the plan the port
    picks (the whole plan at these maps), launched without the gate's image
    group (the kernels need none); two runs give the same bits."""
    _, fn, plain = KERNELS[kernel]
    args = _case(n + H + D + N, n, H, W, D, kinds, N, dtype)
    got = fn(*args)
    assert got.dtype == dtype and got.shape == (n, H * W, D)
    assert _rel(got, plain(*args)) < _tol(dtype)
    assert torch.equal(got, fn(*args))
    plans = ab.ablation_scan_cuda.by_plan
    assert sum(plans.values()) == 2 and all(p.startswith(f"{kernel} whole") for p in plans)


@pytest.mark.parametrize("kernel,chunk,slab", [("v4", 7, 4), ("v4", 16, 1), ("v3", 7, 32),
                                               ("v3", 5, 8)])
def test_emulated_chunked_plan(emulated, plan, kernel, chunk, slab):
    """The chunked plan (forced by a budget below the whole plan's block),
    its last chunk ragged, walks the kinds (17) or the pairs (18) in turns
    into one accumulator with the whole plan's steps and sums in the same
    order: the same bits as the whole plan, and the plain twin's values."""
    _, fn, plain = KERNELS[kernel]
    dtype, N = torch.float32, 5
    args = _case(80 + slab, 1, 5, 6, 40, CROSS2D, N, dtype)
    plan(kernel, 8 if kernel == "v4" else 32)
    whole = fn(*args)
    plan(kernel, slab, chunk, (4, 30, N, dtype))
    got = fn(*args)
    assert torch.equal(got, whole)
    assert _rel(got, plain(*args)) < _tol(dtype)
    assert ab.ablation_scan_cuda.by_plan == {
        f"{kernel} whole, slab {8 if kernel == 'v4' else 32}": 1,
        f"{kernel} chunked x{-(-30 // chunk)}, slab {slab}": 1}


@pytest.mark.parametrize("kernel,chunk,slab,band,bands,dtype", [
    ("v4", 7, 4, 12, 3, torch.float32), ("v4", 16, 1, 29, 2, torch.bfloat16),
    ("v3", 7, 32, 12, 3, torch.bfloat16), ("v3", 5, 8, 10, 3, torch.float32)])
def test_emulated_banded_plan(emulated, plan, kernel, chunk, slab, band, bands, dtype):
    """The chunked plan whose accumulator holds only a band of the map (a
    budget that leaves room for ``band`` positions): the block walks every
    traversal once a band, carrying h, and adds only the band's parts, so
    the bands' seams change no addition: the same bits as the whole plan
    and the plain twin's values (8 channels: a ragged slab of 32)."""
    _, fn, plain = KERNELS[kernel]
    N = 5
    args = _case(90 + slab, 1, 5, 6, 8, CROSS2D, N, dtype)
    plan(kernel, 8 if kernel == "v4" else 32)
    whole = fn(*args)
    plan(kernel, slab, chunk, (4, 30, N, dtype), band=band)
    got = fn(*args)
    assert torch.equal(got, whole)
    assert _rel(got, plain(*args)) < _tol(dtype)
    assert ab.ablation_scan_cuda.by_plan == {
        f"{kernel} whole, slab {8 if kernel == 'v4' else 32}": 1,
        f"{kernel} chunked x{-(-30 // chunk)}, slab {slab}, {bands} bands": 1}


def _exact(kinds):
    """Inputs on which every step is exact in float32: delta 32 (softplus
    is the identity past 20), A -1000 (decay 0, so h is delta u B), u 1/32,
    B 1, so each kind's part is its C; C of +-2^24, 1 and 0.5 and u * Dsum
    = 1 make the order of the kind sum show in its rounding."""
    n, H, W, D, N = 8, 5, 6, 8, 1
    L, K = H * W, len(kinds)
    C = torch.tensor([2.0 ** 24, 1.0, -(2.0 ** 24), 0.5][:K])
    return (torch.full((n, L, D), 1 / 32), torch.full((n, L, K * D), 32.0),
            torch.ones(n, L, K * N), C.expand(n, L, K * N).contiguous(),
            torch.full((K * N, D), -1000.0),
            torch.cat([torch.full((1, D), 32.0), torch.zeros(K - 1, D)]),
            torch.zeros(K, D), H, W, kinds)


def test_emulated_sums_in_the_plain_order(emulated, plan):
    """On exact inputs, kernel 17 adds u * Dsum and the kinds' parts in
    kind order, kernel 18 pair by pair with the chain that reaches a
    position first adding first: the plain twins' bits.  Another order
    (for 17 the kinds in reverse or in pairs, for 18 kind order or each
    pair's forward chain first) gives other bits."""
    args = _exact(CROSS2D)
    one, big = torch.ones(8, 30, 8), torch.tensor(2.0 ** 24)
    others = {"v4": (((one + 0.5) - big) + 1.0) + big, "v3": ((one + big) - big) + (1.0 + 0.5)}
    others["v4 pairs"] = ((big + 1.0) + (0.5 - big)) + one
    others["v3 kinds"] = (((one + big) + 1.0) - big) + 0.5
    for kernel in ("v4", "v3"):
        fn, _, plain = KERNELS[kernel]
        want = plain(*args)
        assert torch.equal(fn(*args), want)
        for name, other in others.items():
            if name.startswith(kernel):
                assert not torch.equal(other, want), name


@pytest.mark.parametrize("kernel", ["v4", "v3"])
def test_emulated_kernel_matches_pallas_interpret(emulated, kernel):
    """`nk_scan_v4` / `nk_scan_v3` against ``nk_scan_call_v4`` /
    ``nk_scan_call_v3`` in interpret mode at the geometries of
    ``tests/test_torch_ablations.py`` (kernel 17: 8 images of 2 x 4, D 16,
    N 4; kernel 18: 2 images, D 128, N 2, group 2), cross2d, float32; each
    wrapper counts its one launch."""
    B, H, W, D, K, N, group = (8, 2, 4, 16, 4, 4, 8) if kernel == "v4" else (2, 2, 4, 128, 4, 2, 2)
    rng = np.random.default_rng(B + D)
    f, L = np.float32, H * W
    ops = (rng.standard_normal((B, L, D)).astype(f),
           (0.3 * rng.standard_normal((B, L, K * D))).astype(f),
           rng.standard_normal((B, L, K * N)).astype(f),
           rng.standard_normal((B, L, K * N)).astype(f),
           -np.exp(0.5 * rng.standard_normal((K * N, D))).astype(f),
           rng.standard_normal((K, D)).astype(f), (0.1 * rng.standard_normal((K, D))).astype(f))
    call = nk_scan_call_v4 if kernel == "v4" else nk_scan_call_v3
    want = call(*map(jnp.asarray, ops), H, W, CROSS2D, group=group, interpret=True)
    fn = KERNELS[kernel][0]
    before = fn.launches
    got = fn(*map(T, ops), H, W, CROSS2D, group=group)
    assert fn.launches == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_emulated_plan_at_the_model_maps(emulated):
    """Every model call of the two kernels (XFMamba-S's ShallowFuse at bs 32
    and Cross_SS2Dv5's K=4 step call, XFMamba-B's ShallowFuse at bs 16, both
    dtypes) takes the whole plan in blocks of at most 1024 (17) or 384 (18)
    threads and at least 128; 56 x 56 and 128 x 128 maps take the chunked
    plan with the accumulator holding the map; a 256 x 256 map, whose
    accumulator does not fit at one channel, takes it in two bands at one
    channel."""
    for kernel, pairs in (("v4", 0), ("v3", 1), ("v3", 2)):
        for n, K, D in ((32, 1, 1536), (48, 4, 1536), (16, 1, 2048)):
            if kernel == "v3" and pairs != (1 if K == 1 else 2):
                continue
            for dtype in (torch.bfloat16, torch.float32):
                whole, slab, chunk, band = ab.ablation_plan(kernel, n, 49, K, 16, D, pairs,
                                                            dtype)
                thr = ab.threads(kernel, K, pairs, slab, 16)
                assert whole and chunk == band == 49 and 128 <= thr <= ab.MAX_THREADS[kernel]
        whole, slab, chunk, band = ab.ablation_plan(kernel, 2, 56 * 56, 4, 16, 192,
                                                    max(pairs, 2), torch.float32)
        assert not whole and chunk == ab.CHUNK and band == 56 * 56
        whole, slab, chunk, band = ab.ablation_plan(kernel, 2, 128 * 128, 4, 16, 192,
                                                    max(pairs, 2), torch.float32)
        assert not whole and slab >= 2 and band == 128 * 128
        for dtype in (torch.float32, torch.bfloat16):
            assert ab.ablation_plan(kernel, 2, 256 * 256, 4, 16, 192, max(pairs, 2), dtype) == (
                False, 1, ab.CHUNK, 256 * 256 // 2)


def test_emulated_phase_clock_counts_nothing(emulated, plan):
    """``phase_ns`` launches with the phase clock on (the emulator's timer
    reads 0) and returns a block's mean time in each phase; it counts no
    launch and no plan."""
    args = _case(5, 1, 5, 6, 40, CROSS2D, 4, torch.float32)
    before = nk_scan_v4.nk_scan_v4.launches, nk_scan_wide.nk_scan_v3.launches
    for phases in (nk_scan_v4.nk_scan_v4_cuda(*args, phase_ns=True),
                   nk_scan_wide.nk_scan_v3_cuda(*args, phase_ns=True)):
        assert phases == dict.fromkeys(ab.PHASES + ("block",), 0.0)
    assert (nk_scan_v4.nk_scan_v4.launches, nk_scan_wide.nk_scan_v3.launches) == before
    assert ab.ablation_scan_cuda.by_plan == {}


@pytest.mark.slow
@pytest.mark.parametrize("kernel,N", [("v4", 1), ("v3", 4)])
def test_emulated_map_past_the_accumulator(emulated, kernel, N):
    """A 256 x 256 map, whose float32 accumulator does not fit in shared
    memory at one channel, in the plan the port picks (two bands at one
    channel), cross2d, against the plain twin (about 30 s each)."""
    _, fn, plain = KERNELS[kernel]
    args = _case(7, 1, 256, 256, 2, CROSS2D, N, torch.float32)
    ab.ablation_scan_cuda.by_plan.clear()
    got = fn(*args)
    assert _rel(got, plain(*args)) < _tol(torch.float32)
    assert ab.ablation_scan_cuda.by_plan == {f"{kernel} chunked x1024, slab 1, 2 bands": 1}
