"""The CUDA source of kernels 2 and 3 (``xfmamba_tpu_torch/csrc/
nk_scan_fused.cu``: the fusion scans with the map slice staged on chip,
the rank projection on the tensor cores, four lanes per chain and the
kinds summed in a fixed order) run on the CPU.

g++ compiles the source against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles and the ``mma.sync``
fragments, ``cp.async`` as a plain copy; the launches and the inline PTX
rewritten first), and the port's wrappers call it through ctypes on CPU
tensors.  The results are held against the plain versions
(`nk_scan_plain`, `nk_scan_x_plain`) and against the JAX package's Pallas
kernels (``nk_scan_call_v2`` / ``nk_scan_call_v2r``) in interpret mode: K
1 and 4, N 16 and odd, R odd and even up to 64, H != W, a ragged last
channel slab, rows staged by cp.async and element by element, maps walked
in one chunk and in several, both dtypes, and two runs bit for bit.
``nk_scan_x``'s out-norm is the plain LayerNorm here (the kernel under
test writes the y it normalises).  Tolerances: the kernels' exponentials
(ex2.approx against torch.exp) and product sums differ from the plain
versions' in the last bits (float32, 2e-5 of each output's largest
magnitude); in bfloat16 the rank product rounds w_dt to bfloat16 where the
plain version keeps float32 (5e-3).  The JAX tolerances are the JAX
package's own tests' (2e-4 for kernel 2, 3e-4 for kernel 3).
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

from xfmamba_tpu.ops.vss_block_pallas_v2 import nk_scan_call_v2, nk_scan_call_v2r
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import nk_scan as nk
from xfmamba_tpu_torch.ops.primitives import layer_norm_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "nk_scan_fused.cu")
CROSS2D = nk.scan_mode_kinds("cross2d")
BIDI = nk.scan_mode_kinds("bidi")


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's, the
    PTX products, conversions, ex2, cp.async and the bulk copies (a plain
    copy, their barrier's operations none) the emulator's, the global timer
    0."""
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
    text = re.sub(r"(long long fs_clock\(\) \{).*?\n\}", r"\1 return 0; }", text, flags=re.S)
    for fn, body in (("void fs_bar_init", ""), ("void fs_bar_arrive", ""), ("void fs_bar_wait", ""),
                     ("void fs_bulk_copy", "std::memcpy(dst, src, bytes);")):
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
    so = out / "libnk_fused_emulated.so"
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
                        str(src / "nk_scan_fused.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_fusion_scan", "xfm_fusion_scan_smem"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        mp.setattr(nk, "on_cpu", lambda *t: False)
        mp.setattr(nk, "require_cuda", lambda *t: None)
        mp.setattr(nk, "stream", lambda t: None)
        mp.setattr(nk, "layer_norm_cuda", layer_norm_plain)
        yield lib


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _case(seed, n, H, W, D, kinds, N, R, dtype):
    """nk_scan's (R = 0) or nk_scan_x's arguments: decays A in [-e^1.5, -1]
    and biases near softplus^-1 of 0.01-0.1, as in a trained model."""
    g = torch.Generator().manual_seed(seed)
    K, L = len(kinds), H * W
    u = torch.randn(n, L, D, generator=g).to(dtype)
    Bs = torch.randn(n, L, K * N, generator=g).to(dtype)
    Cs = torch.randn(n, L, K * N, generator=g).to(dtype)
    A = -torch.exp(1.5 * torch.rand(K * N, D, generator=g))
    Dvec = torch.randn(K, D, generator=g)
    bias = 0.5 * torch.randn(K, D, generator=g) - 3.0
    if not R:
        dts = (0.5 * torch.randn(n, L, K * D, generator=g)).to(dtype)
        return (u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds), nk.nk_scan, nk.nk_scan_plain
    ranks = torch.randn(n, L, K * R, generator=g).to(dtype)
    w_dt = torch.randn(K * R, D, generator=g) * R ** -0.5
    lno = torch.stack([1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g)])
    return ((u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds), nk.nk_scan_x,
            nk.nk_scan_x_plain)


# (n, H, W, D, kinds, N, R, chunk, rank kinds): R 0 is kernel 2 (the dts
# form), else kernel 3; chunk None is the whole-map plan, else the chunked
# plan with that many positions a chunk.  D 40: a ragged second slab, rows
# staged by cp.async; D 33 and 70: one-channel and six-channel last slabs,
# rows element by element; N 16 (four states a lane), odd N (5: padded to
# 16; 3: one state a lane).  The rank form with the ranks and w_dt of 1, 2
# or all kinds on chip at once.
CASES = [
    (2, 7, 7, 40, ("row_f",), 16, 0, None, 1),      # ShallowFuse
    (1, 5, 6, 33, CROSS2D, 5, 0, None, 1),          # Cross_SS2Dv5's training call
    (2, 7, 7, 40, CROSS2D, 16, 48, None, 4),        # Cross_SS2Dv5, XFMamba-S's R
    (1, 7, 7, 40, CROSS2D, 16, 64, None, 2),        # XFMamba-B's R
    (1, 4, 6, 70, BIDI, 3, 7, None, 3),             # passes of 3 kinds and 1
    (1, 6, 5, 40, CROSS2D, 16, 64, 8, 1),           # four chunks
    (1, 5, 7, 33, CROSS2D, 16, 0, 12, 1),           # three chunks
]


def _force_plan(monkeypatch, chunk, rk_kinds):
    """The plan asked for: a chunk forces the chunked plan, else the whole
    plan with the ranks of rk_kinds kinds at once."""
    if chunk is not None:
        monkeypatch.setattr(nk, "FUSION_SMEM", 0)
        monkeypatch.setattr(nk, "FUSION_CHUNK", chunk)
    else:
        real = nk.fusion_scan_plan
        monkeypatch.setattr(nk, "fusion_scan_plan",
                            lambda L, K, N, R, dtype: (*real(L, K, N, R, dtype)[:2], rk_kinds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,H,W,D,kinds,N,R,chunk,rk_kinds", CASES)
def test_emulated_fusion_scans_match_plain(emulated, monkeypatch, dtype, n, H, W, D, kinds, N, R,
                                           chunk, rk_kinds):
    """Kernel 2 (`nk_scan`) or 3 (`nk_scan_x`) against its plain version,
    through the plan asked for; two runs give the same bits."""
    _force_plan(monkeypatch, chunk, rk_kinds)
    monkeypatch.setattr(nk.fusion_scan_cuda, "by_plan", {})
    args, kernel, plain = _case(n + H + D + R, n, H, W, D, kinds, N, R, dtype)
    got = kernel(*args)
    want = plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 5e-3
    if dtype == torch.bfloat16:  # the output's own rounding
        tol += 2 ** -8
    assert _rel(got, want) < tol
    assert torch.equal(got, kernel(*args))
    plan = "whole" if chunk is None else f"chunked x{-(-H * W // chunk)}"
    if R:
        plan += f", ranks of {rk_kinds} kinds"
    assert nk.fusion_scan_cuda.by_plan == {plan: 2}


@pytest.mark.parametrize("R", [0, 6])
def test_emulated_plans_agree_bit_for_bit(emulated, monkeypatch, R):
    """The whole-map plan (with the ranks of every kind on chip at once,
    and of one at a time) and the chunked plan (one chunk per kind's
    traversal, then four) take the same steps in the same order and sum
    the kinds in the same order: the same bits."""
    args, kernel, _ = _case(11, 2, 5, 8, 40, CROSS2D, 16, R, torch.float32)
    whole = kernel(*args)
    with monkeypatch.context() as mp:
        _force_plan(mp, None, 1)
        assert torch.equal(kernel(*args), whole)
    for chunk in (40, 10):
        _force_plan(monkeypatch, chunk, 1)
        assert torch.equal(kernel(*args), whole)


# the rank kinds on chip at once at the fusion maps: (K, R, dtype) -> kinds
FUSION_RANK_KINDS = {(4, 48, torch.float32): 2, (4, 48, torch.bfloat16): 4,
                     (4, 64, torch.float32): 2, (4, 64, torch.bfloat16): 3}


def test_emulated_plan_at_the_fusion_maps(emulated):
    """Every fusion call of XFMamba-S and -B (7 x 7, N 16, R 48 / 64) takes
    the whole-map plan in both dtypes, two such blocks fitting an SM; the
    rank form stages the ranks and w_dt of all four kinds at once for
    XFMamba-S in bfloat16, of three for XFMamba-B, of two in float32."""
    for K, R in ((1, 0), (4, 0), (4, 48), (4, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            kinds = FUSION_RANK_KINDS.get((K, R, dtype), 1)
            assert nk.fusion_scan_plan(49, K, 16, R, dtype) == (True, 49, kinds)
            code = int(dtype == torch.bfloat16)
            smem = emulated.xfm_fusion_scan_smem(1, K, 49, 49, 16, R, kinds, code)
            assert 2 * (smem + 1024) <= 228 * 1024


def test_emulated_probes_count_nothing(emulated, monkeypatch):
    """``blocks_per_sm`` asks the runtime how many blocks an SM holds (the
    emulator answers 1) and launches nothing; ``phase_ns`` launches with
    the phase clock on (the emulator's timer reads 0); neither counts."""
    monkeypatch.setattr(nk.fusion_scan_cuda, "by_plan", {})
    args, _, _ = _case(3, 1, 7, 7, 40, CROSS2D, 16, 0, torch.float32)
    u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds = args
    ops = nk._nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    before = nk.fusion_scan_cuda.launches
    got = nk.fusion_scan_cuda(H=H, W=W, dts=dts.view(1, 49, 4, 40), out_dtype=u.dtype,
                              blocks_per_sm=True, **ops)
    phases = nk.fusion_scan_cuda(H=H, W=W, dts=dts.view(1, 49, 4, 40), out_dtype=u.dtype,
                                 phase_ns=True, **ops)
    assert phases == dict.fromkeys(nk.FUSION_PHASES + ("block",), 0.0)
    assert got == 1 and nk.fusion_scan_cuda.launches == before
    assert nk.fusion_scan_cuda.by_plan == {}


@pytest.mark.parametrize("R", [0, 6])
def test_emulated_refuses_a_graph(emulated, monkeypatch, R):
    """Kernels 2 and 3 have no backward: while autograd records, an
    operand that requires a gradient is refused before the launch (its
    output would leave the graph); under ``torch.no_grad()`` the same call
    runs."""
    monkeypatch.setattr(nk.fusion_scan_cuda, "by_plan", {})
    args, kernel, plain = _case(5, 1, 7, 7, 40, CROSS2D, 16, R, torch.float32)
    u = args[0].clone().requires_grad_()
    before = nk.fusion_scan_cuda.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        kernel(u, *args[1:])
    assert nk.fusion_scan_cuda.launches == before and nk.fusion_scan_cuda.by_plan == {}
    with torch.no_grad():
        got = kernel(u, *args[1:])
    assert _rel(got, plain(*args)) < 2e-5


def _jax_case(seed, B, H, W, D, K, N, R):
    rng = np.random.default_rng(seed)
    f, L = np.float32, H * W
    ops = dict(u=rng.standard_normal((B, L, D)).astype(f),
               Bs=rng.standard_normal((B, L, K * N)).astype(f),
               Cs=rng.standard_normal((B, L, K * N)).astype(f),
               A=-np.exp(0.5 * rng.standard_normal((K * N, D))).astype(f),
               Dvec=rng.standard_normal((K, D)).astype(f),
               bias=(0.1 * rng.standard_normal((K, D))).astype(f))
    if R:
        ops.update(ranks=(0.3 * rng.standard_normal((B, L, K * R))).astype(f),
                   w_dt=(0.2 * rng.standard_normal((K * R, D))).astype(f),
                   lno=np.stack([1 + 0.1 * rng.standard_normal(D),
                                 0.1 * rng.standard_normal(D)]).astype(f))
    else:
        ops["dts"] = (0.3 * rng.standard_normal((B, L, K * D))).astype(f)
    return ops


# (B, H, W, D, kinds, N, R): JAX's rank-form kernel needs L G and W G
# multiples of 8 (image group G = 8 at 8 images, else 1)
JAX_CASES = [
    (8, 7, 7, 40, CROSS2D, 16, 5),
    (2, 3, 8, 33, CROSS2D, 4, 64),
    (2, 3, 8, 40, CROSS2D, 16, 0),
    (2, 5, 6, 33, ("row_f",), 5, 0),
]


@pytest.mark.parametrize("B,H,W,D,kinds,N,R", JAX_CASES)
def test_emulated_fusion_scans_match_pallas_interpret(emulated, B, H, W, D, kinds, N, R):
    """`nk_scan` against ``nk_scan_call_v2`` and `nk_scan_x` against
    ``nk_scan_call_v2r``, the Pallas kernels in interpret mode, float32."""
    ops = _jax_case(B * H + D + R, B, H, W, D, len(kinds), N, R)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    t = {k: T(v) for k, v in ops.items()}
    if R:
        want = nk_scan_call_v2r(j["u"], j["ranks"], j["Bs"], j["Cs"], j["w_dt"], j["A"],
                                j["Dvec"], j["bias"], j["lno"], H, W, kinds, interpret=True)
        got = nk.nk_scan_x(t["u"], t["ranks"], t["Bs"], t["Cs"], t["w_dt"], t["A"], t["Dvec"],
                           t["bias"], t["lno"], H, W, kinds)
        tol = 3e-4
    else:
        want = nk_scan_call_v2(j["u"], j["dts"], j["Bs"], j["Cs"], j["A"], j["Dvec"],
                               j["bias"], H, W, kinds, interpret=True)
        got = nk.nk_scan(t["u"], t["dts"], t["Bs"], t["Cs"], t["A"], t["Dvec"], t["bias"], H, W,
                         kinds)
        tol = 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
