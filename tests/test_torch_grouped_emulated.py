"""The CUDA source of kernels 13 and 14 (``xfmamba_tpu_torch/csrc/
grouped_scan_lanes.cu``: the grouped selective scan and its adjoint, four
lanes a chain, no state in device memory, no atomics, fixed-order sums)
run on the CPU.

g++ compiles the source against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles, ``cp.async`` as a plain
copy; the launches and the inline PTX rewritten first), and the port's
wrappers (`grouped_scan_fwd`, `grouped_scan_bwd`) call it through ctypes on
CPU tensors.  The results are held against the plain twins
(`grouped_scan_fwd_plain`, `grouped_scan_bwd_plain`, the gradients from
the plain checkpoints) and against the JAX package's Pallas kernels
(``grouped_scan_pallas_fwd`` / ``_bwd``) in interpret mode: K 1, 2 and 4;
N 1, 5 and 16; forward and reverse; L below one chunk, exact and ragged
last chunks; blocks of 1, 2 and 4 warps with a ragged last channel slab;
rows staged by cp.async and value by value; both dtypes; and two runs bit
for bit.  Tolerances: the kernels take exp2 of log2(e)-scaled A where the
twins take ``torch.exp``, and sum in their own fixed order (over the four
lanes of a chain, the chains of a warp, the warps, the slabs, the images),
so they differ from the twins in the last bits of float32: 2e-5 of each
output's largest magnitude (the operands of both are the same bfloat16
values, so bfloat16 holds the same bound).  The JAX tolerances are the JAX
package's own tests' (2e-4).
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

from xfmamba_tpu.ops.selective_scan_pallas import (
    grouped_scan_pallas_bwd, grouped_scan_pallas_fwd)
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import selective_scan_grouped as ssg

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "grouped_scan_lanes.cu")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's, ex2 and
    mma.cuh's PTX the emulator's (cp.async a plain copy, its commit and
    wait nothing)."""
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
    so = out / "libgrouped_lanes_emulated.so"
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
                        str(src / "grouped_scan_lanes.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_grouped_scan_fwd", "xfm_grouped_scan_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        mp.setattr(ssg, "on_cpu", lambda *t: False)
        mp.setattr(ssg, "require_cuda", lambda *t: None)
        mp.setattr(ssg, "stream", lambda t: None)
        yield lib


def _rel(got, want):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _case(seed, B, L, K, C, N, dtype):
    """u, delta, A, B, C, D, bias and dy with a trained model's ranges: A in
    [-e^1.5, -1] per state, deltas about softplus(-3 +- 1)."""
    g = torch.Generator().manual_seed(seed)
    KC = K * C
    args = (torch.randn(B, L, KC, generator=g).to(dtype),
            (torch.randn(B, L, KC, generator=g) - 3.0).to(dtype),
            -torch.exp(1.5 * torch.rand(KC, N, generator=g)),
            torch.randn(B, L, K, N, generator=g).to(dtype),
            torch.randn(B, L, K, N, generator=g).to(dtype),
            torch.randn(KC, generator=g), 0.5 * torch.randn(KC, generator=g))
    return args, torch.randn(B, L, KC, generator=g)


# (B, L, K, C, N, chunk, warps): L 13 inside one chunk of 32 (two segments
# of the adjoint, the last ragged); L 45 a ragged second chunk; chunks of 8
# (one segment each), of 12 (two) and of 40 (five); C 40 at 4 warps (slabs
# of 32, the last of 8), C 70 at 8 warps (a slab of 64 and one of 6), C 37
# and 13 (rows staged value by value, ragged slabs); N 1 (one lane group's
# first state, the rest padding), 5 (a second lane group with one state),
# 16 (B and C rows by cp.async)
CASES = [
    (2, 13, 1, 40, 16, 32, 4),
    (2, 45, 2, 37, 5, 32, 2),
    (1, 21, 4, 13, 16, 8, 1),
    (3, 30, 1, 16, 1, 12, 1),
    (1, 49, 2, 24, 16, 32, 2),
    (2, 17, 4, 8, 5, 8, 1),
    (1, 45, 1, 16, 16, 40, 2),
    (1, 21, 1, 70, 16, 32, 8),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,K,C,N,chunk,warps", CASES)
def test_emulated_grouped_scan_matches_plain(emulated, monkeypatch, dtype, reverse, B, L, K, C,
                                             N, chunk, warps):
    """Kernel 13 (y, checkpoints) and kernel 14 (every gradient, from the
    plain checkpoints) against their plain twins; two runs give the same
    bits."""
    monkeypatch.setattr(ssg, "lanes_warps", lambda *a: warps)
    args, dy = _case(B * L + K * C + N, B, L, K, C, N, dtype)
    before = (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches)
    y, ck = ssg.grouped_scan_fwd(*args, reverse=reverse, chunk=chunk)
    y_p, ck_p = ssg.grouped_scan_fwd_plain(*args, reverse=reverse, chunk=chunk)
    assert ck.shape == ck_p.shape == (B, K, -(-L // chunk), N, C)
    assert _rel(y, y_p) < 2e-5 and _rel(ck, ck_p) < 2e-5
    got = ssg.grouped_scan_bwd(*args, ck_p, dy, reverse=reverse, chunk=chunk)
    want = ssg.grouped_scan_bwd_plain(*args, ck_p, dy, reverse=reverse, chunk=chunk)
    for name in GRADS:
        assert got[name].shape == want[name].shape, name
        assert _rel(got[name], want[name]) < 2e-5, name
    again = ssg.grouped_scan_bwd(*args, ck_p, dy, reverse=reverse, chunk=chunk)
    assert all(torch.equal(got[name], again[name]) for name in GRADS)
    y2, ck2 = ssg.grouped_scan_fwd(*args, reverse=reverse, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(ck, ck2)
    assert (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches) == \
        (before[0] + 2, before[1] + 2)


# (B, L, K, C, N, chunk, reverse), float32: three chunks of 8, the last of 4
JAX_CASES = [(1, 20, 2, 8, 3, 8, True), (2, 37, 1, 24, 16, 8, False)]


@pytest.mark.parametrize("B,L,K,C,N,chunk,reverse", JAX_CASES)
def test_emulated_grouped_scan_matches_pallas_interpret(emulated, B, L, K, C, N, chunk, reverse):
    """y and the checkpoints against ``grouped_scan_pallas_fwd``, and every
    gradient (from the Pallas checkpoints) against ``grouped_scan_pallas_bwd``,
    in interpret mode, float32; the kernels at their default blocks."""
    rng = np.random.default_rng(B * L + N)
    f = np.float32
    KC = K * C
    args = (rng.standard_normal((B, L, KC)).astype(f),
            (0.5 * rng.standard_normal((B, L, KC))).astype(f),
            -np.exp(0.3 * rng.standard_normal((KC, N))).astype(f),
            rng.standard_normal((B, L, K, N)).astype(f),
            rng.standard_normal((B, L, K, N)).astype(f),
            rng.standard_normal(KC).astype(f), (0.1 * rng.standard_normal(KC)).astype(f))
    gy = rng.standard_normal((B, L, KC)).astype(f)
    jargs = list(map(jnp.asarray, args))
    y_ref, carr = grouped_scan_pallas_fwd(*jargs, delta_softplus=True, reverse=reverse,
                                          interpret=True, chunk=chunk)
    y, ck = ssg.grouped_scan_fwd(*map(T, args), reverse=reverse, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ck.numpy(), np.asarray(carr)[:, :, :, :N], rtol=2e-4, atol=2e-4)
    want = grouped_scan_pallas_bwd(*jargs, carr, jnp.asarray(gy), reverse=reverse,
                                   interpret=True, chunk=chunk)
    ck_j = T(np.array(np.asarray(carr)[:, :, :, :N]))
    got = ssg.grouped_scan_bwd(*map(T, args), ck_j, T(gy), reverse=reverse, chunk=chunk)
    for name, w in zip(GRADS, want):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_lanes_blocks_and_no_atomics():
    """The block rule (8 warps at the XFMamba-B and -S calls, fewer where
    the grid would leave an SM under two blocks) and the adjoint's source:
    no atomics, no state scratch among its operands."""
    assert ssg.lanes_warps(48, 1, 2048) == 8 and ssg.lanes_warps(12, 2, 1536) == 8
    assert ssg.lanes_warps(2, 4, 192) == 1 and ssg.lanes_warps(16, 1, 512) == 2
    text = (build.CSRC_DIR / "grouped_scan_lanes.cu").read_text()
    assert not re.search(r"\batomic\w*\(", text)
    assert "hs" not in re.findall(r"\w+", text.split("struct LanesParams")[1].split("};")[0])
