"""The CUDA source of kernels 11 and 12 (``xfmamba_tpu_torch/csrc/
ss2d_core_n1.cu``: the tile-parallel scan, its adjoint with the rank
products, the carries and the fixed-order sums) run on the CPU.

g++ compiles the source against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles and the ``mma.sync``
fragments; the launches and the inline PTX rewritten first), and the
port's launch functions call it through ctypes on CPU tensors.  The
results are held against the plain twins and the JAX package (the XLA core
and the Pallas kernels in interpret mode), at ragged tiles, H != W, several
channel slabs, blocks that walk several tiles, dt ranks odd and even up to
64, explicit chunks and both dtypes.  Tolerances: the kernels sum in a
fixed order of their own and take the rank products in 3xTF32 (float32,
about 1e-6 of each output's largest magnitude against the twins); in
bfloat16 the gradient products round dpre and w_dt to bfloat16 where the
kernel-12 twin keeps float32 (5e-3).  The JAX tolerances are the JAX
package's own tests' (2e-4 forward, 5e-4 backward).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import ss2d_core as jax_ss2d_core
from xfmamba_tpu.ops.selective_scan_pallas import (
    _core_fused_proj_bwd_impl, _core_fused_proj_parts)
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import cross2d_scan as cs
from xfmamba_tpu_torch.ops import ss2d_core_n1 as n1
from xfmamba_tpu_torch.ops.primitives import gemm_ab_plain

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "ss2d_core_n1.cu")
NAMES = ("dx", "d_x_proj_weight", "d_dt_projs_weight", "d_dt_projs_bias", "d_A_logs", "d_Ds")


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's, and
    mma.cuh's PTX products and conversion the emulator's."""
    if name == "mma.cuh":
        for fn, body in (("void mma_bf16", "emu_mma(c, a, b, true);"),
                         ("void mma_tf32", "emu_mma(c, a, b, false);"),
                         ("uint32_t to_tf32", "return emu_to_tf32(v);")):
            text = re.sub(rf"({re.escape(fn)}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
                          flags=re.S)
        # cp.async and ldmatrix: PTX with no use in this source
        text = re.sub(r"__device__ __forceinline__ void (cp_async16|ldmatrix_x4)\(.*?\n\}\n", "",
                      text, flags=re.S)
        text = re.sub(r"__device__ __forceinline__ void cp_async_commit\(\).*?\n", "", text)
        text = re.sub(r"template <int N>\n__device__ __forceinline__ void cp_async_wait\(\).*?\n\}\n",
                      "", text, flags=re.S)
    text = re.sub(r"extern __shared__ float (\w+)\[\];", r"float* \1 = emu_smem;", text)
    return re.sub(r"(\w+)\s*<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text, flags=re.S)


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
    so = out / "libss2d_n1_emulated.so"
    if not so.exists():
        # each process rewrites and compiles in its own directory, then
        # renames its library into place: test workers may build at once
        src = out / f"src.{os.getpid()}"
        src.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():
            (src / name).write_text(_rewrite(name, text))
        tmp = out / f"lib.{os.getpid()}.tmp"
        subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                        "-I", str(STUBS), "-I", str(src), "-x", "c++", str(src / "ss2d_core_n1.cu"),
                        "-o", str(tmp)], check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_ss2d_n1_fwd", "xfm_ss2d_n1_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", lambda status, what: _check(status, what))
        for mod in (n1, cs):
            mp.setattr(mod, "on_cpu", lambda *t: False)
            mp.setattr(mod, "require_cuda", lambda *t: None)
        mp.setattr(n1, "stream", lambda t: None)
        yield lib


def _check(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: status {status}")


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _operands(seed, B, H, W, D, R, dtype):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, D, generator=g).to(dtype)
    xw = torch.randn(4, R + 2, D, generator=g) * D ** -0.5
    dtw = torch.randn(4, D, R, generator=g) * R ** -0.5
    bias = torch.randn(4, D, generator=g) * 0.5 - 2.0
    A_logs = torch.rand(4 * D, 1, generator=g)
    return (x, *n1.pack_n1_inputs(x, xw, dtw, bias, A_logs, torch.randn(4 * D, generator=g))), \
        torch.randn(B, H, W, D, generator=g)


# (B, H, W, D, R, chunk, blocks a launch aims for): tiles 5 x 6 (ragged 4 x
# 5), three slabs with a ragged one, blocks walking several tiles; 6 x 6
# tiles in a 17 x 6 map; one 7 x 7 tile with R 48 (two dw_dt slots); two
# 8 x 8 tiles at R 64; 7 x 7 tiles of a 14 x 14 map at an odd R.  Few
# blocks a launch: the emulator runs one thread per CUDA thread.
CASES = [(2, 9, 11, 70, 5, None, 4), (2, 9, 11, 70, 5, 7, 3), (1, 17, 6, 130, 12, 10, 5),
         (3, 7, 7, 64, 48, None, 2), (1, 8, 16, 40, 64, 9, 1), (1, 14, 14, 33, 33, 13, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,D,R,chunk,target", CASES)
def test_emulated_kernels_match_plain_twins(emulated, monkeypatch, dtype, B, H, W, D, R, chunk,
                                            target):
    """Kernels 11 and 12 (through `ss2d_core_n1_fwd` / `_bwd`) against the
    plain twins: y, every checkpoint, du, dxdbl, dw_dt, dbias, dA, dD; two
    runs of the backward give the same bits."""
    monkeypatch.setattr(n1, "TARGET_BLOCKS", target)
    args, gy = _operands(B + H + R, B, H, W, D, R, dtype)
    y, ck = n1.ss2d_core_n1_fwd(*args, chunk)
    y_p, ck_p = n1.ss2d_core_n1_fwd_plain(*args, chunk)
    assert _rel(y, y_p) < 1e-5 and _rel(ck, ck_p) < 1e-5
    got = n1.ss2d_core_n1_bwd(*args, ck_p, gy, chunk)
    want = n1.ss2d_core_n1_bwd_plain(*args, ck_p, gy, chunk)
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    for name, w in want.items():
        assert got[name].shape == w.shape
        assert _rel(got[name], w) < (tol if name in ("dxdbl", "dw_dt") else 1e-5), name
    again = n1.ss2d_core_n1_bwd(*args, ck_p, gy, chunk)
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,D,R,chunk", [(2, 9, 11, 70, 5, 7), (1, 17, 6, 40, 12, None),
                                             (3, 7, 7, 64, 48, None), (1, 14, 14, 33, 33, 13)])
def test_emulated_forward_routes_agree(emulated, monkeypatch, dtype, B, H, W, D, R, chunk):
    """Kernel 11 as one cluster launch (maps of at most `FUSE_TILES`
    tiles) and as three launches (pairs, carries, apply; forced by
    ``FUSE_TILES = 0``) take the same steps in the same order: y and the
    checkpoints agree bit for bit, and with the plain twin."""
    args, _ = _operands(B * H + R, B, H, W, D, R, dtype)
    calls = []
    for limit in (n1.FUSE_TILES, 0):
        monkeypatch.setattr(n1, "FUSE_TILES", limit)
        monkeypatch.setattr(n1.ss2d_core_n1_fwd, "by_plan", {})
        calls.append(n1.ss2d_core_n1_fwd(*args, chunk))
        fused = n1.tile_plan(B, H, W, D).fused
        assert list(n1.ss2d_core_n1_fwd.by_plan) == [n1.tile_plan(B, H, W, D).key()]
        assert fused == (limit > 0)
    (y, ck), (y3, ck3) = calls
    assert torch.equal(y, y3) and torch.equal(ck, ck3)
    y_p, ck_p = n1.ss2d_core_n1_fwd_plain(*args, chunk)
    assert _rel(y, y_p) < 1e-5 and _rel(ck, ck_p) < 1e-5


def _inputs(seed, H, W, B=2, D=16, R=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return ([rng.standard_normal((B, H, W, D)).astype(f),
             (rng.standard_normal((4, R + 2, D)) * 0.1).astype(f),
             (rng.standard_normal((4, D, R)) * 0.1).astype(f),
             (rng.standard_normal((4, D)) * 0.1).astype(f),
             (rng.standard_normal((4 * D, 1)) * 0.2).astype(f),
             rng.standard_normal((4 * D,)).astype(f)],
            rng.standard_normal((B, H, W, D)).astype(f))


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize("H,W,chunk,R", [(10, 9, 32, 2), (12, 8, 7, 3), (9, 17, 96, 5)])
def test_emulated_kernels_match_pallas_interpret(emulated, H, W, chunk, R):
    """The whole core (`core_n1_parts` / `core_n1_bwd`, the x_proj glue
    around kernels 11 and 12) against the Pallas forward and backward in
    interpret mode at the same chunk: y, the checkpoints (JAX ``cf`` / ``cr``)
    and all six gradients."""
    args, g = _inputs(31, H, W, R=R)
    D = args[0].shape[-1]
    jargs = list(map(jnp.asarray, args))
    want_y, residuals = _core_fused_proj_parts(*jargs, interpret=True, chunk=chunk)
    y, (xdbl, ck) = n1.core_n1_parts(*map(T, args), chunk=chunk)
    _close(y, want_y, 2e-4)
    cf, cr = (np.asarray(c)[:, :, 0] for c in residuals[2:])
    for k, ref in enumerate((cf[..., :D], cf[..., D:], cr[..., :D], cr[..., D:])):
        _close(ck[:, k], ref, 2e-4, f"direction {k}")
    want = _core_fused_proj_bwd_impl(*jargs, *residuals, jnp.asarray(g), interpret=True,
                                     chunk=chunk)
    got = n1.core_n1_bwd(*map(T, args), xdbl, ck, T(g), chunk=chunk)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 5e-4, name)


def test_emulated_autograd_matches_jax_vjp(emulated):
    """`ss2d_core_n1` (kernels 11 and 12 under autograd) against ``jax.vjp``
    of the XLA core: the output and all six gradients, 9 x 13 map, R 3."""
    args, g = _inputs(32, 9, 13, R=3)
    y_j, vjp = jax.vjp(jax.jit(lambda *a: jax_ss2d_core(*a, d_state=1, backend="xla")),
                       *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [T(a).requires_grad_() for a in args]
    y = n1.ss2d_core_n1(*leaves)
    y.backward(T(g))
    _close(y.detach(), y_j, 2e-4)
    for name, leaf, b in zip(NAMES, leaves, want):
        _close(leaf.grad, b, 5e-4, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_stage_adjoint_matches_dz_and_the_old_gemms(emulated, dtype):
    """The stage route (``cross2d_scan_bwd``, projection rows [rank_0 ..
    rank_3 | B0 C0 .. B3 C3]): the kernels' d rank (in dxdbl's rank
    columns) and dw_dt equal what the plain adjoint's dz and the 8 GEMMs
    of kernel 6's first design give (dz and w_dt rounded to the
    activation dtype, float32 sums); the other outputs against the plain
    twin.  The summation orders differ (and, in bfloat16, where a dz
    rounds): 1e-5 in float32, 1e-2 in bfloat16."""
    g = torch.Generator().manual_seed(40)
    n, H, W, D, R = 2, 9, 10, 80, 6
    L = H * W
    u = torch.randn(n, L, D, generator=g).to(dtype)
    xdbl = torch.randn(n, L, 4 * R + 8, generator=g).to(dtype)
    args = (u, xdbl, -torch.exp(0.5 * torch.randn(4, 1, D, generator=g)),
            0.5 * torch.randn(4, D, generator=g) - 1.0, torch.randn(D, generator=g),
            torch.randn(4, R, D, generator=g) * R ** -0.5, H, W)
    y, ck = cs.cross2d_scan(*args, checkpoints=True)
    y_p, ck_p = cs.cross2d_scan_plain(*args, checkpoints=True)
    assert _rel(y, y_p) < 1e-5 and _rel(ck, ck_p) < 1e-5
    gy = torch.randn(n, L, D, generator=g)
    dx, dx_p = torch.zeros(n * L, 4 * R + 8), torch.zeros(n * L, 4 * R + 8)
    got = cs.cross2d_scan_bwd(*args, gy, ck_p, dx)
    want = cs.cross2d_scan_bwd_plain(*args, gy, ck_p, dx_p)
    dz = want["dz"].view(n * L, 4, D)
    w_dt = args[5].to(dtype)
    ranks = xdbl.view(n * L, 4 * R + 8)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for k in range(4):
        d_rank = gemm_ab_plain(dz[:, k], w_dt[k], out_dtype=torch.float32)
        dw = gemm_ab_plain(ranks[:, k * R:(k + 1) * R].t(), dz[:, k].t(), out_dtype=torch.float32)
        assert _rel(dx[:, k * R:(k + 1) * R], d_rank) < tol
        assert _rel(got["dw_dt"][k], dw) < tol
    assert _rel(dx[:, 4 * R:], dx_p[:, 4 * R:]) < 1e-5
    for name in ("du", "dA", "dbias", "dDsum"):
        assert _rel(got[name], want[name]) < 1e-5, name
