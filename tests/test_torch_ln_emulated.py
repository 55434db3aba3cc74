"""The CUDA source of kernels 19-21 (``xfmamba_tpu_torch/csrc/ln_act.cu``:
the LayerNorm (+ erf GELU) forward and its backward as staged streaming
passes, tiles of contiguous pixels brought into shared memory by the bulk
copy engine, a group of threads a pixel, the backward's column sums in a
fixed order) run on the CPU, beside the first design
(``csrc/ln_act_v1.cu``).

g++ compiles the sources against the stub CUDA headers of
``tests/cuda_emulator`` (one thread per CUDA thread, barriers for
``__syncthreads``, warp exchanges for the shuffles; a bulk copy is made
when a thread first waits on its barrier, so a read of a stage before its
wait finds the tile before; nine SMs, so a grid of the card's resident
blocks walks more tiles a block than it keeps in flight at 3 x 37 x 41
pixels, and the backward's partial rows outnumber the eight running sums
that add them), and the port's wrappers (`ln_act_fused`,
`seg_ln_fwd`, `seg_ln_bwd`) call it through ctypes on CPU tensors.  They
are held against the plain twins and against the JAX package's Pallas
kernels in interpret mode: C 48, 96, 192, 1536 (groups wider than a warp)
and 41 (no whole 16-byte piece a pixel), C 6143 and 6400 (the row path: a
block a pixel, where no group holds the pixel or no stage fits), a pixel
count that fills no whole tile (3 x 37 x 41), base pointers that are not
16-byte aligned, both dtypes, the GELU on and off; the plans of every C;
the column sums bit for bit over two runs and against a float32 model of
their order; the device launches a call; calls refused by the wrappers'
checks or by the C entries count nothing.  Tolerances: float32 within 2e-5
of the plain twins (the sums' order differs), dscale / dbias 1e-4; a
bfloat16 output may round the other way (8e-3 relative, 1.2e-2 absolute,
``tests/test_seg_ln.py``'s bfloat16 tolerance); JAX's are its own tests'.
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

from xfmamba_tpu.ops.ablations import pe_fused as jax_pe
from xfmamba_tpu.ops.ablations import seg_ln as jax_seg
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.ablations import pe_fused, seg_ln
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCES = ("common.cuh", "mma.cuh", "staging.cuh", "ln_act.cu", "ln_act_v1.cu")
ENTRIES = ("xfm_ln_act", "xfm_seg_ln_fwd", "xfm_seg_ln_bwd", "xfm_ln_plan",
           "xfm_ln_act_first", "xfm_seg_ln_fwd_first", "xfm_seg_ln_bwd_first")
WRAPPERS = (pe_fused.ln_act_fused, seg_ln.seg_ln_fwd, seg_ln.seg_ln_bwd)


# a bulk copy waits on its barrier: the first thread that waits makes the
# copies issued on it (the other threads wait for the lock); one whose
# addresses or size are not whole 16-byte pieces, which the card refuses,
# copies nothing
DEFERRED_COPIES = """
#include <map>
#include <mutex>
#include <tuple>
inline std::mutex emu_bulk_lock;
inline std::map<const void*, std::vector<std::tuple<void*, const void*, int>>> emu_bulk;
inline void emu_bulk_issue(void* dst, const void* src, int bytes, const void* bar) {
  std::lock_guard<std::mutex> hold(emu_bulk_lock);
  emu_bulk[bar].emplace_back(dst, src, bytes);
}
inline void emu_bulk_wait(const void* bar) {
  std::lock_guard<std::mutex> hold(emu_bulk_lock);
  for (auto& [dst, src, bytes] : emu_bulk[bar])
    if ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) | bytes) % 16 == 0)
      std::memcpy(dst, src, bytes);
  emu_bulk.erase(bar);
}
"""


def _rewrite(name, text):
    """The source as g++ takes it with the stub headers: launches become
    ``emu_launch`` calls, the dynamic shared memory the emulator's,
    cp.async a plain copy, a bulk copy made at the first wait on its
    barrier, the barrier's other operations and the proxy fence none;
    ln_act.cu reports the emulator's launches."""
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
    if name == "staging.cuh":
        text = text.replace('#include "mma.cuh"\n', '#include "mma.cuh"\n' + DEFERRED_COPIES)
    for fn, body in (("void stage_bar_init", ""), ("void stage_bar_arrive", ""),
                     ("void stage_bar_wait", "emu_bulk_wait(bar);"), ("void ln_fence_async", ""),
                     ("void stage_bulk_copy", "emu_bulk_issue(dst, src, bytes, bar);")):
        text = re.sub(rf"({re.escape(fn)}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
                      flags=re.S)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                  r"float* \1 = emu_smem;", text)
    # a static __shared__ array: the block's (emu_static), keyed by its line
    lines = text.split("\n")
    for i, line in enumerate(lines):
        lines[i] = re.sub(r"__shared__ (\w+) (\w+)((?:\[\w+\])+);",
                          rf"\1 (&\2)\3 = *emu_static<\1\3>({i});", line)
    text = "\n".join(lines)
    if name == "ln_act.cu":
        text += '\nextern "C" int emu_launches() { return emu_launch_count; }\n'
    # a kernel name may carry template arguments (the first design's)
    return re.sub(r"(\w+(?:<[\w, ]+>)?)\s*<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text,
                  flags=re.S)


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
    so = out / "libln_emulated.so"
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
                        str(src / "ln_act.cu"), str(src / "ln_act_v1.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.emu_launches.restype = ctypes.c_int
    # the process's first float32 torch.erf over several threads (the plain
    # backward's GELU derivative) has been seen to take a less exact kernel
    # in part of the tensor (errors up to 2.4e-4): the first call is made
    # here, on one thread
    torch.erf(torch.zeros(8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        for module in (pe_fused, seg_ln):
            mp.setattr(module, "on_cpu", lambda *t: False)
            mp.setattr(module, "stream", lambda t: None)
        yield lib


def _case(seed, shape, C, dtype, offset=0):
    """x (shape + (C,)) and g in ``dtype``, scale and bias float32, as
    phase 10c draws them; ``offset`` elements before x and g in their
    storage (a base pointer that is not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape)) * C

    def tensor(scale, shift):
        flat = (scale * rng.standard_normal(n + offset) + shift).astype(np.float32)
        return T(flat).to(dtype)[offset:].view(*shape, C)

    x, g = tensor(2.0, 0.5), tensor(1.0, 0.0)
    scale = T((1 + 0.1 * rng.standard_normal(C)).astype(np.float32))
    bias = T((0.1 * rng.standard_normal(C)).astype(np.float32))
    return x, scale, bias, g


def _tol(dtype):
    return (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 1.2e-2)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), want.detach().float().numpy(),
                               rtol=rtol, atol=atol)


# (C, pixels, GELU): 3 x 37 x 41 fills no whole tile at any C; C 1536
# takes groups of 64 threads (two warps), C 41 goes element by element; C
# 6143 (element by element) stages one ragged tile of 8 pixels in the
# forward, where the backward's tile does not fit and takes the row path.
# The forward also runs C 6400, past a block's 6,144 values (the row path;
# the backward's row path is the same code at any C, and its 400 blocks of
# column sums are slow on the emulator)
CASES = [(48, (3, 37, 41), True), (48, (3, 37, 41), False), (96, (2, 13, 11), True),
         (96, (2, 13, 11), False), (192, (2, 7, 9), True), (192, (2, 7, 9), False),
         (1536, (2, 3, 2), True), (41, (3, 5, 7), False), (6143, (1, 2, 5), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,shape,act", CASES + [(6400, (1, 1, 3), False)])
def test_emulated_forward_matches_plain(emulated, C, shape, act, dtype):
    """Kernels 19 and 20 against their plain twins, one counted call and
    one device launch each."""
    x, scale, bias, _ = _case(C + len(shape), shape, C, dtype)
    want = pe_fused.ln_act_fused_plain(x, scale, bias, act)
    for fn, call in ((pe_fused.ln_act_fused, lambda: pe_fused.ln_act_fused(x, scale, bias, act)),
                     (seg_ln.seg_ln_fwd, lambda: seg_ln.seg_ln_fwd(x, scale, bias, act=act))):
        before, dev = fn.launches, emulated.emu_launches()
        got = call()
        assert fn.launches == before + 1 and emulated.emu_launches() == dev + 1
        assert got.dtype == dtype and got.shape == x.shape
        _close(got, want, *_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,shape,act", CASES)
def test_emulated_backward_matches_plain(emulated, C, shape, act, dtype):
    """Kernel 21 against its plain twin: dx in x's dtype, dscale and dbias
    float32; one counted call, two device launches; dscale and dbias bit
    for bit over two runs."""
    x, scale, bias, g = _case(C + len(shape) + 1, shape, C, dtype)
    before, dev = seg_ln.seg_ln_bwd.launches, emulated.emu_launches()
    got = seg_ln.seg_ln_bwd(x, scale, bias, g, act=act)
    assert seg_ln.seg_ln_bwd.launches == before + 1
    assert emulated.emu_launches() == dev + 2
    want = seg_ln.seg_ln_bwd_plain(x, scale, bias, g, act=act)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    _close(got[0], want[0], *_tol(dtype))
    for a, w in zip(got[1:], want[1:]):
        _close(a, w, 1e-4, 1e-4 * float(w.abs().max()))
    again = seg_ln.seg_ln_bwd(x, scale, bias, g, act=act)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_unaligned_base(emulated, dtype):
    """x and g one element past a 16-byte boundary: every tile staged
    element by element; the bulk path's results."""
    x, scale, bias, g = _case(3, (3, 9, 11), 48, dtype, offset=1)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    for act in (True, False):
        xa, ga = x.clone(), g.clone()
        assert torch.equal(seg_ln.seg_ln_fwd(x, scale, bias, act=act),
                           seg_ln.seg_ln_fwd(xa, scale, bias, act=act))
        for a, b in zip(seg_ln.seg_ln_bwd(x, scale, bias, g, act=act),
                        seg_ln.seg_ln_bwd(xa, scale, bias, ga, act=act)):
            assert torch.equal(a, b)
        _close(seg_ln.seg_ln_fwd(x, scale, bias, act=act),
               seg_ln.seg_ln_fwd_plain(x, scale, bias, act=act), *_tol(dtype))


# (C, dtype, backward, the row path): the last of the staged plan at 24
# values a thread, a tile past shared memory (the backward's at C 6143),
# past 6,144 values, a pixel of 4 MB
PLANS = [(6144, torch.bfloat16, True, False), (6143, torch.bfloat16, False, False),
         (6143, torch.bfloat16, True, True), (6145, torch.float32, False, True),
         (6400, torch.bfloat16, True, True), (10 ** 6, torch.float32, True, True)]


@pytest.mark.parametrize("C,dtype,backward,rowwise", PLANS)
def test_emulated_plan_takes_every_C(emulated, C, dtype, backward, rowwise):
    """Every C has a plan: the staged one within the shared memory a block
    may take, with at most 24 values a thread, else the row path (a block a
    pixel, no shared memory staged)."""
    plan = seg_ln.ln_plan(torch.empty(1, C, dtype=dtype).expand(10, C), backward)
    assert plan["rowwise"] == rowwise and plan["blocks"] >= 1
    if rowwise:
        assert (plan["tpp"], plan["tile"], plan["tiles"], plan["smem"]) == (256, 1, 10, 0)
    else:
        per = 16 // dtype.itemsize if C * dtype.itemsize % 16 == 0 else 1
        assert -(-C // (per * plan["tpp"])) * per <= 24
        assert 0 < plan["stages"] <= 3 and plan["smem"] <= 227 * 1024


def test_emulated_first_design(emulated):
    """The first design's wrappers (kept for old-against-new timings)
    against the plain twins, each counted on its own."""
    x, scale, bias, g = _case(5, (2, 9, 11), 48, torch.float32)
    before = (pe_fused.ln_act_fused_first.launches, seg_ln.seg_ln_fwd_first.launches,
              seg_ln.seg_ln_bwd_first.launches)
    want = seg_ln.seg_ln_fwd_plain(x, scale, bias, act=True)
    _close(pe_fused.ln_act_fused_first(x, scale, bias, True), want, 2e-5, 2e-5)
    _close(seg_ln.seg_ln_fwd_first(x, scale, bias, act=True), want, 2e-5, 2e-5)
    got = seg_ln.seg_ln_bwd_first(x, scale, bias, g, act=True)
    for a, w in zip(got, seg_ln.seg_ln_bwd_plain(x, scale, bias, g, act=True)):
        _close(a, w, 1e-4, 1e-4 * float(w.abs().max()))
    assert (pe_fused.ln_act_fused_first.launches, seg_ln.seg_ln_fwd_first.launches,
            seg_ln.seg_ln_bwd_first.launches) == tuple(b + 1 for b in before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8), (3, 37, 41)])
def test_emulated_kernel19_matches_pallas_interpret(emulated, shape, act, dtype):
    """Kernel 19 against ``ln_act_fused(..., interpret=True)`` (the Pallas
    kernel ``_ln_act_kernel``), C 48."""
    x, scale, bias, _ = _case(6, shape, 48, torch.float32)
    jx = jnp.asarray(x.numpy()).astype(dtype)
    want = jax_pe.ln_act_fused(jx, jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
                               act_gelu=act, interpret=True)
    got = pe_fused.ln_act_fused(x.to(getattr(torch, dtype)), scale, bias, act)
    tol = (2e-5, 2e-5) if dtype == "float32" else (8e-3, 1.2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), *tol)


@pytest.mark.parametrize("C,shape,act", [(48, (2, 16, 16), True), (96, (2, 8, 8), False),
                                         (192, (2, 28, 28), True), (384, (3, 14, 14), False)])
def test_emulated_kernels20_21_match_pallas_interpret(emulated, C, shape, act):
    """Kernels 20 and 21 against ``_seg_ln_fwd_call`` and
    ``_seg_ln_bwd_call`` in interpret mode at ``tests/test_seg_ln.py``'s
    gradient and downsample geometries, float32 (JAX's packed (P * C)
    dscale / dbias rows folded back to C), with that test's tolerances."""
    x, scale, bias, g = _case(7, shape, C, torch.float32)
    jx, jg = jnp.asarray(x.numpy()), jnp.asarray(g.numpy())
    x2, P, width = jax_seg._pack2d(jx, C)
    sb = jnp.stack([jnp.tile(jnp.asarray(scale.numpy()), P), jnp.tile(jnp.asarray(bias.numpy()),
                                                                      P)])
    y2 = jax_seg._seg_ln_fwd_call(x2, sb, C, 1e-5, act, interpret=True)
    dx2, dsb = jax_seg._seg_ln_bwd_call(x2, sb, jg.reshape(x2.shape), C, 1e-5, act,
                                        interpret=True)
    np.testing.assert_allclose(seg_ln.seg_ln_fwd(x, scale, bias, 1e-5, act).numpy(),
                               np.asarray(y2).reshape(x.shape), rtol=0, atol=2e-5)
    dx, dscale, dbias = seg_ln.seg_ln_bwd(x, scale, bias, g, 1e-5, act)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx2).reshape(x.shape), rtol=0, atol=3e-5)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(dsb[0]).reshape(P, C).sum(0),
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(dsb[1]).reshape(P, C).sum(0),
                               rtol=1e-4, atol=3e-4)


def _dbias_in_the_kernels_order(g, plan):
    """dbias as kernel 21 adds it, in float32: each thread its pixels in
    the order it serves them (tile by tile of its block, a group a pixel),
    a butterfly across the groups of a warp, the block's rows (warps, or
    groups wider than a warp) in order; on the row path each channel its
    block's pixels in order; then the blocks' partial rows, row j into
    running sum j % 8, the eight sums in order."""
    rows, C = g.shape
    tile, tpp, grid = plan["tile"], plan["tpp"], plan["blocks"]
    ngrp, f32 = 256 // tpp, np.float32
    partial = np.zeros((grid, C), f32)
    for blk in range(grid):
        if plan["rowwise"]:
            for r in range(blk, rows, grid):
                partial[blk] = partial[blk] + g[r]
            continue
        acc = np.zeros((ngrp, C), f32)  # a group's threads hold its channels
        for t in range(blk, plan["tiles"], grid):
            rn = min(tile, rows - t * tile)
            for p0 in range(0, rn, ngrp):
                n = min(ngrp, rn - p0)
                acc[:n] = acc[:n] + g[t * tile + p0:t * tile + p0 + n]
        if tpp < 32:  # groups of a warp: xor offsets 1 .. 32 / tpp / 2 over them
            acc = acc.reshape(8, 32 // tpp, C)
            off = 1
            while off < 32 // tpp:
                acc = acc + acc[:, np.arange(32 // tpp) ^ off]
                off *= 2
            acc = acc[:, 0]
        out = acc[0].copy()
        for r in range(1, len(acc)):
            out = out + acc[r]
        partial[blk] = out
    runs = np.zeros((8, C), f32)
    for j in range(grid):
        runs[j % 8] = runs[j % 8] + partial[j]
    total = runs[0].copy()
    for k in range(1, 8):
        total = total + runs[k]
    return total


@pytest.mark.parametrize("C,rows", [(48, 3 * 37 * 41), (1536, 200), (6400, 40)])
def test_emulated_column_sums_in_a_fixed_order(emulated, C, rows):
    """dbias (float32 g of widely spread magnitudes, so that another order
    of the additions rounds otherwise) equals, bit for bit, a float32 model
    of the kernel's order (`_dbias_in_the_kernels_order`) at the plan's
    tiles, groups and grid, over a pixel count that fills no whole tile,
    and on the row path (C 6400)."""
    rng = np.random.default_rng(10)
    g = (rng.standard_normal((rows, C)) * 2.0 ** rng.integers(-12, 13, (rows, C))).astype(
        np.float32)
    x, scale, bias, _ = _case(11, (rows,), C, torch.float32)
    plan = seg_ln.ln_plan(x, backward=True)
    assert plan["tiles"] > plan["blocks"] > 1 and plan["rowwise"] == (C > 6144)
    want = _dbias_in_the_kernels_order(g, plan)
    got = seg_ln.seg_ln_bwd(x, scale, bias, T(g))[2]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, g.sum(0, dtype=np.float32))


class _Refusing:
    """A library whose every entry refuses its call (a CUDA error status)."""

    def __getattr__(self, name):
        return lambda *args: 1


def test_emulated_refused_calls_count_nothing(emulated, monkeypatch):
    """Calls refused by the wrappers' checks (a scale of another width, g
    of another dtype, x of float16) or by the C entries (each returning an
    error status) raise and add nothing to the wrappers' launches; the
    emulator saw no launch."""
    x, scale, bias, g = _case(9, (2, 3, 5), 48, torch.bfloat16)
    before = [fn.launches for fn in WRAPPERS], emulated.emu_launches()
    refused = [
        (ValueError, lambda: pe_fused.ln_act_fused(x, scale[:40], bias, True)),
        (ValueError, lambda: seg_ln.seg_ln_fwd(x, scale[:40], bias)),
        (TypeError, lambda: seg_ln.seg_ln_bwd(x, scale, bias, g.float())),
        (TypeError, lambda: seg_ln.seg_ln_fwd(x.half(), scale, bias)),
    ]
    for exc, call in refused:
        with pytest.raises(exc):
            call()
    with monkeypatch.context() as mp:
        mp.setattr(build, "library", _Refusing)
        for call in (lambda: pe_fused.ln_act_fused(x, scale, bias, True),
                     lambda: seg_ln.seg_ln_fwd(x, scale, bias),
                     lambda: seg_ln.seg_ln_bwd(x, scale, bias, g)):
            with pytest.raises(RuntimeError):
                call()
    assert ([fn.launches for fn in WRAPPERS], emulated.emu_launches()) == before
    pe_fused.ln_act_fused(x, scale, bias, True)
    seg_ln.seg_ln_fwd(x, scale, bias)
    seg_ln.seg_ln_bwd(x, scale, bias, g)
    assert [fn.launches for fn in WRAPPERS] == [b + 1 for b in before[0]]
    assert emulated.emu_launches() == before[1] + 4


def test_emulated_forwards_refuse_a_graph(emulated):
    """Kernels 19 and 20 have no backward of their own (`seg_ln_act` wraps
    kernel 20 with 21): while autograd records, a scale that requires a
    gradient is refused before the launch; under ``torch.no_grad()`` the
    calls run."""
    x, scale, bias, _ = _case(5, (2, 3, 4), 48, torch.float32)
    scale = scale.clone().requires_grad_()
    dev = emulated.emu_launches()
    for fn, call in ((pe_fused.ln_act_fused, lambda: pe_fused.ln_act_fused(x, scale, bias, True)),
                     (seg_ln.seg_ln_fwd, lambda: seg_ln.seg_ln_fwd(x, scale, bias, act=True))):
        before = fn.launches
        with pytest.raises(RuntimeError, match="no gradient"):
            call()
        assert fn.launches == before and emulated.emu_launches() == dev
        with torch.no_grad():
            got = call()
        _close(got, pe_fused.ln_act_fused_plain(x, scale.detach(), bias, True), *_tol(x.dtype))
        dev = emulated.emu_launches()
