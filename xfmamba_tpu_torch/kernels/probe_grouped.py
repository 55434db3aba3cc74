"""What sets the pace of kernels 13 and 14 (the grouped scan and its adjoint)
on the card: each design compiled as it is and with parts of its work taken
out, timed at the XFMamba-B step's call.

    python -m xfmamba_tpu_torch.kernels.probe_grouped [v1] [lanes]

For each variant the probe copies ``csrc`` into its own directory, edits the
copy, compiles the design's source there with nvcc (all variants at once,
each into its own library) and, in a process of its own, runs the port's
wrappers on that library:
the first design (``selective_scan_grouped_v1.cu``, `grouped_scan_*_v1`)
and the redesign (``grouped_scan_lanes.cu``, `grouped_scan_fwd` / `_bwd`).
Prints each build's registers and spills (``-Xptxas -v``) and each
variant's device ms per call by CUDA-graph replay at (48, 49, 2048) K=1
N=16, float32, scanned forward and in reverse; the redesign as it is also
with blocks of `WARPS` warps.  A variant with work taken
out computes wrong results: it only times what is left.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import selective_scan_grouped as ssg

SHAPE = (48, 49, 1, 2048, 16)        # (B, L, K, C, N)
WARPS = (2, 4)                       # the redesign as it is also timed at these widths
V1, LANES = "selective_scan_grouped_v1.cu", "grouped_scan_lanes.cu"
ENTRY = re.compile(r".*entry function '(\w+)'.*")

# the first design: its dB / dC atomics (the warp sums still made, kept
# alive by a store that never happens) and its state scratch (no state
# stored, the walk back reading the state after each position instead of
# the one before)
_ATOMIC = ("atomicAdd(dst + ((ch.img * p.L + t0 + i) * p.K + ch.k) * p.N + n, sum);",
           "if (sum == 1.5e-38f) dst[0] = sum;")
_SCRATCH = [("if (ch.active) hs[static_cast<long long>(i * p.N + n) * p.C] = h[n];", ""),
            (": hs[static_cast<long long>(ip * p.N + n) * p.C];", ": h[n];")]
# the redesign: the states' exp2 as an FMA, the softplus without its
# exponential, the dB / dC reduce-scatter, the segment flushes, the walks;
# the forward's checkpoint writes, y rows and y shuffles; the adjoint's walk
# to the segments' entry states and its second launch
_EX2 = ("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "y = fmaf(x, 0.0625f, 0.9f);")
_SOFTPLUS = ("common.cuh", "  if (z > 20.f) return z;\n  const float t = __expf(-fabsf(z));",
             "  if (z > 20.f) return z;\n  return fmaxf(z, 0.f) + 0.25f;\n  const float t = 0.f;")
_REDUCE = (LANES, "lanes_reduce_scatter(v, th.lane)", "(v[0] + v[5])")
_FLUSH = [(LANES, "f_n < p.N && sl < scnt;", "sl < 0;"), (LANES, "plive && sl < scnt;", "sl < 0;")]
_FWD_WALK = (LANES, "for (int s = 0; s < cnt; ++s) {\n      const int i = p.reverse ?",
             "for (int s = 0; s < 0; ++s) {\n      const int i = p.reverse ?")
_BWD_WALK = (LANES, "for (int q = kLanesSeg - 1; q >= 0; --q) {\n        if (q < scnt) {",
             "for (int q = kLanesSeg - 1; q >= 0; --q) {\n        if (q < scnt && scnt < 0) {")

_CK = (LANES, "    if (th.active) {\n      float* ckj = lanes_ck(p, th, t0 / chunk);",
       "    if (th.active && cnt < 0) {\n      float* ckj = lanes_ck(p, th, t0 / chunk);")
_Y = (LANES, "y[static_cast<long long>(t0 + i) * th.KC] = fmaf(p_d, to_f32(r.u[e]), s_y[e]);",
      "if (s_y[e] == 1.5e-38f) y[0] = p_d;")
_SHFL = (LANES, "      yv += __shfl_xor_sync(0xffffffffu, yv, 1);\n"
         "      yv += __shfl_xor_sync(0xffffffffu, yv, 2);\n", "")
_PASS1 = (LANES, "for (int s = 0; s < cnt; ++s) {\n      if (s % kLanesSeg == 0) {",
          "for (int s = 0; s < 0; ++s) {\n      if (s % kLanesSeg == 0) {")
_FINISH = (LANES, "  lanes_finish_kernel<<<", "  if (blocks < 0) lanes_finish_kernel<<<")

# design -> variant -> [(file, old, new)]
DESIGNS = {
    "v1": (V1, {"as is": [], "no dB/dC atomics": [(V1, *_ATOMIC)],
                "no state scratch": [(V1, *e) for e in _SCRATCH],
                "neither": [(V1, *_ATOMIC)] + [(V1, *e) for e in _SCRATCH]}),
    "lanes": (LANES, {"as is": [], "states' exp2 as an FMA": [_EX2],
                      "softplus without its exponential": [_SOFTPLUS],
                      "no dB/dC reduce-scatter": [_REDUCE], "no segment flushes": _FLUSH,
                      "no dB/dC flush": _FLUSH[:1], "no du/d delta flush": _FLUSH[1:],
                      "no forward walk, no walk back": [_FWD_WALK, _BWD_WALK],
                      "no checkpoint writes, no walk to the segments": [_CK, _PASS1],
                      "no y rows, no second launch": [_Y, _FINISH],
                      "no shuffles of y": [_SHFL]}),
}


def compile_all(design):
    """One nvcc per variant, all started together, each into
    ``probe_<design>/v<i>/probe.so``: {name: ptxas log}."""
    source, variants = DESIGNS[design]
    root = build.BUILD_DIR / f"probe_{design}"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = root / f"v{i}"
        shutil.copytree(build.CSRC_DIR, src)
        for file, old, new in edits:
            text = (src / file).read_text()
            if old not in text:
                raise RuntimeError(f"{file} no longer holds {old!r}")
            (src / file).write_text(text.replace(old, new))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(src / "probe.so"),
               str(src / source)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    logs = {}
    for name, proc in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{logs[name]}")
    return logs


def load(design, index):
    """Variant ``index``'s library, bound as `build.library`."""
    lib = ctypes.CDLL(str(build.BUILD_DIR / f"probe_{design}" / f"v{index}" / "probe.so"))
    names = ("xfm_grouped_scan_fwd", "xfm_grouped_scan_bwd") if design == "lanes" else (
        "xfm_grouped_scan_fwd_v1", "xfm_grouped_scan_bwd_v1")
    for fn in names:
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    build.library = lambda: lib
    build.check = _check  # a variant's library has no error strings


def _check(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def graph_ms(fn, reps=20):
    """Device ms per call: ``reps`` calls in one CUDA graph, replayed between
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3 / reps


def operands(B, L, K, C, N):
    """A trained model's ranges: A in [-e^1.5, -1], deltas about
    softplus(-4 +- 1); and the gradient of y."""
    g = torch.Generator().manual_seed(13)
    KC = K * C

    def randn(*shape, shift=0.0, scale=1.0):
        return (scale * torch.randn(*shape, generator=g) + shift).cuda()

    args = (randn(B, L, KC), randn(B, L, KC, shift=-4.0),
            -torch.exp(1.5 * torch.rand(KC, N, generator=g)).cuda(), randn(B, L, K, N),
            randn(B, L, K, N), randn(KC), randn(KC, scale=0.5))
    return args, randn(B, L, KC)


def time_variant(design, index):
    """Times variant ``index`` of ``design`` (in a process of its own: each
    library carries its own CUDA runtime)."""
    load(design, index)
    args, dy = operands(*SHAPE)
    fwd, bwd = ((ssg.grouped_scan_fwd, ssg.grouped_scan_bwd) if design == "lanes" else
                (ssg.grouped_scan_fwd_v1, ssg.grouped_scan_bwd_v1))
    for reverse in (False, True):
        _, ck = fwd(*args, reverse=reverse)
        ms_f = graph_ms(lambda: fwd(*args, reverse=reverse))
        ms_b = graph_ms(lambda: bwd(*args, ck, dy, reverse=reverse))
        print(f"   {'reverse' if reverse else 'forward'} scan: kernel 13 {ms_f:.4f} ms, "
              f"kernel 14 {ms_b:.4f} ms per call (graph replay)")
    if design == "lanes" and index == 0:
        for warps in WARPS:
            ssg.LANES_WARPS = warps
            _, ck = fwd(*args)
            print(f"   blocks of at most {warps} warps: kernel 13 "
                  f"{graph_ms(lambda: fwd(*args)):.4f} ms, kernel 14 "
                  f"{graph_ms(lambda: bwd(*args, ck, dy)):.4f} ms per call (graph replay)")
    torch.cuda.synchronize()


def main(designs):
    if not torch.cuda.is_available():
        raise SystemExit("probe_grouped: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; shape (B, L, K, C, N) {SHAPE}, float32, chunk {ssg.CHUNK}", flush=True)
    for design in designs:
        logs = compile_all(design)
        for index, (name, log) in enumerate(logs.items()):
            lines = log.splitlines()
            regs = [ENTRY.sub(r"\1", ln) + f": {lines[k + 2].strip()}; "
                    + lines[k + 3].split(":")[-1].strip()
                    for k, ln in enumerate(lines[:-3]) if "Compiling entry" in ln]
            print(f"-- {design} {name!r}:\n  " + "\n  ".join(regs), flush=True)
            run = subprocess.run([sys.executable, "-m", __spec__.name, "--time", design,
                                  str(index)], capture_output=True, text=True, check=False)
            print(run.stdout.rstrip() if run.returncode == 0 else
                  f"   failed:\n{run.stdout}{run.stderr[-2000:]}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2], int(sys.argv[3]))
    else:
        main(sys.argv[1:] or list(DESIGNS))
