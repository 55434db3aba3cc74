"""What sets the pace of a hand-written kernel on the card: its source
compiled as it is and with edits (another schedule, a part of its work taken
out), each variant's registers and spills (``-Xptxas -v``) and device ms per
call by CUDA-graph replay (``chip_smoke.graph_ms``).

    python -m xfmamba_tpu_torch.kernels.probe [subject ...]

run from the repo's root.  The subjects (`SUBJECTS`, all by default):
- ``grouped_v1`` and ``grouped``: kernels 13 and 14, the first design
  (``selective_scan_grouped_v1.cu``, `grouped_scan_*_v1`) and the redesign
  (``grouped_scan_lanes.cu``, `grouped_scan_fwd` / `_bwd`), at (48, 49,
  2048) K=1 N=16 in float32, scanned forward and in reverse; the redesign
  as it is also with blocks of 2 and 4 warps;
- ``v4`` and ``v3``: kernels 17 and 18 (``nk_scan_ablations.cu``,
  `nk_scan_v4_cuda` / `nk_scan_v3_cuda`) at XFMamba-S's bs-32 ShallowFuse
  call (32, 49, 1536) K=1 and its bs-16 step's Cross_SS2Dv5 call (48, 49,
  1536) K=4, N 16, both dtypes; as it is also at every slab of
  ``ablation_scan.SLABS`` whose whole-map block fits;
- ``ln``: kernels 19/20 and 21 (``ln_act.cu``, `seg_ln_fwd` / `seg_ln_bwd`)
  at the bs-64 patch embed's two norms in bfloat16, (128, 112, 112, 48)
  with the GELU and (128, 56, 56, 96) without; as it is also with 48
  values a thread (a thread a pixel at C 48, two at C 96: the other work
  split).

Each subject's source as it is also reports its kernels' SASS instructions
(``cuobjdump -sass``, NOPs left out), and, where the subject names the
values a thread holds, the instructions a value.

For each variant the probe copies ``csrc`` into its own directory, applies
the variant's (file, old, new) edits to the copy, compiles the subject's
source there with nvcc (all variants at once, each into its own library)
and, in a process of its own, runs the port's wrappers on that library.  A
variant with work taken out computes wrong results: it only times what is
left.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from xfmamba_tpu_torch.kernels import build

ENTRY = re.compile(r".*entry function '(\w+)'.*")
SASS_LINE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+[A-Z@]")  # an instruction of cuobjdump -sass
GROUPED_V1, LANES, ABLATIONS = (
    "selective_scan_grouped_v1.cu", "grouped_scan_lanes.cu", "nk_scan_ablations.cu")
_EX2 = ("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "y = fmaf(x, 0.0625f, 0.9f);")

# kernels 13/14, the first design: its dB / dC atomics (the warp sums still
# made, kept alive by a store that never happens) and its state scratch (no
# state stored, the walk back reading the state after each position)
_ATOMIC = (GROUPED_V1,
           "atomicAdd(dst + ((ch.img * p.L + t0 + i) * p.K + ch.k) * p.N + n, sum);",
           "if (sum == 1.5e-38f) dst[0] = sum;")
_SCRATCH = [(GROUPED_V1, "if (ch.active) hs[static_cast<long long>(i * p.N + n) * p.C] = h[n];",
             ""),
            (GROUPED_V1, ": hs[static_cast<long long>(ip * p.N + n) * p.C];", ": h[n];")]
# the redesign: the softplus without its exponential, the dB / dC
# reduce-scatter, the segment flushes, the walks; the forward's checkpoint
# writes, y rows and y shuffles; the adjoint's walk to the segments' entry
# states and its second launch
_SOFTPLUS = ("common.cuh", "  if (z > 20.f) return z;\n  const float t = __expf(-fabsf(z));",
             "  if (z > 20.f) return z;\n  return fmaxf(z, 0.f) + 0.25f;\n  const float t = 0.f;")
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

# kernels 19-21: the tile's bytes, the stages, the backward's blocks an SM,
# the GELU's work (none: what the erf costs), the stores of y and dx
LN = "ln_act.cu"
_LN_TILE = (LN, "kLnStageBytes = 16 * 1024;", "kLnStageBytes = 32 * 1024;")
_LN_STAGES = (LN, "kLnStages = 3;", "kLnStages = {};")
_LN_BWD_ONE = (LN, "kLnBwdBlocks = 2;", "kLnBwdBlocks = 1;")
_LN_NO_GELU = [(LN, "o[e] = a.act ? gelu_erf(z) : z;", "o[e] = z;"),
               (LN, "if (a.act) gp *= gelu_erf_grad(", "if (a.act < 0) gp *= gelu_erf_grad(")]
# the GELU known at compile time (the GELU norm's timing only), the
# derivative's exponential on the SFU, more blocks an SM
_LN_ACT_FIXED = [(LN, "o[e] = a.act ? gelu_erf(z) : z;", "o[e] = gelu_erf(z);"),
                 (LN, "if (a.act) gp *= gelu_erf_grad(", "gp *= gelu_erf_grad(")]
_LN_FAST_EXP = (LN, "z * 0.39894228040143268f * expf(-0.5f * z * z);",
                "z * 0.39894228040143268f * __expf(-0.5f * z * z);")
_LN_FWD_FIVE = (LN, "__launch_bounds__(kLnThreads) ln_fwd_kernel",
                "__launch_bounds__(kLnThreads, 5) ln_fwd_kernel")
_LN_WIDE = (LN, "kLnElems = 24;", "kLnElems = 48;")
_LN_NO_STORE = [(LN, "ln_store<PE>(yt + static_cast<long long>(pix) * C + pc * PE, o, vec_y);",
                 "if (o[0] == 1.5e-38f) ln_store<PE>(yt, o, vec_y);"),
                (LN, "ln_store<PE>(dxt + static_cast<long long>(pix) * C + pc * PE, o, vec_y);",
                 "if (o[0] == 1.5e-38f) ln_store<PE>(dxt, o, vec_y);")]

# kernels 17/18: kernel 17's walk another number of steps at a time
_UNROLL = "#pragma unroll 2\n          for (int t = 0; t < tn; ++t) {"
_WALK = """#pragma unroll 2
          for (int t = 0; t < tn; ++t) {
            const float2 dx = dxp[t * S], bc = bcp[t * NP];
            hf[0] = fmaf(fast_exp2(dx.x * a2), hf[0], dx.y * bc.x);
            float y = bc.y * hf[0];
#pragma unroll
            for (int off = NP / 2; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
            if (walker && g == 0) {"""


def _steps(rs):
    """Kernel 17's walk summing the states of RS steps at once: each lane
    keeps its C_n h_n of RS steps, log2(RS) rounds of shuffles halve the
    steps a lane holds (a reduce-scatter) and log2(NP / RS) more sum the
    rest, so that lanes j NP / RS hold step tb + j's sum; RS - 1 + log2(NP /
    RS) shuffles for RS steps instead of RS log2(NP)."""
    return (ABLATIONS, _WALK, f"""constexpr int RS = {rs} < NP ? {rs} : NP;
          for (int tb = 0; tb < tn; tb += RS) {{
            float v[RS];
#pragma unroll
            for (int j = 0; j < RS; ++j) {{
              v[j] = 0.f;
              if (tb + j < tn) {{
                const float2 dx = dxp[(tb + j) * S], bc = bcp[(tb + j) * NP];
                hf[0] = fmaf(fast_exp2(dx.x * a2), hf[0], dx.y * bc.x);
                v[j] = bc.y * hf[0];
              }}
            }}
            int w = NP / 2;
#pragma unroll
            for (int m = RS; m > 1; m >>= 1, w >>= 1) {{
              const bool upper = g & w;
#pragma unroll
              for (int j = 0; j < m / 2; ++j) {{
                const float send = upper ? v[j] : v[j + m / 2];
                v[j] = (upper ? v[j + m / 2] : v[j]) + __shfl_xor_sync(0xffffffffu, send, w);
              }}
            }}
#pragma unroll
            for (; w > 0; w >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], w);
            const float y = v[0];
            const int t = tb + g / (NP / RS);
            if (walker && g % (NP / RS) == 0 && t < tn) {{""")


@dataclass
class Subject:
    source: str                # the source compiled, in csrc
    entries: tuple             # the C entries bound as `build.library`
    variants: dict             # name -> [(file, old, new)], "as is" first
    reported: str              # in the entry functions whose registers print ("": all)
    values: int = 0            # values a reported kernel's thread holds (0: not one count)


SUBJECTS = {
    "grouped_v1": Subject(
        GROUPED_V1, ("xfm_grouped_scan_fwd_v1", "xfm_grouped_scan_bwd_v1"),
        {"as is": [], "no dB/dC atomics": [_ATOMIC], "no state scratch": _SCRATCH,
         "neither": [_ATOMIC] + _SCRATCH}, ""),
    "grouped": Subject(
        LANES, ("xfm_grouped_scan_fwd", "xfm_grouped_scan_bwd"),
        {"as is": [], "states' exp2 as an FMA": [_EX2],
         "softplus without its exponential": [_SOFTPLUS],
         "no dB/dC reduce-scatter": [(LANES, "lanes_reduce_scatter(v, th.lane)", "(v[0] + v[5])")],
         "no segment flushes": _FLUSH, "no dB/dC flush": _FLUSH[:1],
         "no du/d delta flush": _FLUSH[1:],
         "no forward walk, no walk back": [_FWD_WALK, _BWD_WALK],
         "no checkpoint writes, no walk to the segments": [_CK, _PASS1],
         "no y rows, no second launch": [_Y, _FINISH], "no shuffles of y": [_SHFL]}, ""),
    "v4": Subject(
        ABLATIONS, ("xfm_nk_scan_v4", "xfm_nk_scan_v3", "xfm_nk_ablation_smem"),
        {"as is": [], "walk one step at a time": [(ABLATIONS, _UNROLL, _UNROLL.replace("2", "1"))],
         "walk four steps at a time": [(ABLATIONS, _UNROLL, _UNROLL.replace("2", "4"))],
         "64 registers": [(ABLATIONS, "KERNEL == kAbV4 ? 2 : 1)", "1)")],
         "states summed every 2 steps": [_steps(2)], "states summed every 4 steps": [_steps(4)],
         "states summed every 16 steps": [_steps(16)],
         "no shuffles": [(ABLATIONS, "for (int off = NP / 2; off > 0; off >>= 1) y += "
                          "__shfl_xor_sync(0xffffffffu, y, off);", "")],
         "exp2 as an FMA": [_EX2]}, "Li0ELi16E"),
    "v3": Subject(
        ABLATIONS, ("xfm_nk_scan_v4", "xfm_nk_scan_v3", "xfm_nk_ablation_smem"),
        {"as is": [], "255 registers (blocks of at most 256)": [
            (ABLATIONS, "kAbV3Threads = 384;", "kAbV3Threads = 256;")],
         "exp2 as an FMA": [_EX2]}, "Li1ELi16E"),
    "ln": Subject(
        LN, ("xfm_ln_act", "xfm_seg_ln_fwd", "xfm_seg_ln_bwd", "xfm_ln_plan"),
        {"as is": [], "tiles up to 32 KB": [_LN_TILE],
         "two stages": [(_LN_STAGES[0], _LN_STAGES[1], _LN_STAGES[2].format(2))],
         "four stages": [(_LN_STAGES[0], _LN_STAGES[1], _LN_STAGES[2].format(4))],
         "backward one block an SM": [_LN_BWD_ONE],
         "backward three blocks an SM": [(LN, "kLnBwdBlocks = 2;", "kLnBwdBlocks = 3;")],
         "forward five blocks an SM": [_LN_FWD_FIVE],
         "the GELU known at compile time": _LN_ACT_FIXED,
         "the derivative's exp on the SFU": [_LN_FAST_EXP], "no GELU work": _LN_NO_GELU,
         "no stores of y or dx": _LN_NO_STORE,
         "48 values a thread (fewer threads a pixel)": [_LN_WIDE]}, "13__nv_bfloat16Li8E", 24),
}


def compile_all(name):
    """One nvcc per variant of subject ``name``, all started together, each
    into ``probe_<name>/v<i>/probe.so``: {variant: ptxas log}."""
    subject = SUBJECTS[name]
    root = build.BUILD_DIR / f"probe_{name}"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for i, (variant, edits) in enumerate(subject.variants.items()):
        src = root / f"v{i}"
        shutil.copytree(build.CSRC_DIR, src)
        for file, old, new in edits:
            text = (src / file).read_text()
            if old not in text:
                raise RuntimeError(f"{file} no longer holds {old!r}")
            (src / file).write_text(text.replace(old, new))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(src / "probe.so"),
               str(src / subject.source)]
        jobs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)
    logs = {}
    for variant, proc in jobs.items():
        logs[variant] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant!r}:\n{logs[variant]}")
    return logs


def _check(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def load(name, index):
    """Variant ``index`` of subject ``name``, bound as `build.library`."""
    lib = ctypes.CDLL(str(build.BUILD_DIR / f"probe_{name}" / f"v{index}" / "probe.so"))
    for fn in SUBJECTS[name].entries:
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    build.library = lambda: lib
    build.check = _check  # a variant's library has no error strings


def _randn(g, *shape, shift=0.0, scale=1.0, dtype=torch.float32):
    return (scale * torch.randn(*shape, generator=g) + shift).cuda().to(dtype)


def time_grouped(name, index, graph_ms):
    """Kernels 13 and 14 at (B, L, K, C, N) = (48, 49, 1, 2048, 16): A in
    [-e^1.5, -1], deltas about softplus(-4 +- 1)."""
    from xfmamba_tpu_torch.ops import selective_scan_grouped as ssg

    B, L, K, C, N = 48, 49, 1, 2048, 16
    g = torch.Generator().manual_seed(13)
    KC = K * C
    args = (_randn(g, B, L, KC), _randn(g, B, L, KC, shift=-4.0),
            -torch.exp(1.5 * torch.rand(KC, N, generator=g)).cuda(), _randn(g, B, L, K, N),
            _randn(g, B, L, K, N), _randn(g, KC), _randn(g, KC, scale=0.5))
    dy = _randn(g, B, L, KC)
    fwd, bwd = ((ssg.grouped_scan_fwd, ssg.grouped_scan_bwd) if name == "grouped" else
                (ssg.grouped_scan_fwd_v1, ssg.grouped_scan_bwd_v1))
    for reverse in (False, True):
        _, ck = fwd(*args, reverse=reverse)
        ms_f = graph_ms(lambda: fwd(*args, reverse=reverse))
        ms_b = graph_ms(lambda: bwd(*args, ck, dy, reverse=reverse))
        print(f"   {'reverse' if reverse else 'forward'} scan: kernel 13 {ms_f:.4f} ms, "
              f"kernel 14 {ms_b:.4f} ms per call (graph replay)")
    if name == "grouped" and index == 0:
        for warps in (2, 4):
            ssg.LANES_WARPS = warps
            _, ck = fwd(*args)
            print(f"   blocks of at most {warps} warps: kernel 13 "
                  f"{graph_ms(lambda: fwd(*args)):.4f} ms, kernel 14 "
                  f"{graph_ms(lambda: bwd(*args, ck, dy)):.4f} ms per call (graph replay)")


def time_ablation(name, index, graph_ms):
    """Kernel 17 (``v4``) or 18 (``v3``) at (32, 49, 1536) K=1 and (48, 49,
    1536) K=4, N 16, both dtypes: A in [-e^1.5, -1], dt in [1e-3, 1e-1]."""
    from xfmamba_tpu_torch.ops.ablations import ablation_scan, nk_scan_v4, nk_scan_wide
    from xfmamba_tpu_torch.ops.nk_scan import scan_mode_kinds

    fn = nk_scan_v4.nk_scan_v4_cuda if name == "v4" else nk_scan_wide.nk_scan_v3_cuda
    slabs, D, H, N = ablation_scan.SLABS[name], 1536, 7, 16
    for n, K in ((32, 1), (48, 4)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator().manual_seed(17)
            dt = torch.exp(torch.rand(K, D, generator=g) * 4.6 - 6.9)
            L = H * H
            args = (_randn(g, n, L, D, dtype=dtype), _randn(g, n, L, K * D, scale=0.5, dtype=dtype),
                    _randn(g, n, L, K * N, dtype=dtype), _randn(g, n, L, K * N, dtype=dtype),
                    -torch.exp(1.5 * torch.rand(K * N, D, generator=g)).cuda(),
                    torch.randn(K, D, generator=g).cuda(),
                    (dt + torch.log(-torch.expm1(-dt))).cuda(), H, H,
                    ("row_f",) if K == 1 else scan_mode_kinds("cross2d"))

            def plan():
                ablation_scan._plan.cache_clear()
                return ablation_scan.ablation_plan(name, n, L, K, N, D, 1 + (K > 1), dtype)

            line = (f"   ({n},{L},{D}) K={K} {str(dtype)[6:]}: slab {plan()[1]} "
                    f"{graph_ms(lambda: fn(*args)):.4f} ms")
            if index == 0:
                for s in slabs:
                    ablation_scan.SLABS[name] = (s,)
                    if plan()[0]:
                        line += f", slab {s} {graph_ms(lambda: fn(*args)):.4f}"
                ablation_scan.SLABS[name] = slabs
                plan()
            print(line + " per call (graph replay)", flush=True)


def time_ln(name, index, graph_ms):
    """Kernels 20 (19's function) and 21 at the bs-64 patch embed's norms in
    bfloat16, x as phase 10c draws it."""
    from xfmamba_tpu_torch.ops.ablations import seg_ln

    g = torch.Generator().manual_seed(19)
    total = [0.0, 0.0]
    for shape, C, act in (((128, 112, 112), 48, True), ((128, 56, 56), 96, False)):
        x = _randn(g, *shape, C, shift=0.5, scale=2.0, dtype=torch.bfloat16)
        scale, bias = _randn(g, C, shift=1.0, scale=0.1), _randn(g, C, scale=0.1)
        gy = _randn(g, *shape, C, dtype=torch.bfloat16)
        fwd = graph_ms(lambda: seg_ln.seg_ln_fwd(x, scale, bias, act=act))
        bwd = graph_ms(lambda: seg_ln.seg_ln_bwd(x, scale, bias, gy, act=act))
        total = [total[0] + fwd, total[1] + bwd]
        print(f"   {shape + (C,)} {'GELU' if act else 'no act'}: kernel 20 {fwd:.4f} ms, kernel "
              f"21 {bwd:.4f} ms (its plan {seg_ln.ln_plan(x, True)})", flush=True)
    print(f"   per bs-64 patch embed: kernel 20 {total[0]:.4f} ms, kernel 21 {total[1]:.4f} ms "
          f"(graph replay)")


def sass_counts(path, reported):
    """{kernel (mangled): SASS instructions, NOPs left out} of the library's
    kernels whose name holds ``reported``, from ``cuobjdump -sass`` (beside
    nvcc)."""
    tool = str(Path(build._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            current = fn if reported in fn else None
            if current:
                counts[current] = 0
        elif current and SASS_LINE.match(line) and " NOP" not in line:
            counts[current] += 1
    return counts


def time_variant(name, index):
    """Times variant ``index`` of subject ``name`` (in a process of its own:
    each library carries its own CUDA runtime)."""
    from chip_smoke import graph_ms

    load(name, index)
    timer = time_grouped if name.startswith("grouped") else (
        time_ln if name == "ln" else time_ablation)
    timer(name, index, graph_ms)
    torch.cuda.synchronize()


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for name in names:
        logs = compile_all(name)
        for index, (variant, log) in enumerate(logs.items()):
            lines = log.splitlines()
            regs = [ENTRY.sub(r"\1", ln) + f": {lines[k + 2].strip()}; "
                    + lines[k + 3].split(":")[-1].strip()
                    for k, ln in enumerate(lines[:-3])
                    if "Compiling entry" in ln and SUBJECTS[name].reported in ln]
            print(f"-- {name} {variant!r}:\n  " + "\n  ".join(regs), flush=True)
            if index == 0:
                subject = SUBJECTS[name]
                so = build.BUILD_DIR / f"probe_{name}" / "v0" / "probe.so"
                for fn, n in sass_counts(so, subject.reported).items():
                    print(f"  SASS {fn[:80]}: {n} instructions"
                          + (f", {n / subject.values:.1f} a value of the {subject.values} a "
                             f"thread holds (an upper bound: staging and the walk included)"
                             if subject.values else ""), flush=True)
            run = subprocess.run([sys.executable, "-m", __spec__.name, "--time", name,
                                  str(index)], capture_output=True, text=True, check=False)
            print(run.stdout.rstrip() if run.returncode == 0 else
                  f"   failed:\n{run.stdout}{run.stderr[-2000:]}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2], int(sys.argv[3]))
    else:
        main(sys.argv[1:] or list(SUBJECTS))
