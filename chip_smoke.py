#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xfmamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``xfmamba_tpu_torch/csrc`` (nvcc, sm_90a),
   printing ``-Xptxas -v``;
3. each ported kernel against its plain PyTorch version on the card, at the
   shapes the batch-8 forward of XFMamba-S gives it (every backbone stage
   at its full depth, the ShallowFuse and the Cross_SS2Dv5 scans), in
   float32 and bfloat16, TF32 off;
4. XFMamba-S two-view 224x224 inference in bfloat16 with seeded weights,
   through ``two_view_xfmamba(...)(x_a, x_b)``: one batch of 8 and one of 32
   with the launch counts reset before and read after, then timings (CUDA
   events) per batch and per kernel beside the plain versions;
5. the same model in float32, on the card and on the CPU (plain path), at
   batch 1: the logits must agree.

The line before the last is one JSON object with the kernels' results, the
last ``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.tops import two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import nk_scan, vss_stage
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params

IMAGE = 224
# XFMamba-S backbone stages: (H, d, depth); di = 2d, R = ceil(d / 16)
STAGES = [(56, 96, 2), (28, 192, 2), (14, 384, 15), (7, 768, 2)]
FUSION = dict(H=7, D=1536, N=16, R=48)
TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
COMPARE_BATCH = 8                      # the first batch that phase 4 runs
KERNELS = {
    "vss_stage": dict(fn=vss_stage.vss_stage, per_forward=4,
                      source="xfmamba_tpu_torch/csrc/vss_stage.cu",
                      replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:542"),
    "nk_scan": dict(fn=nk_scan.nk_scan, per_forward=2,
                    source="xfmamba_tpu_torch/csrc/nk_scan.cu",
                    replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:890"),
    "nk_scan_x": dict(fn=nk_scan.nk_scan_x, per_forward=1,
                      source="xfmamba_tpu_torch/csrc/nk_scan.cu",
                      replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:944"),
}


class PhaseFailure(RuntimeError):
    pass


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def randn(g, *shape, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=g)).to("cuda", dtype)


def time_ms(fn, reps):
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel cases at the main path's widths
# ---------------------------------------------------------------------------

def stage_case(g, H, d, depth, batch, dtype):
    blocks = [VSSBlock(d, generator=g).eval().cuda() for _ in range(depth)]
    packed = [pack_vss_block_params(b, dtype) for b in blocks]
    x = randn(g, 2 * batch, H * H, d, dtype=dtype)
    return (x, packed, H, H), vss_stage.vss_stage, vss_stage.vss_stage_plain


def fusion_scan_operands(g, n, K, dtype):
    H, D, N = FUSION["H"], FUSION["D"], FUSION["N"]
    L = H * H
    A = -torch.arange(1.0, N + 1).repeat(K, 1).reshape(K * N, 1).expand(K * N, D)
    dt = torch.exp(torch.rand(K, D, generator=g) * 4.6 - 6.9)   # dt in [1e-3, 1e-1]
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, K * N, dtype=dtype),
            randn(g, n, L, K * N, dtype=dtype), A.contiguous().cuda(),
            torch.ones(K, D, device="cuda"), (dt + torch.log(-torch.expm1(-dt))).cuda())


def shallow_case(g, batch, dtype):
    """One of ShallowFuse's two K=1 row_f calls: (B, 49, 1536), N = 16."""
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, batch, 1, dtype)
    dts = randn(g, *u.shape, dtype=dtype, scale=0.5)
    H = FUSION["H"]
    return ((u, dts, Bs, Cs, A, Dvec, bias, H, H, ("row_f",)),
            nk_scan.nk_scan, nk_scan.nk_scan_plain)


def cross_case(g, batch, dtype):
    """Cross_SS2Dv5's rank-form call: (3B, 49, 1536), K = 4, N = 16, R = 48."""
    K, R, D, H = 4, FUSION["R"], FUSION["D"], FUSION["H"]
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, 3 * batch, K, dtype)
    ranks = randn(g, *u.shape[:2], K * R, dtype=dtype)
    w_dt = randn(g, K * R, D, scale=R ** -0.5)
    lno = torch.stack([torch.ones(D), torch.zeros(D)]).cuda()
    return ((u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, H,
             nk_scan.scan_mode_kinds("cross2d")), nk_scan.nk_scan_x, nk_scan.nk_scan_x_plain)


def main_path_cases(g, batch, dtype):
    """(kernel name, label, (args, kernel, plain)) at every main-path geometry."""
    for H, d, depth in STAGES:
        yield "vss_stage", f"stage H={H} d={d} depth={depth}", \
            stage_case(g, H, d, depth, batch, dtype)
    yield "nk_scan", "ShallowFuse (B,49,1536) K=1 N=16", shallow_case(g, batch, dtype)
    yield "nk_scan_x", "Cross_SS2Dv5 (3B,49,1536) K=4 N=16 R=48", cross_case(g, batch, dtype)


def phase_compare(errors):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 3: kernels vs plain versions on the card, batch {COMPARE_BATCH}, TF32 off")
    g = torch.Generator().manual_seed(1)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, (args, kernel, plain) in main_path_cases(g, COMPARE_BATCH, dtype):
            with torch.no_grad():
                got = kernel(*args)
                want = plain(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            ok = bool(torch.isfinite(got).all()) and rel <= TOL[dtype]
            errors[name] = max(errors.get(name, 0.0), err)
            print(f"  {name:9s} {label:42s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} tol={TOL[dtype]:.0e} {'OK' if ok else 'FAIL'}")
            if not ok:
                failed.append((name, label, dtype))
    if failed:
        raise PhaseFailure(f"kernels disagree with their plain versions: {failed}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def views(batch, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, IMAGE, IMAGE, 1, generator=g).to("cuda", dtype) for _ in range(2)]


def phase_model(model, card):
    print("phase 4: XFMamba-S two-view 224x224 inference, bfloat16, seeded weights")
    inputs = {bs: views(bs, torch.bfloat16, bs) for bs in (8, 32)}
    with torch.no_grad():
        model(*inputs[8])                                  # warm-up
        torch.cuda.synchronize()
        for k in KERNELS.values():
            k["fn"].launches = 0
        for bs, (xa, xb) in inputs.items():
            logits = model(xa, xb)
            torch.cuda.synchronize()
            if logits.shape != (bs, 2) or not torch.isfinite(logits).all():
                raise PhaseFailure(f"bs {bs}: bad logits {tuple(logits.shape)}")
            print(f"  bs {bs}: logits finite, shape {tuple(logits.shape)}, "
                  f"first row {logits[0].float().tolist()}")
        launches = {name: k["fn"].launches for name, k in KERNELS.items()}
    print(f"  launches over the two batches: {launches}")
    for name, k in KERNELS.items():
        if launches[name] != 2 * k["per_forward"]:
            raise PhaseFailure(f"{name}: {launches[name]} launches, expected "
                               f"{2 * k['per_forward']}")
    with torch.no_grad():
        for bs, (xa, xb) in inputs.items():
            samples = sorted(time_ms(lambda: model(xa, xb), 5) for _ in range(3))
            ms = samples[1]
            print(f"  bs {bs}: {ms:.2f} ms per batch (median of 3 runs of 5: "
                  f"{', '.join(f'{s:.2f}' for s in samples)}), {1000 * bs / ms:.1f} "
                  f"two-view samples/s ({card})")
    return launches


def phase_kernel_times(card):
    """Per-forward time of each kernel at batch 32 (sum over its calls in
    one forward), kernel and plain version on the same inputs."""
    print(f"phase 4b: kernel times per bs-32 forward, bfloat16 ({card})")
    g = torch.Generator().manual_seed(2)
    times = {}
    with torch.no_grad():
        cases = {"vss_stage": [stage_case(g, H, d, depth, 32, torch.bfloat16)
                               for H, d, depth in STAGES],
                 "nk_scan": [shallow_case(g, 32, torch.bfloat16)] * 2,
                 "nk_scan_x": [cross_case(g, 32, torch.bfloat16)]}
        for name, group in cases.items():
            ms = sum(time_ms(lambda a=args, f=kernel: f(*a), 5) for args, kernel, _ in group)
            plain_ms = sum(time_ms(lambda a=args, f=plain: f(*a), 1) for args, _, plain in group)
            times[name] = (ms, plain_ms)
            print(f"  {name:9s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")
    return times


def phase_cpu_parity(model):
    print("phase 5: float32 logits, card vs CPU plain path, batch 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xa, xb = views(1, torch.float32, 7)
    with torch.no_grad():
        got = model(xa, xb).cpu()
        t0 = time.time()
        want = model.to("cpu")(xa.cpu(), xb.cpu())
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max()) + 1e-5
    print(f"  card {got.tolist()}  cpu {want.tolist()}  max_abs_err={err:.3e} "
          f"tol={tol:.3e} (cpu forward {time.time() - t0:.1f} s)")
    if not err <= tol:
        raise PhaseFailure("float32 logits on the card disagree with the CPU plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("phase 2: building the kernels")
    t0 = time.time()
    path, log = build.build()
    build.library()
    print(f"  {path} ({time.time() - t0:.1f} s)\n{log.strip()}")
    errors = {}
    phase_compare(errors)
    model = two_view_xfmamba("small", device="cuda", seed=0)
    launches = phase_model(model, card)
    times = phase_kernel_times(card)
    phase_cpu_parity(model)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=launches[name], max_abs_err=errors[name], ms=times[name][0],
             plain_ms=times[name][1])
        for name, k in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
