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
   batch 1: the logits must agree;
6. each training kernel against its plain version on the card, TF32 off,
   in float32 and bfloat16, every output tensor within its tolerance: the
   adjoint scan at the four stage maps, kernels 4 and 6 at every stage
   width, kernel 5 (forward and the stage backward) at every stage width at
   depth 2, all at 2 images per view, and kernel 7 (with the adjoint scan)
   at the ShallowFuse (16, 49, 1536) K=1 and Cross_SS2Dv5 (48, 49, 1536)
   K=4 N=16 geometries;
7. XFMamba-S training, batch 16, 224x224, bfloat16 activations, float32
   weights, Adam (lr 1e-4, weight decay 1e-5), seeded weights and views,
   labels 0 as ``bench.py --train``: 10 steps on one batch (the loss is
   finite at every step and lower at step 10 than at step 1) with the
   launch counts per step, then one step with ``use_checkpoint``; ms per
   step (CUDA events); then (7b) kernels 4-7 and the stage backward against
   their plain versions again, at the batch-16 shapes of the step (every
   stage at its full depth; the weight-gradient GEMMs split their rows
   there), in float32 and bfloat16, with each kernel's bfloat16 time per
   step beside its plain version's;
8. float32 gradients of one train step, card against the CPU plain path,
   XFMamba-S widths at depths (2, 2, 2, 2), batch 2 with labels 0 and 1.

The line before the last is one JSON object with the kernels' results, the
last ``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba, two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import (
    nk_scan, nk_scan_adjoint, vss_block_train, vss_stage, vss_stage_train)
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params, pack_vss_block_train_params
from xfmamba_tpu_torch.train.config import TrainConfig
from xfmamba_tpu_torch.train.loop import make_optimizer, make_train_step

IMAGE = 224
# XFMamba-S backbone stages: (H, d, depth); di = 2d, R = ceil(d / 16)
STAGES = [(56, 96, 2), (28, 192, 2), (14, 384, 15), (7, 768, 2)]
FUSION = dict(H=7, D=1536, N=16, R=48)
TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
COMPARE_BATCH = 8                      # the first batch that phase 4 runs
TRAIN_BATCH = 16
TRAIN_STEPS = 10
COMPARE_TRAIN_BATCH = 2                # images per view in phase 6
# the training kernels: per-step launches at XFMamba-S depths 2/2/15/2
TRAIN_KERNELS = {
    "vss_block_train": dict(fn=vss_block_train.vss_block_train, per_step=21,
                            source="xfmamba_tpu_torch/csrc/vss_stage.cu",
                            replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:412"),
    "vss_stage_train": dict(fn=vss_stage_train.vss_stage_train_forward, per_step=4,
                            source="xfmamba_tpu_torch/csrc/vss_stage.cu",
                            replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:658"),
    "vss_block_bwd": dict(fn=vss_block_train.vss_block_bwd, per_step=21,
                          source="xfmamba_tpu_torch/csrc/vss_block_bwd.cu",
                          replaces="xfmamba_tpu/ops/vss_block_v2_adjoint.py:128"),
    "nk_scan_bwd": dict(fn=nk_scan_adjoint.nk_scan_bwd, per_step=3,
                        source="xfmamba_tpu_torch/csrc/nk_scan_bwd.cu",
                        replaces="xfmamba_tpu/ops/nk_scan_adjoint.py:54"),
}
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


def timed_call(fn, reps=1):
    """(the last call's result, mean milliseconds per call) from CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def time_ms(fn, reps, warmup=True):
    """Mean milliseconds per call from CUDA events, after one warm-up call
    (none with ``warmup=False``, for the slow plain versions)."""
    if warmup:
        fn()
    return timed_call(fn, reps)[1]


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def rel(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-12)


def check_outputs(errors, name, label, dtype, got, want, failed):
    """Compare dicts (or sequences) of output tensors, each within TOL of
    its own largest plain magnitude."""
    items = want.items() if isinstance(want, dict) else enumerate(want)
    worst = 0.0
    for key, w in items:
        if w is None:
            continue
        err, r = rel(got[key], w)
        errors[name] = max(errors.get(name, 0.0), err)
        worst = max(worst, r)
        if not r <= TOL[dtype]:
            failed.append((name, label, str(dtype), key, r))
    print(f"  {name:15s} {label:44s} {str(dtype)[6:]:8s} worst rel={worst:.3e} "
          f"tol={TOL[dtype]:.0e} {'OK' if worst <= TOL[dtype] else 'FAIL'}")


def train_blocks(g, d, depth, dtype):
    blocks = [VSSBlock(d, generator=g).cuda() for _ in range(depth)]
    with torch.no_grad():
        return [pack_vss_block_train_params(b, dtype) for b in blocks]


def masks(g, *shape):
    return ((torch.rand(*shape, generator=g) < 0.7).float() / 0.7).cuda()


def adjoint_scan_case(g, n, H, d, dtype):
    """The stage maps' rank-form adjoint: K=4 cross2d, N=1, D=2d, R=ceil(d/16)."""
    D, R, L = 2 * d, -(-d // 16), H * H
    return dict(u=randn(g, n, L, D, dtype=dtype), Bs=randn(g, n, L, 4, 1, dtype=dtype),
                Cs=randn(g, n, L, 4, 1, dtype=dtype),
                A=-torch.ones(4, 1, D, device="cuda"), bias=randn(g, 4, D, scale=0.5) - 4.0,
                Dsum=randn(g, D), kinds=nk_scan.CROSS2D_KINDS, H=H, W=H,
                ranks=randn(g, n, L, 4, R, dtype=dtype), w_dt=randn(g, 4, R, D, scale=R ** -0.5),
                gy=randn(g, n, L, D))


def block_grads(result):
    """`vss_block_bwd`'s (dx, gradients) as one dict."""
    dx, grads = result
    return dict(grads, dx=dx)


def stage_grads(result):
    """`stage_train_backward`'s (dx, per-block gradients) as one dict."""
    dx, grads = result
    return {f"{j}.{k}": v for j, gj in enumerate(grads) for k, v in gj.items()} | {"dx": dx}


def nk_bwd_case(g, n, K, dtype):
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, n, K, dtype)
    dts = randn(g, *u.shape[:2], K * u.shape[2], dtype=dtype, scale=0.5)
    H = FUSION["H"]
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    return (u, dts, Bs, Cs, A, Dvec, bias, randn(g, *u.shape, dtype=dtype), H, H, kinds)


def phase_compare_train(errors):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = 2 * COMPARE_TRAIN_BATCH
    print(f"phase 6: training kernels vs plain versions on the card, {COMPARE_TRAIN_BATCH} "
          "images per view, TF32 off; tolerance relative to each output's largest magnitude")
    g = torch.Generator().manual_seed(3)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            for H, d, _ in STAGES:
                geo = f"H={H} d={d}"
                args = adjoint_scan_case(g, n, H, d, dtype)
                check_outputs(errors, "vss_block_bwd", f"adjoint scan {geo} K=4 N=1", dtype,
                              nk_scan.selective_scan_bwd_cuda(**args),
                              nk_scan.selective_scan_bwd_plain(**args), failed)
                (p,) = train_blocks(g, d, 1, dtype)
                x, m1 = randn(g, n, H * H, d, dtype=dtype), masks(g, n)
                check_outputs(errors, "vss_block_train", f"block forward {geo}", dtype,
                              [vss_block_train.vss_block_train(x, p, H, H, m1)],
                              [vss_block_train.vss_block_train_plain(x, p, H, H, m1)], failed)
                gy = randn(g, n, H * H, d)
                check_outputs(errors, "vss_block_bwd", f"block backward {geo}", dtype,
                              block_grads(vss_block_train.vss_block_bwd(x, p, H, H, m1, gy)),
                              block_grads(vss_block_train.vss_block_bwd_plain(x, p, H, H, m1, gy)),
                              failed)
                ps = train_blocks(g, d, 2, dtype)
                m1, m2 = masks(g, 2, n), masks(g, 2, n)
                got = vss_stage_train.vss_stage_train_forward(x, ps, H, H, m1, m2)
                want = vss_stage_train.vss_stage_train_forward_plain(x, ps, H, H, m1, m2)
                check_outputs(errors, "vss_stage_train", f"stage forward {geo} depth 2", dtype,
                              got, want, failed)
                gy = randn(g, n, H * H, d, dtype=dtype)
                check_outputs(errors, "vss_stage_train", f"stage backward {geo} depth 2", dtype,
                              *(stage_grads(vss_stage_train.stage_train_backward(
                                  gy, *got[1:], ps, H, H, m1, m2, block_bwd=bwd))
                                for bwd in (vss_block_train.vss_block_bwd,
                                            vss_block_train.vss_block_bwd_plain)), failed)
            for K, label, bs in ((1, "ShallowFuse (16,49,1536) K=1 N=16", TRAIN_BATCH),
                                 (4, "Cross_SS2Dv5 (48,49,1536) K=4 N=16", 3 * TRAIN_BATCH)):
                args = nk_bwd_case(g, bs, K, dtype)
                check_outputs(errors, "nk_scan_bwd", label, dtype,
                              nk_scan_adjoint.nk_scan_bwd(*args),
                              nk_scan_adjoint.nk_scan_bwd_plain(*args), failed)
        torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"training kernels disagree with their plain versions: {failed}")


def train_batch(dtype):
    g = torch.Generator().manual_seed(16)
    xa, xb = (torch.randn(TRAIN_BATCH, IMAGE, IMAGE, 1, generator=g).to("cuda", dtype)
              for _ in range(2))
    return {"image1": xa, "image2": xb,
            "label": torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")}


def reset_counts():
    for k in list(TRAIN_KERNELS.values()) + [KERNELS["nk_scan"]]:
        k["fn"].launches = 0


def read_counts():
    return {name: k["fn"].launches for name, k in TRAIN_KERNELS.items()} | {
        "nk_scan": KERNELS["nk_scan"]["fn"].launches}


def timed_steps(step, batch, runs=3, steps=3):
    samples = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step(batch)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / steps)
    return sorted(samples)


def phase_train(card):
    print(f"phase 7: XFMamba-S training, batch {TRAIN_BATCH}, {IMAGE}x{IMAGE}, bfloat16 "
          f"activations, float32 weights, Adam lr 1e-4 wd 1e-5 ({card})")
    model = two_view_xfmamba("small", device="cuda", seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, multilabel=False)
    batch = train_batch(torch.bfloat16)
    reset_counts()
    losses, per_step = [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    launches = read_counts()
    print(f"  losses: {', '.join(f'{v:.6f}' for v in losses)}")
    print(f"  launches over the {TRAIN_STEPS} steps: {launches}")
    want = {name: k["per_step"] for name, k in TRAIN_KERNELS.items()} | {"nk_scan": 3}
    want["vss_block_train"] = 0
    bad = [(i, c) for i, c in enumerate(per_step) if c != want]
    if bad:
        raise PhaseFailure(f"training launches per step {bad[:2]}, expected {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise PhaseFailure(f"training loss not finite or not falling: {losses}")
    torch.cuda.reset_peak_memory_stats()
    samples = timed_steps(step, batch)
    print(f"  {samples[1]:.2f} ms per step (median of 3 runs of 3 steps: "
          f"{', '.join(f'{v:.2f}' for v in samples)}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    model.mamba_feature_extrac.use_checkpoint = True
    reset_counts()
    step(batch)
    torch.cuda.synchronize()
    ck = read_counts()
    print(f"  use_checkpoint step launches: {ck}")
    if (ck["vss_block_train"], ck["vss_block_bwd"], ck["vss_stage_train"]) != (21, 21, 0):
        raise PhaseFailure(f"use_checkpoint launches {ck}, expected vss_block_train 21, "
                           "vss_block_bwd 21")
    ck_samples = timed_steps(step, batch)
    print(f"  use_checkpoint: {ck_samples[1]:.2f} ms per step (median of 3 runs of 3 steps: "
          f"{', '.join(f'{v:.2f}' for v in ck_samples)})")
    return {name: ck[name] if name == "vss_block_train" else launches[name]
            for name in TRAIN_KERNELS}


def phase_train_kernel_times(card, errors):
    """Each training kernel and the stage backward against its plain
    version at the batch-16 shapes of a step, float32 and bfloat16, every
    output tensor within its tolerance; and each kernel's bfloat16 time per
    step (sum over its calls in one step; a block at a stage's shape timed
    once and counted depth times), kernel and plain version on the same
    inputs."""
    print(f"phase 7b: training kernels vs plain versions at the bs-{TRAIN_BATCH} step's shapes, "
          f"TF32 off; bfloat16 times per step ({card})")
    g = torch.Generator().manual_seed(4)
    n = 2 * TRAIN_BATCH
    times = {name: [0.0, 0.0] for name in TRAIN_KERNELS}
    failed = []

    def run(name, label, fn, plain, count=1):
        fn()                                               # warm-up
        got, ms = timed_call(fn, 3)
        want, plain_ms = timed_call(plain)
        check_outputs(errors, name, label, dtype, got, want, failed)
        if dtype == torch.bfloat16:
            times[name][0] += count * ms
            times[name][1] += count * plain_ms
        return got

    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            for H, d, depth in STAGES:
                geo = f"H={H} d={d}"
                (p,) = train_blocks(g, d, 1, dtype)
                x, m1 = randn(g, n, H * H, d, dtype=dtype), masks(g, n)
                gy = randn(g, n, H * H, d)
                run("vss_block_train", f"block forward {geo}",
                    lambda: [vss_block_train.vss_block_train(x, p, H, H, m1)],
                    lambda: [vss_block_train.vss_block_train_plain(x, p, H, H, m1)], depth)
                run("vss_block_bwd", f"block backward {geo}",
                    lambda: block_grads(vss_block_train.vss_block_bwd(x, p, H, H, m1, gy)),
                    lambda: block_grads(vss_block_train.vss_block_bwd_plain(x, p, H, H, m1, gy)),
                    depth)
                ps = train_blocks(g, d, depth, dtype)
                m1s, m2s = masks(g, depth, n), masks(g, depth, n)
                _, xs, mids = run(
                    "vss_stage_train", f"stage forward {geo} depth {depth}",
                    lambda: vss_stage_train.vss_stage_train_forward(x, ps, H, H, m1s, m2s),
                    lambda: vss_stage_train.vss_stage_train_forward_plain(x, ps, H, H, m1s, m2s))
                gy = randn(g, n, H * H, d, dtype=dtype)
                got, want = (stage_grads(vss_stage_train.stage_train_backward(
                    gy, xs, mids, ps, H, H, m1s, m2s, block_bwd=bwd))
                    for bwd in (vss_block_train.vss_block_bwd, vss_block_train.vss_block_bwd_plain))
                check_outputs(errors, "vss_stage_train", f"stage backward {geo} depth {depth}",
                              dtype, got, want, failed)
            for K, bs, count in ((1, TRAIN_BATCH, 2), (4, 3 * TRAIN_BATCH, 1)):
                args = nk_bwd_case(g, bs, K, dtype)
                run("nk_scan_bwd", f"fusion adjoint ({bs},49,1536) K={K} N=16",
                    lambda: nk_scan_adjoint.nk_scan_bwd(*args),
                    lambda: nk_scan_adjoint.nk_scan_bwd_plain(*args), count)
    for name, (ms, plain_ms) in times.items():
        print(f"  {name:15s} kernel {ms:10.3f} ms   plain {plain_ms:10.3f} ms")
    if failed:
        raise PhaseFailure(f"training kernels disagree with their plain versions: {failed}")
    return times


def phase_train_cpu_parity():
    print("phase 8: float32 gradients of one train step, card vs CPU plain path, "
          "XFMamba-S widths at depths (2, 2, 2, 2), batch 2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(model_type="small", hidden_dim=768, drop_path_rate=0.0,
              backbone_overrides=dict(depths=(2, 2, 2, 2), drop_path_rate=0.0))
    model = TwoViewXFMamba(generator=torch.Generator().manual_seed(5), **kw).train()
    g = torch.Generator().manual_seed(6)
    xa, xb = (torch.randn(2, IMAGE, IMAGE, 1, generator=g) for _ in range(2))
    label = torch.tensor([0, 1])
    t0 = time.time()
    loss = torch.nn.functional.cross_entropy(model(xa, xb), label)
    loss.backward()
    loss = loss.detach()
    want = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    cpu_s = time.time() - t0
    model.zero_grad()
    model.cuda()
    loss_c = torch.nn.functional.cross_entropy(model(xa.cuda(), xb.cuda()), label.cuda())
    loss_c.backward()
    loss_c = loss_c.detach()
    # Batch 2: at batch 1 the BatchNorm ahead of ShallowFuse would remove
    # the per-sample mean that its squeeze-excitation averages, leaving
    # those weight gradients at rounding noise.  Each gradient is held to
    # 1e-3 of its own largest magnitude.
    worst, worst_key = 0.0, None
    for k, p in model.named_parameters():
        if k in want:
            _, r = rel(p.grad.cpu(), want[k])
            if r > worst:
                worst, worst_key = r, k
    print(f"  loss card {float(loss_c):.7f} cpu {float(loss):.7f}; {len(want)} gradients, "
          f"worst relative error {worst:.3e} ({worst_key}), tol 1e-03 "
          f"(cpu step {cpu_s:.1f} s)")
    if not (worst <= 1e-3 and abs(float(loss_c) - float(loss)) <= 1e-4):
        raise PhaseFailure("float32 gradients on the card disagree with the CPU plain path")


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
    del model
    phase_compare_train(errors)
    launches |= phase_train(card)
    times |= phase_train_kernel_times(card, errors)
    phase_train_cpu_parity()
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=launches[name], max_abs_err=errors[name], ms=times[name][0],
             plain_ms=times[name][1])
        for name, k in (KERNELS | TRAIN_KERNELS).items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
