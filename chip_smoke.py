#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xfmamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``xfmamba_tpu_torch/csrc`` (nvcc, sm_90a),
   printing ``-Xptxas -v``;
3. each ported kernel against its plain PyTorch version on the card, at the
   shapes the batch-8 forward of XFMamba-S gives it (every backbone stage
   at its full depth, the ShallowFuse and the Cross_SS2Dv5 scans, kernel 11
   (y and the checkpoints) at the four stage maps), in float32 and
   bfloat16, and at XFMamba-B's (kernels 2, 3 and 11; fusion D 2048, dt
   rank up to 64) in float32 and, for its bfloat16 path's kernels 1 (depth 2
   per stage), 2 and 3, in bfloat16, TF32 off; (3b) kernels 13 and 14 (the grouped scan and its
   adjoint, ``csrc/grouped_scan_lanes.cu``, every output, bitwise over two
   runs) at the XFMamba-B Cross_SS2Dv5 direction (48, 49, 2048) K=1, the
   XFMamba-S bs-12 ShallowFuse call (12, 49, 2 x 1536) K=2 and a 56 x 56
   map (2, L, 4 x 192) K=4 at L 3136 and 3127 (a ragged chunk), N=16,
   forward and reverse, float32 and bfloat16, with their float32 times per
   XFMamba-B step, and device times by graph replay per XFMamba-B step and
   per bs-12 ShallowFuse call beside their first design
   (``grouped_scan_*_v1``) in turns, the bound and the exponentials' SFU
   time; (3d) kernels 2 and 3
   (``csrc/nk_scan_fused.cu``; 3 holds them bitwise over two runs too) at
   every fusion geometry of XFMamba-S and -B in both dtypes (ShallowFuse's
   K=1 and Cross_SS2Dv5's rank-form calls at bs 8 and 32, the bs-16 step's
   K=4 dts-form call): against their plain versions, bitwise over two
   runs, and against their first design (the serial scan of
   ``csrc/nk_scan.cu``, swapped in by `first_design_fusion_scans`) in
   turns, by CUDA events and graph replay, beside the bound, the bound
   with every product on the CUDA cores, the exponentials' time on the
   special-function units, the blocks an SM holds and the plan;
4. XFMamba-S two-view 224x224 inference in bfloat16 with seeded weights,
   through ``two_view_xfmamba(...)(x_a, x_b)``: one batch of 8 and one of 32
   with the launch counts reset before and read after, then timings (CUDA
   events) per batch, the bs-32 forward with the fusion scans on their
   first design and redesigned in turns (also in 4c, 7 and 7c), and (4b)
   per kernel beside the plain versions and the kernels' bounds (kernels
   2 and 3 also beside their exponentials' SFU time); (4c) the same in
   float32, the composable blocks
   with kernel 11 (21 launches per forward, no stage kernel); (4d) kernel
   11 per float32 bs-32 forward against its plain twin (y, checkpoints),
   then against its first design (``ss2d_core_n1_fwd_v1``) in turns, and,
   at the maps whose forward is one cluster launch (14 x 14, 7 x 7),
   against the same kernels as three launches (bit for bit, and in turns),
   by CUDA events and CUDA-graph replay, per stage and per forward, beside the
   plain twin, the serial rank-form scan of ``csrc/nk_scan.cu`` on the same
   inputs and the bound by both counts (rank products on the tensor cores,
   and every product on the CUDA cores); phase 4 also times each batch
   with the block operands kept (``pack_for_inference``);
   (4e) XFMamba-B float32 inference at bs 8 and 32 (dims 128-1024, d_inner
   2048, dt rank 64): launches 21 / 0 / 2 / 1 / 0 of kernel 11, the stage
   kernel, kernels 2 and 3 and kernel 13 per forward, ms per batch;
5. the model in float32 (kernel 11), on the card and on the CPU (plain
   twins), at batch 1: the logits must agree, and the launches be kernel
   11 21 and kernel 9 3 (at one study no fusion scan has an aligned image
   group);
6. each training kernel against its plain version on the card, TF32 off,
   every output tensor within its tolerance: in float32 and bfloat16 at
   XFMamba-S's widths, and in bfloat16 at XFMamba-B's (dims 128-1024, dt
   rank 8-64), the adjoint scan at the four stage maps, kernels 4
   and 6 at every stage width, kernel 5 (forward and the stage backward)
   at every stage width at depth 2, all at 2 images per view; then, for
   both models in both dtypes, kernels 2 and 7 at the bs-16 step's
   ShallowFuse (16, 49, D) K=1 and Cross_SS2Dv5 (48, 49, D) K=4 N=16
   geometries (kernel 7 against its segment-checkpoint twin and the serial
   plain adjoint, every output, and bitwise equal over two runs), and
   kernels 11 and 12 at the four stage maps at the step's 16 images per
   view (XFMamba-B in float32), kernel 12 bitwise equal over two runs and
   launching no GEMM, the stage adjoint likewise at 16 images per view,
   with kernels 11 and 12's float32 times per step against their first
   design (and kernel 11's three-launch route) in turns (CUDA events and
   graph replay) and the nk pair's times
   per call, kernel 7 beside its old design
   (the serial adjoint of ``csrc/nk_scan_bwd.cu``) in turns, by CUDA
   events and CUDA-graph replay, per call and per XFMamba-S step
   (XFMamba-B's K=4 call beside kernels 13 + 14, the route its
   Cross_SS2Dv5 takes);
7. XFMamba-S training, batch 16, 224x224, bfloat16 activations, float32
   weights, Adam (lr 1e-4, weight decay 1e-5), seeded weights and views,
   labels 0 as ``bench.py --train``: 10 steps on one batch (the loss is
   finite at every step and lower at step 10 than at step 1) with the
   launch counts per step, then one step with ``use_checkpoint``; ms per
   step (CUDA events); then (7b) kernels 4-7 and the stage backward against
   their plain versions again, at the batch-16 shapes of the step (every
   stage at its full depth; the weight-gradient GEMMs split their rows
   there), in float32 and bfloat16, with each kernel's bfloat16 time per
   step beside its plain version's; (7c) training in float32 (the
   composable blocks, kernels 11 and 12, 21 launches each per step, 42 of
   kernel 11 with ``use_checkpoint``; kernels 2 and 7 3 each, the stage
   kernels and the GEMM kernels none; counts reset before each step): a
   finite loss at every
   step, ms per step and peak memory in both ``use_checkpoint`` modes; (7d)
   the same for XFMamba-B, whose Cross_SS2Dv5 scan trains through kernels
   13 and 14 (4 launches each per step; kernels 2 and 7 twice, for
   ShallowFuse), with the step on their first design and redesigned in
   turns, wall and device ms; (7e) the bfloat16 block sequence on the serial pieces
   (``vss_stage.SERIAL_OPS``: SIMT GEMMs, serial scans), on the first chunked design's (the
   first chunked scans, ``cross2d_scan_v1``, with the 8 rank GEMMs) and on
   the new one (``CUDA_OPS``: the tile-parallel scans, the rank gradients
   inside the adjoint) on the same inputs, in turns, device time by
   CUDA-graph replay: kernel 1 per bs-32 forward, kernels 4, 5 and 6 per
   bs-16 step, and the GEMMs, the scan and the adjoint alone; (7f)
   torch.profiler by kernel name over the bs-16 bfloat16 step, the bs-32
   bfloat16 forward and the float32 bs-16 step, with the busy share, and
   kernels 11 and 12 alone at that step's shapes.
   Phases 4 and 7 also count the pieces' routes per forward and step
   (tensor-core vs SIMT GEMM launches, the chunked scans by chunk count,
   the serial scans) and fail unless every bfloat16 stage GEMM takes the
   tensor cores (168 launches fewer per step than the first design: the rank
   gradients are the adjoint's own) and every stage scan and adjoint the
   tile-parallel kernels;
8. float32 gradients of one train step (kernels 11 and 12; both fusion
   scans through kernels 13 and 14 at this batch, 5 launches each), card
   against the CPU plain twins, XFMamba-S widths at depths (2, 2, 2, 2),
   batch 2 with labels 0 and 1; (8b) the same for XFMamba-B, after its
   batch-1 logits as in phase 5; (8c) an SS2D layer with d_state 16 at 56 x 56, batch 2,
   forward and backward (kernels 13 and 14 through ``core_dispatch``);
9. the Mamba-2 (m0 / SSD) classifiers: kernels 15 (inference, and with
   the chunk checkpoints) and 16 against their plain twins at the four
   stage geometries of vmamba_small_m2 and vmamba_base_m2 (L 3136-49, 24-256
   heads of width 16, d_state 64), batch 8, float32 and bfloat16, and each
   of their three passes (chunk states, state pass, chunk scan or chunk
   gradients) against its plain pass; then the chunk-parallel kernels
   against the serial ones they replaced (``ssd_fwd_serial`` /
   ``ssd_bwd_serial``), in turns, device time by CUDA-graph replay and
   CUDA events: float32 per bs-32 forward, with checkpoints and kernel 16
   per bs-16 step, bfloat16 per bs-32 forward, per stage and in sum, with
   the passes' times, the plain twins' and the bounds (tensor-core
   products, and every product on the CUDA cores);
   (9b) vmamba_small_m2 224x224 float32 inference at bs 8 and 32 (18
   launches of kernel 15 per forward, 18 of each of its passes, no other
   kernel), ms per batch, and a bs-8 bfloat16 forward on the same route
   (no stage kernel); (9c) its float32 training at bs 16 (18 + 18
   launches per step, the passes 36 / 36 / 18 / 18; 36 + 18 with
   ``use_checkpoint``), ms per step and peak memory; (9d) its widths at
   depths (2, 2, 2, 2), batch 2: logits and one step's gradients, card
   against the CPU plain twins; (9e) the SSD scan past the kernels' limits
   (d_state 128, head width 64: two width slices x two d_state tiles),
   kernels 15/16 against the untiled plain twins, and an m0 SS2D layer of
   that geometry, forward and backward, card against the CPU.

Single-study and unaligned-batch inference (kernels 8, 9 and 10):
3c. kernel 8 (the v1 whole block, one cooperative launch of
   ``csrc/vss_block_v1.cu``) against its plain twin at every stage map of
   XFMamba-S and XFMamba-B, 2 and 4 images, both dtypes, and one device
   launch per block (torch.profiler); per bs-1 bfloat16 XFMamba-S forward
   (15 blocks at 14 x 14, 2 at 7 x 7, 2 images) the old launch sequence
   (``vss_block_v1.vss_block_v1_sequence``) and the kernel in turns, by CUDA
   events and by CUDA-graph replay, with the kernel's phase times (its
   global-timer stamps); kernels 9 (the v1 nk scan) at ShallowFuse's (1,
   49, D) K=1 and Cross_SS2Dv5's (3, 49, D) K=4 N=16 shapes in both dtypes,
   and 10 (the cross2d core from projections) at the four stage maps for 2
   images, N=1 in both dtypes, and N=16, each against its plain twin, TF32
   off; with ms, plain ms and bound per forward (kernels 8 and 9 per bs-1
   bfloat16 forward) or step (kernel 10 at phase 8d's layer), kernel 9
   beside kernel 2 on the same inputs;
4f. XFMamba-S bfloat16 inference at 1 and 2 studies per batch: launches
   per forward (vss_stage 2 / 3, kernel 8 17 / 2, kernel 9 3 / 3, kernels
   2 and 3 none), ms per forward, and the device's busy share of a bs-1
   forward (torch.profiler); float32 at 1 study (kernel 11 21, kernel 9 3);
   XFMamba-B bfloat16 at 1 and 32 studies; the models keep their block
   operands (``pack_for_inference``), and the bs-1 bfloat16 forward is also
   timed packing them at every forward, the default;
5b. XFMamba-S widths at depths (2, 2, 2, 2), 1 study, the bfloat16 route's
   kernels in float32 (kernel 1 at stages 0-1, kernel 8 at stages 2-3,
   kernel 9): logits card against the CPU plain twins;
8d. a Cross_SS2Dv5 layer with d_state 1 (XFMamba-S's width, 7 x 7, 2
   studies) in training, forward and backward: kernel 10 through
   ``core_dispatch`` on the card against the CPU plain twins.

The ablation kernels behind JAX's switches (kernels 17-21):
10. kernels 17 (the v4 nk scan) and 18 (v3) against their plain twins and
   against kernel 2 on the same inputs at XFMamba-S's ShallowFuse (32, 49,
   1536) K=1 and Cross_SS2Dv5 training (48, 49, 1536) K=4 shapes and
   XFMamba-B's ShallowFuse (16, 49, 2048), N 16, both dtypes, with ms per
   call beside kernel 2 and the plain twins;
10b. XFMamba-S with ``FUSED_V4``, then ``FUSED_V3``, on against both off:
   bfloat16 inference at bs 32 (2 launches of the switched kernel per
   forward, none of kernel 2; logits within 5e-2 of the largest) and one
   float32 training step at bs 16 from the same weights and drop-path
   draws (3 launches, none of kernel 2; the loss within 1e-4 relative), ms
   per forward and per step; the switches are restored whatever happens;
10c. kernels 19 (LayerNorm + GELU, a warp per pixel), 20 (segment-packed)
   and 21 (its backward) against their plain twins at the patch-embed and
   downsample geometries of a bs-64 two-view batch (128 x 112 x 112 x 48
   with GELU, 128 x 56 x 56 x 96, 128 x 28 x 28 x 192) and a ragged pixel
   count, both dtypes, timed in bfloat16 beside ``F.layer_norm`` (+
   ``F.gelu``: two calls) and its autograd backward; then XFMamba-S's patch
   embed at bs 64 two-view built from ``PatchEmbedV2``'s weights as the JAX
   A/B script builds it (conv1, LayerNorm + GELU, conv2, LayerNorm), once on
   kernel 19 (forward) and once on kernels 20 / 21 (forward and backward),
   against the module's own forward and gradients, bfloat16, 5e-2.

The line before the last but one is one JSON object with the kernels'
results (launches per main-path forward or step, errors, times, bounds;
for kernels 1 and 4-6 also their route counts and phase 7e's device times
of the serial sequence and the new one; for kernels 15 and 16 their
passes' launches and device times, the serial kernels' times and the
bound with every product on the CUDA cores; for kernel 8 the old
sequence's times, device times, its grid and phase times (3c); for kernel
7 the float32 per-step times of it and the serial adjoint (6); for
kernels 11 and 12 their first design's times in the same run, device
times, the bound with every product on the CUDA cores, the bfloat16 stage
scans' device times old and new (7e), XFMamba-B's step (6); for kernels 2
and 3 per bs-32 bfloat16 forward their first design's times and device
times, the SFU time, the blocks an SM holds and every geometry's device
times (3d); for kernels 13 and 14 per XFMamba-B step their device times and
their first design's, the SFU time, and the bs-12 ShallowFuse call's (3b)),
the line before the last the card's name and power limit, the last
``{"ok": true, "device": {...}}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba, two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import VSSBlock, vmamba_small_m2
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.fusion import CrossSS2Dv5
from xfmamba_tpu_torch.ops import (
    cross2d_scan, fused_cross_scan, nk_scan, nk_scan_adjoint, nk_scan_v1, primitives,
    selective_scan_grouped, ss2d_core_n1, ssd_chunk, vss_block_train, vss_block_v1, vss_stage,
    vss_stage_train)
from xfmamba_tpu_torch.ops.ablations import nk_scan_v4, nk_scan_wide, pe_fused, seg_ln
from xfmamba_tpu_torch.ops.vss_block import (
    mlp_half, pack_vss_block_params, pack_vss_block_train_params, ss2d_half, ss2d_half_fwd,
    vss_block_body)
from xfmamba_tpu_torch.models.vssm import PatchEmbedV2
from xfmamba_tpu_torch.train.profile import (
    STAGES, _device_us, n1_calls_fn, print_profile, profile_calls, train_step_fn)
from xfmamba_tpu_torch.train.config import TrainConfig
from xfmamba_tpu_torch.train.loop import make_optimizer, make_train_step

IMAGE = 224
# each model's fusion scans: D = 2 x hidden, R = ceil(hidden / 16)
FUSION = {"small": dict(H=7, D=1536, N=16, R=48), "base": dict(H=7, D=2048, N=16, R=64)}
MODEL_NAME = {"small": "XFMamba-S", "base": "XFMamba-B"}
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
                        source="xfmamba_tpu_torch/csrc/nk_scan_adjoint.cu",
                        replaces="xfmamba_tpu/ops/nk_scan_adjoint.py:54"),
}
KERNELS = {
    "vss_stage": dict(fn=vss_stage.vss_stage, per_forward=4,
                      source="xfmamba_tpu_torch/csrc/vss_stage.cu",
                      replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:542"),
    "nk_scan": dict(fn=nk_scan.nk_scan, per_forward=2,
                    source="xfmamba_tpu_torch/csrc/nk_scan_fused.cu",
                    replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:890"),
    "nk_scan_x": dict(fn=nk_scan.nk_scan_x, per_forward=1,
                      source="xfmamba_tpu_torch/csrc/nk_scan_fused.cu",
                      replaces="xfmamba_tpu/ops/vss_block_pallas_v2.py:944"),
}


# the float32 path's kernels: 21 launches each per forward / step at depths 2/2/15/2
N1_KERNELS = {
    "ss2d_core_n1_fwd": dict(fn=ss2d_core_n1.ss2d_core_n1_fwd,
                             source="xfmamba_tpu_torch/csrc/ss2d_core_n1.cu",
                             replaces="xfmamba_tpu/ops/selective_scan_pallas.py:298"),
    "ss2d_core_n1_bwd": dict(fn=ss2d_core_n1.ss2d_core_n1_bwd,
                             source="xfmamba_tpu_torch/csrc/ss2d_core_n1.cu",
                             replaces="xfmamba_tpu/ops/selective_scan_pallas.py:440"),
}
F32_TRAIN_STEPS = 3
# kernels 13 and 14, the grouped scan and its adjoint: 4 launches each per
# XFMamba-B float32 step (Cross_SS2Dv5's four cross2d directions)
GROUPED_KERNELS = {
    "selective_scan_grouped_fwd": dict(
        fn=selective_scan_grouped.grouped_scan_fwd,
        source="xfmamba_tpu_torch/csrc/grouped_scan_lanes.cu",
        replaces="xfmamba_tpu/ops/selective_scan_pallas.py:838"),
    "selective_scan_grouped_bwd": dict(
        fn=selective_scan_grouped.grouped_scan_bwd,
        source="xfmamba_tpu_torch/csrc/grouped_scan_lanes.cu",
        replaces="xfmamba_tpu/ops/selective_scan_pallas.py:979"),
}
# (B, L, K, C, N, label): the grouped scan's geometries; the first is the
# XFMamba-B step's (timed), the last two a 56 x 56 map, exact and ragged in
# the kernel's chunk of 32
GROUPED_CASES = [
    (48, 49, 1, 2048, 16, "XFMamba-B Cross_SS2Dv5 direction, bs 16"),
    (12, 49, 2, 1536, 16, "XFMamba-S ShallowFuse, bs 12"),
    (2, 3136, 4, 192, 16, "56x56 map, 98 chunks"),
    (2, 3127, 4, 192, 16, "ragged last chunk"),
]
# the float32 launches per forward (inference) and per step (training) of
# each model at full depth; the step with use_checkpoint runs kernel 11 42 times
F32_FORWARD = {"ss2d_core_n1_fwd": 21, "vss_stage": 0, "nk_scan": 2, "nk_scan_x": 1,
               "selective_scan_grouped_fwd": 0}
F32_STEP = {
    "small": {"ss2d_core_n1_fwd": 21, "ss2d_core_n1_bwd": 21, "nk_scan": 3, "nk_scan_bwd": 3},
    "base": {"ss2d_core_n1_fwd": 21, "ss2d_core_n1_bwd": 21, "nk_scan": 2, "nk_scan_bwd": 2,
             "selective_scan_grouped_fwd": 4, "selective_scan_grouped_bwd": 4},
}

# kernels 15 and 16, the chunked SSD scan and its adjoint: the m2 classifiers'
# SS2D (18 launches per vmamba_small_m2 forward, 18 + 18 per step)
SSD_KERNELS = {
    "ssd_chunk_fwd": dict(fn=ssd_chunk.ssd_fwd, source="xfmamba_tpu_torch/csrc/ssd_chunk.cu",
                          replaces="xfmamba_tpu/ops/ssd_pallas.py:74"),
    "ssd_chunk_bwd": dict(fn=ssd_chunk.ssd_bwd, source="xfmamba_tpu_torch/csrc/ssd_chunk.cu",
                          replaces="xfmamba_tpu/ops/ssd_pallas.py:356"),
}
# each m2 model's stages: (H, d, depth); d_inner = d, R = ceil(d / 16) heads
# of width 16 per direction, d_state 64
M2_STAGES = {"small": [(56, 96, 2), (28, 192, 2), (14, 384, 12), (7, 768, 2)],
             "base": [(56, 128, 2), (28, 256, 2), (14, 512, 12), (7, 1024, 2)]}
M2_NAME = {"small": "vmamba_small_m2", "base": "vmamba_base_m2"}
M2_BLOCKS = 18
# the kernel launches of kernels 15 and 16's passes (ssd_chunk.PASSES) per
# forward and per step (kernel 15 with checkpoints and kernel 16 per block)
M2_FORWARD_PASSES = {"states": M2_BLOCKS, "state_pass": M2_BLOCKS, "scan": M2_BLOCKS, "grads": 0}
M2_STEP_PASSES = {"states": 2 * M2_BLOCKS, "state_pass": 2 * M2_BLOCKS, "scan": M2_BLOCKS,
                  "grads": M2_BLOCKS}
M2_TRAIN_STEPS = 3

# kernels 8, 9 and 10: single-study and unaligned-batch inference (the v1
# whole block and nk scan, two-level scans along L) and the cross2d core
# from projections (d_state-1 Cross_SS2Dv5 training through core_dispatch)
V1_KERNELS = {
    "vss_block_v1": dict(fn=vss_block_v1.vss_block_v1,
                         source="xfmamba_tpu_torch/csrc/vss_block_v1.cu",
                         replaces="xfmamba_tpu/ops/vss_block_pallas.py:295"),
    "nk_scan_v1": dict(fn=nk_scan_v1.nk_scan_v1, source="xfmamba_tpu_torch/csrc/scan_two_level.cu",
                       replaces="xfmamba_tpu/ops/vss_block_pallas.py:690"),
    "fused_cross_scan": dict(fn=fused_cross_scan.fused_cross_scan,
                             source="xfmamba_tpu_torch/csrc/scan_two_level.cu",
                             replaces="xfmamba_tpu/ops/selective_scan_pallas.py:73"),
}
# bfloat16 launches per forward at 1 and 2 studies (XFMamba-S; XFMamba-B at
# 1 study the same), every kernel not named 0
ONE_STUDY = {1: {"vss_stage": 2, "vss_block_v1": 17, "nk_scan_v1": 3},
             2: {"vss_stage": 3, "vss_block_v1": 2, "nk_scan_v1": 3}}
F32_ONE_STUDY = {"ss2d_core_n1_fwd": 21, "nk_scan_v1": 3}
# phase 8d's layer: Cross_SS2Dv5 at XFMamba-S's width, 7 x 7, 2 studies (3 x 2 streams)
CROSS_N1 = dict(views=2, H=7, d=768)

# kernels 17-21, the ablations behind JAX's switches: the v4 and v3 schedules
# of the nk scan (FUSED_V4 / FUSED_V3, launches per bs-32 bfloat16 XFMamba-S
# forward with the switch on) and the patch embed's LayerNorm(+GELU)
# (launches per bs-64 two-view patch embed built on them)
ABLATION_KERNELS = {
    "nk_scan_v4": dict(fn=nk_scan_v4.nk_scan_v4,
                       source="xfmamba_tpu_torch/csrc/nk_scan_ablations.cu",
                       replaces="xfmamba_tpu/ops/ablations/nk_scan_v4.py:50"),
    "nk_scan_v3": dict(fn=nk_scan_wide.nk_scan_v3,
                       source="xfmamba_tpu_torch/csrc/nk_scan_ablations.cu",
                       replaces="xfmamba_tpu/ops/ablations/nk_scan_wide.py:40"),
    "ln_act_fused": dict(fn=pe_fused.ln_act_fused, source="xfmamba_tpu_torch/csrc/ln_act.cu",
                         replaces="xfmamba_tpu/ops/ablations/pe_fused.py:46"),
    "seg_ln_fwd": dict(fn=seg_ln.seg_ln_fwd, source="xfmamba_tpu_torch/csrc/ln_act.cu",
                       replaces="xfmamba_tpu/ops/ablations/seg_ln.py:101"),
    "seg_ln_bwd": dict(fn=seg_ln.seg_ln_bwd, source="xfmamba_tpu_torch/csrc/ln_act.cu",
                       replaces="xfmamba_tpu/ops/ablations/seg_ln.py:110"),
}
# phase 10's fusion-scan shapes: (model, images, K, label)
NK_ABLATION_CASES = [("small", 32, 1, "XFMamba-S ShallowFuse bs 32"),
                     ("small", 48, 4, "XFMamba-S Cross_SS2Dv5 bs-16 step"),
                     ("base", 16, 1, "XFMamba-B ShallowFuse bs 16")]
# the switches of phase 10b: route -> (module, flag, kernel)
NK_SWITCHES = {"v4": (nk_scan_v4, "FUSED_V4", "nk_scan_v4"),
               "v3": (nk_scan, "FUSED_V3", "nk_scan_v3")}
# phase 10c: (pixels, C, GELU) of scripts/ab_seg_ln.py (128 backbone images,
# bs 64 two-view; the first two are the patch embed's norms), then a pixel
# count that fills no whole block of kernel 21
PE_IMAGES = 128
LN_CASES = [((PE_IMAGES, 112, 112), 48, True), ((PE_IMAGES, 56, 56), 96, False),
            ((PE_IMAGES, 28, 28), 192, False), ((3, 37, 41), 48, True)]

# the routes of the bfloat16 blocks' pieces, counted per forward or step:
# the tensor-core and SIMT GEMMs, the chunked cross2d scans (by chunk
# count), the fusion scans (kernels 2 and 3, csrc/nk_scan_fused.cu) and the
# serial scans of csrc/nk_scan.cu (their first design) and
# csrc/nk_scan_bwd.cu (kernel 7's), on no main path
ROUTE_FNS = {"gemm_tc": primitives.gemm_tc_cuda, "gemm_simt": primitives.gemm_simt_cuda,
             "cross2d_scan": cross2d_scan.cross2d_scan,
             "cross2d_scan_bwd": cross2d_scan.cross2d_scan_bwd,
             "fusion_scan": nk_scan.fusion_scan_cuda,
             "serial_scan": nk_scan.selective_scan_cuda,
             "serial_scan_bwd": nk_scan.selective_scan_bwd_cuda}
# the tile-parallel d_state-1 scans, whose calls are also counted by tile
# plan (a forward in one cluster launch or three launches)
PLAN_FNS = {"cross2d_scan": cross2d_scan.cross2d_scan,
            "cross2d_scan_bwd": cross2d_scan.cross2d_scan_bwd,
            "ss2d_core_n1_fwd": ss2d_core_n1.ss2d_core_n1_fwd,
            "ss2d_core_n1_bwd": ss2d_core_n1.ss2d_core_n1_bwd}
# GEMMs of a block: the forward's five; kernel 6's 9 (its recompute's 3,
# out_proj 2, x_proj 2, in_proj 2); the 8 rank-gradient GEMMs per block
# that kernel 6 launched in its first design are the adjoint scan's own
FWD_GEMMS, BWD_GEMMS, RANK_GEMMS = 5, 9, 8

# route counts per main-path forward (kernel 1) or step (kernels 4-6),
# filled by phases 4 and 7 for the kernels line
ROUTES = {}
# the redesigned kernels' extra keys of the kernels line (the old designs'
# times in the same run, device times by CUDA-graph replay), filled by
# phases 3c, 3d and 6
V1_EXTRA = {}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense operations/s by
# type; the special-function units' exponentials per SM and clock
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
SMS, SFU_PER_SM_CLOCK = 132, 16


class PhaseFailure(RuntimeError):
    pass


class Work:
    """The bytes a function must move (each input read once, each output
    written once) and the operations it must do, by type: its bound is the
    larger of bytes / HBM rate and the sum of operations / peak rate.  An
    add, multiply, exp or log counts one, an FMA two; products of bfloat16
    operands count at the tensor-core rate, products that the kernel runs
    on the tensor cores in TF32 (kernels 15 and 16 on float32 operands)
    at the TF32 rate, all other arithmetic at the float32 rate (the port
    does it in float32 outside the tensor cores)."""

    def __init__(self):
        self.bytes = 0.0
        self.ops = {"bf16": 0.0, "tf32": 0.0, "f32": 0.0}

    def add(self, bytes=0.0, **ops):
        self.bytes += bytes
        for kind, n in ops.items():
            self.ops[kind] += n
        return self

    def times(self, k):
        self.bytes *= k
        self.ops = {kind: k * n for kind, n in self.ops.items()}
        return self

    def __iadd__(self, other):
        self.add(other.bytes, **other.ops)
        return self

    def bound(self):
        """(milliseconds, "bytes" or "operations")."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = sum(n / PEAK_OPS[kind] for kind, n in self.ops.items())
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def simt_bound(self):
        """The bound with every operation at the float32 CUDA-core rate."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S, sum(self.ops.values()) / PEAK_OPS["f32"])


def scan_ops(M, D, K, N, R=0):
    """A selective scan of K directions over M positions x D channels: per
    step 2R + 4 for delta (rank projection, bias, softplus), 7 per state
    (delta A, exp, delta u B, the h FMA, the C h FMA), 2 for the skip."""
    return M * D * K * (2 * R + 6 + 7 * N)


def scan_bwd_ops(M, D, K, N, R=0):
    """Its adjoint: the forward again for h, then per state 16 (the lambda
    FMA, du, d exp, d delta, dB, dC, dA) and 4 for the softplus derivative."""
    return scan_ops(M, D, K, N, R) + M * D * K * (16 * N + 4)


def block_work(n, H, d, dtype, mlp, backward=False):
    """One VSSBlock (``mlp``) or its SS2D half on n images: the GEMMs, the
    LayerNorms, the conv + SiLU, GELU and the rank-form cross2d scan, reading
    x and the weights and writing the output; ``backward`` adds the
    gradient GEMMs (twice the forward's), the elementwise backwards and the
    adjoint scan, reads the float32 gradient and writes dx and the float32
    weight gradients."""
    M, di, R, hd = n * H * H, 2 * d, -(-d // 16), 4 * d
    esize = torch.finfo(dtype).bits // 8
    weights = d * di + di * (4 * R + 8) + di * d + (2 * d * hd if mlp else 0)
    gemm = 2 * M * weights
    elem = M * (8 * d + 8 * di + 22 * di + ((8 * d + 8 * hd) if mlp else 0))
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    if not backward:
        return Work().add(2 * M * d * esize + weights * esize,
                          f32=elem + scan_ops(M, di, 4, 1, R)).add(**{kind: gemm})
    return Work().add(M * d * (esize + 8) + weights * (esize + 4),
                      f32=3 * elem + scan_bwd_ops(M, di, 4, 1, R)).add(**{kind: 3 * gemm})


def n1_work(n, H, D, R, backward=False, dtype=torch.float32):
    """Kernel 11 (or 12, ``backward``) on n images of H x H x D: x and the
    projections read once, y (float32) written once; kernel 12 reads x, g,
    the projections and w_dt and writes du, the projections' gradient and
    dw_dt (float32).  The rank products count at the rate the kernels take
    them on the tensor cores: z = rank w_dt (2 M 4 R D, the forward's and
    the backward's recompute) in TF32 for both dtypes, the backward's two
    gradient products (d rank = dpre w_dt^T, dw_dt = rank^T dpre, 2 M 4 R D
    each) in TF32 for float32 and bf16 for bfloat16.  dpre stays on chip, as
    in the TPU kernel.  `Work.simt_bound` puts every product on the CUDA
    cores: the count of the first design."""
    M = n * H * H
    es = torch.finfo(dtype).bits // 8
    prod = 2 * M * 4 * R * D
    grads = "bf16" if dtype == torch.bfloat16 else "tf32"
    if not backward:
        return Work().add(M * (es * D + 4 * D + es * 4 * (R + 2)), f32=scan_ops(M, D, 4, 1),
                          tf32=prod)
    return Work().add(M * (es * D + 8 * D + es * 4 * (R + 2) + 16 * (R + 2)) + 2 * 16 * R * D,
                      f32=scan_bwd_ops(M, D, 4, 1), tf32=prod).add(**{grads: 2 * prod})


def nk_work(n, L, D, K, N, dtype, R=0, backward=False):
    """Kernels 2, 3 (``R``: rank form with the out-norm) and 7
    (``backward``) on (n, L, D) maps.  Kernel 3's rank product z = ranks
    w_dt (2 n L K R D) counts at the tensor-core rate it runs at (bf16 for
    bfloat16, TF32 for float32); `Work.simt_bound` puts it on the CUDA
    cores, the count of its first design."""
    esize = torch.finfo(dtype).bits // 8
    # u, B, C and the deltas (or their ranks) in; y out, or g in and du,
    # dB, dC (float32) and the deltas' gradient out
    per_pos = (D + 2 * K * N + K * (R or D)) * esize
    if backward:
        per_pos += (D + K * D) * esize + (D + 2 * K * N) * 4
        return Work().add(n * L * per_pos, f32=scan_bwd_ops(n * L, D, K, N))
    per_pos += D * esize
    prod = "bf16" if dtype == torch.bfloat16 else "tf32"
    return Work().add(n * L * per_pos + 4 * K * R * D,
                      f32=scan_ops(n * L, D, K, N) + (8 * n * L * D if R else 0)).add(
        **{prod: 2 * n * L * K * R * D})


def sm_clock_mhz():
    """The card's highest SM clock (nvidia-smi), in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])


def sfu_ms(n, L, D, K, N, clock_mhz):
    """The fusion scans' exponentials (n L D K N) on the special-function
    units at 16 per SM per clock: a floor beside the bound, not in it."""
    return 1e3 * n * L * D * K * N / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6)


def grouped_work(B, L, K, C, N, dtype, backward=False):
    """Kernel 13 (or 14, ``backward``) on one (B, L, K * C) call: u, delta,
    B and C read and y and the checkpoints written once (the backward also
    reads dy and the checkpoints and writes du, d delta, dB, dC and the
    parameter gradients), with the scan's operations per chain and step."""
    esize = torch.finfo(dtype).bits // 8
    M, KC = B * L, K * C
    ck = 4 * B * KC * N * -(-L // selective_scan_grouped.CHUNK)
    if not backward:
        return Work().add(M * (2 * KC + 2 * K * N) * esize + 4 * M * KC + ck + 4 * KC * (N + 2),
                          f32=scan_ops(M, KC, 1, N))
    return Work().add(M * (2 * KC + 2 * K * N) * esize + 4 * M * (3 * KC + 2 * K * N) + ck
                      + 8 * KC * (N + 2), f32=scan_bwd_ops(M, KC, 1, N))


def ssd_work(b, L, R, dtype, K=4, P=16, N=64, chunk=64, backward=False, states=False):
    """Kernel 15 (or 16, ``backward``) on one (b, K groups of R heads, L, P,
    N) call.  Bytes: x, dt, B and C read, y written (``states``: the
    checkpoints too), the final state; the backward reads them with dy and
    the checkpoints and writes dx, d dt, dB, dC (float32) and dinit.
    Operations per chunk of cl valid positions: the products, C B^T on its
    lower triangle per group, per head M (dt x), C state and the state
    update, at the tensor-core rate of the operands (bfloat16, or TF32 for
    float32 operands); the decay mask (3 per entry), dt, the cumsum and the
    skip at the float32 rate.  The backward adds the recomputation, the
    products M^T dy and dM (cl (cl + 1) P each), the five c x N x P products
    of the read-out and the update and dCB's two per group, and the mask's
    gradients.  The same count whatever implements it: the serial kernels
    ran every product on the CUDA cores (`Work.simt_bound`)."""
    esize = torch.finfo(dtype).bits // 8
    h, nc = K * R, -(-L // chunk)
    io = b * L * (h * P + h + 2 * K * N) * esize
    prod = elem = 0.0
    for i in range(nc):
        cl = min(chunk, L - i * chunk)
        tri = cl * (cl + 1)
        group = tri * N
        head = tri * P + 4 * cl * N * P
        head_elem = 1.5 * tri + 6 * cl * P + 6 * cl
        if backward:
            group += 2 * tri * N
            head += 2 * tri * P + 10 * cl * N * P
            head_elem += 5 * tri + 20 * cl * P + 20 * cl
        prod += b * (K * group + h * head)
        elem += b * h * head_elem
    kind = "bf16" if dtype == torch.bfloat16 else "tf32"
    state = 4 * b * h * N * P
    if not backward:
        out = b * L * h * P * esize + state * (1 + (nc if states else 0))
        return Work().add(io + out, f32=elem, **{kind: prod})
    return Work().add(io + state * (nc + 1) + 4 * b * L * (2 * h * P + h + 2 * K * N) + state,
                      f32=elem, **{kind: prod})


def cross_work(n, H, W, D, N, dtype):
    """Kernel 10 on n images of H x W x D: x, the four directions' deltas,
    B and C read once, y (float32) written once, the four directions' scans
    and the merge's three adds."""
    esize = torch.finfo(dtype).bits // 8
    M = n * H * W
    return Work().add(M * (5 * D + 8 * N) * esize + 4 * M * D,
                      f32=scan_ops(M, D, 4, N) + 3 * M * D)


def ln_work(rows, C, dtype, act, backward=False):
    """Kernels 19 / 20 (or 21, ``backward``) on rows pixels of C channels:
    x read and y written once (the backward reads x and g and writes dx
    and the float32 dscale and dbias), scale and bias read once.  Per
    element 7 operations for the moments and the affine and 5 for the erf
    GELU; the backward 18, and 10 for the GELU's derivative."""
    esize = torch.finfo(dtype).bits // 8
    n = rows * C
    if not backward:
        return Work().add(2 * n * esize + 8 * C, f32=n * (7 + (5 if act else 0)))
    return Work().add(3 * n * esize + 16 * C, f32=n * (18 + (10 if act else 0)))


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


def reset_routes():
    for fn in ROUTE_FNS.values():
        fn.launches = 0
    for fn in PLAN_FNS.values():
        fn.by_plan.clear()


def read_routes():
    """The route counts since `reset_routes`, with the tile-parallel scans'
    calls by tile plan (``ops/ss2d_core_n1.py::tile_plan``)."""
    return {n: fn.launches for n, fn in ROUTE_FNS.items()} | {
        f"{n} plans": dict(sorted(fn.by_plan.items())) for n, fn in PLAN_FNS.items()}


def check_routes(label, routes, want):
    """Fail unless the route counts hold ``want``: every bfloat16 stage
    GEMM on the tensor-core kernel, every stage scan and adjoint chunked,
    the serial kernels only for the fusion scans."""
    got = {k: routes[k] for k in want}
    print(f"  {label} routes: {routes}")
    if got != want:
        raise PhaseFailure(f"{label}: route counts {got}, expected {want}")


# ---------------------------------------------------------------------------
# kernel cases at the main path's widths
# ---------------------------------------------------------------------------

def stage_case(g, H, d, depth, batch, dtype):
    blocks = [VSSBlock(d, generator=g).eval().cuda() for _ in range(depth)]
    packed = [pack_vss_block_params(b, dtype) for b in blocks]
    x = randn(g, 2 * batch, H * H, d, dtype=dtype)
    return (x, packed, H, H), vss_stage.vss_stage, vss_stage.vss_stage_plain


def fusion_scan_operands(g, n, K, dtype, size="small"):
    H, D, N = (FUSION[size][k] for k in "HDN")
    L = H * H
    A = -torch.arange(1.0, N + 1).repeat(K, 1).reshape(K * N, 1).expand(K * N, D)
    dt = torch.exp(torch.rand(K, D, generator=g) * 4.6 - 6.9)   # dt in [1e-3, 1e-1]
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, K * N, dtype=dtype),
            randn(g, n, L, K * N, dtype=dtype), A.contiguous().cuda(),
            torch.ones(K, D, device="cuda"), (dt + torch.log(-torch.expm1(-dt))).cuda())


def shallow_case(g, batch, dtype, size="small"):
    """One of ShallowFuse's two K=1 row_f calls: (B, 49, D), N = 16."""
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, batch, 1, dtype, size)
    dts = randn(g, *u.shape, dtype=dtype, scale=0.5)
    H = FUSION[size]["H"]
    return ((u, dts, Bs, Cs, A, Dvec, bias, H, H, ("row_f",)),
            nk_scan.nk_scan, nk_scan.nk_scan_plain)


def cross_case(g, batch, dtype, size="small"):
    """Cross_SS2Dv5's rank-form call: (3B, 49, D), K = 4, N = 16, rank R."""
    K, R, D, H = 4, FUSION[size]["R"], FUSION[size]["D"], FUSION[size]["H"]
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, 3 * batch, K, dtype, size)
    ranks = randn(g, *u.shape[:2], K * R, dtype=dtype)
    w_dt = randn(g, K * R, D, scale=R ** -0.5)
    lno = torch.stack([torch.ones(D), torch.zeros(D)]).cuda()
    return ((u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, H,
             nk_scan.scan_mode_kinds("cross2d")), nk_scan.nk_scan_x, nk_scan.nk_scan_x_plain)


def n1_case(g, n, H, d, dtype):
    """Kernel 11's operands at a backbone stage on n images: x (n, H, H, 2d),
    R = ceil(d / 16), the projections from `pack_n1_inputs`; deltas about
    softplus(-4 +- 1) and A in [-e^1.5, -1], as in a trained model."""
    D, R = 2 * d, -(-d // 16)
    x = randn(g, n, H, H, D, dtype=dtype)
    xw, dtw = randn(g, 4, R + 2, D, scale=D ** -0.5), randn(g, 4, D, R, scale=R ** -0.5)
    bias = randn(g, 4, D, scale=0.5) - 4.0
    A_logs = (1.5 * torch.rand(4 * D, 1, generator=g)).cuda()
    return (x, *ss2d_core_n1.pack_n1_inputs(x, xw, dtw, bias, A_logs, randn(g, 4 * D)))


def main_path_cases(g, batch, dtype, size="small"):
    """(kernel name, label, (args, kernel, plain)) at every geometry of the
    model's inference path in ``dtype``: XFMamba-S's stages at full depth;
    XFMamba-B's float32 path runs no stage kernel and its bfloat16 path
    (dims 128-1024, dt rank 8-64) is checked at depth 2 per stage, where
    the plain version stays within the run's time, and without kernel 11,
    which bfloat16 does not take."""
    D, R = FUSION[size]["D"], FUSION[size]["R"]
    if size == "small" or dtype == torch.bfloat16:
        for H, d, depth in STAGES[size]:
            depth = depth if size == "small" else 2
            yield "vss_stage", f"stage H={H} d={d} depth={depth}", \
                stage_case(g, H, d, depth, batch, dtype)
    yield "nk_scan", f"ShallowFuse (B,49,{D}) K=1 N=16", shallow_case(g, batch, dtype, size)
    yield "nk_scan_x", f"Cross_SS2Dv5 (3B,49,{D}) K=4 N=16 R={R}", \
        cross_case(g, batch, dtype, size)
    if size == "base" and dtype == torch.bfloat16:
        return
    for H, d, _ in STAGES[size]:
        yield "ss2d_core_n1_fwd", f"N=1 core H={H} D={2 * d} R={-(-d // 16)} (y, ck)", \
            (n1_case(g, 2 * batch, H, d, dtype), ss2d_core_n1.ss2d_core_n1_fwd,
             ss2d_core_n1.ss2d_core_n1_fwd_plain)


def phase_compare(errors):
    """Every inference kernel against its plain version at XFMamba-S's
    shapes in float32 and bfloat16, and at XFMamba-B's (dims 128-1024,
    fusion D 2048, dt rank up to 64) in float32 and, for the kernels of its
    bfloat16 path (1, 2, 3), in bfloat16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 3: kernels vs plain versions on the card, batch {COMPARE_BATCH}, TF32 off; "
          "XFMamba-S and XFMamba-B in float32 and bfloat16")
    g = torch.Generator().manual_seed(1)
    failed = []
    runs = [("small", torch.float32), ("small", torch.bfloat16), ("base", torch.float32),
            ("base", torch.bfloat16)]
    for size, dtype in runs:
        for name, label, (args, kernel, plain) in main_path_cases(g, COMPARE_BATCH, dtype, size):
            label = f"{MODEL_NAME[size]} {label}"
            with torch.no_grad():
                got = kernel(*args)
                want = plain(*args)
                # kernels 2 and 3 sum in a fixed order: the same bits on every run
                same = name not in ("nk_scan", "nk_scan_x") or torch.equal(got, kernel(*args))
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
            rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                      for a, b in pairs)
            ok = all(bool(torch.isfinite(a).all()) for a, _ in pairs) and rel <= TOL[dtype] \
                and same
            errors[name] = max(errors.get(name, 0.0), err)
            print(f"  {name:9s} {label:52s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} tol={TOL[dtype]:.0e}{'' if same else ' two runs differ'} "
                  f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failed.append((name, label, dtype))
    if failed:
        raise PhaseFailure(f"kernels disagree with their plain versions: {failed}")


@contextlib.contextmanager
def first_design_fusion_scans():
    """Kernels 2 and 3 on their first design while open: `nk_scan` and
    `nk_scan_x` call the serial scan of ``csrc/nk_scan.cu`` on the same
    operands (the old-against-new timings of phases 3d, 4, 4c, 7, 7c)."""
    fused = nk_scan.fusion_scan_cuda
    nk_scan.fusion_scan_cuda = nk_scan.selective_scan_cuda
    try:
        yield
    finally:
        nk_scan.fusion_scan_cuda = fused


@contextlib.contextmanager
def first_design_grouped_scan():
    """Kernels 13 and 14 on their first design while open:
    `SelectiveScanGrouped` calls ``grouped_scan_fwd_v1`` / ``_bwd_v1`` on the
    same operands (phase 7d's old-against-new step timing)."""
    ssg = selective_scan_grouped
    new = ssg.grouped_scan_fwd, ssg.grouped_scan_bwd
    ssg.grouped_scan_fwd, ssg.grouped_scan_bwd = ssg.grouped_scan_fwd_v1, ssg.grouped_scan_bwd_v1
    try:
        yield
    finally:
        ssg.grouped_scan_fwd, ssg.grouped_scan_bwd = new


def on_first_design(fn):
    def run():
        with first_design_fusion_scans():
            return fn()
    return run


def fusion_cases(g, size, dtype):
    """(label, (args, kernel, plain), images, K): kernels 2 and 3 at every
    fusion geometry of the model: ShallowFuse's K=1 call and Cross_SS2Dv5's
    rank-form call at bs 8 and 32, the training step's K=4 dts-form call at
    bs 16."""
    L, D, R = FUSION[size]["H"] ** 2, FUSION[size]["D"], FUSION[size]["R"]
    for bs in (8, 32):
        yield f"ShallowFuse bs {bs} ({bs},{L},{D}) K=1", shallow_case(g, bs, dtype, size), bs, 1
        yield (f"Cross_SS2Dv5 bs {bs} ({3 * bs},{L},{D}) K=4 R={R}",
               cross_case(g, bs, dtype, size), 3 * bs, 4)
    a = nk_bwd_case(g, 3 * TRAIN_BATCH, 4, dtype, size)
    yield (f"step's K=4 call bs {TRAIN_BATCH} ({3 * TRAIN_BATCH},{L},{D})",
           (a[:7] + a[8:], nk_scan.nk_scan, nk_scan.nk_scan_plain), 3 * TRAIN_BATCH, 4)


def fusion_probe(args, kernel, **probe):
    """`fusion_scan_cuda` on the operands of ``args`` with a probe
    (``blocks_per_sm`` or ``phase_ns``)."""
    if kernel is nk_scan.nk_scan:
        u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds = args
        deltas = dict(dts=dts.view(*u.shape[:2], len(kinds), u.shape[2]), out_dtype=u.dtype)
    else:
        u, ranks, Bs, Cs, w_dt, A, Dvec, bias, _, H, W, kinds = args
        deltas = nk_scan._rank_operands(u, ranks, w_dt, kinds)
    return nk_scan.fusion_scan_cuda(H=H, W=W, **probe, **deltas,
                                    **nk_scan._nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))


def out_norm_graph_ms(args):
    """Device ms of kernel 3's out-norm launch alone (the row LayerNorm of
    ``csrc/vss_stage.cu`` on a float32 y of the call's shape)."""
    u, lno = args[0], args[8].float()
    y = torch.randn(u.shape[0] * u.shape[1], u.shape[2], device="cuda")
    w, b = lno[0].contiguous(), lno[1].contiguous()
    return graph_ms(lambda: primitives.layer_norm_cuda(y, w, b, u.dtype), 10)


def phase_fusion_scans(errors, card):
    """Kernels 2 and 3 (``csrc/nk_scan_fused.cu``) at every fusion geometry
    of XFMamba-S and -B in both dtypes: against their plain versions,
    bitwise over two runs, and against their first design (the serial scan)
    in turns, by CUDA events and graph replay, beside the bound (rank
    products on the tensor cores), the bound with every product on the
    CUDA cores, the exponentials' SFU time, the blocks an SM holds, the
    plan and a block's mean time in each phase (the kernel's phase clock).
    Kernel 3's rows include its out-norm launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = sm_clock_mhz()
    print(f"phase 3d: kernels 2 and 3 at every fusion geometry, against their plain versions "
          f"and their first design (the serial scan) in turns; ms per call, device time by graph "
          f"replay; SFU: the exponentials at {SFU_PER_SM_CLOCK} per SM per clock on {SMS} SMs at "
          f"{clock:.0f} MHz ({card})")
    g = torch.Generator().manual_seed(7)
    failed = []
    rows = {}
    for size in STAGES:
        H, D, N, R = (FUSION[size][k] for k in "HDNR")
        for dtype in (torch.bfloat16, torch.float32):
            for label, (args, kernel, plain), n, K in fusion_cases(g, size, dtype):
                name = "nk_scan" if kernel is nk_scan.nk_scan else "nk_scan_x"
                nk_scan.fusion_scan_cuda.by_plan.clear()
                with torch.no_grad():
                    got, again, want = kernel(*args), kernel(*args), plain(*args)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    rel_err = err / float(want.float().abs().max())
                    same = torch.equal(got, again)
                    plan = ", ".join(nk_scan.fusion_scan_cuda.by_plan)
                    calls = {"old": on_first_design(lambda: kernel(*args)),
                             "new": lambda: kernel(*args)}
                    ev = in_turns(calls, lambda fn: time_ms(fn, 10))
                    gr = in_turns(calls, lambda fn: graph_ms(fn, 10))
                    blocks = fusion_probe(args, kernel, blocks_per_sm=True)
                    phases = fusion_probe(args, kernel, phase_ns=True)
                    ln = out_norm_graph_ms(args) if name == "nk_scan_x" else None
                ok = same and rel_err <= TOL[dtype] and bool(torch.isfinite(got).all())
                errors[name] = max(errors.get(name, 0.0), err)
                work = nk_work(n, H * H, D, K, N, dtype, R=R if name == "nk_scan_x" else 0)
                bound, by = work.bound()
                sfu = sfu_ms(n, H * H, D, K, N, clock)
                rows[(size, dtype, label)] = dict(ms=ev["new"], serial_ms=ev["old"],
                                                  graph_ms=gr["new"], serial_graph_ms=gr["old"],
                                                  bound_ms=bound, simt_bound_ms=work.simt_bound(),
                                                  sfu_ms=sfu, blocks_per_sm=blocks)
                if ln is not None:
                    rows[(size, dtype, label)]["out_norm_graph_ms"] = ln
                print(f"  {MODEL_NAME[size]} {label:40s} {str(dtype)[6:]:8s} rel={rel_err:.2e} "
                      f"{'bitwise' if same else 'two runs differ'} {'OK' if ok else 'FAIL'}; "
                      f"new {ev['new']:.4f} (device {gr['new']:.4f}) ms, first design "
                      f"{ev['old']:.4f} (device {gr['old']:.4f}); bound {bound:.4f} ({by}), every "
                      f"product on the CUDA cores {work.simt_bound():.4f}; SFU time {sfu:.4f}; "
                      f"{'' if ln is None else f'the out-norm launch alone {ln:.4f} (device); '}"
                      f"{blocks} blocks an SM; {plan}; a block's phases (us): "
                      + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in phases.items()))
                if not ok:
                    failed.append((MODEL_NAME[size], label, str(dtype)))
    if failed:
        raise PhaseFailure(f"kernels 2 / 3 disagree with their plain versions or between runs: "
                           f"{failed}")
    # per main-path bs-32 bfloat16 forward: two ShallowFuse calls, one Cross_SS2Dv5 call
    for name, label, calls in (("nk_scan", "ShallowFuse bs 32", 2),
                               ("nk_scan_x", "Cross_SS2Dv5 bs 32", 1)):
        row = next(r for (size, dtype, lab), r in rows.items()
                   if size == "small" and dtype == torch.bfloat16 and lab.startswith(label))
        # the line's ms and bound_ms are phase 4b's (per forward, the same geometry)
        V1_EXTRA[name] = {k: calls * v for k, v in row.items()
                          if k not in ("ms", "bound_ms", "blocks_per_sm")} | {
            "per": "bs-32 bfloat16 XFMamba-S forward", "blocks_per_sm": row["blocks_per_sm"],
            "geometries": {f"{MODEL_NAME[size]} {lab} {str(dtype)[6:]}": {
                k: round(v, 5) for k, v in r.items() if k in ("graph_ms", "serial_graph_ms")}
                for (size, dtype, lab), r in rows.items()
                if (name == "nk_scan_x") == lab.startswith("Cross")}}


def grouped_case(g, B, L, K, C, N, dtype):
    """The grouped scan's operands with a trained model's ranges: A in
    [-e^1.5, -1] per state, deltas about softplus(-4 +- 1)."""
    return (randn(g, B, L, K * C, dtype=dtype), randn(g, B, L, K * C, dtype=dtype) - 4.0,
            -torch.exp(1.5 * torch.rand(K * C, N, generator=g)).cuda(),
            randn(g, B, L, K, N, dtype=dtype), randn(g, B, L, K, N, dtype=dtype),
            randn(g, K * C), randn(g, K * C, scale=0.5))


def grouped_sfu_ms(B, L, K, C, N, clock_mhz, backward=False):
    """Kernel 13's (or 14's, ``backward``) special-function-unit work at 16
    per SM per clock, as ``csrc/grouped_scan_lanes.cu`` computes it: per
    position and channel an exp2 per state (the adjoint two: the walk to the
    segments' entry states and the segment's recompute) and the softplus's
    exponential and reciprocal (the adjoint also the sigmoid's)."""
    per = 2 * N + 4 if backward else N + 2
    return 1e3 * B * L * K * C * per / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6)


# phase 3b's timed calls, float32: (GROUPED_CASES index, label, [(reverse, calls)])
GROUPED_TIMED = [(0, f"XFMamba-B bs-{TRAIN_BATCH} step", [(0, 2), (1, 2)]),
                 (1, "XFMamba-S bs-12 ShallowFuse call", [(0, 1)])]


def grouped_turns(args, ck, gy, reverse):
    """Device ms per call by CUDA-graph replay of kernels 13 and 14 and of
    their first design (``grouped_scan_*_v1``), in turns (first, new, new,
    first): {kernel name: (new, first design)}."""
    ssg = selective_scan_grouped
    out = {}
    for name, new, old in (
            ("selective_scan_grouped_fwd", lambda: ssg.grouped_scan_fwd(*args, reverse=reverse),
             lambda: ssg.grouped_scan_fwd_v1(*args, reverse=reverse)),
            ("selective_scan_grouped_bwd",
             lambda: ssg.grouped_scan_bwd(*args, ck, gy, reverse=reverse),
             lambda: ssg.grouped_scan_bwd_v1(*args, ck, gy, reverse=reverse))):
        t = in_turns({"first": old, "new": new}, graph_ms)
        out[name] = (t["new"], t["first"])
    return out


def phase_compare_grouped(errors, card):
    """Kernels 13 and 14 (``csrc/grouped_scan_lanes.cu``) against their
    plain twins at every grouped-scan geometry, float32 and bfloat16,
    forward and reverse, every output (y, checkpoints, all seven gradients
    from the plain checkpoints), and bitwise equal over two runs; each
    kernel's float32 time per XFMamba-B step (the first geometry's two
    forward and two reverse calls, kernel and plain twin on the same inputs,
    CUDA events), and device times by CUDA-graph replay per XFMamba-B step
    and per XFMamba-S bs-12 ShallowFuse call beside the first design's in
    turns, the bound and the exponentials' SFU time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 3b: kernels 13 and 14 vs their plain twins, TF32 off; float32 times per "
          f"XFMamba-B bs-{TRAIN_BATCH} step ({card})")
    ssg = selective_scan_grouped
    g = torch.Generator().manual_seed(9)
    failed = []
    times = {name: [0.0, 0.0] for name in GROUPED_KERNELS}
    works = {name: Work() for name in GROUPED_KERNELS}
    turns = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (B, L, K, C, N, label), reverse in ((c, r) for c in GROUPED_CASES for r in (0, 1)):
            args = grouped_case(g, B, L, K, C, N, dtype)
            geo = f"({B},{L},{K}x{C}) N={N} {'rev' if reverse else 'fwd'}"
            gy = randn(g, B, L, K * C)
            with torch.no_grad():
                fwd = (lambda: ssg.grouped_scan_fwd(*args, reverse=bool(reverse)))
                fwd_plain = (lambda: ssg.grouped_scan_fwd_plain(*args, reverse=bool(reverse)))
                fwd()                                      # warm-up
                got, ms = timed_call(fwd, 5)
                want, plain_ms = timed_call(fwd_plain)
                check_outputs(errors, "selective_scan_grouped_fwd", f"{label} {geo}", dtype,
                              got, want, failed)
                if not all(map(torch.equal, fwd(), got)):
                    failed.append(f"selective_scan_grouped_fwd {label} {geo} {dtype}: two runs "
                                  f"differ")
                ck = want[1]
                bwd = (lambda: ssg.grouped_scan_bwd(*args, ck, gy, reverse=bool(reverse)))
                bwd()
                got_b, ms_b = timed_call(bwd, 5)
                want_b, plain_ms_b = timed_call(
                    lambda: ssg.grouped_scan_bwd_plain(*args, ck, gy, reverse=bool(reverse)))
                check_outputs(errors, "selective_scan_grouped_bwd", f"{label} {geo}", dtype,
                              got_b, want_b, failed)
                again = bwd()
                if not all(torch.equal(again[k], got_b[k]) for k in got_b):
                    failed.append(f"selective_scan_grouped_bwd {label} {geo} {dtype}: two runs "
                                  f"differ")
                if dtype == torch.float32:
                    for index, _, calls in GROUPED_TIMED:
                        if (B, L, K, C, N, label) == GROUPED_CASES[index] and \
                                reverse in dict(calls):
                            turns[index, reverse] = grouped_turns(args, ck, gy, bool(reverse))
            if dtype == torch.float32 and (B, L, K, C, N) == GROUPED_CASES[0][:5]:
                for name, k_ms, p_ms, backward in (
                        ("selective_scan_grouped_fwd", ms, plain_ms, False),
                        ("selective_scan_grouped_bwd", ms_b, plain_ms_b, True)):
                    times[name][0] += 2 * k_ms
                    times[name][1] += 2 * p_ms
                    works[name] += grouped_work(B, L, K, C, N, dtype, backward).times(2)
            del args, got, want, got_b, want_b, again
    if failed:
        raise PhaseFailure(f"kernels 13/14 disagree with their plain twins: {failed}")
    clock = sm_clock_mhz()
    out = {}
    for name, (ms, plain_ms) in times.items():
        out[name] = (ms, plain_ms, *works[name].bound())
        backward = name.endswith("bwd")
        extra = {"per": f"XFMamba-B bs-{TRAIN_BATCH} float32 step", "geometries": {}}
        for index, label, calls in GROUPED_TIMED:
            B, L, K, C, N, _ = GROUPED_CASES[index]
            new = sum(n * turns[index, r][name][0] for r, n in calls)
            first = sum(n * turns[index, r][name][1] for r, n in calls)
            n_calls = sum(n for _, n in calls)
            bound = grouped_work(B, L, K, C, N, torch.float32, backward).times(n_calls).bound()
            sfu = n_calls * grouped_sfu_ms(B, L, K, C, N, clock, backward)
            print(f"  {name} per {label}: device {new:.4f} ms (graph replay), first design "
                  f"{first:.4f} in turns; bound {bound[0]:.4f} ms ({bound[1]}), "
                  f"SFU time {sfu:.4f} ms at {clock:.0f} MHz")
            row = {"graph_ms": round(new, 5), "serial_graph_ms": round(first, 5),
                   "sfu_ms": round(sfu, 5)}
            if index == 0:
                extra |= row
            else:
                extra["geometries"][label] = row | {"bound_ms": round(bound[0], 5)}
        V1_EXTRA[name] = extra
        print(f"  {name} per XFMamba-B step (2 forward + 2 reverse calls): kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {out[name][2]:.4f} ms ({out[name][3]}, "
              f"{works[name].bytes / 1e6:.1f} MB)")
    return out


# ---------------------------------------------------------------------------
# kernels 8, 9 and 10: single-study inference and the cross2d core
# ---------------------------------------------------------------------------

def v1_block_case(g, H, d, n, dtype=torch.bfloat16):
    """One VSSBlock at a stage map on n images: its kernel-8 operands and x."""
    block = VSSBlock(d, generator=g).eval().cuda()
    return (randn(g, n, H * H, d, dtype=dtype),
            vss_block_v1.pack_vss_block_v1_params(block, dtype))


def device_launches(fn):
    """The card's kernel launches in one call of ``fn`` (torch.profiler, 3
    calls after a warm-up): {kernel name: launches per call}."""
    _, _, table = profile_calls(fn, calls=3, warmup=1)
    return {name: count for _, count, name in table}


def in_turns(fns, timer):
    """Time each of ``fns`` (name -> callable) with ``timer`` in turns, the
    first, the others, the others again, the first (old, new, new, old for
    two); returns {name: mean ms}."""
    names = list(fns)
    order = names + names[::-1]
    t = {name: [] for name in names}
    for name in order:
        t[name].append(timer(fns[name]))
    return {name: sum(v) / len(v) for name, v in t.items()}


def v1_scan_case(g, n, K, dtype, size):
    """Kernel 9's operands at a fusion shape: (n, 49, D), K kinds, N 16."""
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, n, K, dtype, size)
    dts = randn(g, n, u.shape[1], K * u.shape[2], dtype=dtype, scale=0.5)
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    H = FUSION[size]["H"]
    return (u, dts, Bs, Cs, A, Dvec, bias, H, H, kinds)


def cross_case_n(g, n, H, D, N, dtype):
    """Kernel 10's operands on n images of H x H x D: deltas about
    softplus(-4 +- 1) and A in [-e^1.5, -1], as in a trained model."""
    return (randn(g, n, H, H, D, dtype=dtype), randn(g, n, H, H, 4, D, dtype=dtype) - 4.0,
            randn(g, n, H, H, 4, N, dtype=dtype), randn(g, n, H, H, 4, N, dtype=dtype),
            -torch.exp(1.5 * torch.rand(4, D, N, generator=g)).cuda(), randn(g, 4, D),
            randn(g, 4, D, scale=0.5))


def phase_compare_v1(errors, card):
    """Kernels 8, 9 and 10 against their plain twins on the card, TF32 off,
    with each one's time, its plain twin's and its bound: kernel 8 per
    bs-1 bfloat16 XFMamba-S forward (15 blocks at 14 x 14, 2 at 7 x 7, 2
    images) beside kernel 1's block sequence on the same blocks and inputs;
    kernel 9 per bs-1 bfloat16 forward (two ShallowFuse calls, one
    Cross_SS2Dv5 call) beside kernel 2 on the same inputs; kernel 10 per
    step of phase 8d's layer (float32, 6 images of 7 x 7 x 1536, N 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 3c: kernels 8, 9 and 10 vs their plain twins on the card, TF32 off ({card})")
    g = torch.Generator().manual_seed(30)
    failed, times = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    k8 = dict(ms=0.0, plain=0.0, serial_ms=0.0, graph_ms=0.0, serial_graph_ms=0.0, work=Work())
    phases = {}
    with torch.no_grad():
        # every stage map of both models, 2 and 4 images, both dtypes; the
        # 4-image 56 x 56 map fills the grid many times over, the 2-image
        # 7 x 7 one leaves most of its blocks idle in every phase
        for size in ("small", "base"):
            for H, d, depth in STAGES[size]:
                for n in (2, 4):
                    for dtype in (bf16, f32):
                        x, p = v1_block_case(g, H, d, n, dtype)
                        before = vss_block_v1.vss_block_v1.launches
                        got = vss_block_v1.vss_block_v1(x, p, H, H)
                        if vss_block_v1.vss_block_v1.launches != before + 1:
                            raise PhaseFailure("kernel 8 counted other than one launch per call")
                        check_outputs(errors, "vss_block_v1",
                                      f"{MODEL_NAME[size]} block H={H} d={d} ({n} images)", dtype,
                                      [got], [vss_block_v1.vss_block_v1_phases_plain(x, p, H, H)],
                                      failed)
        launches = device_launches(lambda: vss_block_v1.vss_block_v1(x, p, H, H))
        print(f"  kernel 8's device launches per call: {launches}")
        if list(launches.values()) != [1.0] or "vss_block_v1_kernel" not in next(iter(launches)):
            raise PhaseFailure(f"kernel 8 is not one device launch per block: {launches}")
        # per bs-1 bfloat16 XFMamba-S forward: the old sequence and the
        # cooperative kernel in turns, CUDA events and CUDA-graph replay
        for H, d, depth in STAGES["small"][2:]:
            x, p = v1_block_case(g, H, d, 2)
            calls = {"sequence": lambda: vss_block_v1.vss_block_v1_sequence(x, p, H, H),
                     "kernel": lambda: vss_block_v1.vss_block_v1(x, p, H, H)}
            ev = in_turns(calls, lambda fn: time_ms(fn, 5))
            gr = in_turns(calls, lambda fn: graph_ms(fn, 5))
            k8["ms"] += depth * ev["kernel"]
            k8["serial_ms"] += depth * ev["sequence"]
            k8["graph_ms"] += depth * gr["kernel"]
            k8["serial_graph_ms"] += depth * gr["sequence"]
            k8["plain"] += depth * time_ms(
                lambda: vss_block_v1.vss_block_v1_phases_plain(x, p, H, H), 1, warmup=False)
            k8["work"] += block_work(2, H, d, bf16, mlp=True).times(depth)
            ph = [vss_block_v1.phase_ns(x, p, H, H) for _ in range(3)]
            phases[f"H={H}"] = {k: sorted(v[k] for v in ph)[1] / 1e3 for k in ph[0]}
            print(f"  kernel 8 at H={H} d={d} (2 images) per block: events {ev['kernel']:.4f} ms "
                  f"(sequence {ev['sequence']:.4f}), device {gr['kernel']:.4f} ms (sequence "
                  f"{gr['sequence']:.4f}); phases (us, median of 3): "
                  f"{', '.join(f'{k} {v:.1f}' for k, v in phases[f'H={H}'].items())} ({card})")
        k9 = dict(ms=0.0, plain=0.0, k2=0.0, work=Work())
        for size in ("small", "base"):
            for dtype in (f32, bf16):
                for n, K, count in ((1, 1, 2), (3, 4, 1)):
                    args = v1_scan_case(g, n, K, dtype, size)
                    D = FUSION[size]["D"]
                    label = f"{MODEL_NAME[size]} ({n},49,{D}) K={K} N=16"
                    check_outputs(errors, "nk_scan_v1", label, dtype,
                                  [nk_scan_v1.nk_scan_v1(*args)],
                                  [nk_scan_v1.nk_scan_v1_plain(*args)], failed)
                    if size == "small" and dtype == bf16:
                        k9["ms"] += count * time_ms(lambda: nk_scan_v1.nk_scan_v1(*args), 5)
                        k9["plain"] += count * time_ms(
                            lambda: nk_scan_v1.nk_scan_v1_plain(*args), 1, warmup=False)
                        k9["k2"] += count * time_ms(lambda: nk_scan.nk_scan(*args), 5)
                        k9["work"] += nk_work(n, 49, D, K, 16, bf16).times(count)
        for dtype in (f32, bf16):
            cases = [(H, 2 * d, 1) for H, d, _ in STAGES["small"]] + [(7, 1536, 16)]
            for H, D, N in cases:
                args = cross_case_n(g, 2, H, D, N, dtype)
                check_outputs(errors, "fused_cross_scan",
                              f"cross2d core H={H} D={D} N={N} (2 images)", dtype,
                              [fused_cross_scan.fused_cross_scan(*args)],
                              [fused_cross_scan.fused_cross_scan_plain(*args)], failed)
        n, H, D = 3 * CROSS_N1["views"], CROSS_N1["H"], 2 * CROSS_N1["d"]
        args = cross_case_n(g, n, H, D, 1, f32)
        k10 = (time_ms(lambda: fused_cross_scan.fused_cross_scan(*args), 5),
               time_ms(lambda: fused_cross_scan.fused_cross_scan_plain(*args), 1, warmup=False),
               *cross_work(n, H, H, D, 1, f32).bound())
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"kernels 8, 9 or 10 disagree with their plain twins: {failed}")
    times["vss_block_v1"] = (k8["ms"], k8["plain"], *k8["work"].bound())
    V1_EXTRA["vss_block_v1"] = {k: k8[k] for k in ("serial_ms", "graph_ms", "serial_graph_ms")} | {
        "phases_us": phases, "grid_blocks": {str(dt)[6:]: vss_block_v1.cooperative_grid(dt)
                                             for dt in (bf16, f32)}}
    times["nk_scan_v1"] = (k9["ms"], k9["plain"], *k9["work"].bound())
    times["fused_cross_scan"] = k10
    print(f"  kernel 8 per bs-1 bfloat16 XFMamba-S forward (17 blocks): {k8['ms']:.3f} ms "
          f"(events; the old sequence in turns {k8['serial_ms']:.3f} ms), device "
          f"{k8['graph_ms']:.3f} ms (sequence {k8['serial_graph_ms']:.3f} ms), plain "
          f"{k8['plain']:.3f} ms, bound {times['vss_block_v1'][2]:.4f} ms "
          f"({times['vss_block_v1'][3]}) ({card})")
    print(f"  kernel 9 per bs-1 bfloat16 forward (2 + 1 calls): {k9['ms']:.3f} ms, plain "
          f"{k9['plain']:.3f} ms, bound {times['nk_scan_v1'][2]:.4f} ms "
          f"({times['nk_scan_v1'][3]}); kernel 2 on the same inputs {k9['k2']:.3f} ms")
    print(f"  kernel 10 per step of phase 8d's layer ({n} images, {H}x{H}x{D}, N 1, float32): "
          f"{k10[0]:.3f} ms, plain {k10[1]:.3f} ms, bound {k10[2]:.4f} ms ({k10[3]})")
    return times


def graph_ms(fn, reps=20):
    """Mean milliseconds per call of ``fn`` on the device: ``reps`` calls
    captured in one CUDA graph, the graph replayed between CUDA events, so
    the host's launch work (the wrapper's checks, its small torch
    operations' launches) drops out and only the device's time is left."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                               # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    _, ms = timed_call(graph.replay, 3)
    return ms / reps


def busy_share(fn, reps=3):
    """(wall ms, device ms) per call of ``fn`` under torch.profiler: wall
    from CUDA events, device the sum of the device-only rows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if r.self_cpu_time_total == 0 and _device_us(r) > 0
            and not getattr(r, "is_user_annotation", False)]
    return start.elapsed_time(end) / reps, sum(map(_device_us, rows)) / 1e3 / reps


def one_study_forward(model, bs, dtype, want, label, card, profile=False):
    """One forward at ``bs`` studies with the launch counts read around it
    (``want``: the expected non-zero counts), then ms per forward (median
    of 3 runs of 5) and, with ``profile``, the device's busy share."""
    fns = all_kernels()
    xa, xb = views(bs, dtype, 300 + bs)
    with torch.no_grad():
        model(xa, xb)                                      # warm-up
        torch.cuda.synchronize()
        counts = counted(fns)
        logits = model(xa, xb)
        torch.cuda.synchronize()
        launches = {n: c for n, c in counts().items() if c}
        if logits.shape != (bs, 2) or not torch.isfinite(logits.float()).all() or launches != want:
            raise PhaseFailure(f"{label} bs {bs}: logits {tuple(logits.shape)} or launches "
                               f"{launches}, expected {want}")
        samples = sorted(time_ms(lambda: model(xa, xb), 5) for _ in range(3))
        line = (f"  {label} bs {bs}: launches per forward {launches}; {samples[1]:.2f} ms per "
                f"forward (median of 3 runs of 5: {', '.join(f'{v:.2f}' for v in samples)})")
        if profile:
            wall, device = busy_share(lambda: model(xa, xb))
            line += f"; profiled: wall {wall:.3f} ms, device {device:.3f} ms, busy share " \
                    f"{device / wall:.3f}"
    print(f"{line} ({card})")
    return launches


def phase_one_study(card):
    """XFMamba-S bfloat16 inference at 1 and 2 studies per batch (kernels
    8 and 9), float32 at 1 study, XFMamba-B bfloat16 at 1 and 32 studies;
    launches per forward and ms per forward, the operands kept by
    `pack_for_inference` (the bs-1 bfloat16 forward also without).  Returns the bs-1 bfloat16
    XFMamba-S launches (the main path of kernels 8 and 9)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 4f: single-study inference, 224x224, seeded weights, TF32 off ({card})")
    bf16 = torch.bfloat16
    model = two_view_xfmamba("small", seed=0)
    # the default packs each block's kernel operands at every forward; the
    # timed runs below keep them (pack_for_inference), as the model once did
    one_study_forward(model, 1, bf16, ONE_STUDY[1], "XFMamba-S bfloat16, packed per forward",
                      card)
    model.pack_for_inference()
    main = one_study_forward(model, 1, bf16, ONE_STUDY[1], "XFMamba-S bfloat16", card, True)
    one_study_forward(model, 2, bf16, ONE_STUDY[2], "XFMamba-S bfloat16", card)
    one_study_forward(model, 1, torch.float32, F32_ONE_STUDY, "XFMamba-S float32", card)
    del model
    base = two_view_xfmamba("base", seed=0).pack_for_inference()
    one_study_forward(base, 1, bf16, ONE_STUDY[1], "XFMamba-B bfloat16", card)
    one_study_forward(base, 32, bf16, {"vss_stage": 4, "nk_scan": 2, "nk_scan_x": 1},
                      "XFMamba-B bfloat16", card)
    del base
    return main


def phase_v1_cpu_parity():
    """XFMamba-S widths at depths (2, 2, 2, 2), 1 study, float32 through the
    bfloat16 route's kernels (kernel 1 at stages 0-1, kernel 8 at stages
    2-3, kernel 9 for both fusion scans), card against the CPU plain twins:
    logits within 1e-3 of the largest."""
    print("phase 5b: XFMamba-S widths at depths (2, 2, 2, 2), 1 study: the bfloat16 route's "
          "kernels (1, 8, 9) in float32, card vs CPU plain twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    route = vssm._uses_stage_route
    vssm._uses_stage_route = lambda dtype: True
    try:
        model = depth2_model("small").eval()
        xa, xb = (x.cpu().float() for x in views(1, torch.float32, 9))
        fns = all_kernels()
        with torch.no_grad():
            t0 = time.time()
            want = model(xa, xb)
            cpu_s = time.time() - t0
            model.cuda()
            counts = counted(fns)
            got = model(xa.cuda(), xb.cuda()).cpu()
            launches = {n: c for n, c in counts().items() if c}
    finally:
        vssm._uses_stage_route = route
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max())
    expect = {"vss_stage": 2, "vss_block_v1": 4, "nk_scan_v1": 3}
    print(f"  card {got.tolist()} cpu {want.tolist()} max_abs_err={err:.3e} tol={tol:.3e} "
          f"(cpu forward {cpu_s:.1f} s); launches {launches}")
    if launches != expect or not err <= tol:
        raise PhaseFailure(f"the v1 route on the card disagrees with the CPU plain path, or its "
                           f"launches {launches} differ from {expect}")


def phase_cross_n1_layer():
    """A Cross_SS2Dv5 layer with d_state 1 at XFMamba-S's width (d 768,
    d_inner 1536), 7 x 7, 2 studies, in training mode: forward and
    backward, kernel 10 through ``core_dispatch`` (its backward recomputes
    through kernels 13 and 14) on the card against the CPU plain twins;
    each output and gradient within 1e-3 of its largest magnitude."""
    print("phase 8d: Cross_SS2Dv5(768, d_state=1) at 7x7, 2 studies, float32, training mode, "
          "forward and backward, card (kernel 10 via core_dispatch) vs CPU plain twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v, H, d = CROSS_N1["views"], CROSS_N1["H"], CROSS_N1["d"]
    layer = CrossSS2Dv5(d, d_state=1, generator=torch.Generator().manual_seed(31)).train()
    g = torch.Generator().manual_seed(32)
    x, x2, gy = (torch.randn(v, H, H, d, generator=g) for _ in range(3))
    fns = {n: k["fn"] for n, k in (V1_KERNELS | GROUPED_KERNELS).items()}
    results = []
    for device in ("cpu", "cuda"):
        layer.to(device).zero_grad()
        leaves = [t.clone().to(device).requires_grad_() for t in (x, x2)]
        counts = counted(fns)
        t0 = time.time()
        y = layer(*leaves)
        y.backward(gy.to(device))
        launches = {n: c for n, c in counts().items() if c}
        results.append([y.detach().cpu().clone()] + [t.grad.cpu().clone() for t in leaves]
                       + [p.grad.cpu().clone() for p in layer.parameters()])
        print(f"  {device}: {time.time() - t0:.2f} s, launches {launches}")
    worst = max(rel(a, b)[1] for a, b in zip(results[1], results[0]))
    print(f"  {len(results[0])} outputs and gradients, worst relative error {worst:.3e}, tol 1e-03")
    expect = {"fused_cross_scan": 1, "selective_scan_grouped_fwd": 4,
              "selective_scan_grouped_bwd": 4}
    if launches != expect or not worst <= 1e-3:
        raise PhaseFailure(f"the d_state-1 Cross_SS2Dv5 layer on the card disagrees with the CPU "
                           f"plain path, or its launches {launches} differ from {expect}")
    return launches["fused_cross_scan"]


def phase_ssd_past_limits(errors, card):
    """The SSD scan at d_state 128 and head width 64 (the gate admits it,
    the kernels take 64 and 32): kernels 15 and 16, tiled (2 width slices x
    2 d_state tiles), against the untiled plain twins in both dtypes; then
    an m0 SS2D layer of that geometry (d_model 96, ssm_ratio 4, 28 x 28,
    batch 2), forward and backward, card against the CPU plain twins."""
    print(f"phase 9e: the SSD kernels past their limits, d_state 128, head width 64 ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(33)
    failed = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            R, P, N, L = 6, 64, 128, 784
            args = (randn(g, 2, 4, L, R, P, dtype=dtype), randn(g, 2, 4, L, R, dtype=dtype) - 4.0,
                    -torch.exp(1.5 * torch.rand(4 * R, generator=g)).cuda(),
                    randn(g, 2, 4, L, N, dtype=dtype), randn(g, 2, 4, L, N, dtype=dtype),
                    randn(g, 4 * R, P), randn(g, 4 * R, scale=0.5), None)
            counts = counted({n: k["fn"] for n, k in SSD_KERNELS.items()})
            got = ssd_chunk.ssd_fwd_tiled(*args, save_states=True)
            want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
            check_outputs(errors, "ssd_chunk_fwd", f"tiled L={L} R={R} P={P} N={N}", dtype,
                          got, want, failed)
            dy = randn(g, *args[0].shape)
            check_outputs(errors, "ssd_chunk_bwd", f"tiled L={L} R={R} P={P} N={N}", dtype,
                          ssd_chunk.ssd_bwd_tiled(*args[:7], want[2], dy),
                          ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy), failed)
            torch.cuda.synchronize()
            launches = counts()
            if launches != {"ssd_chunk_fwd": 4, "ssd_chunk_bwd": 4}:
                failed.append(("launches", launches))
    if failed:
        raise PhaseFailure(f"the tiled SSD kernels disagree with the untiled plain twins: {failed}")
    layer = SS2D(96, d_state=128, ssm_ratio=4.0, forward_type="m0_noz", act="gelu",
                 initialize="v2", conv_bias=False, generator=torch.Generator().manual_seed(34))
    x, gy = torch.randn(2, 28, 28, 96, generator=g), torch.randn(2, 28, 28, 96, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        layer.to(device).zero_grad()
        xl = x.clone().to(device).requires_grad_()
        counts = counted({n: k["fn"] for n, k in SSD_KERNELS.items()})
        y = layer(xl)
        y.backward(gy.to(device))
        launches = counts()
        results.append([y.detach().cpu().clone(), xl.grad.cpu().clone()]
                       + [p.grad.cpu().clone() for p in layer.parameters()])
    worst = max(rel(a, b)[1] for a, b in zip(results[1], results[0]))
    print(f"  m0 SS2D(96, d_state=128, ssm_ratio=4) at 28x28, batch 2: {len(results[0])} outputs "
          f"and gradients, worst relative error {worst:.3e}, tol 1e-03; launches {launches}")
    if launches != {"ssd_chunk_fwd": 4, "ssd_chunk_bwd": 4} or not worst <= 1e-3:
        raise PhaseFailure("the m0 SS2D layer past the kernel limits disagrees with the CPU plain "
                           "path, or did not launch kernels 15 and 16 four times each")


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
        reset_routes()
        model(*inputs[32])
        torch.cuda.synchronize()
        routes = read_routes()
    blocks = sum(depth for _, _, depth in STAGES["small"])
    check_routes("bs-32 forward", routes, {
        "gemm_tc": FWD_GEMMS * blocks, "gemm_simt": 0, "cross2d_scan": blocks,
        "fusion_scan": KERNELS["nk_scan"]["per_forward"] + KERNELS["nk_scan_x"]["per_forward"],
        "serial_scan": 0})
    ROUTES["vss_stage"] = routes
    with torch.no_grad():
        for kept in (False, True):
            if kept:
                model.pack_for_inference()
            for bs, (xa, xb) in inputs.items():
                samples = sorted(time_ms(lambda: model(xa, xb), 5) for _ in range(3))
                ms = samples[1]
                print(f"  bs {bs}{', pack_for_inference' if kept else ''}: {ms:.2f} ms per batch "
                      f"(median of 3 runs of 5: {', '.join(f'{s:.2f}' for s in samples)}), "
                      f"{1000 * bs / ms:.1f} two-view samples/s ({card})")
        fusion_scans_in_turns("bs 32, pack_for_inference", lambda: model(*inputs[32]), card)
    return {name: n // 2 for name, n in launches.items()}         # per forward


def fusion_scans_in_turns(label, fn, card, timer=None):
    """``fn`` (a forward or a step) with kernels 2 and 3 on their first
    design and on the new one, in turns; median of 3 runs of 5 calls
    (``timer``: another median)."""
    timer = timer or (lambda f: sorted(time_ms(f, 5) for _ in range(3))[1])
    t = in_turns({"first design": on_first_design(fn), "new": fn}, timer)
    print(f"  {label}, fusion scans on their first design / redesigned, in turns: "
          f"{t['first design']:.2f} / {t['new']:.2f} ms ({card})")


def phase_kernel_times(card):
    """Per-forward time of each kernel at batch 32 (sum over its calls in
    one forward), kernel and plain version on the same inputs."""
    print(f"phase 4b: kernel times per bs-32 forward, bfloat16, beside each kernel's bound "
          f"({card})")
    g = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    times = {}
    with torch.no_grad():
        cases = {"vss_stage": [stage_case(g, H, d, depth, 32, bf16)
                               for H, d, depth in STAGES["small"]],
                 "nk_scan": [shallow_case(g, 32, bf16)] * 2,
                 "nk_scan_x": [cross_case(g, 32, bf16)]}
        work = {"vss_stage": Work(), "nk_scan": nk_work(32, 49, 1536, 1, 16, bf16).times(2),
                "nk_scan_x": nk_work(96, 49, 1536, 4, 16, bf16, R=48)}
        for H, d, depth in STAGES["small"]:
            work["vss_stage"] += block_work(64, H, d, bf16, mlp=True).times(depth)
        clock = sm_clock_mhz()
        sfu = {"nk_scan": 2 * sfu_ms(32, 49, 1536, 1, 16, clock),
               "nk_scan_x": sfu_ms(96, 49, 1536, 4, 16, clock)}
        for name, group in cases.items():
            ms = sum(time_ms(lambda a=args, f=kernel: f(*a), 5) for args, kernel, _ in group)
            plain_ms = sum(time_ms(lambda a=args, f=plain: f(*a), 1) for args, _, plain in group)
            times[name] = (ms, plain_ms, *work[name].bound())
            extra = (f"   every product on the CUDA cores {work[name].simt_bound():.4f} ms   SFU "
                     f"time of the exponentials {sfu[name]:.4f} ms" if name in sfu else "")
            print(f"  {name:9s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms   bound "
                  f"{times[name][2]:.4f} ms ({times[name][3]}){extra}")
    return times


def phase_model_f32(model, card, phase="4c", name="XFMamba-S"):
    """Float32 inference: the composable blocks with kernel 11 (the stage
    kernels are bfloat16's), the fusion scans through kernels 2 and 3 (the
    grouped scan not at all), launch counts and ms per batch."""
    print(f"phase {phase}: {name} two-view 224x224 inference, float32 (composable blocks, "
          f"kernel 11), TF32 off for matmuls and cuDNN ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_forward = F32_FORWARD
    fns = {name: (N1_KERNELS | KERNELS | GROUPED_KERNELS)[name]["fn"] for name in per_forward}
    inputs = {bs: views(bs, torch.float32, 100 + bs) for bs in (8, 32)}
    with torch.no_grad():
        model(*inputs[8])                                  # warm-up
        torch.cuda.synchronize()
        for fn in fns.values():
            fn.launches = 0
        for bs, (xa, xb) in inputs.items():
            logits = model(xa, xb)
            torch.cuda.synchronize()
            if logits.shape != (bs, 2) or not torch.isfinite(logits).all():
                raise PhaseFailure(f"float32 bs {bs}: bad logits {tuple(logits.shape)}")
            print(f"  bs {bs}: logits finite, shape {tuple(logits.shape)}, "
                  f"first row {logits[0].tolist()}")
        launches = {name: fn.launches for name, fn in fns.items()}
        print(f"  launches over the two batches: {launches}")
        if launches != {name: 2 * n for name, n in per_forward.items()}:
            raise PhaseFailure(f"float32 launches {launches}, expected twice {per_forward}")
        for bs, (xa, xb) in inputs.items():
            samples = sorted(time_ms(lambda: model(xa, xb), 5) for _ in range(3))
            print(f"  bs {bs}: {samples[1]:.2f} ms per batch (median of 3 runs of 5: "
                  f"{', '.join(f'{v:.2f}' for v in samples)}), "
                  f"{1000 * bs / samples[1]:.1f} two-view samples/s ({card})")
        fusion_scans_in_turns("bs 32", lambda: model(*inputs[32]), card)
    return launches["ss2d_core_n1_fwd"] // 2                          # per forward


def serial_scan_args(x, xdbl, w_dt, A, Ds, bias):
    """Kernel 11's operands as the serial rank-form scan of ``csrc/nk_scan.cu``
    takes them (cross2d, N=1): the same function, one thread per chain."""
    n, H, W, D = x.shape
    R = w_dt.shape[1]
    xd = xdbl.view(n, H * W, 4, R + 2)
    return dict(u=x.view(n, H * W, D), Bs=xd[..., R:R + 1], Cs=xd[..., R + 1:R + 2],
                A=A.view(4, 1, D), bias=bias, Dsum=Ds.sum(0), kinds=nk_scan.CROSS2D_KINDS,
                H=H, W=W, ranks=xd[..., :R].contiguous(), w_dt=w_dt)


def three_launches(fn):
    """``fn`` with kernel 11's forward as three launches (pairs, carries,
    apply) at every map, also where its tile plan makes it one launch of
    thread-block clusters (``ss2d_core_n1.FUSE_TILES`` set to 0 around the
    call)."""
    def run():
        keep = ss2d_core_n1.FUSE_TILES
        ss2d_core_n1.FUSE_TILES = 0
        try:
            return fn()
        finally:
            ss2d_core_n1.FUSE_TILES = keep
    return run


def n1_fwd_calls(args, H, d, n):
    """Kernel 11's forward on ``args`` as the first design ("old"), on its
    tile plan ("new") and, where the plan makes it one cluster launch, as
    three launches ("three")."""
    calls = {"old": lambda: ss2d_core_n1.ss2d_core_n1_fwd_v1(*args),
             "new": lambda: ss2d_core_n1.ss2d_core_n1_fwd(*args)}
    if ss2d_core_n1.tile_plan(n, H, H, 2 * d).fused:
        calls["three"] = three_launches(calls["new"])
    return calls


def phase_n1_times(card):
    """Kernel 11 per float32 bs-32 forward (64 images, the stage shapes at
    their depths): the tile-parallel kernels against their plain twin (y
    and the checkpoints; the one-launch and three-launch routes bit for
    bit where the plan takes one launch), then against the first design
    (the chunked walk, ``ss2d_core_n1_fwd_v1``) in turns, old-new-new-old
    (old-new-three-three-new-old where both routes exist), by CUDA events
    and by CUDA-graph replay, per call per stage and per forward; beside
    the plain twin, the serial rank-form scan of the stage kernels on the
    same inputs, and the bound by both counts (the rank products on the
    tensor cores; every product on the CUDA cores)."""
    print(f"phase 4d: kernel 11 per float32 bs-32 forward: the tile-parallel kernels vs the "
          f"plain twin, vs the first design in turns (events, graph replay), the serial scan "
          f"(nk_scan.selective_scan_cuda) on the same inputs ({card})")
    g = torch.Generator().manual_seed(8)
    tot = dict.fromkeys(("new", "old", "three", "new_graph", "old_graph", "three_graph",
                         "plain", "serial"), 0.0)
    work = Work()
    failed = []
    with torch.no_grad():
        for H, d, depth in STAGES["small"]:
            args = n1_case(g, 64, H, d, torch.float32)
            serial = serial_scan_args(*args)
            calls = n1_fwd_calls(args, H, d, 64)
            ev = in_turns(calls, lambda fn: time_ms(fn, 5))
            gr = in_turns(calls, lambda fn: graph_ms(fn, 5))
            ev.setdefault("three", ev["new"])
            gr.setdefault("three", gr["new"])
            want, p_ms = timed_call(lambda: ss2d_core_n1.ss2d_core_n1_fwd_plain(*args))
            got = calls["new"]()
            check_outputs({}, "ss2d_core_n1_fwd", f"bs-32 forward H={H} D={2 * d}",
                          torch.float32, got, want, failed)
            route = ss2d_core_n1.tile_plan(64, H, H, 2 * d).key()
            if "three" in calls:
                three = calls["three"]()
                if not (torch.equal(got[0], three[0]) and torch.equal(got[1], three[1])):
                    failed.append(("ss2d_core_n1_fwd", f"H={H}", "float32",
                                   "one launch and three launches differ", float("nan")))
            s_ms = time_ms(lambda: nk_scan.selective_scan_cuda(**serial), 5)
            _, r = rel(nk_scan.selective_scan_cuda(**serial), want[0].view(serial["u"].shape))
            print(f"  H={H:2d} D={2 * d:4d} x{depth:2d} ({route}): per call new {ev['new']:8.3f} "
                  f"ms (device {gr['new']:.3f}), three launches {ev['three']:8.3f} ms (device "
                  f"{gr['three']:.3f}), first design {ev['old']:8.3f} ms (device "
                  f"{gr['old']:.3f}), plain {p_ms:9.3f} ms, serial {s_ms:8.3f} ms; serial vs "
                  f"plain rel {r:.2e}")
            if not r <= TOL[torch.float32]:
                raise PhaseFailure("the serial scan and kernel 11's plain twin disagree")
            for key, v in (("new", ev["new"]), ("old", ev["old"]), ("three", ev["three"]),
                           ("new_graph", gr["new"]), ("old_graph", gr["old"]),
                           ("three_graph", gr["three"]), ("plain", p_ms), ("serial", s_ms)):
                tot[key] += depth * v
            work += n1_work(64, H, 2 * d, -(-d // 16)).times(depth)
    if failed:
        raise PhaseFailure(f"kernel 11 disagrees with its plain twin: {failed}")
    bound_ms, bound_by = work.bound()
    print(f"  per forward: new {tot['new']:.3f} ms (device {tot['new_graph']:.3f}), three "
          f"launches at every map {tot['three']:.3f} ms (device {tot['three_graph']:.3f}), first "
          f"design {tot['old']:.3f} ms (device {tot['old_graph']:.3f}), plain "
          f"{tot['plain']:.3f} ms, serial {tot['serial']:.3f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}, {work.bytes / 1e9:.3f} GB), every product on the CUDA cores "
          f"{work.simt_bound():.4f} ms ({card})")
    V1_EXTRA["ss2d_core_n1_fwd"] = {
        "graph_ms": tot["new_graph"], "v1_ms": tot["old"], "v1_graph_ms": tot["old_graph"],
        "three_launch_ms": tot["three"], "three_launch_graph_ms": tot["three_graph"],
        "simt_bound_ms": work.simt_bound(), "serial_ms": tot["serial"]}
    return {"ss2d_core_n1_fwd": (tot["new"], tot["plain"], bound_ms, bound_by)}


def phase_cpu_parity(model, expect, phase="5", name="XFMamba-S"):
    """Float32 eval logits at batch 1, the model on the card (kernel 11,
    the fusion scans through kernel 9; ``expect`` the launches of that
    forward) against itself on the CPU (plain twins).  Leaves the model on
    the CPU."""
    print(f"phase {phase}: {name} float32 logits, card vs CPU plain path, batch 1; the float32 "
          "route: composable blocks, kernel 11 on the card, its plain twin on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xa, xb = views(1, torch.float32, 7)
    fns = all_kernels()
    with torch.no_grad():
        model.eval().cuda()
        counts = counted(fns)
        got = model(xa, xb).cpu()
        launches = {n: c for n, c in counts().items() if c}
        t0 = time.time()
        want = model.cpu()(xa.cpu(), xb.cpu())
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max())
    print(f"  card {got.tolist()}  cpu {want.tolist()}  max_abs_err={err:.3e} "
          f"tol={tol:.3e} (cpu forward {time.time() - t0:.1f} s); launches {launches}")
    if launches != expect or not err <= tol:
        raise PhaseFailure(f"{name} float32 logits on the card disagree with the CPU plain "
                           f"path, or its launches {launches} differ from {expect}")


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


def cross2d_case(g, n, H, d, dtype):
    """The stage maps' chunked cross2d scan operands (``ops/cross2d_scan.py``):
    u (n, L, 2d), the projection rows (n, L, 4R + 8) with R = ceil(d / 16),
    A in [-e^1.5, -1], deltas about softplus(-4 +- 1)."""
    D, R, L = 2 * d, -(-d // 16), H * H
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, 4 * R + 8, dtype=dtype),
            -torch.exp(1.5 * torch.rand(4, 1, D, generator=g)).cuda(),
            randn(g, 4, D, scale=0.5) - 4.0, randn(g, D), randn(g, 4, R, D, scale=R ** -0.5),
            H, H)


def cross2d_check(errors, g, n, H, d, dtype, failed):
    """The stage scan (y, checkpoints) and its adjoint (every output: du,
    dw_dt, dA, dbias, dDsum and the projections' gradient, rank, dB and dC
    columns) against their plain twins, counted under kernel 6; the
    adjoint bitwise equal over two runs and launching no GEMM."""
    args = cross2d_case(g, n, H, d, dtype)
    u, xdbl = args[:2]
    geo = f"H={H} d={d}"
    y, ck = cross2d_scan.cross2d_scan_plain(*args, checkpoints=True)
    check_outputs(errors, "vss_block_bwd", f"chunked scan {geo} (y, ck)", dtype,
                  cross2d_scan.cross2d_scan(*args, checkpoints=True), (y, ck), failed)
    gy = randn(g, *u.shape)
    dx = [torch.zeros(u.shape[0] * u.shape[1], xdbl.shape[-1], device="cuda") for _ in range(3)]
    gemms = (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches)
    got = cross2d_scan.cross2d_scan_bwd(*args, gy, ck, dx[0])
    again = cross2d_scan.cross2d_scan_bwd(*args, gy, ck, dx[2])
    if (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches) != gemms:
        failed.append(("vss_block_bwd", f"adjoint {geo}", str(dtype), "launched a GEMM",
                       float("nan")))
    if not (all(torch.equal(got[k], again[k]) for k in got) and torch.equal(dx[0], dx[2])):
        failed.append(("vss_block_bwd", f"adjoint {geo}", str(dtype), "two runs differ",
                       float("nan")))
    want = cross2d_scan.cross2d_scan_bwd_plain(*args, gy, ck, dx[1])
    want.pop("dz")                                  # the kernel keeps dz on chip
    check_outputs(errors, "vss_block_bwd", f"adjoint with rank gradients {geo}", dtype,
                  got | {"dxdbl": dx[0]}, want | {"dxdbl": dx[1]}, failed)


def block_grads(result):
    """`vss_block_bwd`'s (dx, gradients) as one dict."""
    dx, grads = result
    return dict(grads, dx=dx)


def stage_grads(result):
    """`stage_train_backward`'s (dx, per-block gradients) as one dict."""
    dx, grads = result
    return {f"{j}.{k}": v for j, gj in enumerate(grads) for k, v in gj.items()} | {"dx": dx}


def nk_bwd_case(g, n, K, dtype, size="small"):
    """Kernel 7's operands (u, dts, Bs, Cs, A, D, bias, gy, H, W, kinds);
    kernel 2's dts form takes the same without gy."""
    u, Bs, Cs, A, Dvec, bias = fusion_scan_operands(g, n, K, dtype, size)
    dts = randn(g, *u.shape[:2], K * u.shape[2], dtype=dtype, scale=0.5)
    H = FUSION[size]["H"]
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    return (u, dts, Bs, Cs, A, Dvec, bias, randn(g, *u.shape, dtype=dtype), H, H, kinds)


def phase_compare_train(errors, card):
    """The training kernels against their plain versions: XFMamba-S's in
    float32 and bfloat16, XFMamba-B's (kernels 2, 7, 11, 12 at its widths)
    in float32, and kernels 4-6 at XFMamba-B's widths in bfloat16.  Also, in float32 at each model's bs-16 step shapes,
    kernel 12's and kernel 11's times per step, and the nk pair's (kernels
    2 + 7) times at the fusion geometries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = 2 * COMPARE_TRAIN_BATCH
    print(f"phase 6: training kernels vs plain versions on the card, {COMPARE_TRAIN_BATCH} "
          f"images per view (kernels 2, 7, 11 and 12: the bs-{TRAIN_BATCH} step's shapes), "
          "TF32 off; tolerance relative to each output's largest magnitude; XFMamba-S in "
          "float32 and bfloat16, XFMamba-B in float32 and (kernels 4-6) bfloat16 "
          f"({card})")
    g = torch.Generator().manual_seed(3)
    failed = []
    times = {size: {} for size in STAGES}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            # XFMamba-B's widths (dims 128-1024, dt rank 8-64) in bfloat16,
            # the precision that runs kernels 4-6 on its path
            widths = STAGES["small"] + (STAGES["base"] if dtype == torch.bfloat16 else [])
            for H, d, _ in widths:
                geo = f"H={H} d={d}"
                cross2d_check(errors, g, 2 * TRAIN_BATCH, H, d, dtype, failed)
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
            for size in STAGES:
                compare_fusion(errors, g, dtype, failed, times[size], size)
                if size == "small" or dtype == torch.float32:
                    compare_n1(errors, g, dtype, failed, times[size], size)
        torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"training kernels disagree with their plain versions: {failed}")
    for size, t in times.items():
        for key, num, work in (("fwd", 11, t["work_fwd"]), ("bwd", 12, t["work"])):
            e = t[key]
            three = f", three launches at every map {e['three_ms']:.3f} ms (device " \
                f"{e['three_graph_ms']:.3f})" if key == "fwd" else ""
            print(f"  {MODEL_NAME[size]} kernel {num} per float32 bs-{TRAIN_BATCH} step: "
                  f"{e['ms']:.3f} ms (device {e['graph_ms']:.3f}){three}, the first design in "
                  f"turns {e['v1_ms']:.3f} ms (device {e['v1_graph_ms']:.3f}), plain "
                  f"{e['plain_ms']:.3f} ms; bound {work.bound()[0]:.4f} ms ({work.bound()[1]}, "
                  f"{work.bytes / 1e9:.3f} GB), every product on the CUDA cores "
                  f"{work.simt_bound():.4f} ms ({card})")
        for label, f_ms, b_ms, old_ms, g_ms, old_g_ms in t["nk"].values():
            print(f"  {MODEL_NAME[size]} nk pair at {label}: kernel 2 {f_ms:.3f} ms + kernel 7 "
                  f"{b_ms:.3f} ms per call (the serial adjoint in turns {old_ms:.3f} ms; device "
                  f"{g_ms:.3f} vs {old_g_ms:.3f} ms)")
        # per step: ShallowFuse's two K=1 calls and Cross_SS2Dv5's K=4 call
        # (XFMamba-B's K=4 call takes the grouped scan; its row is a comparison)
        per_step = {key: 2 * t["nk"][1][i] + t["nk"][4][i] for key, i in
                    (("ms", 2), ("serial_ms", 3), ("graph_ms", 4), ("serial_graph_ms", 5))}
        t["nk_step"] = per_step
        print(f"  {MODEL_NAME[size]} kernel 7 per float32 bs-{TRAIN_BATCH} step (2 K=1 + 1 K=4 "
              f"calls): {per_step['ms']:.3f} ms (serial adjoint {per_step['serial_ms']:.3f} ms), "
              f"device {per_step['graph_ms']:.3f} ms (serial {per_step['serial_graph_ms']:.3f} ms) "
              f"({card})")
    V1_EXTRA["nk_scan_bwd"] = {f"f32_step_{k}": v for k, v in times["small"]["nk_step"].items()}
    bound_ms, bound_by = times["small"]["work"].bound()
    e = times["small"]["bwd"]
    V1_EXTRA["ss2d_core_n1_bwd"] = {
        "graph_ms": e["graph_ms"], "v1_ms": e["v1_ms"], "v1_graph_ms": e["v1_graph_ms"],
        "simt_bound_ms": times["small"]["work"].simt_bound(),
        "base_step": {k: times["base"]["bwd"][k] for k in ("ms", "graph_ms", "v1_ms",
                                                            "v1_graph_ms")}}
    return {"ss2d_core_n1_bwd": (e["ms"], e["plain_ms"], bound_ms, bound_by)}, times


def compare_fusion(errors, g, dtype, failed, times, size):
    """Kernels 2 (the dts form that training runs) and 7 against their
    plain versions at the model's bs-16 fusion geometries, ShallowFuse's
    (B, 49, D) K=1 and Cross_SS2Dv5's (3B, 49, D) K=4: kernel 7 against its
    segment-checkpoint twin and the serial plain adjoint, every output, and
    bitwise equal over two runs; in float32 also each call's times
    (``times["nk"]``: kernel 2, kernel 7 and the serial adjoint in turns,
    CUDA events and CUDA-graph replay)."""
    D = FUSION[size]["D"]
    for K, bs in ((1, TRAIN_BATCH), (4, 3 * TRAIN_BATCH)):
        label = f"({bs},49,{D}) K={K} N=16"
        args = nk_bwd_case(g, bs, K, dtype, size)
        fwd_args = args[:7] + args[8:]
        y = nk_scan.nk_scan(*fwd_args)
        if not torch.equal(y, nk_scan.nk_scan(*fwd_args)):
            failed.append(("nk_scan", label, str(dtype), "two runs differ", float("nan")))
        check_outputs(errors, "nk_scan", f"{MODEL_NAME[size]} fusion scan {label}", dtype,
                      [y], [nk_scan.nk_scan_plain(*fwd_args)], failed)
        got = nk_scan_adjoint.nk_scan_bwd(*args)
        again = nk_scan_adjoint.nk_scan_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failed.append(("nk_scan_bwd", label, str(dtype), "two runs differ", float("nan")))
        check_outputs(errors, "nk_scan_bwd", f"{MODEL_NAME[size]} fusion adjoint {label}",
                      dtype, got, nk_scan_adjoint.nk_scan_bwd_segments_plain(*args), failed)
        check_outputs(errors, "nk_scan_bwd", f"{MODEL_NAME[size]} vs the serial plain {label}",
                      dtype, got, nk_scan_adjoint.nk_scan_bwd_plain(*args), failed)
        if dtype == torch.float32:
            calls = {"serial": lambda: nk_scan_adjoint.nk_scan_bwd_serial(*args),
                     "kernel": lambda: nk_scan_adjoint.nk_scan_bwd(*args)}
            ev = in_turns(calls, lambda fn: time_ms(fn, 3))
            gr = in_turns(calls, lambda fn: graph_ms(fn, 5))
            times.setdefault("nk", {})[K] = (
                label, time_ms(lambda: nk_scan.nk_scan(*fwd_args), 3), ev["kernel"],
                ev["serial"], gr["kernel"], gr["serial"])


def compare_n1(errors, g, dtype, failed, times, size):
    """Kernels 11 and 12 against their plain twins at the float32 step's
    shapes (2 x 16 images, every stage of the model), every output: y, the
    checkpoints, du, dxdbl, dw_dt, dbias, dA, dD (kernel 12 from the plain
    checkpoints); kernel 12 bitwise equal over two runs and launching no
    GEMM.  In float32 also each kernel's time per step (a stage's call
    times its depth), the new kernels and the first design in turns
    (old-new-new-old) by CUDA events and by CUDA-graph replay, and kernel
    12's work."""
    n = 2 * TRAIN_BATCH
    gemms = (primitives.gemm_simt_cuda, primitives.gemm_tc_cuda)
    for H, d, depth in STAGES[size]:
        args = n1_case(g, n, H, d, dtype)
        geo = f"{MODEL_NAME[size]} H={H} D={2 * d} R={-(-d // 16)}"
        (y, ck), f_plain_ms = timed_call(lambda: ss2d_core_n1.ss2d_core_n1_fwd_plain(*args))
        check_outputs(errors, "ss2d_core_n1_fwd", f"N=1 core ({n} images) {geo}", dtype,
                      ss2d_core_n1.ss2d_core_n1_fwd(*args), (y, ck), failed)
        gy = randn(g, *args[0].shape)
        before = [f.launches for f in gemms]
        got = ss2d_core_n1.ss2d_core_n1_bwd(*args, ck, gy)
        again = ss2d_core_n1.ss2d_core_n1_bwd(*args, ck, gy)
        if [f.launches for f in gemms] != before:
            failed.append(("ss2d_core_n1_bwd", geo, str(dtype), "launched a GEMM", float("nan")))
        if not all(torch.equal(got[k], again[k]) for k in got):
            failed.append(("ss2d_core_n1_bwd", geo, str(dtype), "two runs differ", float("nan")))
        want, plain_ms = timed_call(lambda: ss2d_core_n1.ss2d_core_n1_bwd_plain(*args, ck, gy))
        check_outputs(errors, "ss2d_core_n1_bwd", f"N=1 core backward ({n} images) {geo}",
                      dtype, got, want, failed)
        if dtype != torch.float32:
            continue
        fwd = n1_fwd_calls(args, H, d, n)
        bwd = {"old": lambda: ss2d_core_n1.ss2d_core_n1_bwd_v1(*args, ck, gy),
               "new": lambda: ss2d_core_n1.ss2d_core_n1_bwd(*args, ck, gy)}
        for key, calls, p_ms in (("fwd", fwd, f_plain_ms), ("bwd", bwd, plain_ms)):
            ev = in_turns(calls, lambda fn: time_ms(fn, 3))
            gr = in_turns(calls, lambda fn: graph_ms(fn, 3))
            ev.setdefault("three", ev["new"])
            gr.setdefault("three", gr["new"])
            acc = times.setdefault(key, dict.fromkeys(("ms", "plain_ms", "graph_ms", "v1_ms",
                                                       "v1_graph_ms", "three_ms",
                                                       "three_graph_ms"), 0.0))
            for k, v in (("ms", ev["new"]), ("plain_ms", p_ms), ("graph_ms", gr["new"]),
                         ("v1_ms", ev["old"]), ("v1_graph_ms", gr["old"]),
                         ("three_ms", ev["three"]), ("three_graph_ms", gr["three"])):
                acc[k] += depth * v
            three = f", three launches {ev['three']:.3f} ms (device {gr['three']:.3f})" \
                if "three" in calls else ""
            print(f"  kernel {11 if key == 'fwd' else 12} per call at {geo}: new {ev['new']:.3f} "
                  f"ms (device {gr['new']:.3f}){three}, first design {ev['old']:.3f} ms (device "
                  f"{gr['old']:.3f})")
        times.setdefault("work", Work())
        times["work"] += n1_work(n, H, 2 * d, -(-d // 16), backward=True).times(depth)
        times.setdefault("work_fwd", Work())
        times["work_fwd"] += n1_work(n, H, 2 * d, -(-d // 16)).times(depth)


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
        if i == TRAIN_STEPS - 1:
            reset_routes()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    routes = read_routes()
    launches = read_counts()
    print(f"  losses: {', '.join(f'{v:.6f}' for v in losses)}")
    print(f"  launches over the {TRAIN_STEPS} steps: {launches}")
    want = {name: k["per_step"] for name, k in TRAIN_KERNELS.items()} | {"nk_scan": 3}
    want["vss_block_train"] = 0
    bad = [(i, c) for i, c in enumerate(per_step) if c != want]
    if bad:
        raise PhaseFailure(f"training launches per step {bad[:2]}, expected {want}")
    blocks = want["vss_block_bwd"]
    print(f"  tensor-core GEMMs per step: {routes['gemm_tc']}, {RANK_GEMMS * blocks} fewer than "
          f"the first design's {(FWD_GEMMS + BWD_GEMMS + RANK_GEMMS) * blocks} (the rank gradients are the "
          "adjoint scan's)")
    # kernel 5's forward and kernel 6's recompute each scan every block
    check_routes("step", routes, {
        "gemm_tc": (FWD_GEMMS + BWD_GEMMS) * blocks, "gemm_simt": 0,
        "cross2d_scan": 2 * blocks, "cross2d_scan_bwd": blocks,
        "fusion_scan": want["nk_scan"], "serial_scan": 0, "serial_scan_bwd": 0})
    ROUTES["vss_stage_train"] = ROUTES["vss_block_bwd"] = routes
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise PhaseFailure(f"training loss not finite or not falling: {losses}")
    torch.cuda.reset_peak_memory_stats()
    samples = timed_steps(step, batch)
    print(f"  {samples[1]:.2f} ms per step (median of 3 runs of 3 steps: "
          f"{', '.join(f'{v:.2f}' for v in samples)}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    fusion_scans_in_turns("step", lambda: step(batch), card,
                          lambda f: timed_steps(lambda b: f(), batch)[1])
    model.mamba_feature_extrac.use_checkpoint = True
    reset_counts()
    reset_routes()
    step(batch)
    torch.cuda.synchronize()
    ck = read_counts()
    print(f"  use_checkpoint step launches: {ck}")
    # kernel 4 (the SS2D half's 3 GEMMs; the MLP half is torch's, under
    # the checkpoint), then kernel 6 with its recompute
    check_routes("use_checkpoint step", read_routes(), {
        "gemm_tc": (FWD_GEMMS - 2 + BWD_GEMMS) * blocks, "gemm_simt": 0,
        "cross2d_scan": 2 * blocks, "cross2d_scan_bwd": blocks})
    ROUTES["vss_block_train"] = read_routes()
    if (ck["vss_block_train"], ck["vss_block_bwd"], ck["vss_stage_train"]) != (21, 21, 0):
        raise PhaseFailure(f"use_checkpoint launches {ck}, expected vss_block_train 21, "
                           "vss_block_bwd 21")
    ck_samples = timed_steps(step, batch)
    print(f"  use_checkpoint: {ck_samples[1]:.2f} ms per step (median of 3 runs of 3 steps: "
          f"{', '.join(f'{v:.2f}' for v in ck_samples)})")
    # per step, each step's counts having been checked above
    return {name: ck[name] if name == "vss_block_train" else per_step[-1][name]
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
    works = {name: Work() for name in TRAIN_KERNELS}
    failed = []
    bf16 = torch.bfloat16

    def run(name, label, fn, plain, count=1, work=None):
        fn()                                               # warm-up
        got, ms = timed_call(fn, 3)
        want, plain_ms = timed_call(plain)
        check_outputs(errors, name, label, dtype, got, want, failed)
        if dtype == bf16:
            times[name][0] += count * ms
            times[name][1] += count * plain_ms
            works[name] += work.times(count)
        return got

    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            for H, d, depth in STAGES["small"]:
                geo = f"H={H} d={d}"
                (p,) = train_blocks(g, d, 1, dtype)
                x, m1 = randn(g, n, H * H, d, dtype=dtype), masks(g, n)
                gy = randn(g, n, H * H, d)
                run("vss_block_train", f"block forward {geo}",
                    lambda: [vss_block_train.vss_block_train(x, p, H, H, m1)],
                    lambda: [vss_block_train.vss_block_train_plain(x, p, H, H, m1)], depth,
                    block_work(n, H, d, bf16, mlp=False))
                run("vss_block_bwd", f"block backward {geo}",
                    lambda: block_grads(vss_block_train.vss_block_bwd(x, p, H, H, m1, gy)),
                    lambda: block_grads(vss_block_train.vss_block_bwd_plain(x, p, H, H, m1, gy)),
                    depth, block_work(n, H, d, bf16, mlp=False, backward=True))
                ps = train_blocks(g, d, depth, dtype)
                m1s, m2s = masks(g, depth, n), masks(g, depth, n)
                work = block_work(n, H, d, bf16, mlp=True).times(depth)
                work += Work().add(2 * depth * n * H * H * d * 2)     # saves x_j and mid_j
                _, xs, mids = run(
                    "vss_stage_train", f"stage forward {geo} depth {depth}",
                    lambda: vss_stage_train.vss_stage_train_forward(x, ps, H, H, m1s, m2s),
                    lambda: vss_stage_train.vss_stage_train_forward_plain(x, ps, H, H, m1s, m2s),
                    work=work)
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
                    lambda: nk_scan_adjoint.nk_scan_bwd_plain(*args), count,
                    nk_work(bs, 49, 1536, K, 16, bf16, backward=True))
    for name, (ms, plain_ms) in times.items():
        times[name] = (ms, plain_ms, *works[name].bound())
        print(f"  {name:15s} kernel {ms:10.3f} ms   plain {plain_ms:10.3f} ms   bound "
              f"{times[name][2]:.4f} ms ({times[name][3]})")
    if failed:
        raise PhaseFailure(f"training kernels disagree with their plain versions: {failed}")
    return times


def phase_old_vs_new(card):
    """The serial sequence (``vss_stage.SERIAL_OPS``: SIMT GEMMs, the serial
    scans), the first chunked design's (tensor-core GEMMs, its scans,
    ``cross2d_scan_v1``, and the rank gradients as 8 tensor-core GEMMs) and
    the new one (``CUDA_OPS``: the tile-parallel scans, the rank gradients
    inside the adjoint) on the same inputs, in turns (serial, first, new,
    new, first, serial), device time by CUDA-graph replay: kernel 1 per
    bs-32 bfloat16 forward (one block per stage at 64 images, counted depth
    times), kernels 4, 5 (its blocks' SS2D and MLP halves) and 6 per bs-16
    step (32 images); and the pieces alone: a block's five forward GEMMs
    and its scan per bs-32 forward, its adjoint scan with the rank
    gradients per bs-16 step.  The sequences' outputs agree within 5e-2.
    Returns {kernel: (serial ms, new ms)}."""
    print(f"phase 7e: the serial sequence (SIMT GEMMs, serial scans), the first chunked one (tensor-core GEMMs, "
          f"the first chunked scans) and the new one (the tile-parallel scans, the rank "
          f"gradients inside the adjoint), in turns, CUDA-graph replay, bfloat16 ({card})")
    g = torch.Generator().manual_seed(70)
    bf16 = torch.bfloat16
    v1 = SimpleNamespace(**vars(vss_stage.CUDA_OPS))
    v1.cross2d_scan, v1.cross2d_scan_bwd = cross2d_scan.cross2d_scan_v1, \
        cross2d_scan.cross2d_scan_bwd_v1
    seqs = {"old": vss_stage.SERIAL_OPS, "v1": v1, "new": vss_stage.CUDA_OPS}
    names = ("vss_stage", "vss_block_train", "vss_stage_train", "vss_block_bwd", "gemms", "scan",
             "adjoint")
    acc = {name: dict.fromkeys(seqs, 0.0) for name in names}
    worst = 0.0
    with torch.no_grad():
        for H, d, depth in STAGES["small"]:
            (x, (p,), _, _), _, _ = stage_case(g, H, d, 1, 32, bf16)
            (tp,) = train_blocks(g, d, 1, bf16)
            xt, m1, m2 = randn(g, 32, H * H, d, dtype=bf16), masks(g, 32), masks(g, 32)
            gy = randn(g, 32, H * H, d)
            calls = {
                "vss_stage": lambda ops: vss_block_body(x, p, H, H, ops),
                "vss_block_train": lambda ops: ss2d_half(xt, tp, H, H, ops, m1),
                "vss_stage_train": lambda ops: mlp_half(ss2d_half(xt, tp, H, H, ops, m1), tp,
                                                        ops, m2),
                "vss_block_bwd": lambda ops: vss_block_train.vss_block_bwd_body(
                    xt, tp, H, H, m1, gy, ops)[0]}
            # the pieces alone: a block's five forward GEMMs and its scan at
            # 64 images, its adjoint scan at 32 (the bs-16 step's)
            f = ss2d_half_fwd(x, p, H, H, vss_stage.CUDA_OPS)
            ft = ss2d_half_fwd(xt, tp, H, H, vss_stage.CUDA_OPS, m1, checkpoints=True)
            n, L, di = x.shape[0], H * H, 2 * d
            f1 = vss_stage.CUDA_OPS.gemm(f.x1, p.w_fc1, bias=p.b_fc1, gelu=True)
            gyt = randn(g, 32, L, di)
            dxd = torch.zeros(32 * L, ft.xdbl.shape[-1], device="cuda")
            calls |= {
                "gemms": lambda ops: [
                    ops.gemm(f.h1, p.w_in), ops.gemm(f.u.view(-1, di), p.w_xp),
                    ops.gemm(f.yn, p.w_out, residual=f.rows),
                    ops.gemm(f.x1, p.w_fc1, bias=p.b_fc1, gelu=True),
                    ops.gemm(f1, p.w_fc2, bias=p.b_fc2, residual=f.x1)][-1],
                "scan": lambda ops: ops.cross2d_scan(f.u.view(n, L, di), f.xdbl, p.A, p.b_dt,
                                                     p.Dsum, p.w_dt, H, H)[0],
                "adjoint": lambda ops: ops.cross2d_scan_bwd(
                    ft.u.view(32, L, di), ft.xdbl, tp.A, tp.b_dt, tp.Dsum, tp.w_dt, H, H, gyt,
                    ft.ck, dxd.zero_())["du"]}
            line = []
            for name, fn in calls.items():
                outs = {w: fn(ops) for w, ops in seqs.items()}
                worst = max(worst, rel(outs["new"], outs["old"])[1],
                            rel(outs["v1"], outs["new"])[1])
                ms = in_turns({w: lambda f=fn, o=ops: f(o) for w, ops in seqs.items()},
                              lambda call: graph_ms(call, 3))
                for which, v in ms.items():
                    acc[name][which] += depth * v
                line.append(f"{name} {ms['old']:.3f} / {ms['v1']:.3f} -> {ms['new']:.3f}")
            print(f"  H={H:2d} d={d:3d} x{depth:2d}, ms per block (serial / first -> new): "
                  f"{'; '.join(line)}")
    for name, t in acc.items():
        per = "bs-32 forward" if name in ("vss_stage", "gemms", "scan") else f"bs-{TRAIN_BATCH} step"
        print(f"  {name:15s} per {per}: serial {t['old']:.3f} ms, first {t['v1']:.3f} ms, new "
              f"{t['new']:.3f} ms ({t['v1'] / t['new']:.2f}x the first's) ({card})")
    print(f"  new vs old outputs: worst rel {worst:.3e} (tol 5e-02)")
    if not worst <= 5e-2:
        raise PhaseFailure(f"the new sequence disagrees with the serial one: rel {worst}")
    for key, name in (("ss2d_core_n1_fwd", "scan"), ("ss2d_core_n1_bwd", "adjoint")):
        V1_EXTRA.setdefault(key, {})["stage_bf16_graph_ms"] = {
            "v1": acc[name]["v1"], "new": acc[name]["new"]}
    return {name: (t["old"], t["new"]) for name, t in acc.items() if name in names[:4]}


def phase_profile(card):
    """torch.profiler by kernel name: the bs-16 bfloat16 train step (as
    ``python -m xfmamba_tpu_torch.train.profile``) and a bs-32 bfloat16
    forward, with the busy share; the float32 bs-16 step (TF32 off), and
    kernels 11 and 12 alone at its shapes (``--dtype float32 --n1``)."""
    print(f"phase 7f: profiles by kernel name ({card})")
    print_profile("bs-16 bfloat16 train step", *profile_calls(train_step_fn()), top=15)
    model = two_view_xfmamba("small", seed=0)
    xa, xb = views(32, torch.bfloat16, 32)
    with torch.no_grad():
        print_profile("bs-32 bfloat16 forward", *profile_calls(lambda: model(xa, xb)), top=12)
    del model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print_profile("bs-16 float32 train step", *profile_calls(train_step_fn(torch.float32)),
                  top=15)
    for backward in (False, True):
        print_profile(f"kernel {12 if backward else 11} per float32 bs-16 step",
                      *profile_calls(n1_calls_fn(backward)), top=8)


def phase_train_f32(card, size, phase, n1_times):
    """Float32 training at batch 16 through the composable blocks: kernel 11
    forward, kernel 12 backward, the fusion scans through kernels 2/7
    (XFMamba-S) or, for Cross_SS2Dv5, 13/14 (XFMamba-B, whose whole-map
    adjoint would not fit the TPU's VMEM rule); launch counts per step in
    both ``use_checkpoint`` modes, ms per step and peak memory, beside
    kernels 11 and 12's times per step from phase 6 (``n1_times``).
    Returns the launches per step without ``use_checkpoint``."""
    name = MODEL_NAME[size]
    print(f"phase {phase}: {name} training, batch {TRAIN_BATCH}, {IMAGE}x{IMAGE}, float32 "
          "activations and weights (composable blocks, kernels 11 and 12), Adam lr 1e-4 wd 1e-5, "
          f"TF32 off for matmuls and cuDNN ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = two_view_xfmamba(size, seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, multilabel=False)
    batch = train_batch(torch.float32)
    # the port's GEMMs too: kernel 12 takes its rank gradients inside, so
    # the float32 step launches neither GEMM kernel (the first design: 168 SIMT GEMMs)
    fns = {name: k["fn"]
           for name, k in (N1_KERNELS | TRAIN_KERNELS | KERNELS | GROUPED_KERNELS).items()} | {
        "gemm_simt": primitives.gemm_simt_cuda, "gemm_tc": primitives.gemm_tc_cuda}
    want = dict.fromkeys(fns, 0) | F32_STEP[size]

    def counted_step():
        for fn in fns.values():
            fn.launches = 0
        loss = float(step(batch)["loss"])
        torch.cuda.synchronize()
        return loss, {name: fn.launches for name, fn in fns.items()}

    losses = []
    for _ in range(F32_TRAIN_STEPS):
        loss, counts = counted_step()
        losses.append(loss)
        if counts != want:
            raise PhaseFailure(f"float32 launches per step {counts}, expected {want}")
    print(f"  losses: {', '.join(f'{v:.6f}' for v in losses)}; launches per step {want}")
    if not all(map(math.isfinite, losses)):
        raise PhaseFailure(f"float32 training loss not finite: {losses}")
    for checkpointed in (False, True):
        model.mamba_feature_extrac.use_checkpoint = checkpointed
        if checkpointed:
            loss, counts = counted_step()
            want_ck = want | {"ss2d_core_n1_fwd": 42}
            print(f"  use_checkpoint step: loss {loss:.6f}, launches {counts}")
            if counts != want_ck or not math.isfinite(loss):
                raise PhaseFailure(f"use_checkpoint launches {counts} (expected {want_ck}) "
                                   f"or loss {loss} not finite")
        torch.cuda.reset_peak_memory_stats()
        samples = timed_steps(step, batch)
        print(f"  {'use_checkpoint: ' if checkpointed else ''}{samples[1]:.2f} ms per step "
              f"(median of 3 runs of 3 steps: {', '.join(f'{v:.2f}' for v in samples)}); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
        if not checkpointed:
            fusion_scans_in_turns("step", lambda: step(batch), card,
                                  lambda f: timed_steps(lambda b: f(), batch)[1])
        if not checkpointed and size == "base":
            grouped_scan_in_turns(step, batch, card)
    print(f"  per step (phase 6, the same shapes): kernel 11 {n1_times['fwd']['ms']:.3f} ms, "
          f"kernel 12 {n1_times['bwd']['ms']:.3f} ms (its bound "
          f"{n1_times['work'].bound()[0]:.4f} ms)")
    del model, optimizer, step
    return want


def grouped_scan_in_turns(step, batch, card):
    """XFMamba-B's float32 step with kernels 13 and 14 on their first design
    and redesigned, in turns: wall ms per step (CUDA events, median of 3
    runs of 3 steps) and device ms per step (torch.profiler), kept for the
    kernels line."""
    def first():
        with first_design_grouped_scan():
            return step(batch)

    fns = {"first": first, "new": lambda: step(batch)}
    wall = in_turns(fns, lambda f: timed_steps(lambda b: f(), batch)[1])
    dev = {name: busy_share(f)[1] for name, f in fns.items()}
    print(f"  step, kernels 13 and 14 on their first design / redesigned, in turns: "
          f"{wall['first']:.2f} / {wall['new']:.2f} ms; on the device (torch.profiler) "
          f"{dev['first']:.3f} / {dev['new']:.3f} ms ({card})")
    V1_EXTRA["selective_scan_grouped_bwd"]["base_step"] = {
        "ms": wall["new"], "first_ms": wall["first"], "device_ms": dev["new"],
        "first_device_ms": dev["first"]}


def counted(fns):
    """Snapshot the launch counts of ``fns`` (name -> wrapper); the returned
    function gives each one's launches since the snapshot."""
    before = {name: fn.launches for name, fn in fns.items()}
    return lambda: {name: fn.launches - before[name] for name, fn in fns.items()}


def grad_errors(model, want):
    """The worst relative error of the model's gradients against ``want``,
    each tensor against its own largest magnitude, and its name."""
    worst, worst_key = 0.0, None
    for k, p in model.named_parameters():
        if k in want:
            _, r = rel(p.grad.cpu(), want[k])
            if r > worst:
                worst, worst_key = r, k
    return worst, worst_key


def depth2_model(size):
    """The model at full widths and depths (2, 2, 2, 2), on the CPU, with
    no drop path: the size at which the CPU plain path fits the run."""
    return TwoViewXFMamba(
        generator=torch.Generator().manual_seed(5), model_type=size,
        hidden_dim=1024 if size == "base" else 768, drop_path_rate=0.0,
        backbone_overrides=dict(depths=(2, 2, 2, 2), drop_path_rate=0.0))


def phase_train_cpu_parity(model, name, phase):
    """Float32 gradients of one train step at batch 2, the model (on the
    CPU, from `depth2_model`) on the card against the CPU plain twins; at
    batch 2 neither fusion scan has an aligned image group and both take
    kernels 13 and 14 (ShallowFuse one K=2 call, Cross_SS2Dv5 four)."""
    print(f"phase {phase}: float32 card vs CPU plain path, {name} widths at depths (2, 2, 2, 2): "
          "gradients of one train step at batch 2; composable blocks with kernels 11 and 12, "
          "fusion scans through kernels 13 and 14 on the card, their plain twins on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = {n: k["fn"] for n, k in (N1_KERNELS | KERNELS | GROUPED_KERNELS).items()}
    fns |= {"nk_scan_bwd": TRAIN_KERNELS["nk_scan_bwd"]["fn"]}
    model.train()
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
    counts = counted(fns)
    loss_c = torch.nn.functional.cross_entropy(model(xa.cuda(), xb.cuda()), label.cuda())
    loss_c.backward()
    loss_c = loss_c.detach()
    launches = {n: c for n, c in counts().items() if c}
    expect = {"ss2d_core_n1_fwd": 8, "ss2d_core_n1_bwd": 8, "selective_scan_grouped_fwd": 5,
              "selective_scan_grouped_bwd": 5}
    if launches != expect:
        raise PhaseFailure(f"batch-2 step launches {launches}, expected {expect}")
    # Batch 2: at batch 1 the BatchNorm ahead of ShallowFuse would remove
    # the per-sample mean that its squeeze-excitation averages, leaving
    # those weight gradients at rounding noise.  Each gradient is held to
    # 1e-3 of its own largest magnitude.
    worst, worst_key = grad_errors(model, want)
    print(f"  loss card {float(loss_c):.7f} cpu {float(loss):.7f}; {len(want)} gradients, "
          f"worst relative error {worst:.3e} ({worst_key}), tol 1e-03 "
          f"(cpu step {cpu_s:.1f} s); launches {launches}")
    if not (worst <= 1e-3 and abs(float(loss_c) - float(loss)) <= 1e-4):
        raise PhaseFailure(f"{name} float32 gradients on the card disagree with the CPU plain "
                           "path")


def phase_ss2d_layer():
    """An SS2D layer with d_state 16 (d_model 96, d_inner 192) at 56 x 56,
    batch 2, forward and backward, card against the CPU plain twins: its
    scan core takes kernels 13 and 14 through ``core_dispatch`` (the TPU
    rule gives no nk group at this map), one call per cross2d direction."""
    print("phase 8c: SS2D(d_model=96, d_state=16) at 56x56, batch 2, float32, forward and "
          "backward, card (kernels 13/14 via core_dispatch) vs CPU plain twins")
    layer = SS2D(96, d_state=16, generator=torch.Generator().manual_seed(10))
    g = torch.Generator().manual_seed(11)
    x, gy = torch.randn(2, 56, 56, 96, generator=g), torch.randn(2, 56, 56, 96, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        layer.to(device).zero_grad()
        xl = x.clone().to(device).requires_grad_()
        counts = counted({n: k["fn"] for n, k in GROUPED_KERNELS.items()})
        t0 = time.time()
        y = layer(xl)
        y.backward(gy.to(device))
        # copies: moving the layer to the card moves its CPU gradients with it
        results.append((y.detach().cpu().clone(), xl.grad.cpu().clone(),
                        {k: p.grad.cpu().clone() for k, p in layer.named_parameters()}))
        launches = counts()
        print(f"  {device}: {time.time() - t0:.2f} s, launches {launches}")
    (y_c, dx_c, gp_c), (y_g, dx_g, gp_g) = results
    errs = {"y": rel(y_g, y_c)[1], "dx": rel(dx_g, dx_c)[1]}
    errs |= {k: rel(gp_g[k], gp_c[k])[1] for k in gp_c}
    worst = max(errs, key=errs.get)
    print(f"  {len(errs)} outputs and gradients, worst relative error {errs[worst]:.3e} "
          f"({worst}), tol 1e-03")
    if launches != {"selective_scan_grouped_fwd": 4, "selective_scan_grouped_bwd": 4} or \
            not errs[worst] <= 1e-3:
        raise PhaseFailure("the SS2D layer on the card disagrees with the CPU plain path, or "
                           "did not launch kernels 13 and 14 four times each")


# ---------------------------------------------------------------------------
# the Mamba-2 (m0 / SSD) classifiers: kernels 15 and 16
# ---------------------------------------------------------------------------

def ssd_case(g, b, L, d, dtype):
    """Kernel 15/16 operands at an m2 stage of width d on b images: K = 4
    groups of R = ceil(d / 16) heads of width 16, N = 64; A in [-e^1.5, -1]
    per head and dt about softplus(-4 +- 1), as in a trained model; D, the
    dt bias and an initial state present."""
    R, h = -(-d // 16), 4 * -(-d // 16)
    return (randn(g, b, 4, L, R, 16, dtype=dtype), randn(g, b, 4, L, R, dtype=dtype) - 4.0,
            -torch.exp(1.5 * torch.rand(h, generator=g)).cuda(),
            randn(g, b, 4, L, 64, dtype=dtype), randn(g, b, 4, L, 64, dtype=dtype),
            randn(g, h, 16), randn(g, h, scale=0.5), randn(g, b, h, 64, 16))


def ssd_pass_worst(errors, args, dy, dfin):
    """Each kernel pass of 15 and 16 against its plain pass on the same
    inputs (each pass fed the plain result of the pass before it), every
    output within its largest plain magnitude: {pass: worst relative
    error}."""
    x, dt, A, Bm, Cm, D, bias, init = args
    sc = ssd_chunk
    worst = {}

    def check(name, got, want):
        got = got.values() if isinstance(got, dict) else got
        want = want.values() if isinstance(want, dict) else want
        for gt, w in zip(got, want):
            err, r = rel(gt, w)
            errors[name] = max(errors.get(name, 0.0), err)
            worst[name] = max(worst.get(name, 0.0), r)

    local = sc.ssd_chunk_states_plain(x, dt, A, Bm, bias)
    check("states", sc.ssd_chunk_states(x, dt, A, Bm, bias), local)
    states = sc.ssd_state_pass_plain(*local, init)
    check("state_pass", sc.ssd_state_pass(local[0].clone(), local[1], init), states)
    check("scan", [sc.ssd_chunk_scan(x, dt, A, Bm, Cm, D, bias, states[0])],
          [sc.ssd_chunk_scan_plain(x, dt, A, Bm, Cm, D, bias, states[0])])
    q = sc.ssd_chunk_states_plain(dy, dt, A, Cm, bias, adjoint=True)
    check("states_adjoint", sc.ssd_chunk_states(dy, dt, A, Cm, bias, adjoint=True), q)
    ds = sc.ssd_state_pass_plain(*q, dfin, reverse=True)
    check("state_pass_reverse", sc.ssd_state_pass(q[0].clone(), q[1], dfin, reverse=True), ds)
    check("grads", sc.ssd_chunk_grads(x, dt, A, Bm, Cm, D, bias, states[0], ds[0], dy),
          sc.ssd_chunk_grads_plain(x, dt, A, Bm, Cm, D, bias, states[0], ds[0], dy))
    return worst


def ssd_calls(args, batch_dy, which, train):
    """{"new", "serial", "plain"} -> a call of kernel 15 (``which`` "fwd",
    with checkpoints where ``train``) or 16 ("bwd", from kernel 15's
    checkpoints), and {pass: call} for the new kernel's passes alone."""
    sc = ssd_chunk
    x, dt, A, Bm, Cm, D, bias, init = args
    if which == "fwd":
        calls = {"new": lambda: sc.ssd_fwd(*args, save_states=train),
                 "serial": lambda: sc.ssd_fwd_serial(*args, save_states=train),
                 "plain": lambda: sc.ssd_fwd_plain(*args, save_states=train)}
        local, decay = sc.ssd_chunk_states(x, dt, A, Bm, bias)
        buf = local.clone()
        states = sc.ssd_state_pass(local, decay, init)[0]
        return calls, {"states": lambda: sc.ssd_chunk_states(x, dt, A, Bm, bias),
                       "state_pass": lambda: sc.ssd_state_pass(buf, decay, init),
                       "scan": lambda: sc.ssd_chunk_scan(x, dt, A, Bm, Cm, D, bias, states)}
    states = sc.ssd_fwd(*args, save_states=True)[2]
    dy = batch_dy
    calls = {"new": lambda: sc.ssd_bwd(*args[:7], states, dy),
             "serial": lambda: sc.ssd_bwd_serial(*args[:7], states, dy),
             "plain": lambda: sc.ssd_bwd_plain(*args[:7], states, dy)}
    q, decay = sc.ssd_chunk_states(dy, dt, A, Cm, bias, adjoint=True)
    buf = q.clone()
    ds = sc.ssd_state_pass(q, decay, None, reverse=True)[0]
    return calls, {"states_adjoint": lambda: sc.ssd_chunk_states(dy, dt, A, Cm, bias,
                                                                adjoint=True),
                   "state_pass_reverse": lambda: sc.ssd_state_pass(buf, decay, None, reverse=True),
                   "grads": lambda: sc.ssd_chunk_grads(x, dt, A, Bm, Cm, D, bias, states, ds, dy)}


# phase 9's timed runs: (name, dtype, batch, kernel, checkpoints, per)
SSD_TIMED = [("ssd_chunk_fwd", torch.float32, 32, "fwd", False, "bs-32 forward"),
             ("ssd_chunk_fwd_train", torch.float32, TRAIN_BATCH, "fwd", True,
              f"bs-{TRAIN_BATCH} step"),
             ("ssd_chunk_bwd", torch.float32, TRAIN_BATCH, "bwd", True, f"bs-{TRAIN_BATCH} step"),
             ("ssd_chunk_fwd_bf16", torch.bfloat16, 32, "fwd", False, "bs-32 forward")]


def phase_compare_ssd(errors, card):
    """Kernels 15 (inference and with checkpoints: y, the final state, the
    checkpoints) and 16 (every output, from the plain checkpoints) against
    their plain twins at the four stage geometries of vmamba_small_m2 and
    vmamba_base_m2, batch 8, float32 and bfloat16, and each of their
    passes against its plain pass; then the chunk-parallel kernels against
    the serial ones (``ssd_fwd_serial`` / ``ssd_bwd_serial``) on the same
    inputs, device time by CUDA-graph replay in turns (serial, new, new,
    serial) and CUDA events around the calls: kernel 15 per
    bs-32 vmamba_small_m2 forward in float32 and bfloat16 and with
    checkpoints per bs-16 step, kernel 16 per bs-16 step (a stage's call
    times its depth), beside the plain twins, the bounds (tensor-core
    products) and the bounds with every product on the CUDA cores, and the
    new kernels' passes alone (device time).  Returns (times, extra): the
    kernels line's (event ms, plain ms, bound ms, bound by) and, per
    kernel, both kernels' device and event times and the passes'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 9: kernels 15 and 16 and their passes vs their plain twins at the m2 stage "
          f"geometries, batch {COMPARE_BATCH}, TF32 off; then the chunk-parallel kernels vs the "
          f"serial ones per vmamba_small_m2 forward (bs 32) and step (bs {TRAIN_BATCH}) ({card})")
    g = torch.Generator().manual_seed(12)
    failed = []
    with torch.no_grad():
        for size in ("small", "base"):
            for dtype in (torch.float32, torch.bfloat16):
                for H, d, _ in M2_STAGES[size]:
                    args = ssd_case(g, COMPARE_BATCH, H * H, d, dtype)
                    label = f"{M2_NAME[size]} L={H * H} KR={4 * -(-d // 16)}"
                    y, fin, states = ssd_chunk.ssd_fwd(*args, save_states=True)
                    y_i, fin_i = ssd_chunk.ssd_fwd(*args)
                    want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
                    check_outputs(errors, "ssd_chunk_fwd", label, dtype,
                                  [y, fin, states, y_i, fin_i], list(want) + list(want[:2]),
                                  failed)
                    dy = randn(g, *args[0].shape)
                    dfin = randn(g, *args[7].shape)
                    check_outputs(errors, "ssd_chunk_bwd", label, dtype,
                                  ssd_chunk.ssd_bwd(*args[:7], want[2], dy, dfin),
                                  ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy, dfin), failed)
                    worst = ssd_pass_worst(errors, args, dy, dfin)
                    bad = [n for n, r in worst.items() if not r <= TOL[dtype]]
                    failed += [("pass", n, label, str(dtype), worst[n]) for n in bad]
                    print(f"    passes: {', '.join(f'{n} {r:.1e}' for n, r in worst.items())} "
                          f"{'OK' if not bad else 'FAIL'}")
                    del args, y, fin, states, want
        torch.cuda.synchronize()
        if failed:
            raise PhaseFailure(f"kernels 15/16 disagree with their plain twins: {failed}")
        times, extra = {}, {}
        for name, dtype, batch, which, train, per in SSD_TIMED:
            acc = {k: 0.0 for k in ("new", "serial", "graph_new", "graph_serial", "plain")}
            passes = {}
            work = Work()
            for H, d, depth in M2_STAGES["small"]:
                args = ssd_case(g, batch, H * H, d, dtype)
                dy = randn(g, *args[0].shape)
                calls, pass_calls = ssd_calls(args, dy, which, train)
                dev = {"new": 0.0, "serial": 0.0}
                for w in ("serial", "new", "new", "serial"):
                    dev[w] += graph_ms(calls[w], 3) / 2
                for w in ("new", "serial"):
                    acc["graph_" + w] += depth * dev[w]
                    acc[w] += depth * time_ms(calls[w], 3)
                acc["plain"] += depth * time_ms(calls["plain"], 1, warmup=False)
                stage_passes = {n: graph_ms(fn, 3) for n, fn in pass_calls.items()}
                for pname, ms in stage_passes.items():
                    passes[pname] = passes.get(pname, 0.0) + depth * ms
                print(f"    L={H * H:4d} x{depth:2d}, device ms per call: new {dev['new']:.4f} "
                      f"(passes {', '.join(f'{v:.4f}' for v in stage_passes.values())}), "
                      f"serial {dev['serial']:.4f}")
                work += ssd_work(batch, H * H, -(-d // 16), dtype, backward=which == "bwd",
                                 states=train).times(depth)
                del args, dy, calls, pass_calls
            bound, by = work.bound()
            times[name] = (acc["new"], acc["plain"], bound, by)
            extra[name] = dict(ms=acc["new"], serial_ms=acc["serial"], graph_ms=acc["graph_new"],
                               serial_graph_ms=acc["graph_serial"], plain_ms=acc["plain"],
                               bound_ms=bound, bound_by=by, simt_bound_ms=work.simt_bound(),
                               passes_graph_ms=passes)
            print(f"  {name:19s} per {per} ({str(dtype)[6:]}): device (graph) new "
                  f"{acc['graph_new']:8.3f} ms, serial {acc['graph_serial']:8.3f} ms "
                  f"({acc['graph_serial'] / acc['graph_new']:.2f}x); events new {acc['new']:8.3f} "
                  f"ms, serial {acc['serial']:8.3f} ms; plain {acc['plain']:9.3f} ms; bound "
                  f"{bound:.4f} ms ({by}; every product on the CUDA cores "
                  f"{work.simt_bound():.4f} ms; {work.bytes / 1e9:.3f} GB, "
                  f"{sum(work.ops.values()) / 1e9:.1f} GFLOP) ({card})")
            print(f"    passes (device): {', '.join(f'{n} {v:.3f} ms' for n, v in passes.items())}")
        step = {k: extra["ssd_chunk_fwd_train"][k] + extra["ssd_chunk_bwd"][k]
                for k in ("graph_ms", "serial_graph_ms")}
        print(f"  kernels 15 + 16 per bs-{TRAIN_BATCH} float32 step (device): new "
              f"{step['graph_ms']:.3f} ms, serial {step['serial_graph_ms']:.3f} ms ({card})")
    return times, extra


def ssd_extra_line(name, extra):
    """The kernels line's extra keys of kernels 15 and 16: the serial
    kernel's time in the same run, the bound with every product on the CUDA
    cores, the passes' times, and kernel 15's other timed runs."""
    if name not in ("ssd_chunk_fwd", "ssd_chunk_bwd"):
        return {}
    e = extra[name]
    line = {k: e[k] for k in ("serial_ms", "graph_ms", "serial_graph_ms", "simt_bound_ms",
                              "passes_graph_ms")}
    if name == "ssd_chunk_fwd":
        line["runs"] = {run: extra[run] for run in ("ssd_chunk_fwd_train", "ssd_chunk_fwd_bf16")}
    return line


def kernel_table():
    """Every kernel of the port by name, in the order of the kernels line."""
    return (KERNELS | TRAIN_KERNELS | N1_KERNELS | GROUPED_KERNELS | SSD_KERNELS | V1_KERNELS
            | ABLATION_KERNELS)


def all_kernels():
    """Every kernel wrapper of the port by name."""
    return {n: k["fn"] for n, k in kernel_table().items()}


def images(batch, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, IMAGE, IMAGE, 3, generator=g).to("cuda", dtype)


def phase_m2_inference(card):
    """vmamba_small_m2 (seeded weights, 1000 classes) float32 inference at
    bs 8 and 32: finite logits, 18 launches of kernel 15 per forward and
    none of any other kernel, ms per batch (median of 3 runs of 5); then one
    bs-8 bfloat16 forward, which takes the same composable route (kernel
    15, no stage kernel)."""
    print(f"phase 9b: vmamba_small_m2 224x224 inference, float32, seeded weights, TF32 off "
          f"({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vmamba_small_m2(seed=0)
    fns = all_kernels()
    want = dict.fromkeys(fns, 0) | {"ssd_chunk_fwd": M2_BLOCKS}
    inputs = {bs: images(bs, torch.float32, 200 + bs) for bs in (8, 32)}
    with torch.no_grad():
        model(inputs[8])                                   # warm-up
        torch.cuda.synchronize()
        for bs, x in inputs.items():
            counts, pass_counts = counted(fns), counted(ssd_chunk.PASSES)
            logits = model(x)
            torch.cuda.synchronize()
            launches, passes = counts(), pass_counts()
            if logits.shape != (bs, 1000) or not torch.isfinite(logits).all() or \
                    launches != want or passes != M2_FORWARD_PASSES:
                raise PhaseFailure(f"bs {bs}: logits {tuple(logits.shape)} or launches "
                                   f"{launches} / passes {passes}, expected {want} / "
                                   f"{M2_FORWARD_PASSES}")
            print(f"  bs {bs}: logits finite, shape {tuple(logits.shape)}, first row [:4] "
                  f"{logits[0, :4].tolist()}; launches per forward: ssd_chunk_fwd "
                  f"{launches['ssd_chunk_fwd']} (passes {passes}), every other kernel 0")
        ROUTES["ssd_chunk_fwd"] = passes
        for bs, x in inputs.items():
            samples = sorted(time_ms(lambda: model(x), 5) for _ in range(3))
            print(f"  bs {bs}: {samples[1]:.2f} ms per batch (median of 3 runs of 5: "
                  f"{', '.join(f'{v:.2f}' for v in samples)}), {1000 * bs / samples[1]:.1f} "
                  f"images/s ({card})")
        counts, pass_counts = counted(fns), counted(ssd_chunk.PASSES)
        logits = model(images(8, torch.bfloat16, 208))
        torch.cuda.synchronize()
        launches, passes = counts(), pass_counts()
    print(f"  bfloat16 bs 8: logits finite {bool(torch.isfinite(logits.float()).all())}, "
          f"launches ssd_chunk_fwd {launches['ssd_chunk_fwd']} (passes {passes}), vss_stage "
          f"{launches['vss_stage']}")
    if launches != want or passes != M2_FORWARD_PASSES or \
            not torch.isfinite(logits.float()).all():
        raise PhaseFailure(f"bfloat16 m2 forward: launches {launches}, expected {want}")
    return launches["ssd_chunk_fwd"]


def phase_m2_train(card):
    """vmamba_small_m2 float32 training at bs 16 through
    ``make_train_step(..., two_view=False)``: Adam lr 1e-4 wd 1e-5, labels
    from a seeded generator, 3 steps with 18 launches of kernel 15 (with
    checkpoints) and 18 of kernel 16 each and none of any other kernel, a
    finite loss; then ``use_checkpoint`` (non-reentrant
    ``torch.utils.checkpoint`` runs each block's forward again before its
    backward: 36 and 18); ms per step and peak memory in both modes."""
    print(f"phase 9c: vmamba_small_m2 training, batch {TRAIN_BATCH}, 224x224, float32, Adam "
          f"lr 1e-4 wd 1e-5, TF32 off ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vmamba_small_m2(seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, False, two_view=False)
    g = torch.Generator().manual_seed(21)
    batch = {"image1": images(TRAIN_BATCH, torch.float32, 216),
             "label": torch.randint(0, 1000, (TRAIN_BATCH,), generator=g).cuda()}
    fns = all_kernels()
    want = dict.fromkeys(fns, 0) | {"ssd_chunk_fwd": M2_BLOCKS, "ssd_chunk_bwd": M2_BLOCKS}

    def counted_step():
        counts, pass_counts = counted(fns), counted(ssd_chunk.PASSES)
        loss = float(step(batch)["loss"])
        torch.cuda.synchronize()
        return loss, counts(), pass_counts()

    losses = []
    for _ in range(M2_TRAIN_STEPS):
        loss, launches, passes = counted_step()
        losses.append(loss)
        if launches != want or passes != M2_STEP_PASSES or not math.isfinite(loss):
            raise PhaseFailure(f"m2 step: loss {loss}, launches {launches} / passes {passes}, "
                               f"expected {want} / {M2_STEP_PASSES}")
    ROUTES["ssd_chunk_bwd"] = passes
    print(f"  losses: {', '.join(f'{v:.6f}' for v in losses)}; launches per step: ssd_chunk_fwd "
          f"{M2_BLOCKS}, ssd_chunk_bwd {M2_BLOCKS} (passes {passes}), every other kernel 0")
    for checkpointed in (False, True):
        model.use_checkpoint = checkpointed
        if checkpointed:
            loss, launches, passes = counted_step()
            want_ck = want | {"ssd_chunk_fwd": 2 * M2_BLOCKS}
            passes_ck = M2_STEP_PASSES | {n: c + M2_FORWARD_PASSES[n]
                                          for n, c in M2_STEP_PASSES.items()}
            print(f"  use_checkpoint step: loss {loss:.6f}, launches ssd_chunk_fwd "
                  f"{launches['ssd_chunk_fwd']}, ssd_chunk_bwd {launches['ssd_chunk_bwd']} "
                  f"(passes {passes})")
            if launches != want_ck or passes != passes_ck or not math.isfinite(loss):
                raise PhaseFailure(f"use_checkpoint launches {launches} (expected {want_ck}) or "
                                   f"loss {loss} not finite")
        torch.cuda.reset_peak_memory_stats()
        samples = timed_steps(step, batch)
        print(f"  {'use_checkpoint: ' if checkpointed else ''}{samples[1]:.2f} ms per step "
              f"(median of 3 runs of 3 steps: {', '.join(f'{v:.2f}' for v in samples)}); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    del model, optimizer, step
    return M2_BLOCKS


def phase_m2_cpu_parity():
    """vmamba_small_m2 widths at depths 2/2/2/2, batch 2, float32, no drop
    path: eval logits (kernel 15, 8 launches) within 1e-3 of the largest
    logit, and the gradients of one train step (8 + 8 launches) each within
    1e-3 of its largest magnitude, card against the CPU plain twins."""
    print("phase 9d: vmamba_small_m2 widths at depths (2, 2, 2, 2), batch 2, float32: logits and "
          "one train step's gradients, card (kernels 15/16) vs CPU plain twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vmamba_small_m2(device="cpu", seed=5, depths=(2, 2, 2, 2), drop_path_rate=0.0)
    g = torch.Generator().manual_seed(22)
    x, label = torch.randn(2, IMAGE, IMAGE, 3, generator=g), torch.tensor([3, 7])
    fns = all_kernels()
    results = []
    for device in ("cpu", "cuda"):
        model.to(device).eval().zero_grad()
        t0 = time.time()
        counts = counted(fns)
        with torch.no_grad():
            logits = model(x.to(device)).cpu()
        model.train()
        loss = torch.nn.functional.cross_entropy(model(x.to(device)), label.to(device))
        loss.backward()
        launches = {n: c for n, c in counts().items() if c}
        results.append((logits, float(loss.detach()), {k: p.grad.cpu().clone()
                                              for k, p in model.named_parameters()}))
        print(f"  {device}: {time.time() - t0:.1f} s, launches {launches}")
    (l_c, loss_c, g_c), (l_g, loss_g, g_g) = results
    err = float((l_g - l_c).abs().max())
    tol = 1e-3 * float(l_c.abs().max())
    worst = max(g_c, key=lambda k: rel(g_g[k], g_c[k])[1])
    w_rel = rel(g_g[worst], g_c[worst])[1]
    print(f"  logits max_abs_err {err:.3e} (tol {tol:.3e}); loss card {loss_g:.7f} cpu "
          f"{loss_c:.7f}; {len(g_c)} gradients, worst relative error {w_rel:.3e} ({worst}), "
          "tol 1e-03")
    if launches != {"ssd_chunk_fwd": 16, "ssd_chunk_bwd": 8} or not err <= tol or \
            not w_rel <= 1e-3:
        raise PhaseFailure("vmamba_small_m2 on the card disagrees with the CPU plain path, or its "
                           f"launches {launches} differ from 16 / 8")


# ---------------------------------------------------------------------------
# kernels 17-21: the ablations behind JAX's switches
# ---------------------------------------------------------------------------

def phase_compare_nk_ablations(errors, card):
    """Kernels 17 and 18 against their plain twins and against kernel 2 on
    the same inputs at the fusion scans' shapes, float32 and bfloat16, TF32
    off; per call, each kernel's device time beside kernel 2's (`graph_ms`:
    at these sub-millisecond sizes the CUDA-event time of a call follows
    the host's speed), the CUDA-event times and the plain twins'.  Returns
    each kernel's (device ms, plain ms, bound) per bs-32 bfloat16 XFMamba-S
    forward (two ShallowFuse calls)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 10: kernels 17 (nk scan v4) and 18 (v3) vs their plain twins and kernel 2, "
          f"TF32 off ({card})")
    g = torch.Generator().manual_seed(45)
    kernels = {"nk_scan_v4": (nk_scan_v4.nk_scan_v4, nk_scan_v4.nk_scan_v4_plain),
               "nk_scan_v3": (nk_scan_wide.nk_scan_v3, nk_scan_wide.nk_scan_v3_plain)}
    failed, times = [], {}
    with torch.no_grad():
        for size, n, K, label in NK_ABLATION_CASES:
            D = FUSION[size]["D"]
            for dtype in (torch.float32, torch.bfloat16):
                args = v1_scan_case(g, n, K, dtype, size)
                k2 = nk_scan.nk_scan(*args)
                for name, (fn, plain) in kernels.items():
                    got = fn(*args, group=8)
                    check_outputs(errors, name, f"{label} ({n},49,{D}) K={K} vs plain, k2", dtype,
                                  [got, got], [plain(*args), k2], failed)
                calls = {"nk_scan": lambda: nk_scan.nk_scan(*args),
                         "nk_scan_v4": lambda: nk_scan_v4.nk_scan_v4(*args, group=8),
                         "nk_scan_v3": lambda: nk_scan_wide.nk_scan_v3(*args, group=8)}
                dev = {name: graph_ms(fn) for name, fn in calls.items()}
                wall = {name: time_ms(fn, 10) for name, fn in calls.items()}
                plain_ms = {name: time_ms(lambda f=plain: f(*args), 1, warmup=False)
                            for name, (_, plain) in kernels.items()}
                print(f"    {str(dtype)[6:]}: ms per call on the device (CUDA events): kernel 2 "
                      f"{dev['nk_scan']:.4f} ({wall['nk_scan']:.4f}), kernel 17 "
                      f"{dev['nk_scan_v4']:.4f} ({wall['nk_scan_v4']:.4f}), kernel 18 "
                      f"{dev['nk_scan_v3']:.4f} ({wall['nk_scan_v3']:.4f}); plain twins "
                      f"{plain_ms['nk_scan_v4']:.3f}, {plain_ms['nk_scan_v3']:.3f}")
                if (size, n, K, dtype) == ("small", 32, 1, torch.bfloat16):
                    for name in kernels:
                        times[name] = (2 * dev[name], 2 * plain_ms[name],
                                       *nk_work(n, 49, D, K, 16, dtype).times(2).bound())
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"kernels 17/18 disagree with their plain twins or kernel 2: {failed}")
    for name, (ms, plain_ms, bound_ms, bound_by) in times.items():
        print(f"  {name} per bs-32 bfloat16 XFMamba-S forward (2 ShallowFuse calls): {ms:.4f} ms "
              f"on the device, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return times


def set_switch(route):
    """Turn on the switch of ``route`` ("v4" or "v3") and the other off;
    "v2" turns both off."""
    for other, (module, flag, _) in NK_SWITCHES.items():
        setattr(module, flag, other == route)


def phase_nk_switches(card):
    """XFMamba-S with FUSED_V4, then FUSED_V3, on against both off: one
    bfloat16 forward at bs 32 and one float32 training step at bs 16 from
    the same weights and drop-path draws, launches counted around each;
    then ms per forward (5 forwards) and per step (3 steps), the three
    routes timed in turns, 3 rounds, medians.  Returns the switched
    kernels' launches per forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 10b: XFMamba-S with FUSED_V4 / FUSED_V3 on vs off: bfloat16 inference at bs 32, "
          f"one float32 training step at bs {TRAIN_BATCH} ({card})")
    model = two_view_xfmamba("small", seed=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    draws = model.dropout_generator.get_state()
    xa, xb = views(32, torch.bfloat16, 32)
    batch = train_batch(torch.float32)
    fns = all_kernels()
    routes = ("v2", "v4", "v3")
    main, ref = {}, None

    def forward():
        model.eval()
        with torch.no_grad():
            return model(xa, xb)

    def new_step():
        """A train step from the seeded weights and drop-path draws (each
        route's forward and step start from them)."""
        model.load_state_dict(state)
        model.dropout_generator.set_state(draws)
        optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
        return make_train_step(model, optimizer, multilabel=False)[0]

    try:
        for route in routes:
            set_switch(route)
            step = new_step()
            kernel = NK_SWITCHES[route][2] if route != "v2" else "nk_scan"
            want_fwd = {"vss_stage": 4, kernel: 2, "nk_scan_x": 1}
            want_step = {k: v for k, v in F32_STEP["small"].items() if k != "nk_scan"} | {kernel: 3}
            forward()                                      # warm-up
            torch.cuda.synchronize()
            counts = counted(fns)
            logits = forward().float()
            torch.cuda.synchronize()
            fwd = {n: c for n, c in counts().items() if c}
            counts = counted(fns)
            loss = float(step(batch)["loss"])
            torch.cuda.synchronize()
            stp = {n: c for n, c in counts().items() if c}
            if ref is None:
                ref = (logits, loss)
            err = float((logits - ref[0]).abs().max()) / float(ref[0].abs().max())
            loss_rel = abs(loss - ref[1]) / abs(ref[1])
            print(f"  {route}: forward launches {fwd}, logits vs switches off rel {err:.3e} (tol "
                  f"5e-02); step launches {stp}, loss {loss:.7f} (rel {loss_rel:.2e}, tol 1e-04)")
            if fwd != want_fwd or stp != want_step or not torch.isfinite(logits).all() or \
                    not err <= 5e-2 or not loss_rel <= 1e-4:
                raise PhaseFailure(f"route {route}: forward launches {fwd} (expected {want_fwd}), "
                                   f"step launches {stp} (expected {want_step}), logits rel {err}, "
                                   f"loss rel {loss_rel}")
            if route != "v2":
                main[kernel] = fwd[kernel]
        step = new_step()
        fwd_ms, step_ms = ({r: [] for r in routes} for _ in range(2))
        for _ in range(3):
            for route in routes:
                set_switch(route)
                fwd_ms[route].append(time_ms(forward, 5))
                step_ms[route].append(timed_steps(step, batch, runs=1)[0])
    finally:
        set_switch("v2")
    for route in routes:
        f, t = sorted(fwd_ms[route]), sorted(step_ms[route])
        print(f"  {route}: {f[1]:.2f} ms per bs-32 bfloat16 forward (runs "
              f"{', '.join(f'{v:.2f}' for v in f)}), {t[1]:.2f} ms per float32 bs-{TRAIN_BATCH} "
              f"step (runs {', '.join(f'{v:.2f}' for v in t)}) ({card})")
    del model, step
    return main


def library_ln(x, scale, bias, act):
    """The one-call yardstick: ``F.layer_norm`` (+ ``F.gelu``, a second
    call), parameters in x's dtype as a bfloat16 LayerNorm module holds
    them."""
    y = F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype))
    return F.gelu(y) if act else y


def patch_embed_on(pe, norm):
    """XFMamba-S's patch embed as ``scripts/ab_pe_fused.py`` builds it from
    ``PatchEmbedV2`` ``pe``'s weights: conv1, ``norm(h, layer, act=True)``,
    conv2, ``norm(h, layer, act=False)``."""
    m = pe._modules
    return lambda x: norm(m["5"](norm(m["0"](x), m["2"], True)), m["7"], False)


def phase_ln_kernels(errors, card):
    """Kernels 19-21 against their plain twins at `LN_CASES` in both dtypes;
    in bfloat16 at the patch embed's two norms, each kernel's ms beside its
    plain twin, its bound and the library call; then the patch embed built
    on kernel 19 and on kernels 20 / 21 against ``PatchEmbedV2`` (the main
    path: launches counted around one forward on 19 and one forward and
    backward on 20 / 21).  Returns (times, library ms, launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 10c: kernels 19-21 (LayerNorm + GELU) vs their plain twins and F.layer_norm, "
          f"TF32 off ({card})")
    g = torch.Generator().manual_seed(46)
    bf16 = torch.bfloat16
    names = ("ln_act_fused", "seg_ln_fwd", "seg_ln_bwd")
    acc = {name: dict(ms=0.0, plain=0.0, lib=0.0, work=Work()) for name in names}
    failed = []
    for dtype in (torch.float32, bf16):
        for shape, C, act in LN_CASES:
            x = randn(g, *shape, C, dtype=dtype, scale=2.0) + 0.5
            scale, bias = 1 + randn(g, C, scale=0.1), randn(g, C, scale=0.1)
            gy = randn(g, *shape, C, dtype=dtype)
            label = f"{tuple(shape) + (C,)} {'GELU' if act else 'no act'}"
            calls = {
                "ln_act_fused": (lambda: [pe_fused.ln_act_fused(x, scale, bias, act)],
                                 lambda: [pe_fused.ln_act_fused_plain(x, scale, bias, act)]),
                "seg_ln_fwd": (lambda: [seg_ln.seg_ln_fwd(x, scale, bias, act=act)],
                               lambda: [seg_ln.seg_ln_fwd_plain(x, scale, bias, act=act)]),
                "seg_ln_bwd": (lambda: seg_ln.seg_ln_bwd(x, scale, bias, gy, act=act),
                               lambda: seg_ln.seg_ln_bwd_plain(x, scale, bias, gy, act=act))}
            with torch.no_grad():
                for name, (fn, plain) in calls.items():
                    check_outputs(errors, name, label, dtype, fn(), plain(), failed)
            if dtype != bf16 or (shape, C, act) not in LN_CASES[:2]:
                continue
            rows = math.prod(shape)
            xl = x.detach().requires_grad_()
            sl, bl = (t.to(dtype).requires_grad_() for t in (scale, bias))
            y = library_ln(xl, sl, bl, act)
            lib = {"ln_act_fused": lambda: library_ln(x, scale, bias, act),
                   "seg_ln_fwd": lambda: library_ln(x, scale, bias, act),
                   "seg_ln_bwd": lambda: torch.autograd.grad(y, (xl, sl, bl), gy,
                                                             retain_graph=True)}
            for name, (fn, plain) in calls.items():
                a = acc[name]
                with torch.no_grad():
                    a["ms"] += time_ms(fn, 10)
                    a["plain"] += time_ms(plain, 1, warmup=False)
                a["lib"] += time_ms(lib[name], 10)
                a["work"] += ln_work(rows, C, dtype, act, backward=name == "seg_ln_bwd")
            del xl, sl, bl, y
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"kernels 19-21 disagree with their plain twins: {failed}")
    times, library = {}, {}
    for name, a in acc.items():
        times[name] = (a["ms"], a["plain"], *a["work"].bound())
        library[name] = a["lib"]
        print(f"  {name:12s} per bs-64 patch embed (bfloat16, its 2 norms): kernel {a['ms']:.4f} ms, "
              f"plain {a['plain']:.3f} ms, bound {times[name][2]:.4f} ms ({times[name][3]}), "
              f"library {a['lib']:.4f} ms (F.layer_norm + F.gelu{' backward' if 'bwd' in name else ''})")
    launches = phase_patch_embed(card)
    return times, library, launches


def phase_patch_embed(card):
    """XFMamba-S's patch embed at bs 64 two-view (128 images 224 x 224 x 3,
    bfloat16) from ``PatchEmbedV2``'s seeded weights: built on kernel 19,
    forward; built on kernels 20 / 21 (``seg_ln_act``), forward and backward;
    each against the module's own forward and gradients within 5e-2 of the
    largest magnitude.  Launches counted around the two runs; ms per
    forward (and per forward + backward) of each build."""
    bf16 = torch.bfloat16
    pe = PatchEmbedV2(3, 96, generator=torch.Generator().manual_seed(47)).cuda()
    x = images(PE_IMAGES, bf16, 48)
    gy = randn(torch.Generator().manual_seed(49), PE_IMAGES, 56, 56, 96, dtype=bf16)
    on19 = patch_embed_on(pe, lambda h, ln, act: pe_fused.ln_act_fused(h, ln.weight, ln.bias,
                                                                        act, ln.eps))
    on20 = patch_embed_on(pe, lambda h, ln, act: seg_ln.seg_ln_act(h, ln.weight, ln.bias,
                                                                   h.shape[-1], ln.eps, act))

    def grads(fn):
        pe.zero_grad()
        y = fn(x)
        y.backward(gy)
        return [y.detach()] + [p.grad.clone() for p in pe.parameters()]

    with torch.no_grad():
        want = pe(x)
        on19(x)                                            # warm-up
    grads(on20)
    torch.cuda.synchronize()
    counts = counted(all_kernels())
    with torch.no_grad():
        got = on19(x)
    got_b = grads(on20)
    torch.cuda.synchronize()
    launches = {n: c for n, c in counts().items() if c}
    want_b = grads(pe)
    err = rel(got, want)[1]
    err_b = max(rel(a, b)[1] for a, b in zip(got_b, want_b))
    with torch.no_grad():
        ms = {name: time_ms(lambda f=fn: f(x), 5) for name, fn in
              (("PatchEmbedV2", pe), ("on kernel 19", on19), ("on kernels 20", on20))}
    ms_b = {name: time_ms(lambda f=fn: grads(f), 3) for name, fn in
            (("PatchEmbedV2", pe), ("on kernels 20/21", on20))}
    print(f"  patch embed bs 64 two-view ({PE_IMAGES} x 224 x 224 x 3 -> 56 x 56 x 96, bfloat16): "
          f"launches {launches}; on kernel 19 vs PatchEmbedV2 rel {err:.3e}, on kernels 20/21 "
          f"output and {len(got_b) - 1} gradients worst rel {err_b:.3e} (tol 5e-02); ms per "
          f"forward {', '.join(f'{k} {v:.3f}' for k, v in ms.items())}; forward + backward "
          f"{', '.join(f'{k} {v:.3f}' for k, v in ms_b.items())} ({card})")
    want_launches = {"ln_act_fused": 2, "seg_ln_fwd": 2, "seg_ln_bwd": 2}
    if launches != want_launches or not err <= 5e-2 or not err_b <= 5e-2:
        raise PhaseFailure(f"the patch embed on kernels 19-21 disagrees with PatchEmbedV2 or its "
                           f"launches {launches} differ from {want_launches}")
    return launches


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
    phase_fusion_scans(errors, card)
    times = phase_compare_grouped(errors, card)
    times |= phase_compare_v1(errors, card)
    model = two_view_xfmamba("small", seed=0)
    launches = phase_model(model, card)
    times |= phase_kernel_times(card)
    launches["ss2d_core_n1_fwd"] = phase_model_f32(model, card)
    times |= phase_n1_times(card)
    phase_cpu_parity(model, F32_ONE_STUDY)
    del model
    base = two_view_xfmamba("base", seed=0)
    phase_model_f32(base, card, "4e", "XFMamba-B")
    del base
    one_study = phase_one_study(card)
    launches |= {name: one_study[name] for name in ("vss_block_v1", "nk_scan_v1")}
    phase_v1_cpu_parity()
    n1_bwd, train_times = phase_compare_train(errors, card)
    times |= n1_bwd
    # the two card routes of XFMamba-B's Cross_SS2Dv5 training scan, kernels only
    grouped_ms = times["selective_scan_grouped_fwd"][0] + times["selective_scan_grouped_bwd"][0]
    grouped_dev = sum(V1_EXTRA[name]["graph_ms"] for name in GROUPED_KERNELS)
    print(f"  XFMamba-B Cross_SS2Dv5 scan per bs-{TRAIN_BATCH} step: grouped scan (kernels 13 + "
          f"14, four K=1 calls each, phase 3b) {grouped_ms:.3f} ms ({grouped_dev:.3f} on the "
          f"device); nk pair (kernels 2 + 7, "
          f"one K=4 call each) {sum(train_times['base']['nk'][4][1:3]):.3f} ms (kernel 7's old "
          f"design: {train_times['base']['nk'][4][1] + train_times['base']['nk'][4][3]:.3f} ms)")
    launches |= phase_train(card)
    times |= phase_train_kernel_times(card, errors)
    serial = phase_old_vs_new(card)
    phase_profile(card)
    launches["ss2d_core_n1_bwd"] = \
        phase_train_f32(card, "small", "7c", train_times["small"])["ss2d_core_n1_bwd"]
    base_step = phase_train_f32(card, "base", "7d", train_times["base"])
    launches |= {name: base_step[name] for name in GROUPED_KERNELS}
    phase_train_cpu_parity(depth2_model("small"), "XFMamba-S", "8")
    base2 = depth2_model("base")
    phase_cpu_parity(base2, {"ss2d_core_n1_fwd": 8, "nk_scan_v1": 3}, "8b",
                     "XFMamba-B (depths 2/2/2/2)")
    phase_train_cpu_parity(base2, "XFMamba-B", "8b")
    del base2
    phase_ss2d_layer()
    launches["fused_cross_scan"] = phase_cross_n1_layer()
    ssd_times, ssd_extra = phase_compare_ssd(errors, card)
    times |= ssd_times
    launches["ssd_chunk_fwd"] = phase_m2_inference(card)
    launches["ssd_chunk_bwd"] = phase_m2_train(card)
    phase_m2_cpu_parity()
    phase_ssd_past_limits(errors, card)
    times |= phase_compare_nk_ablations(errors, card)
    launches |= phase_nk_switches(card)
    ln_times, library, ln_launches = phase_ln_kernels(errors, card)
    times |= ln_times
    launches |= ln_launches
    # library_ms: one PyTorch call computing the same function, where there
    # is one (kernels 19-21); none computes the scans
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
             launches=launches[name], max_abs_err=errors[name], ms=times[name][0],
             plain_ms=times[name][1], bound_ms=times[name][2], bound_by=times[name][3],
             library_ms=library.get(name))
        | ({"routes": ROUTES[name]} if name in ROUTES else {})
        | ({"serial_graph_ms": serial[name][0], "graph_ms": serial[name][1]} if name in serial
           else {})
        | ssd_extra_line(name, ssd_extra)
        | V1_EXTRA.get(name, {})
        for name, k in kernel_table().items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
