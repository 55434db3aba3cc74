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
   against the CPU plain twins; (9e) the SSD scan past one slab of a
   block (d_state 128, head width 64: a block per slab, 2 x 2, the slabs'
   parts summed), kernels 15/16 against the plain twins, and an m0 SS2D
   layer of that geometry, forward and backward, card against the CPU.

Single-study and unaligned-batch inference (kernels 8, 9 and 10):
3c. kernel 8 (the v1 whole block, one cooperative launch of
   ``csrc/vss_block_v1.cu``) against its plain twin at every stage map of
   XFMamba-S and XFMamba-B, 2 and 4 images, both dtypes, and one device
   launch per block (the nodes of a captured CUDA graph); per bs-1
   bfloat16 XFMamba-S forward (15 blocks at 14 x 14, 2 at 7 x 7, 2
   images) the old launch sequence
   (``vss_block_v1.vss_block_v1_sequence``) and the kernel in turns, by CUDA
   events and by CUDA-graph replay, with the kernel's phase times (its
   global-timer stamps); kernels 9 (the v1 nk scan) at ShallowFuse's (1,
   49, D) K=1 and Cross_SS2Dv5's (3, 49, D) K=4 N=16 shapes in both dtypes,
   and 10 (the cross2d core from projections) at the four stage maps for 2
   images, N=1 in both dtypes, and N=16, each against its plain twin, TF32
   off; with ms, plain ms and bound per forward (kernels 8 and 9 per bs-1
   bfloat16 forward) or step (kernel 10 at phase 8d's layer), kernel 9
   beside kernel 2 on the same inputs; then kernel 9 at 112 x 112 (K=4,
   N=16) and kernel 10 at 128 x 128 (N=1), past the maps whose parts fit
   in shared memory, against their plain twins, with the plan and the
   bands each took;
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
10. kernels 17 (the v4 nk scan) and 18 (v3) against
   their plain twins and against kernel 2 on the same inputs at XFMamba-S's
   ShallowFuse (32, 49, 1536) K=1 and Cross_SS2Dv5 training (48, 49, 1536)
   K=4 shapes and XFMamba-B's ShallowFuse (16, 49, 2048), N 16, both
   dtypes: bitwise over two runs, one device launch a call, no float32
   scratch allocated; device ms per call by graph replay of the new design,
   its first design (``csrc/nk_scan_ablations_v1.cu``, swapped in by
   `first_design_nk_ablations`) and kernel 2 in turns, the plain twins'
   times, the plan, a block's phase times and the build's registers;
10b. XFMamba-S with ``FUSED_V4``, then ``FUSED_V3``, on against both off:
   bfloat16 inference at bs 32 (2 launches of the switched kernel per
   forward, none of kernel 2; logits within 5e-2 of the largest) and one
   float32 training step at bs 16 from the same weights and drop-path
   draws (3 launches, none of kernel 2; the loss within 1e-4 relative), ms
   per forward and per step; the switches are restored whatever happens;
10c. kernels 19 (LayerNorm + GELU), 20 (the same function) and 21 (its
   backward), the staged streaming passes of ``csrc/ln_act.cu``, and their
   first design (``csrc/ln_act_v1.cu``) against the plain twins at the
   patch-embed and downsample geometries of a bs-64 two-view batch (128 x
   112 x 112 x 48 with GELU, 128 x 56 x 56 x 96, 128 x 28 x 28 x 192) and a
   ragged pixel count, both dtypes: bitwise over two runs, one device
   launch a forward and two a backward, the plan; timed in bfloat16, new
   and first design in turns, by CUDA-graph replay and by events, with a
   thread a pixel beside the plan's group, beside ``F.layer_norm`` (+
   ``F.gelu``: two calls) and its autograd backward, the bound, the build's
   registers and spills and the SASS instructions of each kernel; then
   XFMamba-S's patch
   embed at bs 64 two-view built from ``PatchEmbedV2``'s weights as the JAX
   A/B script builds it (conv1, LayerNorm + GELU, conv2, LayerNorm), once on
   kernel 19 (forward) and once on kernels 20 / 21 (forward and backward),
   against the module's own forward and gradients, bfloat16, 5e-2.

The CLIs (no new kernel; they run kernels 2, 3, 7, 11, 12 in float32 and 1,
2, 4-7 in bfloat16):
11. a synthetic MURA tree in a temporary directory (``tests/
   torch_mura_tree.py``: 64 train and 16 valid studies over two body
   parts, one patient each, balanced labels, 1-3 PNGs a study at 380-512 x
   300-512, filter types 0-4 row by row, every 11th image 8-bit RGB,
   palette or 16-bit gray); every PNG decoded through the native unfilter
   and its numpy twin (equal bytes), the decode rate on one host thread and
   the loader's feed rate (train transform at 224², 4 threads, then 4
   processes); two float32 epochs of XFMamba-S through ``cli.train.main``
   (bs 16): per epoch the losses, the val AUC, the epoch's seconds split
   into train (and of it the wait on the loader), eval, metrics and
   checkpoints, ms per step by CUDA events; launches per step ss2d_core_n1_fwd
   21, ss2d_core_n1_bwd 21, nk_scan 3, nk_scan_bwd 3 and per eval forward
   21 / nk_scan 2 / nk_scan_x 1, no other kernel; the files
   ``model_epoch_{0,1}.npz``, ``best.npz``, ``epoch_{0,1}/metrics.txt``,
   ``last.pt`` with their sizes; a one-epoch ``fit`` resumed from its
   ``last.pt`` against the CLI's two epochs (the batches' sample indices
   equal, epoch 2's train loss within 1e-3 relative); the npz round trips
   bitwise; one bfloat16 epoch (phase 7's launches per step);
   ``cli.infer_mura.main`` with ``best.npz`` (per-part and combined AUCs,
   ``auc_*.txt``); the directory is deleted.

Every model the CLIs name, and deep mutual learning (no new kernel):
12. (12a) kernels 1, 5, 6, 11 and 12 against their plain versions at
   XFMamba-T's block geometries (ssm_ratio 1: d_inner = d, 96-768), both
   dtypes, at its bs-32 forward's and bs-16 step's shapes, with their
   times per forward or step beside the plain versions and the bounds;
   XFMamba-T at full width (``two_view_xfmamba("tiny")``, depths
   2/2/8/2): bfloat16 and float32 bs-32 forwards, float32 and bfloat16
   bs-16 steps (a falling loss over 4 steps), launches by the wrappers
   (every other kernel none) and by CUDA-graph nodes (the port's kernels by
   source file against the route's, `card_routes`), ms per forward and
   step; its float32 logits and one step's gradients at depths 2/2/2/2,
   card against the CPU plain twins; (12b) the single-view, late-join and
   early-fusion tops at full width (VMamba-S s2l15 backbone): float32 and
   bfloat16 bs-32 forwards and float32 bs-16 steps the same way, float32
   logits at depths 2/2/2/2 card against CPU; (12c) ``cli.train_mutual``
   on phase 11's synthetic tree: XFMamba-T + XFMamba-S for 2 float32
   epochs, then 1 with ``--bf16 1``, then ``singleviewmamba`` +
   XFMamba-S for 1, each run's launches (counts set to 0 before it, read
   after: the models' steps summed per mutual step, nothing else), ms per
   mutual step, every best-ROC file read back into a fresh model; (12d)
   one ``cli.train`` epoch of ``singleviewmamba`` (one view) and
   ``cli.infer_mura`` with its ``best.npz``.

The other datasets (no new kernel):
13. (13a) synthetic trees in a temporary directory (``tests/
   torch_datasets_tree.py``), each about 10 steps an epoch at bs 16 and
   written from a few distinct images: CheXpert-v1.0-small (165 patients,
   baseline JPEGs of about 390 x 320, with the table's quirks), hip X-rays
   (195 image numbers, 4:2:0 JPEGs of about 640 x 512, every class in
   both folds), CBIS-DDSM (200 patients, 16-bit DICOMs of about 1,600 x
   1,000 with 8-bit ROI masks, implicit and explicit VR); the numpy
   encoder's JPEGs decoded by the
   port against the pixels its islow IDCT gives (16 at CheXpert's size,
   gray and YCbCr, restart intervals; two of 2,800 x 2,300, gray and
   4:2:0), the decode rate on one host thread; a 5,000 x 3,000 16-bit
   mammogram read from DICOM against the written array, ``load_view``
   with the NYU crop on it; the loader's feed at the CheXpert train
   transform (4 threads, 4 processes); (13b) two float32 epochs of
   XFMamba-S through ``cli.train --dataset chexpert`` (14 labels,
   multilabel; launches per step and per eval forward as phase 11),
   ``cli.infer_chexpert`` with its ``best.npz`` and, at 13 classes, with
   a seeded 13-class file, one ``cli.train_mutual --dataset chexpert``
   epoch (XFMamba-T + XFMamba-S, the summed steps' launches); (13c) one
   epoch of ``cli.train --dataset hipxray`` (3 classes: the val accuracy,
   as the reference reports no AUC there); (13d) one of ``cli.train
   --dataset ddsmxray``, then ``cli.infer_ddsm --crop 1 --overlay_pass 1``
   (both passes' AUCs); every val AUC (or hip's accuracy) must be finite;
   the directory is deleted.

The device pipeline and the utilities:
14. (14a) the device preprocessing kernel (``csrc/device_preprocess.cu``)
   against its plain version at bs 16: MURA's train and eval stage staged
   at 224, staged at 288 with image size 256 and crop 224, CheXpert's and
   CBIS-DDSM's stages; the values within 1e-5, the crop windows, flips,
   zero-fill masks and source indices bit for bit (ramps of the row and
   the column and a constant 255), bitwise over two runs; the bs-16 call's
   ms by CUDA events and graph replay, the plain version's, the bound;
   (14b) ``cli.train --device_preprocess 1`` for one epoch on a MURA, a hip
   X-ray, a CheXpert and a CBIS-DDSM tree (phase 11's launches plus 2 of
   the kernel a step and an eval forward), the hip loader's staged
   validation batch through ``eval_batch`` against the host eval transform
   (1e-6), loader-fed epochs of the float32 XFMamba-S step with the stage
   on and off in turns (4 loader threads: median step ms, loader wait,
   pairs/s), 4 steps with the stage on one batch of label 1 (a falling
   loss); (14c) ``cli.infer_mura --cal_flops 1`` on the card and the CPU
   (the same params and FLOPs), ``--gradcam 1`` (gradcam.npz), Grad-CAM at
   full widths, depths 2/2/2/2, batch 2 card against CPU (the stage-3
   gradients and the CAMs within 1e-3, no launch of kernels 3 or 9),
   bfloat16 CAMs finite with their largest difference from float32, the
   guard (a bfloat16 eval forward recording autograd, kernels 1, 8, 9 and 3
   given an operand that requires a gradient: each refused); (14d)
   ``utils.profiling.do_bench`` and ``trace`` of the kernel, and whether
   the trace holds its device events.  It prints ``phase 14: N s``.

Data parallelism (``xfmamba_tpu_torch/parallel``; no new kernel):
15. (15a) XFMamba-S float32 at 224x224 through ``driver.fit`` (one epoch
   of 3 steps at the global batch 16, then an eval pass of 12 pairs padded
   to a batch) in two gloo ranks sharing the card, against one rank alone
   from the same weights and batches: each step's loss and the ranks'
   logits, the eval pass's gathered logits and loss, the BN running
   statistics (1e-4), the parameters after 3 Adam steps (6e-4 at most, a
   near-zero Adam input can flip; 1e-6 in the mean), the ranks' weights
   bit for bit, each rank's launches per step (kernels 11 and 12 21 each),
   the ms of a step of each; (15b) ``cli.train`` in two ranks under
   torchrun's environment (gloo, both on card 0), one epoch on phase 11's
   tree: rank 0's files only, equal weights, a resume of rank 0's
   ``last.pt`` for epoch 1; at the same time (15c) ``cli.train_mutual
   --coordinator_address`` in an NCCL world of one.  It prints ``phase 15:
   N s``.

Vanilla VMamba and the other SS2D forward types (kernels 2, 7, 13, 14 at
new geometries):
16. (16a) vanilla VMamba-T (``vanilla_vmamba_tiny``: forward type v0,
   d_state 16, no MLP, PatchEmbedV1, PatchMerging2D; depths 2/2/9/2, dims
   96) at full width and depth, 224x224, seeded weights, float32
   inference at bs 8, 32 and 1: each forward's launches against the
   routing rule's (`vanilla_want`: kernel 13 at stage 0, kernel 2 at
   stages 1-3 at bs 8 and 32; kernel 13 alone at bs 1), ms per batch, and
   a bfloat16 bs-8 forward on the same route; (16b) its float32 training
   at bs 16, 5 steps on one batch (finite, falling loss), the rule's
   launches per step of kernels 2, 7, 13 and 14, ms per step and peak
   memory; (16c) its widths at depths 2/2/2/2, batch 2: logits and one
   step's gradients card against the CPU plain twins (1e-3); (16d) each
   other forward type (v2, v3, v051d, v052d, v052dc, d_state 1 for the
   unidi and bidi scans, every out-norm kind, ``_oact``, ``_nozact``,
   d_conv 1 / 2 / 4, xv1a / xv2a / xv3a with their conv tags) as one
   VSSBlock(96) on 2 images of 16 x 16, forward and backward, card against
   the CPU (1e-3), with the kernels its route names launched.  It prints
   ``phase 16: N s``.

The rest of the model surface (kernels 1, 4, 6, 8 without the MLP half;
kernels 15 and 16 over the whole SSD gate; kernels 2 / 7 for new callers):
17. (17a) VMamba-S s2l15's geometry with ``mlp_ratio`` 0, bfloat16: a bs-32
   forward on kernel 1 (4 launches), a bs-1 forward (kernel 1 at stage 0,
   kernel 8 at stages 1-3), a bs-16 step on kernels 4 -> 6 once a block,
   each against the rule's launches; kernel 1 (stage 0 at bs 32), kernel 8
   (bs 1, its phases up to out_proj + residual) and kernels 4 / 6 (bs 16)
   against their plain versions (5e-2) with times and bounds; (17b)
   vmamba_tiny_m2's geometry with forward type m0 (the z-gate), float32:
   a bs-32 forward and a bs-16 step (kernel 15 / 16 once a block), then
   an m0 SS2D(96) layer at 56 x 56, batch 2, with a carried state over two
   forwards, at d_state 128 / chunk 64, d_state 256 / chunk 128, head
   width 64 / chunk 32 and d_state 512 / head width 128: card against the
   CPU (1e-3), one launch of each kernel a call, and kernels 15 / 16 on its
   scan call against the plain twins (1e-3) with times and bounds; (17c)
   VMamba-T s2l5 with the gated SiLU MLP, post_norm, the position
   embedding, no patch norm and drop rates 0.1: float32 logits card against
   the CPU (1e-3), a bfloat16 forward and a bfloat16 bs-16 step with no
   stage kernel launched; (17d) CrossSS2Dv2 and CrossSS2Dv3 (768, d_state
   16) at 7 x 7, 16 studies, float32: output and every gradient card
   against the CPU (1e-3), kernels 2 / 7 (or 13 / 14) as `core_dispatch`
   routes them.  It prints ``phase 17: N s``.
18. the readers of every JPEG and PNG the JAX readers decode: (18a) the
   host library built with g++; the numpy encoders' progressive (Huffman
   and arithmetic-coded, 4:2:0 with restarts), arithmetic-coded sequential
   (DAC), lossless (8 bits predictor 7 with a point transform, 5 bits) JPEGs
   and Adam7 / 4-bit / 16-bit-colour PNGs at CheXpert's size (390 x 320)
   and at 2,800 x 2,300 (encoded in spawned worker processes while the
   earlier phases run) decode to the encoder's reconstruction (the islow
   IDCT of the final coefficients, or the written samples), each with its
   decode time on one host thread beside the baseline decoder's on the
   same image; cut, corrupt, short-of-Al-0, CMYK, YCCK and RGB files at
   390 x 320 decode to the SHA-256 digests tests/torch_codecs.py keeps
   (pinned to cv2 by tests/test_torch_jpeg_formats.py); (18b) one float32
   epoch of XFMamba-S through ``cli.train --dataset chexpert`` on a tree
   whose JPEGs are progressive, arithmetic-coded, truncated and CMYK, and
   one through ``cli.train --dataset mura`` on Adam7, 2- and 4-bit, 4-bit
   palette and 16-bit-colour PNGs: phase 11's launches per step and per
   eval forward, every loss and val AUC finite.  It prints ``phase 18: N
   s``.

``python3 chip_smoke.py --cards`` needs two cards or more and runs only
15a over every visible card (NCCL, one rank a card) against one rank, then
``cli.train`` started plainly, which starts one rank a card itself.

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
their first design's, the SFU time, and the bs-12 ShallowFuse call's (3b);
for kernels 17 and 18 per bs-32 bfloat16 forward their first design's and
kernel 2's device times, the SFU time and every geometry's times (10); for
kernels 19-21 per bs-64 patch embed their device times, their first
design's and a thread a pixel's, the plans and registers (10c); for every
kernel its launches in phase 12c's float32 mutual run
(``mutual_launches``), for kernels 1, 5, 6, 11 and 12 their times,
plain times and bounds at XFMamba-T's widths (``xfmamba_t``, 12a), and for
kernels 2, 7, 13 and 14 their launches per vanilla VMamba-T forward (bs 8,
32, 1, bfloat16 bs 8) and bs-16 step with the forward and step ms
(``vanilla_t``, 16a/16b), for kernels 1, 4, 6, 8, 15 and 16 phase 17's
launches and, for 1, 8, 15 and 16, the new geometries' errors, times,
plain times and bounds (``phase17``)),
the line before the last the card's name and power limit, the last
``{"ok": true, "device": {...}}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.ss2d import SS2D, XVMode
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba, two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import VSSBlock, vmamba_small_m2
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.fusion import CrossSS2Dv5
from xfmamba_tpu_torch.ops import (
    cross2d_scan, device_preprocess, fused_cross_scan, nk_scan, nk_scan_adjoint, nk_scan_v1,
    primitives, scan_whole_map, selective_scan_grouped, ss2d_core_n1, ssd_chunk, vss_block_train,
    vss_block_v1, vss_stage, vss_stage_train)
from xfmamba_tpu_torch.ops.ablations import (
    ablation_scan, nk_scan_v4, nk_scan_wide, pe_fused, seg_ln)
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
    "nk_scan_v1": dict(fn=nk_scan_v1.nk_scan_v1, source="xfmamba_tpu_torch/csrc/scan_whole_map.cu",
                       replaces="xfmamba_tpu/ops/vss_block_pallas.py:690"),
    "fused_cross_scan": dict(fn=fused_cross_scan.fused_cross_scan,
                             source="xfmamba_tpu_torch/csrc/scan_whole_map.cu",
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
# count that fills no whole block of kernel 21, and a pixel past the staged
# plan (the row path)
PE_IMAGES = 128
LN_NAMES = ("ln_act_fused", "seg_ln_fwd", "seg_ln_bwd")
LN_CASES = [((PE_IMAGES, 112, 112), 48, True), ((PE_IMAGES, 56, 56), 96, False),
            ((PE_IMAGES, 28, 28), 192, False), ((3, 37, 41), 48, True), ((2, 3, 5), 12289, True)]

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


def block_work(n, H, d, dtype, mlp, backward=False, ratio=2):
    """One VSSBlock (``mlp``) or its SS2D half on n images: the GEMMs, the
    LayerNorms, the conv + SiLU, GELU and the rank-form cross2d scan, reading
    x and the weights and writing the output; ``backward`` adds the
    gradient GEMMs (twice the forward's), the elementwise backwards and the
    adjoint scan, reads the float32 gradient and writes dx and the float32
    weight gradients.  ``ratio``: d_inner / d (1 for XFMamba-T)."""
    M, di, R, hd = n * H * H, ratio * d, -(-d // 16), 4 * d
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

def stage_case(g, H, d, depth, batch, dtype, ratio=2):
    blocks = [VSSBlock(d, ssm_ratio=ratio, generator=g).eval().cuda() for _ in range(depth)]
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


def n1_case(g, n, H, d, dtype, ratio=2):
    """Kernel 11's operands at a backbone stage on n images: x (n, H, H,
    ratio d), R = ceil(d / 16), the projections from `pack_n1_inputs`;
    deltas about softplus(-4 +- 1) and A in [-e^1.5, -1], as in a trained
    model."""
    D, R = ratio * d, -(-d // 16)
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


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h, CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver_call(status, what):
    if status != 0:
        raise PhaseFailure(f"{what}: CUDA driver error {status}")


def _node_name(cuda, node):
    """The name of a kernel node's kernel (mangled), from its CUfunction or
    its CUkernel."""
    params = _KernelNodeParams()
    _driver_call(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
                 "cuGraphKernelNodeGetParams")
    name = ctypes.c_char_p()
    if params.func and cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)) == 0:
        return name.value.decode()
    handle = params.kern or params.func
    _driver_call(cuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(handle)),
                 "cuKernelGetName")
    return name.value.decode()


def device_launches(fn, capture_error_mode="global"):
    """The card's launches in one call of ``fn``: {kernel name (mangled),
    "memcpy" or "memset": count}, read by the driver API from the nodes of a
    CUDA graph that captures one call after a warm-up call on the capture's
    stream (a wrapper's workspaces are kept per stream).  torch.profiler,
    which counted them before, drops every device event of about half of
    its short profiles once the port's kernel library is loaded (PERF.md
    section 7)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode=capture_error_mode):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _driver_call(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _driver_call(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    launches = {}
    for node in map(ctypes.c_void_p, nodes):
        kind = ctypes.c_int()
        _driver_call(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET; the rest launch nothing
        name = {0: None, 1: "memcpy", 2: "memset"}.get(kind.value, "")
        if name is None:
            name = _node_name(cuda, node)
        if name:
            launches[name] = launches.get(name, 0) + 1
    graph.reset()
    return launches


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


# kernel 9's timed geometries: (label, images, kinds, D); N 16, 7 x 7
WHOLE_MAP_K9 = [("XFMamba-S ShallowFuse bs 1", 1, 1, 1536),
                ("XFMamba-S Cross_SS2Dv5 bs 1", 3, 4, 1536),
                ("XFMamba-B ShallowFuse bs 1", 1, 1, 2048),
                ("XFMamba-B Cross_SS2Dv5 bs 1", 3, 4, 2048),
                ("XFMamba-S ShallowFuse bs 12", 12, 1, 1536),
                ("XFMamba-S Cross_SS2Dv5 bs 12", 36, 4, 1536)]


def k9_case(g, n, K, D, dtype, H=7, N=16):
    """Kernel 9's operands on (n, H * H, D), K kinds (row_f, or cross2d),
    N states: decays A in [-e^1.5, -1] and dt in [1e-3, 1e-1]."""
    L = H * H
    dt = torch.exp(torch.rand(K, D, generator=g) * 4.6 - 6.9)
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, K * D, dtype=dtype, scale=0.5),
            randn(g, n, L, K * N, dtype=dtype), randn(g, n, L, K * N, dtype=dtype),
            -torch.exp(1.5 * torch.rand(K * N, D, generator=g)).cuda(), randn(g, K, D),
            (dt + torch.log(-torch.expm1(-dt))).cuda(), H, H, kinds)


def kernel2_on(args):
    """Kernel 2 (``fusion_scan_cuda``, the redesigned fusion scan) on kernel 9's
    operands, uncounted by the wrappers' route."""
    u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds = args
    return lambda: nk_scan.fusion_scan_cuda(
        H=H, W=W, dts=dts.view(*u.shape[:2], len(kinds), u.shape[2]), out_dtype=u.dtype,
        **nk_scan._nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))


def ptxas_rows(log, *names):
    """[(kernel, registers, spill bytes stored + loaded)] of the build log's
    ``-Xptxas -v`` report for the kernels whose mangled name holds one of
    ``names``."""
    rows, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            current = fn if any(n in fn for n in names) else None
        elif current and "spill stores" in line:
            # "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
            stores, loads = (int(s.split()[0]) for s in line.split(",")[1:3])
            rows.append([current, None, stores + loads])
        elif current and "Used" in line and rows and rows[-1][0] == current:
            rows[-1][1] = int(line.split("Used")[1].split()[0])
            current = None
    return [tuple(r) for r in rows]


def split_ms(fn):
    """{device kernel name: ms per call} of ``fn`` under torch.profiler."""
    _, _, table = profile_calls(fn, calls=5, warmup=1)
    return {name: ms for ms, _, name in table}


@contextlib.contextmanager
def first_design_whole_map():
    """Kernels 9 and 10 on their first design while open: `nk_scan_v1` and
    `fused_cross_scan` run the two-level scan and its merge of
    ``csrc/scan_two_level.cu`` on the same operands (phase 3c's and 4f's
    old-against-new timings)."""
    new = nk_scan_v1.nk_scan_v1_cuda, fused_cross_scan.fused_cross_scan_cuda
    nk_scan_v1.nk_scan_v1_cuda = nk_scan_v1.nk_scan_v1_first
    fused_cross_scan.fused_cross_scan_cuda = fused_cross_scan._fused_cross_scan_first
    try:
        yield
    finally:
        nk_scan_v1.nk_scan_v1_cuda, fused_cross_scan.fused_cross_scan_cuda = new


@contextlib.contextmanager
def whole_map_slabs(slabs):
    """The whole-map scan's plan held to the slab widths ``slabs`` while
    open (the alternatives phase 3c times)."""
    old = scan_whole_map.SLABS
    scan_whole_map.SLABS = slabs
    scan_whole_map._plan.cache_clear()
    try:
        yield
    finally:
        scan_whole_map.SLABS = old
        scan_whole_map._plan.cache_clear()


def on_design(fn, manager):
    def run():
        with manager():
            return fn()
    return run


def phases_line(phases):
    return ", ".join(f"{k} {v / 1e3:.2f}" for k, v in phases.items())


def whole_map_check(name, label, dtype, fn, plain, failed):
    """``fn`` against its plain twin (TOL), bitwise over two runs, and one
    device launch a call of the whole-map scan; returns (max abs error,
    plan, its device launches)."""
    scan_whole_map.scan_whole_map_cuda.by_plan.clear()
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    rel_err = err / float(want.float().abs().max())
    same = torch.equal(got, again)
    plan = ", ".join(scan_whole_map.scan_whole_map_cuda.by_plan)
    launches = device_launches(fn)
    one = len(launches) == 1 and "whole_map_scan_kernel" in next(iter(launches)) \
        and next(iter(launches.values())) == 1.0
    ok = same and one and rel_err <= TOL[dtype] and bool(torch.isfinite(got).all())
    print(f"  {name} {label} {str(dtype)[6:]}: rel={rel_err:.2e} "
          f"{'bitwise' if same else 'two runs differ'}, {plan}, device launches a call "
          f"{list(launches.values()) if one else launches} {'OK' if ok else 'FAIL'}")
    if not ok:
        failed.append((name, label, str(dtype)))
    return err


def phase_whole_map_scans(errors, card):
    """Kernels 9 and 10 (``csrc/scan_whole_map.cu``), phase 3c's second
    part: at kernel 9's one-study and 12-study fusion calls of XFMamba-S and
    -B and kernel 10 at phase 8d's layer and at the 56 x 56 stage map (the
    chunked plan), and at 112 x 112 (kernel 9, K=4, N=16) and 128 x 128
    (kernel 10, N=1), whose parts do not fit at one channel (the banded
    plan), both dtypes: against their plain twins, bitwise over two runs,
    one device launch a call; then device ms per call by graph
    replay and by CUDA events of the new design, its first design
    (``csrc/scan_two_level.cu``, swapped in by `first_design_whole_map`)
    and, for kernel 9, kernel 2 on the same inputs, in turns; the bound,
    the exponentials' SFU time, the slab widths the plan did not take, and
    the registers and spills of the build log."""
    torch.backends.cuda.matmul.allow_tf32 = False
    clock = sm_clock_mhz()
    print(f"phase 3c (kernels 9 and 10): the whole-map scan against its plain twins, bitwise, "
          f"one launch a call; ms per call, device time by graph replay, new / first design / "
          f"kernel 2 in turns; SFU: the exponentials at {SFU_PER_SM_CLOCK} per SM per clock on "
          f"{SMS} SMs at {clock:.0f} MHz ({card})")
    _, log = build.build()
    for fn, regs, spills in ptxas_rows(log, "whole_map_scan_kernel", "two_level_scan_kernel"):
        print(f"  ptxas {fn[:90]}: {regs} registers, {spills} bytes spilled")
    g = torch.Generator().manual_seed(31)
    failed, rows = [], {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for label, n, K, D in WHOLE_MAP_K9:
                args = k9_case(g, n, K, D, dtype)
                new = lambda: nk_scan_v1.nk_scan_v1(*args)
                err = whole_map_check("kernel 9", f"{label} ({n},49,{D}) K={K}", dtype, new,
                                      lambda: nk_scan_v1.nk_scan_v1_plain(*args), failed)
                errors["nk_scan_v1"] = max(errors.get("nk_scan_v1", 0.0), err)
                calls = {"first": on_design(new, first_design_whole_map), "new": new,
                         "kernel 2": kernel2_on(args)}
                ev = in_turns(calls, lambda fn: time_ms(fn, 10))
                gr = in_turns(calls, lambda fn: graph_ms(fn, 20))
                alt = {s: graph_ms(on_design(new, lambda s=s: whole_map_slabs((s,))), 20)
                       for s in scan_whole_map.SLABS}
                bound, by = nk_work(n, 49, D, K, 16, dtype).bound()
                sfu = sfu_ms(n, 49, D, K, 16, clock)
                phases = nk_scan_v1.nk_scan_v1_cuda(*args, phase_ns=True)
                rows[(label, dtype)] = dict(graph_ms=gr["new"], first_graph_ms=gr["first"],
                                            kernel2_graph_ms=gr["kernel 2"], ms=ev["new"],
                                            first_ms=ev["first"], bound_ms=bound, sfu_ms=sfu,
                                            slab_graph_ms=alt, phases_us={
                                                k: v / 1e3 for k, v in phases.items()})
                print(f"    device {gr['new']:.4f} ms (first design {gr['first']:.4f}, kernel 2 "
                      f"{gr['kernel 2']:.4f}); events {ev['new']:.4f} (first {ev['first']:.4f}, "
                      f"kernel 2 {ev['kernel 2']:.4f}); bound {bound:.4f} ({by}), SFU time "
                      f"{sfu:.4f}; device at slabs "
                      + ", ".join(f"{s}: {v:.4f}" for s, v in alt.items())
                      + f"; a block's phases (us): {phases_line(phases)}")
            cases = [(3 * CROSS_N1["views"], CROSS_N1["H"], 2 * CROSS_N1["d"], 1),
                     (2, 56, 192, 1), (2, 56, 192, 16)]
            for n, H, D, N in cases:
                args = cross_case_n(g, n, H, D, N, dtype)
                new = lambda: fused_cross_scan.fused_cross_scan(*args)
                label = f"({n},{H},{H},{D}) N={N}"
                err = whole_map_check("kernel 10", label, dtype, new,
                                      lambda: fused_cross_scan.fused_cross_scan_plain(*args),
                                      failed)
                errors["fused_cross_scan"] = max(errors.get("fused_cross_scan", 0.0), err)
                calls = {"first": on_design(new, first_design_whole_map), "new": new}
                ev = in_turns(calls, lambda fn: time_ms(fn, 10))
                gr = in_turns(calls, lambda fn: graph_ms(fn, 20))
                alt = {} if H > 7 else {
                    s: graph_ms(on_design(new, lambda s=s: whole_map_slabs((s,))), 20)
                    for s in scan_whole_map.SLABS}
                bound, by = cross_work(n, H, H, D, N, dtype).bound()
                sfu = sfu_ms(n, H * H, D, 4, N, clock)
                phases = fused_cross_scan.fused_cross_scan_cuda(*args, phase_ns=True)
                rows[(label, dtype)] = dict(graph_ms=gr["new"], first_graph_ms=gr["first"],
                                            ms=ev["new"], first_ms=ev["first"], bound_ms=bound,
                                            sfu_ms=sfu, slab_graph_ms=alt, phases_us={
                                                k: v / 1e3 for k, v in phases.items()})
                print(f"    device {gr['new']:.4f} ms (first design {gr['first']:.4f}); events "
                      f"{ev['new']:.4f} (first {ev['first']:.4f}); bound {bound:.4f} ({by}), "
                      f"SFU time {sfu:.4f}; "
                      + "".join(f"device at slabs {s}: {v:.4f}; " for s, v in alt.items())
                      + f"a block's phases (us): {phases_line(phases)}")
            # maps whose parts do not fit at one channel: the banded plan
            for name, key, label, args, fn, plain in (
                    ("kernel 9", "nk_scan_v1", "(1,112x112,192) K=4 N=16",
                     k9_case(g, 1, 4, 192, dtype, H=112), nk_scan_v1.nk_scan_v1,
                     nk_scan_v1.nk_scan_v1_plain),
                    ("kernel 10", "fused_cross_scan", "(1,128,128,192) N=1",
                     cross_case_n(g, 1, 128, 192, 1, dtype), fused_cross_scan.fused_cross_scan,
                     fused_cross_scan.fused_cross_scan_plain)):
                err = whole_map_check(name, label, dtype, lambda: fn(*args), lambda: plain(*args),
                                      failed)
                errors[key] = max(errors.get(key, 0.0), err)
                print(f"    device {graph_ms(lambda: fn(*args), 3):.3f} ms a call (banded plan)")
    if failed:
        raise PhaseFailure(f"kernels 9 / 10 disagree with their plain twins, between runs or "
                           f"in their launches: {failed}")
    # per bs-1 bfloat16 XFMamba-S forward: two ShallowFuse calls, one Cross_SS2Dv5 call
    bf16 = torch.bfloat16
    shallow = rows[("XFMamba-S ShallowFuse bs 1", bf16)]
    cross = rows[("XFMamba-S Cross_SS2Dv5 bs 1", bf16)]
    fwd = {k: 2 * shallow[k] + cross[k] for k in ("graph_ms", "first_graph_ms",
                                                   "kernel2_graph_ms", "bound_ms", "sfu_ms")}
    k10 = rows[(f"({3 * CROSS_N1['views']},7,7,{2 * CROSS_N1['d']}) N=1", torch.float32)]
    print(f"  kernel 9 per bs-1 bfloat16 XFMamba-S forward (2 + 1 calls), device: "
          f"{fwd['graph_ms']:.4f} ms (first design {fwd['first_graph_ms']:.4f}, kernel 2 "
          f"{fwd['kernel2_graph_ms']:.4f}); bound {fwd['bound_ms']:.4f}, SFU time "
          f"{fwd['sfu_ms']:.4f} ({card})")
    print(f"  kernel 10 per step of phase 8d's layer, device: {k10['graph_ms']:.4f} ms (first "
          f"design {k10['first_graph_ms']:.4f}); bound {k10['bound_ms']:.4f}, SFU time "
          f"{k10['sfu_ms']:.4f} ({card})")
    V1_EXTRA["nk_scan_v1"] = fwd | {"per": "bs-1 bfloat16 XFMamba-S forward", "geometries": {
        f"{label} {str(dt)[6:]}": r for (label, dt), r in rows.items() if "bs" in label}}
    V1_EXTRA["fused_cross_scan"] = {k: k10[k] for k in ("graph_ms", "first_graph_ms", "sfu_ms")} \
        | {"per": "step of phase 8d's layer", "geometries": {
            f"{label} {str(dt)[6:]}": r for (label, dt), r in rows.items() if "N=" in label}}


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
    # the same forward with kernels 9 and 10 on their first design, in turns
    xa, xb = views(1, bf16, 301)
    fns = {"first": on_design(lambda: model(xa, xb), first_design_whole_map),
           "new": lambda: model(xa, xb)}
    runs = {name: [] for name in fns}
    with torch.no_grad():
        for name in ("first", "new", "new", "first"):
            runs[name].append(busy_share(fns[name]))
    mean = {name: [sum(v) / len(v) for v in zip(*r)] for name, r in runs.items()}
    print(f"  XFMamba-S bfloat16 bs 1, kernel 9 on its first design / redesigned, in turns: "
          f"device {mean['first'][1]:.3f} / {mean['new'][1]:.3f} ms, wall "
          f"{mean['first'][0]:.3f} / {mean['new'][0]:.3f} ms per forward (torch.profiler) "
          f"({card})")
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
    a block takes a slab of 64 x 32): kernels 15 and 16, a block per slab (2
    x 2) and the slabs' parts summed, against the plain twins in both
    dtypes; then
    an m0 SS2D layer of that geometry (d_model 96, ssm_ratio 4, 28 x 28,
    batch 2), forward and backward, card against the CPU plain twins."""
    print(f"phase 9e: the SSD kernels past one slab, d_state 128, head width 64 ({card})")
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
            got = ssd_chunk.ssd_fwd(*args, save_states=True)
            want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
            check_outputs(errors, "ssd_chunk_fwd", f"slabs L={L} R={R} P={P} N={N}", dtype,
                          got, want, failed)
            dy = randn(g, *args[0].shape)
            check_outputs(errors, "ssd_chunk_bwd", f"slabs L={L} R={R} P={P} N={N}", dtype,
                          ssd_chunk.ssd_bwd(*args[:7], want[2], dy),
                          ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy), failed)
            torch.cuda.synchronize()
            launches = counts()
            if launches != {"ssd_chunk_fwd": 1, "ssd_chunk_bwd": 1}:
                failed.append(("launches", launches))
    if failed:
        raise PhaseFailure(f"the SSD kernels' slab plan disagrees with the plain twins: {failed}")
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
    if launches != {"ssd_chunk_fwd": 1, "ssd_chunk_bwd": 1} or not worst <= 1e-3:
        raise PhaseFailure("the m0 SS2D layer past one slab disagrees with the CPU plain path, or "
                           "did not launch kernels 15 and 16 once each")


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


def train_blocks(g, d, depth, dtype, ratio=2):
    blocks = [VSSBlock(d, ssm_ratio=ratio, generator=g).cuda() for _ in range(depth)]
    with torch.no_grad():
        return [pack_vss_block_train_params(b, dtype) for b in blocks]


def masks(g, *shape):
    return ((torch.rand(*shape, generator=g) < 0.7).float() / 0.7).cuda()


def cross2d_case(g, n, H, d, dtype, ratio=2):
    """The stage maps' chunked cross2d scan operands (``ops/cross2d_scan.py``):
    u (n, L, ratio d), the projection rows (n, L, 4R + 8) with R = ceil(d /
    16), A in [-e^1.5, -1], deltas about softplus(-4 +- 1)."""
    D, R, L = ratio * d, -(-d // 16), H * H
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, 4 * R + 8, dtype=dtype),
            -torch.exp(1.5 * torch.rand(4, 1, D, generator=g)).cuda(),
            randn(g, 4, D, scale=0.5) - 4.0, randn(g, D), randn(g, 4, R, D, scale=R ** -0.5),
            H, H)


def cross2d_check(errors, g, n, H, d, dtype, failed, ratio=2):
    """The stage scan (y, checkpoints) and its adjoint (every output: du,
    dw_dt, dA, dbias, dDsum and the projections' gradient, rank, dB and dC
    columns) against their plain twins, counted under kernel 6; the
    adjoint bitwise equal over two runs and launching no GEMM."""
    args = cross2d_case(g, n, H, d, dtype, ratio)
    u, xdbl = args[:2]
    geo = f"H={H} d={d}" + ("" if ratio == 2 else f" d_inner={ratio * d}")
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
            | ABLATION_KERNELS | PREPROCESS_KERNELS)


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

@contextlib.contextmanager
def first_design_nk_ablations():
    """Kernels 17 and 18 on their first design while open: `nk_scan_v4` and
    `nk_scan_v3` launch ``csrc/nk_scan_ablations_v1.cu`` on the same
    operands (phase 10's old-against-new timings)."""
    new = nk_scan_v4.nk_scan_v4_cuda, nk_scan_wide.nk_scan_v3_cuda
    nk_scan_v4.nk_scan_v4_cuda = nk_scan_v4.nk_scan_v4_first
    nk_scan_wide.nk_scan_v3_cuda = nk_scan_wide.nk_scan_v3_first
    try:
        yield
    finally:
        nk_scan_v4.nk_scan_v4_cuda, nk_scan_wide.nk_scan_v3_cuda = new


def scratch_bytes(fn):
    """Device bytes that one call of ``fn`` asks the allocator for beyond
    its output, at their peak (the requested sizes: a cached block handed
    out whole counts only what was asked)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return peak - base - out.numel() * out.element_size()


def phase_compare_nk_ablations(errors, card):
    """Kernels 17 and 18 (``csrc/nk_scan_ablations.cu``) against their plain
    twins and against kernel 2 on the same inputs at the fusion scans'
    shapes, float32 and bfloat16, TF32 off: bitwise over two runs, one
    device launch a call, no float32 scratch (the bytes a call allocates
    beyond its output, below an eighth of an (n, L, D) float32 buffer);
    device ms per call by graph replay (at these sub-millisecond sizes the
    CUDA-event time of a call follows the host's speed) of the new design,
    its first design (`first_design_nk_ablations`) and kernel 2 in turns,
    the CUDA-event times, the plain twins', the plan and a block's phase
    times.  Returns each kernel's (device ms, plain ms, bound) per bs-32
    bfloat16 XFMamba-S forward (two ShallowFuse calls)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = sm_clock_mhz()
    print(f"phase 10: kernels 17 (nk scan v4) and 18 (v3) vs their plain twins and kernel 2, "
          f"TF32 off; device ms by graph replay, new / first design / kernel 2 in turns; SFU: "
          f"the exponentials at {SFU_PER_SM_CLOCK} per SM per clock on {SMS} SMs at "
          f"{clock:.0f} MHz ({card})")
    _, log = build.build()
    regs = {}
    for fn, n_regs, spills in ptxas_rows(log, "nk_ablation_kernel", "nk_scan_v4_kernel",
                                         "nk_scan_v3_kernel"):
        regs[fn] = (n_regs, spills)
        print(f"  ptxas {fn[:90]}: {n_regs} registers, {spills} bytes spilled")
    g = torch.Generator().manual_seed(45)
    kernels = {"nk_scan_v4": (nk_scan_v4.nk_scan_v4, nk_scan_v4.nk_scan_v4_plain,
                              nk_scan_v4.nk_scan_v4_cuda),
               "nk_scan_v3": (nk_scan_wide.nk_scan_v3, nk_scan_wide.nk_scan_v3_plain,
                              nk_scan_wide.nk_scan_v3_cuda)}
    failed, rows = [], {}
    with torch.no_grad():
        for size, n, K, label in NK_ABLATION_CASES:
            D = FUSION[size]["D"]
            for dtype in (torch.float32, torch.bfloat16):
                args = v1_scan_case(g, n, K, dtype, size)
                k2 = nk_scan.nk_scan(*args)
                calls = {"kernel 2": lambda: nk_scan.nk_scan(*args)}
                for name, (fn, plain, cuda) in kernels.items():
                    new = lambda fn=fn: fn(*args, group=8)
                    ablation_scan.ablation_scan_cuda.by_plan.clear()
                    got, again = new(), new()
                    torch.cuda.synchronize()
                    plan = ", ".join(ablation_scan.ablation_scan_cuda.by_plan)
                    check_outputs(errors, name, f"{label} ({n},49,{D}) K={K} vs plain, k2", dtype,
                                  [got, got], [plain(*args), k2], failed)
                    same = torch.equal(got, again)
                    launches = device_launches(new)
                    one = list(launches.values()) == [1.0] and \
                        "nk_ablation_kernel" in next(iter(launches))
                    extra = scratch_bytes(new)
                    lean = extra < n * 49 * D * 4 / 8
                    phases = cuda(*args, phase_ns=True)
                    print(f"    {'bitwise' if same else 'two runs differ'}, {plan}, device "
                          f"launches a call {list(launches.values()) if one else launches}, "
                          f"{extra} bytes allocated beyond the output; a block's phases (us): "
                          f"{phases_line(phases)} {'OK' if same and one and lean else 'FAIL'}")
                    if not (same and one and lean):
                        failed.append((name, label, str(dtype), same, launches, extra))
                    calls[f"{name} new"] = new
                    calls[f"{name} first"] = on_design(new, first_design_nk_ablations)
                    rows[(name, label, dtype)] = dict(phases_us={k: v / 1e3 for k, v in
                                                                 phases.items()}, plan=plan)
                dev = in_turns(calls, lambda fn: graph_ms(fn, 20))
                wall = in_turns(calls, lambda fn: time_ms(fn, 10))
                plain_ms = {name: time_ms(lambda f=plain: f(*args), 1, warmup=False)
                            for name, (_, plain, _) in kernels.items()}
                sfu = sfu_ms(n, 49, D, K, 16, clock)
                bound, by = nk_work(n, 49, D, K, 16, dtype).bound()
                print(f"    {str(dtype)[6:]}: device ms per call (CUDA events): "
                      + ", ".join(f"{k} {dev[k]:.4f} ({wall[k]:.4f})" for k in calls)
                      + f"; plain twins {plain_ms['nk_scan_v4']:.3f}, "
                      f"{plain_ms['nk_scan_v3']:.3f}; bound {bound:.4f} ({by}), SFU time "
                      f"{sfu:.4f}")
                for name in kernels:
                    rows[(name, label, dtype)] |= dict(
                        graph_ms=dev[f"{name} new"], first_graph_ms=dev[f"{name} first"],
                        kernel2_graph_ms=dev["kernel 2"], ms=wall[f"{name} new"],
                        first_ms=wall[f"{name} first"], plain_ms=plain_ms[name],
                        bound_ms=bound, sfu_ms=sfu)
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"kernels 17/18 disagree with their plain twins or kernel 2, between "
                           f"runs, in their launches or allocate scratch: {failed}")
    times = {}
    for name in kernels:
        # per bs-32 bfloat16 XFMamba-S forward: two ShallowFuse calls
        r = rows[(name, NK_ABLATION_CASES[0][3], torch.bfloat16)]
        fwd = {k: 2 * r[k] for k in ("graph_ms", "first_graph_ms", "kernel2_graph_ms", "sfu_ms",
                                     "plain_ms")}
        times[name] = (fwd["graph_ms"], fwd["plain_ms"],
                       *nk_work(32, 49, FUSION["small"]["D"], 1, 16, torch.bfloat16)
                       .times(2).bound())
        ratio = fwd["graph_ms"] / fwd["kernel2_graph_ms"]
        print(f"  {name} per bs-32 bfloat16 XFMamba-S forward (2 ShallowFuse calls), device: "
              f"{fwd['graph_ms']:.4f} ms (first design {fwd['first_graph_ms']:.4f}, kernel 2 "
              f"{fwd['kernel2_graph_ms']:.4f}: {ratio:.2f}x, aim 1.5x); plain "
              f"{fwd['plain_ms']:.3f} ms, bound {times[name][2]:.4f} ms ({times[name][3]}), SFU "
              f"time {fwd['sfu_ms']:.4f} ({card})")
        # the build's report of this kernel's instantiations (template
        # argument 0 kernel 17, 1 kernel 18) and of its first design
        code, first = ("0", "nk_scan_v4_kernel") if name == "nk_scan_v4" else \
            ("1", "nk_scan_v3_kernel")
        mine = {fn: r for fn, r in regs.items()
                if ("nk_ablation_kernel" in fn and f"Li{code}ELi" in fn) or first in fn}
        print(f"  {name} registers, spilled bytes: "
              + ", ".join(f"{fn[:60]} {r[0]}, {r[1]}" for fn, r in mine.items()))
        V1_EXTRA[name] = fwd | {"per": "bs-32 bfloat16 XFMamba-S forward", "registers": mine,
                                "geometries": {f"{label} {str(dt)[6:]}": r for (nm, label, dt), r
                                               in rows.items() if nm == name}}
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


LN_KERNEL_NAMES = ("ln_fwd_kernel", "ln_bwd_kernel", "ln_fwd_rows_kernel", "ln_bwd_rows_kernel",
                   "ln_col_sum_kernel", "ln_act_fwd_kernel", "seg_ln_bwd_kernel",
                   "seg_ln_bwd_sum_kernel")
# the kernels each of 19-21 launches a call: one of each tuple (the staged
# plan's or the row path's)
LN_LAUNCHES = {"ln_act_fused": (("ln_fwd_kernel", "ln_fwd_rows_kernel"),),
               "seg_ln_fwd": (("ln_fwd_kernel", "ln_fwd_rows_kernel"),),
               "seg_ln_bwd": (("ln_bwd_kernel", "ln_bwd_rows_kernel"), ("ln_col_sum_kernel",))}


def ln_calls(x, scale, bias, gy, act):
    """{kernel: (new, first design, plain)} of kernels 19-21 on one input,
    each returning a list of outputs."""
    pf, sl = pe_fused, seg_ln
    return {
        "ln_act_fused": (lambda: [pf.ln_act_fused(x, scale, bias, act)],
                         lambda: [pf.ln_act_fused_first(x, scale, bias, act)],
                         lambda: [pf.ln_act_fused_plain(x, scale, bias, act)]),
        "seg_ln_fwd": (lambda: [sl.seg_ln_fwd(x, scale, bias, act=act)],
                       lambda: [sl.seg_ln_fwd_first(x, scale, bias, act=act)],
                       lambda: [sl.seg_ln_fwd_plain(x, scale, bias, act=act)]),
        "seg_ln_bwd": (lambda: list(sl.seg_ln_bwd(x, scale, bias, gy, act=act)),
                       lambda: list(sl.seg_ln_bwd_first(x, scale, bias, gy, act=act)),
                       lambda: list(sl.seg_ln_bwd_plain(x, scale, bias, gy, act=act)))}


def phase_ln_kernels(errors, card):
    """Kernels 19-21 and their first design against their plain twins at
    `LN_CASES` in both dtypes: bitwise over two runs, one device launch a
    forward and two a backward (the nodes of a captured CUDA graph), the
    plan; in bfloat16 at the patch embed's two norms, device ms by graph
    replay and by CUDA events of the new design and its first design in
    turns, beside the plain twin, the bound and the library call; the
    build's registers and spills of each kernel.  Then the
    patch embed built on kernel 19 and on kernels 20 / 21 against
    ``PatchEmbedV2`` (the main path: launches counted around one forward on
    19 and one forward and backward on 20 / 21).  Returns (times, library
    ms, launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 10c: kernels 19-21 (LayerNorm + GELU, staged streaming passes) vs their plain "
          f"twins, their first design and F.layer_norm; device ms by graph replay, first "
          f"design / new in turns, TF32 off ({card})")
    _, log = build.build()
    regs = {}
    for fn, n_regs, spills in ptxas_rows(log, *LN_KERNEL_NAMES):
        regs[fn] = (n_regs, spills)
        print(f"  ptxas {fn[:90]}: {n_regs} registers, {spills} bytes spilled")
    g = torch.Generator().manual_seed(46)
    bf16 = torch.bfloat16
    keys = ("graph", "first_graph", "ms", "first_ms", "plain", "lib")
    acc = {name: dict.fromkeys(keys, 0.0) | {"work": Work()} for name in LN_NAMES}
    failed, rows, side = [], {}, {}
    for dtype in (torch.float32, bf16):
        for shape, C, act in LN_CASES:
            x = randn(g, *shape, C, dtype=dtype, scale=2.0) + 0.5
            scale, bias = 1 + randn(g, C, scale=0.1), randn(g, C, scale=0.1)
            gy = randn(g, *shape, C, dtype=dtype)
            rows_n = math.prod(shape)
            label = f"{tuple(shape) + (C,)} {'GELU' if act else 'no act'}"
            calls = ln_calls(x, scale, bias, gy, act)
            plans = {b: seg_ln.ln_plan(x, backward=b) for b in (False, True)}
            print(f"  {label} {str(dtype)[6:]}: plan forward {plans[False]}, backward "
                  f"{plans[True]}")
            with torch.no_grad():
                for name, (new, first, plain) in calls.items():
                    want = plain()
                    check_outputs(errors, name, label, dtype, new(), want, failed)
                    check_outputs(side, f"{name} first", label, dtype, first(), want, failed)
                    same = all(torch.equal(a, b) for a, b in zip(new(), new()))
                    launches = device_launches(new)
                    # a mangled name holds its identifier after its length
                    one = sum(launches.values()) == len(LN_LAUNCHES[name]) and all(
                        sum(any(f"{len(k)}{k}" in fn for k in ks) for fn in launches) == 1
                        for ks in LN_LAUNCHES[name])
                    print(f"    {name}: {'bitwise' if same else 'two runs differ'}, device "
                          f"launches a call {list(launches.values()) if one else launches} "
                          f"{'OK' if same and one else 'FAIL'}")
                    if not (same and one):
                        failed.append((name, label, str(dtype), same, launches))
            if dtype != bf16 or (shape, C, act) not in LN_CASES[:2]:
                continue
            xl = x.detach().requires_grad_()
            sl, bl = (t.to(dtype).requires_grad_() for t in (scale, bias))
            y = library_ln(xl, sl, bl, act)
            lib = {"ln_act_fused": lambda: library_ln(x, scale, bias, act),
                   "seg_ln_fwd": lambda: library_ln(x, scale, bias, act),
                   "seg_ln_bwd": lambda: torch.autograd.grad(y, (xl, sl, bl), gy,
                                                             retain_graph=True)}
            for name, (new, first, plain) in calls.items():
                a = acc[name]
                turns = {"first": first, "new": new}
                with torch.no_grad():
                    gr = in_turns(turns, lambda fn: graph_ms(fn, 20))
                    ev = in_turns(turns, lambda fn: time_ms(fn, 10))
                    plain_ms = time_ms(plain, 1, warmup=False)
                lib_ms = time_ms(lib[name], 10)
                work = ln_work(rows_n, C, dtype, act, backward=name == "seg_ln_bwd")
                bound, by = work.bound()
                a["graph"] += gr["new"]
                a["first_graph"] += gr["first"]
                a["ms"] += ev["new"]
                a["first_ms"] += ev["first"]
                a["plain"] += plain_ms
                a["lib"] += lib_ms
                a["work"] += work
                rows[(name, label)] = dict(graph_ms=gr["new"], first_graph_ms=gr["first"],
                                           ms=ev["new"], first_ms=ev["first"], bound_ms=bound,
                                           library_ms=lib_ms, plain_ms=plain_ms,
                                           plan=plans[name == "seg_ln_bwd"])
                print(f"    {name} {label}: device {gr['new']:.4f} ms (first design "
                      f"{gr['first']:.4f}); events {ev['new']:.4f} (first {ev['first']:.4f}); "
                      f"plain {plain_ms:.3f}, library {lib_ms:.4f}, bound {bound:.4f} ({by}), "
                      f"{bound / gr['new']:.0%} of the bound")
            del xl, sl, bl, y
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"kernels 19-21 (or their first design) disagree with their plain "
                           f"twins, between runs or in their launches: {failed}")
    times, library = {}, {}
    for name, a in acc.items():
        bound, by = a["work"].bound()
        times[name] = (a["ms"], a["plain"], bound, by)
        library[name] = a["lib"]
        print(f"  {name:12s} per bs-64 patch embed (bfloat16, its 2 norms), device: "
              f"{a['graph']:.4f} ms (first design {a['first_graph']:.4f}), events "
              f"{a['ms']:.4f} (first {a['first_ms']:.4f}); plain {a['plain']:.3f} "
              f"ms, bound {bound:.4f} ms ({by}; {bound / a['graph']:.0%} of it, aim 50%), "
              f"library {a['lib']:.4f} ms (F.layer_norm + "
              f"F.gelu{' backward' if 'bwd' in name else ''}) ({card})")
        kernel = "ln_bwd_kernel" if name == "seg_ln_bwd" else "ln_fwd_kernel"
        V1_EXTRA[name] = {
            "per": "bs-64 bfloat16 patch embed (2 norms)", "graph_ms": a["graph"],
            "first_graph_ms": a["first_graph"], "first_ms": a["first_ms"],
            "registers": {fn: r for fn, r in regs.items() if kernel in fn},
            "geometries": {label: r for (nm, label), r in rows.items() if nm == name}}
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


# phase 11: the CLIs on a synthetic MURA tree (tests/torch_mura_tree.py)
CLI_STUDIES, CLI_VALID_STUDIES = 64, 16
CLI_PARTS = ("ELBOW", "WRIST")
CLI_KINDS = ("rgb8", "palette8", "gray16")
# the feed in steady state: the train pairs FEED_REPEAT times over, one
# shuffled epoch a worker count; its rate is read from the batch after each
# worker's first on, when every worker has one batch behind it
FEED_REPEAT = 6
FEED_WORKERS = (4, 8)
# (processes, workers) of the loader-fed epochs of the float32 step
FED_EPOCHS = ((False, 4), (True, 4), (True, 8))
CLI_MODEL, CLI_DEVICE = "twoviewxfmamba", "cuda"
CLI_FILES = ("model_epoch_0.npz", "model_epoch_1.npz", "best.npz", "epoch_0/metrics.txt",
             "epoch_1/metrics.txt", "last.pt")


@contextlib.contextmanager
def recorded_batches(loader_cls):
    """The sample indices of every shuffled epoch that ``loader_cls`` draws
    while the context is open, in order."""
    rec, orig = [], loader_cls._global_batches

    def recording(self):
        out = orig(self)
        if self.shuffle:
            rec.append([b.copy() for b in out])
        return out
    loader_cls._global_batches = recording
    try:
        yield rec
    finally:
        loader_cls._global_batches = orig


@contextlib.contextmanager
def epoch_launches(driver, fns):
    """Launch counts of ``fns`` in each train and eval epoch that
    ``driver.fit`` runs while the context is open: a list of (kind, steps
    or batches, counts) per epoch."""
    rec, run_train, run_eval = [], driver.run_train_epoch, driver.run_eval_epoch

    def train_epoch(*args, **kw):
        torch.cuda.synchronize()
        counts = counted(fns)
        stats = run_train(*args, **kw)
        torch.cuda.synchronize()
        rec.append(("train", stats["steps"], counts()))
        return stats

    def eval_epoch(eval_step, loader, *args, **kw):
        torch.cuda.synchronize()
        counts = counted(fns)
        out = run_eval(eval_step, loader, *args, **kw)
        torch.cuda.synchronize()
        rec.append(("eval", len(loader), counts()))
        return out
    driver.run_train_epoch, driver.run_eval_epoch = train_epoch, eval_epoch
    try:
        yield rec
    finally:
        driver.run_train_epoch, driver.run_eval_epoch = run_train, run_eval


def check_epoch_launches(rec, train_want, eval_want=None):
    """Each train epoch's launches are ``train_want`` per step and each eval
    epoch's ``eval_want`` per batch (kernels not named: none); returns the
    failures."""
    bad = []
    for kind, n, counts in rec:
        want = train_want if kind == "train" else eval_want
        if want is None:
            continue
        full = dict.fromkeys(counts, 0) | want
        got = {k: v for k, v in counts.items() if k in full}
        if any(got[k] != full[k] * n for k in full):
            bad.append((kind, n, {k: v for k, v in counts.items() if v}))
    return bad


def feed_epoch(dataset, workers, processes):
    """One shuffled epoch of the train transform over ``dataset``'s pairs
    FEED_REPEAT times over, taken as fast as it comes: (seconds to the
    first batch, pairs/s from the batch after each worker's first to the
    last, batches)."""
    from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
    loader = TwoViewLoader(
        TwoViewSamples(dataset.samples * FEED_REPEAT, dataset.load_fn, dataset.transform),
        TRAIN_BATCH, shuffle=True, drop_last=True, num_workers=workers, seed=7,
        use_processes=processes)
    t0 = time.perf_counter()
    arrivals, pairs = [], []
    for batch in loader:
        arrivals.append(time.perf_counter())
        pairs.append(int(batch["n_valid"]))
    rate = sum(pairs[workers:]) / (arrivals[-1] - arrivals[workers - 1])
    return arrivals[0] - t0, rate, len(pairs)


def phase_cli(card):
    """The train and inference CLIs on the card (phase 11): a synthetic MURA
    tree, its PNGs decoded by the native unfilter and its numpy twin, the
    loader's feed rate in steady state, two float32 epochs of XFMamba-S
    through ``cli.train.main`` (launches per step and per eval forward, the
    checkpoint files), a long epoch fed by the loader, a resumed run
    against the CLI's, the ``best.npz`` round
    trip, one bfloat16 epoch and ``cli.infer_mura.main``'s AUCs."""
    import dataclasses
    import os
    import shutil
    import statistics
    import tempfile
    from pathlib import Path

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_mura_tree import write_mura_tree
    from xfmamba_tpu_torch import native
    from xfmamba_tpu_torch.checkpoint import io as ckpt
    from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
    from xfmamba_tpu_torch.cli import build_model_by_name, infer_mura, load_variables
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.data import mura, png
    from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
    from xfmamba_tpu_torch.train import driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 11: the train and infer CLIs on a synthetic MURA tree, XFMamba-S at "
          f"{IMAGE}x{IMAGE}, bs {TRAIN_BATCH} ({card})")
    tmp = tempfile.mkdtemp(prefix="xfm_phase11_")
    try:
        t0 = time.perf_counter()
        csvs, paths = write_mura_tree(tmp, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                                      n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=11)
        print(f"  tree: {CLI_STUDIES} train + {CLI_VALID_STUDIES} valid studies, "
              f"{len(paths)} PNGs (filter types 0-4 row by row; every 11th of "
              f"{'/'.join(CLI_KINDS)}), written in {time.perf_counter() - t0:.2f} s")
        # 11.2: decode through the native unfilter and its numpy twin
        raws = [Path(p).read_bytes() for p in paths]
        native.library()
        t0 = time.perf_counter()
        decoded = [png.decode_gray(raw) for raw in raws]
        native_s = time.perf_counter() - t0
        mismatched = [p for p, raw, img in zip(paths, raws, decoded)
                      if not np.array_equal(png.decode_gray(raw, unfilter=native.png_unfilter_plain),
                                      img)]
        pixels = sum(img.size for img in decoded)
        print(f"  decode: {len(raws)} images, {pixels / len(raws) / 1e3:.0f} k pixels each on "
              f"average, {len(raws) / native_s:.1f} images/s on one host thread "
              f"({sum(map(len, raws)) / native_s / 2 ** 20:.1f} MiB/s of PNG); the numpy "
              f"unfilter gave equal bytes for {len(raws) - len(mismatched)} of {len(raws)}")
        if mismatched:
            raise PhaseFailure(f"the native and numpy unfilters disagree on {mismatched[:3]}")
        argv = ["--model_name", CLI_MODEL, "--image_size", str(IMAGE), "--batch_size",
                str(TRAIN_BATCH), "--data_root", tmp, "--train_image_csv", csvs[0],
                "--train_label_csv", csvs[1], "--valid_image_csv", csvs[2],
                "--valid_label_csv", csvs[3], "--num_workers", "4", "--seed", "42",
                "--device", CLI_DEVICE]
        cfg, cfg_dict = cli_train.make_config(cli_train.parse_args(argv))
        train_loader, val_loader, _ = mura.create_data_loaders(*csvs, cfg_dict)
        print(f"  loader: {len(train_loader.dataset)} train pairs ({len(train_loader)} batches "
              f"of {TRAIN_BATCH}), {len(val_loader.dataset)} val pairs; the feed alone, one "
              f"epoch of the train transform at {IMAGE}x{IMAGE} over the train pairs "
              f"{FEED_REPEAT} times over, files in the page cache ({os.cpu_count()} host cores):")
        for procs in (False, True):
            for workers in FEED_WORKERS:
                first, rate, n = feed_epoch(train_loader.dataset, workers, procs)
                print(f"    {workers} {'processes' if procs else 'threads'}: {rate:.1f} pairs/s "
                      f"from batch {workers + 1} to {n}, first batch after {first:.3f} s")

        # 11.3: two float32 epochs through the CLI
        fns = all_kernels()
        run = os.path.join(tmp, "run_f32")
        with recorded_batches(TwoViewLoader) as cli_batches, \
                epoch_launches(driver, fns) as rec:
            state, history = cli_train.main(argv + ["--epochs", "2", "--savemodel_path", run])
        steps = []
        for h in history:
            tr, va, sec = h["train"], h["val"], h["seconds"]
            steps += tr["step_ms"]
            total = sum(sec.values())
            print(f"  epoch {h['epoch']}: train loss {tr['loss']:.6f}, val loss "
                  f"{va['loss']:.6f}, val AUC {va.get('auc', float('nan')):.4f}; "
                  f"{total:.2f} s (train {sec['train_s']:.2f}, of it waiting on the loader "
                  f"{tr['loader_wait_s']:.2f}, {tr['first_batch_wait_s']:.2f} of that for the "
                  f"first batch; eval {sec['eval_s']:.2f}; metrics "
                  f"{sec['artifacts_s']:.2f}; npz {sec.get('npz_s', 0):.2f}; last.pt "
                  f"{sec.get('last_pt_s', 0):.2f}); {tr['steps']} steps, ms per step by CUDA "
                  f"events {', '.join(f'{v:.1f}' for v in tr['step_ms'])}")
        print(f"  float32 step: median {statistics.median(steps):.2f} ms by CUDA events over "
              f"{len(steps)} steps ({card})")
        if not all(math.isfinite(h[k]["loss"]) for h in history for k in ("train", "val")):
            raise PhaseFailure(f"a loss is not finite: {history}")
        bad = check_epoch_launches(rec, F32_STEP["small"], F32_FORWARD)
        print(f"  launches per epoch: {[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec]}")
        if bad:
            raise PhaseFailure(f"launches differ from {F32_STEP['small']} per step and "
                               f"{F32_FORWARD} per eval forward: {bad}")
        for name in CLI_FILES:
            path = os.path.join(run, name)
            if not os.path.isfile(path):
                raise PhaseFailure(f"the train CLI did not write {name}")
            st = os.stat(path)
            print(f"    {name}: {st.st_size / 2 ** 20:.1f} MiB, written "
                  f"{time.strftime('%H:%M:%S', time.localtime(st.st_mtime))}")

        # 11.3b: long epochs of the train step fed by the loader
        model, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=cfg.seed)
        step, _ = make_train_step(model, make_optimizer(cfg, model.parameters()), False)
        for procs, workers in FED_EPOCHS:
            long_loader = TwoViewLoader(
                TwoViewSamples(train_loader.dataset.samples * FEED_REPEAT,
                               train_loader.dataset.load_fn, train_loader.dataset.transform),
                TRAIN_BATCH, shuffle=True, drop_last=True, num_workers=workers, seed=cfg.seed,
                use_processes=procs)
            tr = driver.run_train_epoch(step, long_loader, cfg.lr, False, CLI_DEVICE,
                                        log_every=0)
            rest = tr["loader_wait_s"] - tr["first_batch_wait_s"]
            print(f"  loader-fed epoch, {workers} {'processes' if procs else 'threads'}: "
                  f"{tr['steps']} steps in {tr['time_s']:.2f} s; "
                  f"{tr['first_batch_wait_s']:.3f} s to the first batch, then {rest:.3f} s of "
                  f"waiting over the other {tr['steps'] - 1} steps "
                  f"({1e3 * rest / (tr['steps'] - 1):.1f} ms a step); step median "
                  f"{statistics.median(tr['step_ms']):.2f} ms by CUDA events; "
                  f"{tr['steps'] * TRAIN_BATCH / (tr['time_s'] - tr['first_batch_wait_s']):.1f} "
                  f"pairs/s after the first batch ({card})")
            if not math.isfinite(tr["loss"]):
                raise PhaseFailure(f"the loader-fed epoch's loss is {tr['loss']}")
        del model, step

        # 11.4: resume from a one-epoch run's last.pt against the CLI's run
        resumed = os.path.join(tmp, "run_resume")
        with recorded_batches(TwoViewLoader) as first_batches:
            model, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=cfg.seed)
            loaders = mura.create_data_loaders(*csvs, cfg_dict)
            one = cli_train.make_config(cli_train.parse_args(
                argv + ["--epochs", "1", "--savemodel_path", resumed]))[0]
            driver.fit(model, one, loaders[0], loaders[1], out_dir=resumed)
        del model
        with recorded_batches(TwoViewLoader) as second_batches:
            model, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=cfg.seed)
            loaders = mura.create_data_loaders(*csvs, cfg_dict)
            two = dataclasses.replace(one, epochs=2)
            _, resumed_history = driver.fit(
                model, two, loaders[0], loaders[1], out_dir=resumed,
                init_state=ckpt.load_state(os.path.join(resumed, "last.pt")))
        del model
        same_batches = [len(r) for r in (cli_batches, first_batches, second_batches)] == [2, 1, 1]
        for a, b in zip(cli_batches, first_batches + second_batches):
            same_batches &= len(a) == len(b) and all(map(np.array_equal, a, b))
        want, got = history[1]["train"]["loss"], resumed_history[-1]["train"]["loss"]
        rel_loss = abs(got - want) / abs(want)
        print(f"  resume: epoch 1 after a resumed last.pt: train loss {got:.6f} against "
              f"{want:.6f} uninterrupted (rel {rel_loss:.2e}, tol 1e-3); the batches' sample "
              f"indices {'equal' if same_batches else 'DIFFER'}; history length "
              f"{len(resumed_history)}")
        if not same_batches or not rel_loss <= 1e-3 or len(resumed_history) != 2:
            raise PhaseFailure("the resumed run differs from the uninterrupted one")

        # 11.5: best.npz and model_epoch_{n}.npz round trips
        best_epoch = state["early_stopping"]["best_epoch"]
        last = state["epoch"]
        fresh, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=1)
        load_variables(os.path.join(run, f"model_epoch_{last}.npz"), fresh)
        saved = ckpt.load_state(os.path.join(run, "last.pt"))["model"]
        keys = [k for k in saved if not k.endswith("num_batches_tracked")]
        npz_equal = all(torch.equal(fresh.state_dict()[k].cpu(), saved[k]) for k in keys)
        best = ckpt.load_npz(os.path.join(run, "best.npz"))
        flat_best = ckpt._flatten(best)
        flat_epoch = ckpt._flatten(ckpt.load_npz(os.path.join(run, f"model_epoch_{best_epoch}.npz")))
        fresh_best, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=2)
        load_variables(os.path.join(run, "best.npz"), fresh_best)
        back = ckpt._flatten(export_jax_variables(fresh_best))
        best_equal = (flat_best.keys() == flat_epoch.keys() == back.keys()
                      and all(np.array_equal(flat_best[k], flat_epoch[k]) and np.array_equal(back[k],
                                                                                 flat_best[k])
                              for k in flat_best))
        print(f"  round trip: model_epoch_{last}.npz into a fresh model equals last.pt's state "
              f"dict bitwise ({len(keys)} entries, BatchNorm counters aside): {npz_equal}; "
              f"best.npz (epoch {best_epoch}) equals model_epoch_{best_epoch}.npz and a fresh "
              f"model's export after loading it, bitwise ({len(flat_best)} arrays): {best_equal}")
        if not (npz_equal and best_equal):
            raise PhaseFailure("a checkpoint does not round-trip bitwise")
        del fresh, fresh_best, saved

        # 11.6: one bfloat16 epoch
        bf16_want = {name: k["per_step"] for name, k in TRAIN_KERNELS.items()} | {
            "nk_scan": 3, "vss_block_train": 0}
        # per eval forward: phase 4's bfloat16 counts
        bf16_eval = {name: k["per_forward"] for name, k in KERNELS.items()}
        with epoch_launches(driver, fns) as rec_bf:
            _, bf_hist = cli_train.main(argv + ["--epochs", "1", "--bf16", "1",
                                                "--savemodel_path", os.path.join(tmp, "run_bf16")])
        tr = bf_hist[0]["train"]
        print(f"  bfloat16 epoch: train loss {tr['loss']:.6f}, val loss "
              f"{bf_hist[0]['val']['loss']:.6f}; median {statistics.median(tr['step_ms']):.2f} "
              f"ms per step; launches {[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec_bf]}")
        bad = check_epoch_launches(rec_bf, bf16_want, bf16_eval)
        if bad or not math.isfinite(tr["loss"]):
            raise PhaseFailure(f"bfloat16 epoch: launches differ from {bf16_want} per step and "
                               f"{bf16_eval} per eval forward ({bad}) or the loss is not finite")

        # 11.7: score the valid split with best.npz
        out = os.path.join(tmp, "infer")
        aucs = infer_mura.main(["--model_name", CLI_MODEL, "--pretrained_model_path",
                                os.path.join(run, "best.npz"), "--data_root", tmp,
                                "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3],
                                "--image_size", str(IMAGE), "--batch_size", str(TRAIN_BATCH),
                                "--body_parts", *CLI_PARTS, "--out_dir", out,
                                "--device", CLI_DEVICE])
        written = sorted(f for f in os.listdir(out) if f.startswith("auc_"))
        print(f"  infer_mura: AUCs {aucs}; wrote {written}")
        want_files = [f"auc_{k}.txt" for k in aucs]
        if (set(aucs) != set(CLI_PARTS) | {"combined"} or sorted(want_files) != written
                or not all(math.isfinite(v) for v in aucs.values())):
            raise PhaseFailure(f"infer_mura gave {aucs} and wrote {written}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(str(Path(__file__).resolve().parent / "tests"))


# ---------------------------------------------------------------------------
# phase 12: every model the CLIs name, and mutual learning
# ---------------------------------------------------------------------------

# XFMamba-T's backbone stages (H, d, depth): ssm_ratio 1, so d_inner = d
TINY_STAGES = [(56, 96, 2), (28, 192, 2), (14, 384, 8), (7, 768, 2)]
BASELINES = {"singleviewmamba": False, "twoviewlatejoinmamba": True,
             "twoviewearlyfusionmamba": True}
F32, BF16 = torch.float32, torch.bfloat16
# launches per forward and per step of each model (the baselines share
# VMamba-S s2l15 and have no fusion scan); a kernel not named launches none
FORWARD_WANT = {
    "twoviewxfmamba_tiny": {F32: {"ss2d_core_n1_fwd": 14, "nk_scan": 2, "nk_scan_x": 1},
                            BF16: {"vss_stage": 4, "nk_scan": 2, "nk_scan_x": 1}},
    "baseline": {F32: {"ss2d_core_n1_fwd": 21}, BF16: {"vss_stage": 4}}}
STEP_WANT = {
    "twoviewxfmamba_tiny": {F32: {"ss2d_core_n1_fwd": 14, "ss2d_core_n1_bwd": 14, "nk_scan": 3,
                                  "nk_scan_bwd": 3},
                            BF16: {"vss_stage_train": 4, "vss_block_bwd": 14, "nk_scan": 3,
                                   "nk_scan_bwd": 3}},
    "twoviewxfmamba": {F32: F32_STEP["small"],
                       BF16: {"vss_stage_train": 4, "vss_block_bwd": 21, "nk_scan": 3,
                              "nk_scan_bwd": 3}},
    "baseline": {F32: {"ss2d_core_n1_fwd": 21, "ss2d_core_n1_bwd": 21},
                 BF16: {"vss_stage_train": 4, "vss_block_bwd": 21}}}
# the port's sources whose kernels a route may launch on the card, and
# those it must launch (dtype, training, fusion scans)
ALLOWED_SOURCES = {
    (F32, False): {"ss2d_core_n1.cu", "nk_scan_fused.cu", "vss_stage.cu"},
    (BF16, False): {"vss_stage.cu", "gemm_tc.cu", "ss2d_core_n1.cu", "nk_scan_fused.cu"},
    (F32, True): {"ss2d_core_n1.cu", "nk_scan_fused.cu", "vss_stage.cu", "nk_scan_adjoint.cu"},
    (BF16, True): {"vss_stage.cu", "gemm_tc.cu", "ss2d_core_n1.cu", "vss_block_bwd.cu",
                   "nk_scan_fused.cu", "nk_scan_adjoint.cu"}}
REQUIRED_SOURCES = {F32: {"ss2d_core_n1.cu"}, BF16: {"vss_stage.cu", "gemm_tc.cu",
                                                     "ss2d_core_n1.cu"}}
FUSION_SOURCES = {False: {"nk_scan_fused.cu"}, True: {"nk_scan_fused.cu", "nk_scan_adjoint.cu"}}
MUTUAL_PAIRS = (("twoviewxfmamba_tiny", "twoviewxfmamba"), ("singleviewmamba", "twoviewxfmamba"))
TOP_STEPS = 4


def port_kernel_sources():
    """{kernel function name: source file} of every ``__global__`` function
    in ``xfmamba_tpu_torch/csrc``."""
    out = {}
    for path in sorted((Path(__file__).resolve().parent / "xfmamba_tpu_torch" / "csrc")
                       .glob("*.cu")):
        for head in re.findall(r"__global__(.*?)\{", path.read_text(), re.S):
            names = [n for n in re.findall(r"(\w+)\s*\(", head) if n != "__launch_bounds__"]
            out[names[-1]] = path.name
    return out


def card_routes(label, fn, dtype, train, fusion, relaxed=False):
    """The card's launches in one call of ``fn`` by CUDA-graph nodes
    (`device_launches`): the port's kernels by source file, all others
    (torch, cuBLAS, cuDNN, copies and fills) together; fails if a port
    kernel outside the route's sources launched or a source the route
    needs launched nothing.  Returns (by source, other)."""
    launches = device_launches(fn, "relaxed" if relaxed else "global")
    by_source, other = {}, 0
    sources = port_kernel_sources()
    for node, n in launches.items():
        src = next((f for name, f in sources.items()
                    if node == name or f"{len(name)}{name}" in node), None)
        if src is None:
            other += n
        else:
            by_source[src] = by_source.get(src, 0) + n
    allowed = ALLOWED_SOURCES[(dtype, train)]
    required = REQUIRED_SOURCES[dtype] | (FUSION_SOURCES[train] if fusion else set())
    print(f"  {label}: device launches by CUDA-graph nodes, the port's {dict(sorted(by_source.items()))}, "
          f"others {other}")
    if not set(by_source) <= allowed or not required <= set(by_source):
        raise PhaseFailure(f"{label}: the port's kernels on the card came from "
                           f"{sorted(by_source)}; the route takes {sorted(allowed)} and needs "
                           f"{sorted(required)}")
    return by_source, other


@contextlib.contextmanager
def scales_on_the_card():
    """A graph capture takes no copy from pinned host memory: while open, a
    training forward's drop-path scales are filled on the card (the same
    launches of the port's kernels; the values are not those drawn)."""
    import xfmamba_tpu_torch.models.layers as layers
    orig = (vssm.to_device, layers.to_device)
    fill = lambda t, device=None: torch.ones(t.shape, dtype=t.dtype, device=device)  # noqa: E731
    vssm.to_device = layers.to_device = fill
    try:
        yield
    finally:
        vssm.to_device, layers.to_device = orig


def step_batch(dtype, two_view, label):
    """A bs-16 batch of seeded views, every label ``label`` (a model learns
    one class in a few steps, and the next run's other class starts its
    loss high), without the second view for a one-view model."""
    xa, xb = views(TRAIN_BATCH, dtype, 130 + label)
    batch = {"image1": xa, "label": torch.full((TRAIN_BATCH,), label, device="cuda")}
    if two_view:
        batch["image2"] = xb
    return batch


def drive_model(model, name, two_view, card, dtypes_eval, dtypes_train, fusion):
    """One model at full width, 224x224, on the card: per eval dtype a bs-32
    forward and per train dtype bs-16 steps on one batch, each with the
    launches counted by the wrappers against its route (every other kernel
    none) and by CUDA-graph nodes (`card_routes`), finite outputs, a
    falling loss over `TOP_STEPS` steps, ms per forward and per step (CUDA
    events, median of 3 runs).  Returns {(kind, dtype): ms}."""
    fns = all_kernels()
    key = name if name in FORWARD_WANT else "baseline"
    out = {}
    for dtype in dtypes_eval:
        xa, xb = views(32, dtype, 120)
        xs = (xa, xb) if two_view else (xa,)
        want = dict.fromkeys(fns, 0) | FORWARD_WANT[key][dtype]
        with torch.no_grad():
            model.eval()
            model(*xs)
            torch.cuda.synchronize()
            counts = counted(fns)
            logits = model(*xs)
            torch.cuda.synchronize()
            got = counts()
            if got != want or logits.shape != (32, 2) or not torch.isfinite(logits).all():
                raise PhaseFailure(f"{name} {str(dtype)[6:]} bs-32 forward: launches "
                                   f"{ {k: v for k, v in got.items() if v} } (expected "
                                   f"{FORWARD_WANT[key][dtype]}) or bad logits")
            card_routes(f"{name} {str(dtype)[6:]} bs-32 forward", lambda: model(*xs), dtype,
                        False, fusion)
            samples = sorted(time_ms(lambda: model(*xs), 5) for _ in range(3))
        out[("forward", dtype)] = samples[1]
        print(f"  {name} {str(dtype)[6:]} bs 32: launches {FORWARD_WANT[key][dtype]}, others none; "
              f"{samples[1]:.2f} ms per forward (median of 3 runs of 5: "
              f"{', '.join(f'{v:.2f}' for v in samples)}), {32000 / samples[1]:.1f} samples/s "
              f"({card})")
    for run, dtype in enumerate(dtypes_train):
        optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
        step, _ = make_train_step(model, optimizer, multilabel=False, two_view=two_view)
        batch = step_batch(dtype, two_view, run % 2)
        want = dict.fromkeys(fns, 0) | STEP_WANT[key][dtype]
        losses = []
        for _ in range(TOP_STEPS):
            counts = counted(fns)
            losses.append(float(step(batch)["loss"]))
            torch.cuda.synchronize()
            got = counts()
            if got != want:
                raise PhaseFailure(f"{name} {str(dtype)[6:]} step: launches "
                                   f"{ {k: v for k, v in got.items() if v} }, expected "
                                   f"{STEP_WANT[key][dtype]}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise PhaseFailure(f"{name} {str(dtype)[6:]} training loss not finite or not "
                               f"falling: {losses}")

        def forward_backward():
            model.zero_grad(set_to_none=True)
            xs = (batch["image1"], batch["image2"]) if two_view else (batch["image1"],)
            F.cross_entropy(model(*xs).float(), batch["label"]).backward()
        model.train()
        with scales_on_the_card():
            card_routes(f"{name} {str(dtype)[6:]} bs-16 forward and backward", forward_backward,
                        dtype, True, fusion, relaxed=True)
        torch.cuda.reset_peak_memory_stats()
        samples = timed_steps(step, batch)
        out[("step", dtype)] = samples[1]
        print(f"  {name} {str(dtype)[6:]} bs 16: losses {', '.join(f'{v:.5f}' for v in losses)}; "
              f"launches per step {STEP_WANT[key][dtype]}, others none; {samples[1]:.2f} ms per "
              f"step (median of 3 runs of 3: {', '.join(f'{v:.2f}' for v in samples)}), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
        del optimizer, step
    model.zero_grad(set_to_none=True)
    return out


def phase_tiny_kernels(errors, card):
    """Kernels 1, 5, 6, 11 and 12 against their plain versions at
    XFMamba-T's block geometries (d_inner = d, dt rank 6-48), float32 and
    bfloat16, TF32 off, at the shapes of its bs-32 forward (kernels 1 and
    11: 64 images, every stage at its full depth) and bs-16 step (5, 6, 12
    and the stage scans: 32 images): every output within its tolerance.
    Then each kernel's time per forward (1 bfloat16, 11 float32) or step
    (5, 6 bfloat16, 12 float32), the sum over its calls (a block's call
    counted depth times), beside the plain version's and the bound.
    Returns {name: (ms, plain ms, bound ms, bound by)}."""
    print(f"phase 12a: kernels 1, 5, 6, 11 and 12 vs plain versions at XFMamba-T's widths "
          f"(d_inner = d), TF32 off; times per bs-32 forward and bs-16 step ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(12)
    failed = []
    acc = {name: [0.0, 0.0, Work()] for name in ("vss_stage", "vss_stage_train", "vss_block_bwd",
                                                  "ss2d_core_n1_fwd", "ss2d_core_n1_bwd")}

    def run(name, label, dtype, fn, plain, timed, count=1, work=None):
        fn()                                               # warm-up
        got, ms = timed_call(fn, 3)
        want, plain_ms = timed_call(plain)
        check_outputs(errors, name, f"XFMamba-T {label}", dtype, got, want, failed)
        if timed:
            acc[name][0] += count * ms
            acc[name][1] += count * plain_ms
            acc[name][2] += work.times(count)
        return got

    n_fwd, n_step = 64, 2 * TRAIN_BATCH
    with torch.no_grad():
        for dtype in (F32, BF16):
            for H, d, depth in TINY_STAGES:
                geo = f"H={H} d={d} d_inner={d}"
                R = -(-d // 16)
                (args, kernel, plain) = stage_case(g, H, d, depth, n_fwd // 2, dtype, ratio=1)
                run("vss_stage", f"stage {geo} depth {depth}", dtype, lambda: [kernel(*args)],
                    lambda: [plain(*args)], dtype == BF16,
                    work=block_work(n_fwd, H, d, BF16, mlp=True, ratio=1).times(depth))
                cross2d_check(errors, g, n_step, H, d, dtype, failed, ratio=1)
                (p,) = train_blocks(g, d, 1, dtype, ratio=1)
                x, m1 = randn(g, n_step, H * H, d, dtype=dtype), masks(g, n_step)
                gy = randn(g, n_step, H * H, d)
                run("vss_block_bwd", f"block backward {geo}", dtype,
                    lambda: block_grads(vss_block_train.vss_block_bwd(x, p, H, H, m1, gy)),
                    lambda: block_grads(vss_block_train.vss_block_bwd_plain(x, p, H, H, m1, gy)),
                    dtype == BF16, depth,
                    block_work(n_step, H, d, BF16, mlp=False, backward=True, ratio=1))
                ps = train_blocks(g, d, depth, dtype, ratio=1)
                m1s, m2s = masks(g, depth, n_step), masks(g, depth, n_step)
                work = block_work(n_step, H, d, BF16, mlp=True, ratio=1).times(depth)
                work += Work().add(2 * depth * n_step * H * H * d * 2)   # saves x_j and mid_j
                _, xs, mids = run(
                    "vss_stage_train", f"stage forward {geo} depth {depth}", dtype,
                    lambda: vss_stage_train.vss_stage_train_forward(x, ps, H, H, m1s, m2s),
                    lambda: vss_stage_train.vss_stage_train_forward_plain(x, ps, H, H, m1s, m2s),
                    dtype == BF16, work=work)
                gs = randn(g, n_step, H * H, d, dtype=dtype)
                check_outputs(errors, "vss_stage_train", f"XFMamba-T stage backward {geo}", dtype,
                              *(stage_grads(vss_stage_train.stage_train_backward(
                                  gs, xs, mids, ps, H, H, m1s, m2s, block_bwd=bwd))
                                for bwd in (vss_block_train.vss_block_bwd,
                                            vss_block_train.vss_block_bwd_plain)), failed)
                a = n1_case(g, n_fwd, H, d, dtype, ratio=1)
                run("ss2d_core_n1_fwd", f"N=1 core ({n_fwd} images) {geo} R={R} (y, ck)", dtype,
                    lambda: ss2d_core_n1.ss2d_core_n1_fwd(*a),
                    lambda: ss2d_core_n1.ss2d_core_n1_fwd_plain(*a), dtype == F32, depth,
                    n1_work(n_fwd, H, d, R))
                a = n1_case(g, n_step, H, d, dtype, ratio=1)
                _, ck = ss2d_core_n1.ss2d_core_n1_fwd_plain(*a)
                gy1 = randn(g, *a[0].shape)
                run("ss2d_core_n1_bwd", f"N=1 core backward ({n_step} images) {geo} R={R}",
                    dtype, lambda: ss2d_core_n1.ss2d_core_n1_bwd(*a, ck, gy1),
                    lambda: ss2d_core_n1.ss2d_core_n1_bwd_plain(*a, ck, gy1), dtype == F32,
                    depth, n1_work(n_step, H, d, R, backward=True))
    torch.cuda.synchronize()
    if failed:
        raise PhaseFailure(f"XFMamba-T kernels disagree with their plain versions: {failed}")
    times = {}
    for name, (ms, plain_ms, work) in acc.items():
        times[name] = (ms, plain_ms, *work.bound())
        per = "bs-32 forward" if name in ("vss_stage", "ss2d_core_n1_fwd") else "bs-16 step"
        dt = "float32" if name.startswith("ss2d") else "bfloat16"
        print(f"  {name:16s} per XFMamba-T {per} ({dt}): kernel {ms:9.3f} ms   plain "
              f"{plain_ms:9.3f} ms   bound {times[name][2]:.4f} ms ({times[name][3]}) ({card})")
    return times


def phase_tiny(errors, card):
    """XFMamba-T (phase 12a): its kernels at its widths, the model at full
    width (`drive_model`: float32 and bfloat16 bs-32 forwards and bs-16
    steps), then float32 logits and one step's gradients at depths
    (2, 2, 2, 2), card against the CPU plain twins.  Returns
    (kernel times, model times)."""
    kernels = phase_tiny_kernels(errors, card)
    print(f"phase 12a: XFMamba-T two-view {IMAGE}x{IMAGE}, full width (dims 96-768, d_inner = d, "
          f"depths 2/2/8/2), seeded weights ({card})")
    model = two_view_xfmamba("tiny", seed=0)
    times = drive_model(model, "twoviewxfmamba_tiny", True, card, (BF16, F32), (F32, BF16),
                        fusion=True)
    del model
    small = depth2_model("tiny")
    phase_cpu_parity(small, {"ss2d_core_n1_fwd": 8, "nk_scan_v1": 3}, "12a",
                     "XFMamba-T (depths 2/2/2/2)")
    phase_train_cpu_parity(small, "XFMamba-T", "12a")
    del small
    return kernels, times


@contextlib.contextmanager
def shallow_baselines():
    """The baselines' backbone (and SingleViewMamba's classifier) at depths
    (2, 2, 2, 2), full widths, no drop path, while open."""
    from xfmamba_tpu_torch.models import tops
    cfg, build_model = dict(tops._BACKBONE_CFG["small"]), tops.build_model
    shallow = dict(depths=(2, 2, 2, 2), drop_path_rate=0.0)
    tops._BACKBONE_CFG["small"] = cfg | shallow
    tops.build_model = lambda num_classes, **kw: build_model(num_classes, **(kw | shallow))
    try:
        yield
    finally:
        tops._BACKBONE_CFG["small"], tops.build_model = cfg, build_model


def phase_baselines(card):
    """The three baselines at full width (phase 12b; VMamba-S s2l15
    backbone, 224x224): `drive_model` with float32 and bfloat16 bs-32
    forwards and float32 bs-16 steps, then float32 logits at depths
    (2, 2, 2, 2) and batch 2, card against the CPU plain twins within 1e-3
    of the largest.  Returns {name: model times}."""
    from xfmamba_tpu_torch.cli import build_model_by_name
    print(f"phase 12b: the single-view, late-join and early-fusion tops, full width (VMamba-S "
          f"s2l15 backbone), {IMAGE}x{IMAGE}, seeded weights ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    fns = all_kernels()
    for name, two_view in BASELINES.items():
        model, tv = build_model_by_name(name, 2, device="cuda", seed=0)
        if tv != two_view:
            raise PhaseFailure(f"{name}: two_view {tv}, expected {two_view}")
        out[name] = drive_model(model, name, two_view, card, (F32, BF16), (F32,), fusion=False)
        del model
        with shallow_baselines():
            small, _ = build_model_by_name(name, 2, device="cpu", seed=5)
        xa, xb = (x.float() for x in views(2, F32, 13))
        xs = (xa, xb) if two_view else (xa,)
        with torch.no_grad():
            small.cuda()
            counts = counted(fns)
            got = small(*xs).cpu()
            launches = {n: c for n, c in counts().items() if c}
            t0 = time.time()
            want = small.cpu()(*(x.cpu() for x in xs))
        err = float((got - want).abs().max())
        tol = 1e-3 * float(want.abs().max())
        print(f"  {name} depths 2/2/2/2, batch 2, float32: card {got.tolist()} cpu "
              f"{want.tolist()} max_abs_err={err:.3e} tol={tol:.3e} (cpu forward "
              f"{time.time() - t0:.1f} s); launches {launches}")
        if launches != {"ss2d_core_n1_fwd": 8} or not err <= tol:
            raise PhaseFailure(f"{name}: float32 logits on the card disagree with the CPU plain "
                               f"path, or its launches {launches} differ")
        del small
    return out


def mutual_step_want(names, dtype):
    """Launches per mutual step: the sum of the models' steps."""
    want = {}
    for name in names:
        for k, v in STEP_WANT[name if name in STEP_WANT else "baseline"][dtype].items():
            want[k] = want.get(k, 0) + v
    return want


def phase_mutual(card):
    """``cli.train_mutual`` and the repaired ``cli.train`` on the card
    (phases 12c, 12d), on phase 11's synthetic MURA tree: the default pair
    (XFMamba-T and XFMamba-S) for 2 float32 epochs, then 1 with ``--bf16
    1``, then ``singleviewmamba`` with XFMamba-S (one view and two mixed)
    for 1; for each run the launches (counts set to 0 just before, read
    just after: each model's step's, summed, per mutual step, and nothing
    else), finite losses, the median ms per mutual step (CUDA events), and
    every best-ROC file read back into a fresh model (its parameters
    bitwise) with JAX's keys.  Then one ``cli.train`` epoch of
    ``singleviewmamba`` (kernels 11 and 12 on ``image1`` alone) and
    ``cli.infer_mura`` scoring its ``best.npz``.  Returns (the kernels'
    launches in the default pair's float32 run, {run: median ms per
    mutual step})."""
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_mura_tree import write_mura_tree
    from xfmamba_tpu_torch.checkpoint import io as ckpt
    from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
    from xfmamba_tpu_torch.cli import build_model_by_name, infer_mura, load_variables
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.cli import train_mutual
    from xfmamba_tpu_torch.train import driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 12c: cli.train_mutual on a synthetic MURA tree, {IMAGE}x{IMAGE}, bs "
          f"{TRAIN_BATCH} ({card})")
    tmp = tempfile.mkdtemp(prefix="xfm_phase12_")
    fns = all_kernels()
    ms, main_launches, fresh = {}, None, {}
    try:
        csvs, _ = write_mura_tree(tmp, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                                  n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=11)
        data = ["--data_root", tmp, "--train_image_csv", csvs[0], "--train_label_csv", csvs[1],
                "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3], "--image_size",
                str(IMAGE), "--batch_size", str(TRAIN_BATCH), "--num_workers", "4",
                "--device", CLI_DEVICE]
        runs = [(MUTUAL_PAIRS[0], F32, 2), (MUTUAL_PAIRS[0], BF16, 1), (MUTUAL_PAIRS[1], F32, 1)]
        for r, (names, dtype, epochs) in enumerate(runs):
            label = f"{' + '.join(names)}, {str(dtype)[6:]}, {epochs} epoch(s)"
            out = os.path.join(tmp, f"dml{r}")
            torch.cuda.synchronize()
            for fn in fns.values():
                fn.launches = 0
            models, history = train_mutual.main(
                ["--model_names", *names, "--epochs", str(epochs), "--bf16",
                 str(int(dtype == BF16)), "--savemodel_path", out] + data)
            torch.cuda.synchronize()
            got = {n: fn.launches for n, fn in fns.items()}
            steps = sum(len(h["step_ms"]) for h in history)
            want = dict.fromkeys(fns, 0) | {k: v * steps
                                            for k, v in mutual_step_want(names, dtype).items()}
            step_ms = [v for h in history for v in h["step_ms"]]
            ms[label] = statistics.median(step_ms)
            print(f"  {label}: {steps} mutual steps, median {ms[label]:.2f} ms per step by CUDA "
                  f"events ({card}); launches {({k: v for k, v in got.items() if v})}")
            if got != want:
                raise PhaseFailure(f"{label}: launches differ from "
                                   f"{mutual_step_want(names, dtype)} per mutual step")
            if r == 0:
                main_launches = got
            for h in history:
                for i, avg in enumerate(h["models"]):
                    if not (math.isfinite(avg["ce_loss"]) and math.isfinite(avg["kl_loss"])):
                        raise PhaseFailure(f"{label}: epoch {h['epoch']} model {i} {avg}")
            written = [p for h in history for p in h["checkpoints"]]
            if not written:
                raise PhaseFailure(f"{label}: no best-ROC checkpoint written")
            for path in written:
                name = os.path.basename(os.path.dirname(path))
                tree = ckpt.load_npz(path)
                opt = ckpt._flatten(tree["opt_state"])
                if name not in fresh:
                    fresh[name] = build_model_by_name(name, 2, device=CLI_DEVICE, seed=99)[0]
                load_variables(path, fresh[name])
                back = ckpt._flatten(export_jax_variables(fresh[name]))
                saved = ckpt._flatten({"params": tree["params"],
                                       "batch_stats": tree.get("batch_stats", {})})
                same = back.keys() == saved.keys() and all(np.array_equal(back[k], saved[k])
                                                           for k in back)
                keys = {"epoch", "val_roc", "params", "opt_state"} <= set(tree)
                print(f"    {os.path.relpath(path, out)}: epoch {int(tree['epoch'])}, train AUC "
                      f"{float(tree['val_roc']):.4f}, {len(opt)} optimizer arrays (step "
                      f"{int(tree['opt_state']['count'])}), "
                      f"{os.path.getsize(path) / 2 ** 20:.0f} MiB; read back into a fresh "
                      f"model: {'equal' if same else 'DIFFERS'}")
                if not (same and keys):
                    raise PhaseFailure(f"{path} does not read back")
            del models
        fresh.clear()

        # 12d: the repaired two_view path of cli.train, then cli.infer_mura
        print(f"phase 12d: cli.train, one epoch of singleviewmamba (image1 alone), then "
              f"cli.infer_mura with its best.npz ({card})")
        run = os.path.join(tmp, "single")
        with epoch_launches(driver, fns) as rec:
            _, hist = cli_train.main(["--model_name", "singleviewmamba", "--epochs", "1",
                                      "--savemodel_path", run] + data)
        tr = hist[0]["train"]
        bad = check_epoch_launches(rec, STEP_WANT["baseline"][F32],
                                   FORWARD_WANT["baseline"][F32])
        print(f"  train loss {tr['loss']:.6f}, val loss {hist[0]['val']['loss']:.6f}; median "
              f"{statistics.median(tr['step_ms']):.2f} ms per step ({card}); launches "
              f"{[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec]}")
        if bad or not math.isfinite(tr["loss"]):
            raise PhaseFailure(f"singleviewmamba epoch: launches {bad} or loss {tr['loss']}")
        aucs = infer_mura.main(["--model_name", "singleviewmamba", "--pretrained_model_path",
                                os.path.join(run, "best.npz"), "--data_root", tmp,
                                "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3],
                                "--image_size", str(IMAGE), "--batch_size", str(TRAIN_BATCH),
                                "--body_parts", *CLI_PARTS, "--out_dir",
                                os.path.join(tmp, "infer"), "--device", CLI_DEVICE])
        print(f"  infer_mura: AUCs {aucs}")
        if set(aucs) != set(CLI_PARTS) | {"combined"} or not all(map(math.isfinite,
                                                                   aucs.values())):
            raise PhaseFailure(f"infer_mura gave {aucs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(str(Path(__file__).resolve().parent / "tests"))
    return main_launches, ms


def phase_models(errors, card):
    """Phase 12: XFMamba-T, the baselines, mutual learning and the repaired
    CLI.  Returns (the tiny kernel times, the mutual run's launches)."""
    kernels, tiny = phase_tiny(errors, card)
    tops_ms = phase_baselines(card)
    launches, mutual_ms = phase_mutual(card)
    return {"kernels": kernels, "tiny": tiny, "tops": tops_ms, "mutual": mutual_ms,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 13: CheXpert, hip X-rays and CBIS-DDSM through the CLIs
# ---------------------------------------------------------------------------

# tree sizes, each about 10 float32 steps an epoch at bs 16: CheXpert-v1.0-small's
# images (about 390 x 320), 165 patients (219 two-view studies: 164 train, 27 val,
# 28 test); hip X-rays at 640 x 512, 195 image numbers (4 excluded or incomplete:
# 162 train, 29 val, every class in both); CBIS-DDSM at 1600 x 1000, 200 patients
# (160 train subjects, 40 in the test fold, both classes), a scale cut from the
# dataset's about 5000 x 3000, which phase 13a reads and crops once.  Each tree
# encodes a few distinct images (TREE_DISTINCT a view, or a side for the
# mammograms) and writes them under every name.
CHEX_PATIENTS, CHEX_SIZE = 165, (390, 320)
HIP_IMAGES, HIP_SIZE = 195, (640, 512)
DDSM_PATIENTS, DDSM_SIZE = 200, (1600, 1000)
TREE_DISTINCT = {"chexpert": 48, "hipxray": 16, "ddsmxray": 8}
FULL_XRAY, FULL_MAMMOGRAM = (2800, 2300), (5000, 3000)
READER_DISTINCT = 10             # phase 18b's distinct CheXpert images (2 of each kind)
DECODE_SAMPLES = 16


def time_calls(fn, args, repeat=1):
    """(seconds per call over ``args`` ``repeat`` times, the last results)."""
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = [fn(a) for a in args]
    return (time.perf_counter() - t0) / (repeat * len(args)), out


def phase_datasets(card):
    """Phase 13: the other datasets through the CLIs on the card.  (13a)
    synthetic trees (tests/torch_datasets_tree.py): CheXpert as baseline
    JPEGs, hip X-rays as JPEGs, CBIS-DDSM as 16-bit DICOMs with 8-bit ROI
    masks; JPEGs of the numpy encoder decoded by the port against the
    pixels its islow IDCT gives (gray and 4:2:0, restart intervals, then
    one of about 2,800 x 2,300 each), the decode rate on one host thread,
    a 5,000 x 3,000 mammogram read from DICOM against the written array,
    ``load_view`` with the NYU crop on it, the loader's feed at the
    CheXpert train transform (4 threads, 4 processes); (13b) two float32
    epochs of XFMamba-S through ``cli.train --dataset chexpert`` (multilabel,
    14 outputs; launches per step and per eval forward as phase 11), then
    ``cli.infer_chexpert`` with its ``best.npz`` at 14 classes and a seeded
    13-class one with ``--drop_no_finding 1``, then one epoch of
    ``cli.train_mutual --dataset chexpert`` (XFMamba-T + XFMamba-S, the
    summed steps' launches); (13c) one epoch of ``cli.train --dataset
    hipxray``; (13d) one of ``cli.train --dataset ddsmxray`` on the DICOMs,
    then ``cli.infer_ddsm --crop 1 --overlay_pass 1`` with its
    ``best.npz``.  Returns a summary of the rates and times."""
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_datasets_tree import (encode_dicom, encode_jpeg, mammogram, write_chexpert_tree,
                                     write_ddsm_tree, write_hip_tree)
    from torch_mura_tree import xray_like
    from xfmamba_tpu_torch import native
    from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
    from xfmamba_tpu_torch.checkpoint.io import save_npz
    from xfmamba_tpu_torch.cli import build_model_by_name, infer_chexpert, infer_ddsm
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.cli import train_mutual
    from xfmamba_tpu_torch.data import chexpert, ddsm, dicom, hipxray, jpeg
    from xfmamba_tpu_torch.train import driver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 13a: synthetic CheXpert, hip X-ray and CBIS-DDSM trees; the host readers "
          f"({os.cpu_count()} host cores)")
    tmp = tempfile.mkdtemp(prefix="xfm_phase13_")
    fns = all_kernels()
    out = {}
    try:
        t0 = time.perf_counter()
        chex_root = os.path.join(tmp, "chexpert")
        chex_csv, chex_images = write_chexpert_tree(
            chex_root, CHEX_PATIENTS, CHEX_SIZE, distinct=TREE_DISTINCT["chexpert"], seed=13)
        hip_images, hip_csv = write_hip_tree(os.path.join(tmp, "hip"), HIP_IMAGES, HIP_SIZE,
                                             sampling="420", distinct=TREE_DISTINCT["hipxray"],
                                             seed=13)
        ddsm_base, ddsm_meta, ddsm_cases = write_ddsm_tree(
            os.path.join(tmp, "ddsm"), DDSM_PATIENTS, DDSM_SIZE,
            distinct=TREE_DISTINCT["ddsmxray"], seed=13)
        print(f"  trees written in {time.perf_counter() - t0:.2f} s: CheXpert {len(chex_images)} "
              f"JPEGs of about {CHEX_SIZE[0]} x {CHEX_SIZE[1]}; hip X-rays {HIP_IMAGES} numbers "
              f"(4:2:0 JPEGs of about {HIP_SIZE[0]} x {HIP_SIZE[1]}); CBIS-DDSM {DDSM_PATIENTS} "
              f"patients (16-bit DICOMs of about {DDSM_SIZE[0]} x {DDSM_SIZE[1]}); distinct "
              f"images {TREE_DISTINCT}")
        # the decoder against the encoder's islow pixels, then its rate
        native.library()
        rng = np.random.default_rng(13)
        cases = [(xray_like(rng, *CHEX_SIZE), 60 + 5 * (k % 8), (None, "420", "444", "422")[k % 4],
                  k % 3) for k in range(DECODE_SAMPLES)]
        wrong = [k for k, (y, q, s, r) in enumerate(cases)
                 if not np.array_equal(jpeg.decode_gray(encode_jpeg(y, q, s, r)[0]),
                                       encode_jpeg(y, q, s, r)[1])]
        raws = {Path(p).read_bytes() for p in chex_images if p.endswith(".jpg")}
        raws = [r for r in raws if r[:2] == jpeg.SOI]
        per, _ = time_calls(jpeg.decode_gray, raws, repeat=3)
        print(f"  JPEG: {DECODE_SAMPLES - len(wrong)} of {DECODE_SAMPLES} encoder images "
              f"(gray, 4:2:0, 4:4:4, 4:2:2, restart intervals 0-2, quality 60-95) decode to the "
              f"encoder's islow pixels; CheXpert-small: {1 / per:.1f} images/s on one host "
              f"thread ({1e3 * per:.3f} ms each, {len(raws)} files)")
        out["chexpert_images_per_s"] = 1 / per
        big = xray_like(rng, *FULL_XRAY)
        for sampling in (None, "420"):
            raw, want = encode_jpeg(big, 95, sampling)
            per, (got,) = time_calls(jpeg.decode_gray, [raw], repeat=3)
            same = np.array_equal(got, want)
            kind = "gray" if sampling is None else "4:2:0"
            print(f"  JPEG {FULL_XRAY[0]} x {FULL_XRAY[1]} {kind}, quality 95, "
                  f"{len(raw) / 2 ** 20:.2f} MiB: {1e3 * per:.1f} ms per image on one host "
                  f"thread; pixels {'equal' if same else 'DIFFER'}")
            out[f"jpeg_full_{kind}_ms"] = 1e3 * per
            wrong += [] if same else [kind]
        if wrong:
            raise PhaseFailure(f"JPEG decodes differ from the encoder's pixels: {wrong}")
        img, mask = mammogram(rng, *FULL_MAMMOGRAM, "LEFT")
        full = os.path.join(tmp, "full")
        os.makedirs(full)
        Path(full, "1-1.dcm").write_bytes(encode_dicom(img))
        Path(full, "1-2.dcm").write_bytes(encode_dicom(mask, explicit=False))
        per, (px,) = time_calls(dicom.read_pixels, [os.path.join(full, "1-1.dcm")], repeat=3)
        view = dict(image_file=os.path.join(full, "1-1.dcm"),
                    mask_files=[os.path.join(full, "1-2.dcm")])
        crop_s, ((cropped, roi),) = time_calls(lambda v: ddsm.load_view(v, "left", crop=True),
                                               [view])
        print(f"  DICOM {FULL_MAMMOGRAM[0]} x {FULL_MAMMOGRAM[1]} 16-bit mammogram "
              f"({os.path.getsize(os.path.join(full, '1-1.dcm')) / 2 ** 20:.1f} MiB): "
              f"{1e3 * per:.1f} ms to read on one host thread, "
              f"{'equal to' if np.array_equal(px, img) else 'DIFFERENT FROM'} the written array; "
              f"load_view with its 8-bit mask and the NYU crop {1e3 * crop_s:.0f} ms "
              f"(crop {cropped.shape[0]} x {cropped.shape[1]}, {int(roi.sum())} ROI pixels)")
        out.update(dicom_read_ms=1e3 * per, load_view_crop_ms=1e3 * crop_s)
        if not np.array_equal(px, img) or not roi.any():
            raise PhaseFailure("the DICOM reader or load_view lost the pixels or the ROI")
        del big, img, mask, px, cropped, roi
        argv = ["--model_name", CLI_MODEL, "--image_size", str(IMAGE), "--batch_size",
                str(TRAIN_BATCH), "--num_workers", "4", "--seed", "42", "--device", CLI_DEVICE]
        chex = ["--dataset", "chexpert", "--data_root", chex_root, "--chexpert_csv", chex_csv,
                "--num_classes", "14"]
        cfg, cfg_dict = cli_train.make_config(cli_train.parse_args(argv + chex))
        loaders = chexpert.create_train_val_test_data_loaders([chex_root], [chex_csv], cfg_dict)
        train_set = loaders[0].dataset
        print(f"  CheXpert loaders: {len(train_set)} train, {len(loaders[1].dataset)} val, "
              f"{len(loaders[2].dataset)} test pairs; the feed alone at the train transform, "
              f"{IMAGE}x{IMAGE}, the train pairs {FEED_REPEAT} times over:")
        for procs in (False, True):
            first, rate, n = feed_epoch(train_set, 4, procs)
            print(f"    4 {'processes' if procs else 'threads'}: {rate:.1f} pairs/s from batch 5 "
                  f"to {n}, first batch after {first:.3f} s")
            out[f"feed_{'processes' if procs else 'threads'}_pairs_per_s"] = rate

        def epochs(label, args, want_step, want_eval, auc=True):
            """The CLI's epochs; each val AUC must be finite where the
            metrics hold one (two classes or multilabel: the reference
            reports only the accuracy of 3 classes)."""
            with epoch_launches(driver, fns) as rec:
                _, history = cli_train.main(args)
            bad = check_epoch_launches(rec, want_step, want_eval)
            steps = [v for h in history for v in h["train"]["step_ms"]]
            for h in history:
                tr, sec = h["train"], h["seconds"]
                score = h["val"]["auc"] if auc else h["val"]["accuracy"]
                print(f"  {label} epoch {h['epoch']}: train loss {tr['loss']:.6f}, val loss "
                      f"{h['val']['loss']:.6f}, val {'AUC' if auc else 'accuracy'} {score:.4f}; "
                      f"{sum(sec.values()):.2f} s (train {sec['train_s']:.2f}, waiting on the "
                      f"loader {tr['loader_wait_s']:.2f}); {tr['steps']} steps")
            print(f"  {label}: median {statistics.median(steps):.2f} ms per step by CUDA events "
                  f"over {len(steps)} steps, min {min(steps):.2f}, max {max(steps):.2f} ({card}); "
                  f"launches {[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec]}")
            scores = [h["val"]["auc"] if auc else h["val"]["accuracy"] for h in history]
            if bad or not steps or not all(math.isfinite(h[k]["loss"]) for h in history
                                           for k in ("train", "val")) \
                    or not all(map(math.isfinite, scores)):
                raise PhaseFailure(f"{label}: launches differ from {want_step} per step and "
                                   f"{want_eval} per eval forward ({bad}), no step, or a loss "
                                   f"or a val {'AUC' if auc else 'accuracy'} is not finite "
                                   f"({scores})")
            out[f"{label}_step_ms"] = statistics.median(steps)

        # 13b: CheXpert: two epochs, inference at 14 and 13 classes, mutual learning
        print(f"phase 13b: cli.train --dataset chexpert, XFMamba-S float32, {IMAGE}x{IMAGE}, bs "
              f"{TRAIN_BATCH}, 14 labels ({card})")
        run = os.path.join(tmp, "chexpert_run")
        epochs("chexpert", argv + chex + ["--epochs", "2", "--savemodel_path", run],
               F32_STEP["small"], F32_FORWARD)
        model13, _ = build_model_by_name(CLI_MODEL, 13, device="cpu", seed=3)
        save_npz(os.path.join(tmp, "w13.npz"), export_jax_variables(model13))
        del model13
        for n, ckpt in ((14, os.path.join(run, "best.npz")), (13, os.path.join(tmp, "w13.npz"))):
            res_dir = os.path.join(tmp, f"infer{n}")
            res = infer_chexpert.main(
                ["--model_name", CLI_MODEL, "--pretrained_model_path", ckpt, "--data_root",
                 chex_root, "--csv_file", chex_csv, "--image_size", str(IMAGE), "--batch_size",
                 str(TRAIN_BATCH), "--drop_no_finding", str(int(n == 13)), "--out_dir", res_dir,
                 "--device", CLI_DEVICE])
            print(f"  infer_chexpert, {n} classes: mean AUC {res['mean_auc']:.4f} over "
                  f"{len(res['per_class'])} classes with both labels in the test fold; "
                  f"{res['timing']['num_batches']} batches, {res['timing']['mean_ms']:.2f} ms "
                  f"each, {res['timing']['fps']:.1f} images/s ({card})")
            files = {"inference_timing.txt", "per_class_auc.txt"} <= set(os.listdir(res_dir))
            if not res["per_class"] or not math.isfinite(res["mean_auc"]) or not files:
                raise PhaseFailure(f"infer_chexpert at {n} classes gave {res}")
        names = MUTUAL_PAIRS[0]
        torch.cuda.synchronize()
        for fn in fns.values():
            fn.launches = 0
        models, history = train_mutual.main(
            ["--model_names", *names, "--epochs", "1", "--savemodel_path",
             os.path.join(tmp, "dml")] + argv[2:] + chex)
        torch.cuda.synchronize()
        got = {n: fn.launches for n, fn in fns.items()}
        steps = sum(len(h["step_ms"]) for h in history)
        want = dict.fromkeys(fns, 0) | {k: v * steps
                                        for k, v in mutual_step_want(names, F32).items()}
        mutual_ms = statistics.median(history[0]["step_ms"]) if steps else float("nan")
        print(f"  cli.train_mutual --dataset chexpert, {' + '.join(names)}: {steps} mutual steps, "
              f"median {mutual_ms:.2f} ms per step ({card}); CE / KL "
              f"{[(round(m['ce_loss'], 4), round(m['kl_loss'], 4)) for m in history[0]['models']]}; "
              f"launches {({k: v for k, v in got.items() if v})}")
        if not steps or got != want or not all(
                math.isfinite(m["ce_loss"]) and math.isfinite(m["kl_loss"])
                for m in history[0]["models"]):
            raise PhaseFailure(f"mutual learning on CheXpert: launches differ from "
                               f"{mutual_step_want(names, F32)} per step, or no step, or a loss "
                               "is not finite")
        out["mutual_step_ms"] = mutual_ms
        del models

        # 13c: hip X-rays
        print(f"phase 13c: cli.train --dataset hipxray, 3 classes ({card})")
        hip_args = argv + ["--dataset", "hipxray", "--hip_images_dir", hip_images, "--hip_csv",
                           hip_csv, "--num_classes", "3", "--epochs", "1", "--savemodel_path",
                           os.path.join(tmp, "hip_run")]
        _, hip_cfg = cli_train.make_config(cli_train.parse_args(hip_args))
        folds = [sorted({int(s[2]) for s in loader.dataset.samples})
                 for loader in hipxray.create_data_loaders(hip_images, hip_csv, hip_cfg)[:2]]
        print(f"  hip folds: classes {folds[0]} in train, {folds[1]} in val")
        if folds != [[0, 1, 2]] * 2:
            raise PhaseFailure(f"the hip folds lack a class: {folds}")
        epochs("hipxray", hip_args, F32_STEP["small"], F32_FORWARD, auc=False)

        # 13d: CBIS-DDSM from DICOM, then both inference passes with the crop
        print(f"phase 13d: cli.train --dataset ddsmxray on the DICOMs, then cli.infer_ddsm "
              f"--crop 1 --overlay_pass 1 ({card})")
        run = os.path.join(tmp, "ddsm_run")
        epochs("ddsmxray", argv + ["--dataset", "ddsmxray", "--data_root", ddsm_base,
                                   "--ddsm_metadata_csv", ddsm_meta, "--ddsm_case_csvs",
                                   *ddsm_cases, "--num_classes", "2", "--epochs", "1",
                                   "--savemodel_path", run],
               F32_STEP["small"], F32_FORWARD)
        t0 = time.perf_counter()
        aucs = infer_ddsm.main(["--model_name", CLI_MODEL, "--pretrained_model_path",
                                os.path.join(run, "best.npz"), "--base_dir", ddsm_base,
                                "--metadata_csv", ddsm_meta, "--case_csvs", *ddsm_cases,
                                "--crop", "1", "--overlay_pass", "1", "--image_size", str(IMAGE),
                                "--out_dir", os.path.join(tmp, "infer_ddsm"),
                                "--device", CLI_DEVICE])
        print(f"  infer_ddsm: AUCs {aucs} in {time.perf_counter() - t0:.2f} s")
        if set(aucs) != {"plain", "overlay"} or not all(map(math.isfinite, aucs.values())):
            raise PhaseFailure(f"infer_ddsm gave {aucs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(str(Path(__file__).resolve().parent / "tests"))
    return out


# ---------------------------------------------------------------------------
# phase 14: the device pipeline, --cal_flops and --gradcam
# ---------------------------------------------------------------------------

PREPROCESS_KERNELS = {
    "device_preprocess": dict(
        fn=device_preprocess.device_preprocess,
        source="xfmamba_tpu_torch/csrc/device_preprocess.cu",
        replaces="xfmamba_tpu/data/device_pipeline.py:108 (DevicePreprocess.train_batch, jnp "
                 "fused by XLA into the jitted step; no pallas_call)"),
}
# (label, stage factory, staged size, image size, train): MURA's stage at
# the loaders' staging (the resize the identity), staged at 288 with image
# size 256 and crop 224, CheXpert's and CBIS-DDSM's stages
PREPROCESS_CASES = [("mura", "mura", 224, 224), ("mura 288 -> 256, crop 224", "mura", 288, 256),
                    ("chexpert", "chexpert", 224, 224), ("ddsm", "ddsm", 224, 224)]
PREPROCESS_TOL = 1e-5
# the loader-fed epochs of 14b: device stage on / off, in turns
PREPROCESS_TURNS = (True, False, False, True)
SALIENCY_BATCH = 2


def preprocess_stage(name, size):
    from xfmamba_tpu_torch.data import device_pipeline as dp
    return {"mura": dp.mura_device_preprocess, "chexpert": dp.chexpert_device_preprocess,
            "ddsm": dp.ddsm_device_preprocess}[name]((size, size), seed=3)


def preprocess_work(B, staged, size, h):
    """One call's bytes (the staged views read once, the (B, h, h) float32
    output written once, the parameter rows and the tap tables of the
    resize to ``size`` read once) and operations: per output pixel the
    rotation's map (6), four divides and the resize's six products and
    sums, the normalize (2)."""
    nbytes = B * staged * staged + 4 * B * h * h + 4 * device_preprocess.ROW * B + 24 * size
    return Work().add(bytes=nbytes, f32=B * h * h * 18)


def phase_preprocess_kernel(errors, card):
    """14a: the kernel against its plain version on the card, bs 16, train
    and eval transforms of every case: the crop windows, flips, zero-fill
    masks and source indices bit for bit (ramps of the row and of the column
    and a constant 255, the resize the identity, no normalize), the values
    within PREPROCESS_TOL, bitwise over two runs; then the MURA bs-16 train
    call's ms (CUDA events and CUDA-graph replay), the plain version's, the
    bound.  Returns (max error, per-step times of two views)."""
    print(f"phase 14a: the device preprocessing kernel against its plain version, bs "
          f"{TRAIN_BATCH}, uint8 views ({card})")
    fn = device_preprocess.device_preprocess
    g = torch.Generator().manual_seed(14)
    worst, failed = 0.0, []
    for label, name, staged, size in PREPROCESS_CASES:
        stage = preprocess_stage(name, size)
        u8 = torch.randint(0, 256, (TRAIN_BATCH, staged, staged, 1), generator=g,
                           dtype=torch.uint8)
        rows = stage.rows(stage.draw_params(TRAIN_BATCH, g))
        c = stage.crop_size
        h = c or size
        norm = {} if stage.normalize_mean is None else {"mean": stage.normalize_mean,
                                                        "std": stage.normalize_std}
        for train in (True, False):
            args = ((size, size), rows.cuda(), c, bool(stage.rotation)) if train \
                else ((size, size),)
            plain_args = ((size, size), rows, c, bool(stage.rotation)) if train else ((size, size),)
            before = fn.launches
            got = fn(u8.cuda(), *args, **norm)
            again = fn(u8.cuda(), *args, **norm)
            torch.cuda.synchronize()
            want = device_preprocess.device_preprocess_plain(u8, *plain_args, **norm)
            err = float((got.cpu() - want).abs().max())
            bitwise = torch.equal(got, again) and fn.launches == before + 2
            # the index maps: ramps through the kernel and the plain version
            # at the image size (the resize the identity), no normalize
            maps = True
            if train:
                ys = torch.arange(size) % 256
                for ramp in (ys.view(1, size, 1, 1).expand(TRAIN_BATCH, size, size, 1),
                             ys.view(1, 1, size, 1).expand(TRAIN_BATCH, size, size, 1),
                             torch.full((TRAIN_BATCH, size, size, 1), 255)):
                    ramp = ramp.to(torch.uint8).contiguous()
                    k = fn(ramp.cuda(), (size, size), rows.cuda(), c, bool(stage.rotation))
                    p = device_preprocess.device_preprocess_plain(ramp, (size, size), rows, c,
                                                                  bool(stage.rotation))
                    maps &= torch.equal(k.cpu(), p)
            kind = "train" if train else "eval"
            print(f"  {label} {kind}: {tuple(u8.shape)} -> {tuple(got.shape)}, max_abs_err "
                  f"{err:.3e}, bitwise over two runs {bitwise}"
                  + (f", index maps, flips, crops and zero-fill masks bit for bit {maps}"
                     if train else ""))
            worst = max(worst, err)
            if not (err <= PREPROCESS_TOL and bitwise and maps) or got.shape != (
                    TRAIN_BATCH, h if train else size, h if train else size, 1):
                failed.append(f"{label} {kind}")
    errors["device_preprocess"] = worst
    if failed:
        raise PhaseFailure(f"the device preprocessing kernel disagrees with its plain version: "
                           f"{failed}")
    # times of one view's call at the main path's shape (MURA, staged 224)
    stage = preprocess_stage("mura", IMAGE)
    u8 = torch.randint(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 1), generator=g,
                       dtype=torch.uint8).cuda()
    rows = stage.rows(stage.draw_params(TRAIN_BATCH, g)).cuda()
    call = lambda: stage.train_batch(u8, rows)  # noqa: E731
    plain_u8, plain_rows = u8.clone(), rows.clone()
    plain = lambda: device_preprocess.device_preprocess_plain(  # noqa: E731
        plain_u8, stage.image_size, plain_rows, None, True, mean=0.456, std=0.224)
    ms = time_ms(call, 50)
    dev = graph_ms(call, 50)
    plain_ms = time_ms(plain, 5)
    bound, by = preprocess_work(TRAIN_BATCH, IMAGE, IMAGE, IMAGE).bound()
    eval_ms = time_ms(lambda: stage.eval_batch(u8), 50)
    print(f"  MURA bs-{TRAIN_BATCH} train call: {ms:.4f} ms by CUDA events, {dev:.4f} on the "
          f"device (CUDA-graph replay), plain {plain_ms:.3f}, bound {bound:.4f} ({by}); eval "
          f"call {eval_ms:.4f} ms; per step (two views) {2 * ms:.4f} / {2 * plain_ms:.3f} / "
          f"{2 * bound:.4f} ms ({card})")
    V1_EXTRA["device_preprocess"] = {"graph_ms": 2 * dev, "eval_call_ms": eval_ms,
                                     "per": f"bs-{TRAIN_BATCH} train step, two views"}
    return {"device_preprocess": (2 * ms, 2 * plain_ms, 2 * bound, by)}, call


def phase_preprocess_epochs(card, tmp):
    """14b: ``cli.train --device_preprocess 1`` on a MURA tree as phase
    11's (XFMamba-S float32, 4 loader threads): launches per step (kernel
    11's and the fusion scans' as phase 11, 2 of the stage kernel) and per
    eval forward (2); then loader-fed epochs of the step (the train pairs
    FEED_REPEAT times over) with the device stage on and off in turns:
    median step ms, loader wait a step, pairs/s; 4 steps with the stage on
    one batch of label 1 (a falling loss); one hip X-ray epoch with the
    device stage, its staged validation batch through ``eval_batch``
    against the host eval transform (1e-6); one CheXpert and one CBIS-DDSM
    epoch with the device stage.  Returns the launches per train step."""
    import os
    import statistics

    import numpy as np
    from torch_datasets_tree import write_chexpert_tree, write_ddsm_tree, write_hip_tree
    from torch_mura_tree import write_mura_tree
    from xfmamba_tpu_torch.cli import build_model_by_name
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.data import hipxray, mura
    from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
    from xfmamba_tpu_torch.train import driver

    print(f"phase 14b: cli.train --device_preprocess 1, XFMamba-S float32 at {IMAGE}x{IMAGE}, "
          f"bs {TRAIN_BATCH}, 4 loader threads ({card})")
    t0 = time.perf_counter()
    csvs, _ = write_mura_tree(tmp, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                              n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=11)
    hip_images, hip_csv = write_hip_tree(os.path.join(tmp, "hip"), 60, distinct=8, seed=14)
    chex_csv, _ = write_chexpert_tree(os.path.join(tmp, "chexpert"), 48, distinct=8, seed=14)
    ddsm_base, ddsm_meta, ddsm_cases = write_ddsm_tree(os.path.join(tmp, "ddsm"), 48,
                                                       distinct=4, seed=14)
    print(f"  trees written in {time.perf_counter() - t0:.2f} s")
    fns = all_kernels()
    argv = ["--model_name", CLI_MODEL, "--image_size", str(IMAGE), "--batch_size",
            str(TRAIN_BATCH), "--num_workers", "4", "--seed", "42", "--device", CLI_DEVICE,
            "--epochs", "1", "--device_preprocess", "1"]
    mura_args = ["--data_root", tmp, "--train_image_csv", csvs[0], "--train_label_csv", csvs[1],
                 "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3]]
    step_want = F32_STEP["small"] | {"device_preprocess": 2}
    eval_want = F32_FORWARD | {"device_preprocess": 2}
    datasets = {
        "mura": mura_args,
        "hipxray": ["--dataset", "hipxray", "--hip_images_dir", hip_images, "--hip_csv", hip_csv,
                    "--num_classes", "3"],
        "chexpert": ["--dataset", "chexpert", "--data_root", os.path.join(tmp, "chexpert"),
                     "--chexpert_csv", chex_csv, "--num_classes", "14"],
        "ddsmxray": ["--dataset", "ddsmxray", "--data_root", ddsm_base, "--ddsm_metadata_csv",
                     ddsm_meta, "--ddsm_case_csvs", *ddsm_cases]}
    for label, extra in datasets.items():
        with epoch_launches(driver, fns) as rec:
            _, history = cli_train.main(argv + extra + ["--savemodel_path",
                                                        os.path.join(tmp, f"run_{label}")])
        tr, va = history[0]["train"], history[0]["val"]
        bad = check_epoch_launches(rec, step_want, eval_want)
        print(f"  {label}: train loss {tr['loss']:.6f}, val loss {va['loss']:.6f}, {tr['steps']} "
              f"steps, median {statistics.median(tr['step_ms']):.2f} ms per step; launches "
              f"{[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec]}")
        if bad or not (math.isfinite(tr["loss"]) and math.isfinite(va["loss"])):
            raise PhaseFailure(f"{label} with the device stage: launches differ from {step_want} "
                               f"per step and {eval_want} per eval forward ({bad}), or a loss "
                               "is not finite")
    # the hip loader stages uint8; its eval batch through the card equals the
    # host eval transform
    _, hip_cfg = cli_train.make_config(cli_train.parse_args(argv + datasets["hipxray"]))
    staged = next(iter(hipxray.create_data_loaders(hip_images, hip_csv, hip_cfg)[1]))
    host = next(iter(hipxray.create_data_loaders(hip_images, hip_csv,
                                                 dict(hip_cfg, device_preprocess=False))[1]))
    stage = preprocess_stage("mura", IMAGE)
    nv = int(staged["n_valid"])
    hip_err = max(float((stage.eval_batch(torch.from_numpy(staged[k][:nv]).cuda()).cpu()
                         - torch.from_numpy(host[k][:nv])).abs().max()) for k in ("image1", "image2"))
    print(f"  hip validation batch: staged {staged['image1'].dtype} {staged['image1'].shape}, "
          f"through eval_batch on the card against the host eval transform: max_abs_err "
          f"{hip_err:.3e} over {nv} studies")
    if staged["image1"].dtype != np.uint8 or not hip_err <= 1e-6:
        raise PhaseFailure(f"the hip loader's staged batch differs from the host transform "
                           f"({hip_err})")

    # loader-fed epochs, the device stage on and off in turns
    cfg, cfg_dict = cli_train.make_config(cli_train.parse_args(argv + mura_args))
    model, _ = build_model_by_name(CLI_MODEL, 2, device=CLI_DEVICE, seed=cfg.seed)
    runs = {True: [], False: []}
    for on in PREPROCESS_TURNS:
        loader = mura.create_data_loaders(*csvs, dict(cfg_dict, device_preprocess=on))[0]
        long_loader = TwoViewLoader(
            TwoViewSamples(loader.dataset.samples * FEED_REPEAT, loader.dataset.load_fn,
                           loader.dataset.transform),
            TRAIN_BATCH, shuffle=True, drop_last=True, num_workers=4, seed=cfg.seed)
        stage = preprocess_stage("mura", IMAGE) if on else None
        step, _ = make_train_step(model, make_optimizer(cfg, model.parameters()), False,
                                  preprocess=stage)
        tr = driver.run_train_epoch(step, long_loader, cfg.lr, False, CLI_DEVICE,
                                    torch.uint8 if on else torch.float32, log_every=0)
        rest = (tr["loader_wait_s"] - tr["first_batch_wait_s"]) / (tr["steps"] - 1)
        rate = tr["steps"] * TRAIN_BATCH / (tr["time_s"] - tr["first_batch_wait_s"])
        runs[on].append((statistics.median(tr["step_ms"]), rest, rate))
        print(f"  loader-fed epoch, device stage {'on ' if on else 'off'}: {tr['steps']} steps, "
              f"median {runs[on][-1][0]:.2f} ms per step by CUDA events, waiting "
              f"{1e3 * rest:.1f} ms a step after the first batch, {rate:.1f} pairs/s, loss "
              f"{tr['loss']:.5f} ({card})")
        if not math.isfinite(tr["loss"]):
            raise PhaseFailure(f"the loader-fed epoch's loss is {tr['loss']}")
    mean = {on: [statistics.fmean(v) for v in zip(*r)] for on, r in runs.items()}
    print(f"  device stage on / off (means of {len(runs[True])} epochs each): step "
          f"{mean[True][0]:.2f} / {mean[False][0]:.2f} ms, loader wait "
          f"{1e3 * mean[True][1]:.1f} / {1e3 * mean[False][1]:.1f} ms a step, feed "
          f"{mean[True][2]:.1f} / {mean[False][2]:.1f} pairs/s ({card})")
    # a falling loss with the device stage: 4 steps on one batch of label 1
    loader = mura.create_data_loaders(*csvs, cfg_dict)[0]
    batch = driver._to_device(next(iter(loader)), CLI_DEVICE, torch.uint8, False)
    batch["label"] = torch.ones_like(batch["label"])
    step, _ = make_train_step(model, make_optimizer(cfg, model.parameters()), False,
                              preprocess=preprocess_stage("mura", IMAGE))
    losses = [float(step(batch, cfg.lr)["loss"]) for _ in range(TOP_STEPS)]
    print(f"  {TOP_STEPS} steps with the device stage on one batch of label 1: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise PhaseFailure(f"the loss with the device stage is not finite or not falling: "
                           f"{losses}")
    del model, step
    return {"device_preprocess": 2}, csvs


def phase_utilities(card, tmp, csvs, call):
    """14c: ``cli.infer_mura --cal_flops 1`` on the card and on the CPU (the
    same params and FLOPs), then ``--gradcam 1`` (XFMamba-S float32 at
    224, batch SALIENCY_BATCH; gradcam.npz written); Grad-CAM of the model
    at full widths and depths 2/2/2/2, batch SALIENCY_BATCH, on the card
    against the CPU: the stage-3 gradients (1e-3 of the largest) and the
    CAMs (1e-3), the fusion scans on their differentiable kernels (13/14
    at this batch) and kernels 3 and 9 not at all; in bfloat16 the CAMs
    finite, their largest difference from float32 printed; the guard: an
    eval forward on the card whose operands require a gradient, outside
    ``no_grad``, refused by the bfloat16 stage kernel, and kernel 9 and
    kernel 3 refusing one directly.  14d: ``do_bench`` of the kernel and a
    ``trace`` of it; whether the trace holds the kernel's device events."""
    import os

    import numpy as np
    from xfmamba_tpu_torch.cli import infer_mura
    from xfmamba_tpu_torch.utils import profiling, saliency

    print(f"phase 14c: cli.infer_mura --cal_flops 1 and --gradcam 1, XFMamba-S float32 at "
          f"{IMAGE}x{IMAGE} ({card})")
    base = ["--model_name", CLI_MODEL, "--image_size", str(IMAGE), "--data_root", tmp,
            "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3]]
    counts = {}
    for device in (CLI_DEVICE, "cpu"):
        counts[device] = infer_mura.main(base + ["--cal_flops", "1", "--device", device])
    print(f"  --cal_flops: card {counts[CLI_DEVICE]}, CPU {counts['cpu']}")
    if counts[CLI_DEVICE]["flops"] != counts["cpu"]["flops"] or \
            counts[CLI_DEVICE]["params"] != counts["cpu"]["params"]:
        raise PhaseFailure("--cal_flops counts differ between the card and the CPU")
    out = os.path.join(tmp, "gradcam")
    fns = all_kernels()
    torch.cuda.synchronize()
    c0 = counted(fns)
    infer_mura.main(base + ["--gradcam", "1", "--batch_size", str(SALIENCY_BATCH),
                            "--body_parts", *CLI_PARTS, "--out_dir", out, "--device", CLI_DEVICE])
    torch.cuda.synchronize()
    saved = np.load(os.path.join(out, "gradcam.npz"))
    print(f"  --gradcam: gradcam.npz {({k: saved[k].shape for k in saved.files})}, overlays "
          f"{sorted(f for f in os.listdir(out) if f.startswith('gradcam_overlay'))}; launches "
          f"{ {k: v for k, v in c0().items() if v} }")
    if not all(np.isfinite(saved[k]).all() for k in ("cam_a", "cam_b")) or \
            saved["cam_a"].shape != (SALIENCY_BATCH, IMAGE, IMAGE):
        raise PhaseFailure("--gradcam wrote no finite CAMs of the batch's shape")

    # card against CPU, the model at depths 2/2/2/2
    model = depth2_model("small").eval()
    xa, xb = (x.cpu() for x in views(SALIENCY_BATCH, torch.float32, 140))
    t0 = time.time()
    cpu = saliency.grad_cam_two_view(model, xa, xb, 1, return_gradients=True)
    cpu_s = time.time() - t0
    model.cuda()
    c0 = counted(fns)
    card_out = saliency.grad_cam_two_view(model, xa.cuda(), xb.cuda(), 1, return_gradients=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in c0().items() if v}
    g_err = rel(card_out[2][1].cpu(), cpu[2][1])[1]
    cam_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_out[:2], cpu[:2]))
    bf = saliency.grad_cam_two_view(model, xa.cuda().bfloat16(), xb.cuda().bfloat16(), 1)
    bf_diff = max(float((a.float() - b).abs().max()) for a, b in zip(bf, card_out[:2]))
    bf_finite = all(bool(torch.isfinite(c).all()) for c in bf)
    print(f"  Grad-CAM, full widths, depths 2/2/2/2, batch {SALIENCY_BATCH}: stage-3 gradients "
          f"card vs CPU rel {g_err:.3e}, CAMs max_abs_err {cam_err:.3e} (tol 1e-3; CPU {cpu_s:.1f} "
          f"s); launches {launches}; bfloat16 CAMs finite {bf_finite}, largest difference from "
          f"float32 {bf_diff:.3e} (not gated)")
    if not (g_err <= 1e-3 and cam_err <= 1e-3 and bf_finite) or launches.get("nk_scan_x") or \
            launches.get("nk_scan_v1"):
        raise PhaseFailure("Grad-CAM on the card disagrees with the CPU, took a forward-only "
                           "fusion scan, or gave no finite bfloat16 CAM")
    guard_refusals(model, xa, xb)
    del model

    # 14d: do_bench and trace
    print(f"phase 14d: utils.profiling on the kernel ({card})")
    bench = profiling.do_bench(call, warmup=3, iters=20)
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir) as prof:
        for _ in range(10):
            call()
    device_rows = [e.key for e in prof.key_averages() if "device_preprocess" in e.key
                   and getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0]
    events = json.loads(Path(logdir, "trace.json").read_text()).get("traceEvents", [])
    kernel_events = [e for e in events if e.get("cat") == "kernel"
                     and "device_preprocess" in e.get("name", "")]
    print(f"  do_bench: median {1e3 * bench['median_s']:.4f} ms, min {1e3 * bench['min_s']:.4f} "
          f"over {bench['iters']} calls (host clock, synchronised around each); trace "
          f"{len(events)} events, {len(kernel_events)} device events of the kernel"
          + ("" if len(kernel_events) == 10 else " (the profiler dropped some: "
                                                 "utils/profiling.py's docstring)")
          + f"; profiler rows with device time {device_rows}")


def guard_refusals(model, xa, xb):
    """The guard on the card: ``model``'s bfloat16 eval forward outside
    ``no_grad`` (its eval stage refuses parameters that require a
    gradient), and kernels 1, 8, 9 and 3 each given an operand that
    requires one, must raise."""
    refused = []
    x16 = [x.cuda().bfloat16() for x in (xa, xb)]
    try:
        model(*x16)
    except RuntimeError as e:
        refused.append("eval forward, bfloat16" if "no gradient" in str(e) else str(e))
    k9 = [torch.randn(3, 49, d, device="cuda", requires_grad=i == 0)
          for i, d in enumerate((64, 256, 64, 64))]
    block = VSSBlock(96, generator=torch.Generator().manual_seed(3)).eval().cuda()
    xb16 = torch.randn(2, 49, 96, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    for name, call_guarded in (
            ("vss_stage", lambda: vss_stage.vss_stage(
                xb16, [pack_vss_block_params(block, torch.bfloat16)], 7, 7)),
            ("vss_block_v1", lambda: vss_block_v1.vss_block_v1(
                xb16, vss_block_v1.pack_vss_block_v1_params(block, torch.bfloat16), 7, 7)),
            ("nk_scan_v1", lambda: nk_scan_v1.nk_scan_v1(
                k9[0], k9[1], k9[2], k9[3], -torch.ones(64, 64, device="cuda"),
                torch.ones(4, 64, device="cuda"), torch.zeros(4, 64, device="cuda"), 7, 7,
                ("row_f", "col_f", "row_r", "col_r"))),
            ("nk_scan_x", lambda: nk_scan.nk_scan_x(
                k9[0], torch.randn(3, 49, 16, device="cuda"), k9[2], k9[3],
                torch.randn(16, 64, device="cuda"), -torch.ones(64, 64, device="cuda"),
                torch.ones(4, 64, device="cuda"), torch.zeros(4, 64, device="cuda"),
                torch.stack([torch.ones(64), torch.zeros(64)]).cuda(), 7, 7,
                ("row_f", "col_f", "row_r", "col_r")))):
        try:
            call_guarded()
        except RuntimeError as e:
            if "no gradient" in str(e):
                refused.append(name)
    print(f"  the guard on the card: refused {refused}")
    if refused != ["eval forward, bfloat16", "vss_stage", "vss_block_v1", "nk_scan_v1",
                   "nk_scan_x"]:
        raise PhaseFailure(f"a forward-only kernel took an operand that requires a gradient: "
                           f"refused only {refused}")


def phase_device_pipeline(errors, card):
    """Phase 14: the device preprocessing kernel (14a), the CLIs with the
    device stage (14b), the utilities (14c, 14d).  Returns (launches, times)
    for the kernels line."""
    import shutil
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    tmp = tempfile.mkdtemp(prefix="xfm_phase14_")
    try:
        times, call = phase_preprocess_kernel(errors, card)
        launches, csvs = phase_preprocess_epochs(card, tmp)
        phase_utilities(card, tmp, csvs, call)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(str(Path(__file__).resolve().parent / "tests"))
    return launches, times


# phase 15: data parallelism (two ranks share the card over gloo; NCCL in a
# world of one)
DP_WORLD, DP_STEPS, DP_LR = 2, 3, 1e-4
DP_TRAIN_PAIRS, DP_VAL_PAIRS = DP_STEPS * TRAIN_BATCH, 12
# losses, logits and BN statistics of two ranks against one: float32 on the
# card, batches of 8 against 16 (other GEMM tilings) and the statistics
# summed over the ranks
DP_TOL = 1e-4
DP_MUTUAL = ("twoviewxfmamba_tiny", "twoviewxfmamba")


class DPViews:
    """Load function of phase 15a: sample (i, label) -> two seeded float32
    views (IMAGE, IMAGE, 1) and the label (picklable for spawned ranks)."""

    def __call__(self, sample):
        import numpy as np
        i, label = sample
        views = np.random.default_rng(1500 + i).standard_normal((2, IMAGE, IMAGE, 1),
                                                                dtype=np.float32)
        return views[0], views[1], np.int64(label)


def dp_fit(world, rank=0, port=0, out=None, backend="gloo"):
    """Phase 15a's run of ``driver.fit`` (one epoch of DP_STEPS steps of
    XFMamba-S at the global batch TRAIN_BATCH, float32, then the eval pass
    of DP_VAL_PAIRS pairs padded to a batch), as rank ``rank`` of a group
    of ``world`` ranks (gloo: all on card 0; NCCL: rank r on card r), or
    alone (``world`` 0).  Records
    each step's loss, this rank's logits and launches, the eval pass's
    (gathered) logits and loss, the final weights and the steps' ms; saved
    to ``out/rank{rank}.pt`` by a rank, returned alone."""
    from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
    from xfmamba_tpu_torch.train import driver
    if world:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        torch.distributed.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                             world_size=world, rank=rank)
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = {name: k["fn"] for name, k in (N1_KERNELS | TRAIN_KERNELS | KERNELS
                                         | GROUPED_KERNELS).items()}
    record = {"steps": []}
    make_step, run_eval = driver.make_train_step, driver.run_eval_epoch

    def counted_make(*args, **kw):
        train_step, eval_step = make_step(*args, **kw)

        def step(batch, lr=None, reduce=None):
            for fn in fns.values():
                fn.launches = 0
            out = train_step(batch, lr, reduce=reduce)
            torch.cuda.synchronize()
            record["steps"].append({"loss": float(out["loss"]),
                                    "logits": out["logits"].float().cpu(),
                                    "launches": {n: f.launches for n, f in fns.items()
                                                 if f.launches}})
            return out
        return step, eval_step

    def recorded_eval(*args, **kw):
        stats, logits, labels = run_eval(*args, **kw)
        record["eval"] = (stats["loss"], logits, labels)
        return stats, logits, labels

    samples = [(i, i % 2) for i in range(DP_TRAIN_PAIRS + DP_VAL_PAIRS)]
    train_loader = TwoViewLoader(TwoViewSamples(samples[:DP_TRAIN_PAIRS], DPViews()),
                                 TRAIN_BATCH, drop_last=True, num_workers=2)
    val_loader = TwoViewLoader(TwoViewSamples(samples[DP_TRAIN_PAIRS:], DPViews()), TRAIN_BATCH,
                               num_workers=2)
    cfg = TrainConfig(epochs=1, batch_size=TRAIN_BATCH, eval_batch_size=TRAIN_BATCH, lr=DP_LR,
                      weight_decay=1e-5, scheduler="none", data_parallel=True)
    driver.make_train_step, driver.run_eval_epoch = counted_make, recorded_eval
    try:
        model = two_view_xfmamba("small", seed=0)
        state, history = driver.fit(model, cfg, train_loader, val_loader, out_dir=out or ".",
                                    save_checkpoints=False, log_fn=lambda *a, **k: None)
    finally:
        driver.make_train_step, driver.run_eval_epoch = make_step, run_eval
    record["state"] = {k: v.detach().cpu() for k, v in state["model"].items()}
    record["step_ms"] = history[0]["train"].get("step_ms", [])
    del model, state
    if world:
        torch.save(record, Path(out) / f"rank{rank}.pt")
        torch.distributed.destroy_process_group()
    return record


def dp_rank(rank, world, port, out, backend="gloo"):
    dp_fit(world, rank, port, out, backend)


def phase_dp_fit(card, tmp, world=DP_WORLD, backend="gloo", phase="15a"):
    """15a: ``world`` ranks (two gloo ranks sharing the card; with
    ``--cards``, NCCL ranks, one a card) through ``parallel.mesh`` and
    ``fit`` against one rank alone (`dp_fit`)."""
    where = "sharing the card" if backend == "gloo" else "one a card"
    print(f"phase {phase}: XFMamba-S float32 {IMAGE}x{IMAGE} through fit, global batch "
          f"{TRAIN_BATCH}, {DP_STEPS} steps and an eval pass ({DP_VAL_PAIRS} pairs in a padded "
          f"batch): {world} {backend} ranks {where} against one rank ({card})")
    from xfmamba_tpu_torch.parallel.distributed import free_port
    one = dp_fit(0)
    torch.cuda.empty_cache()
    t0 = time.time()
    torch.multiprocessing.spawn(dp_rank, args=(world, free_port(), tmp, backend), nprocs=world)
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    print(f"  {world} ranks in {time.time() - t0:.1f} s (start, build, {DP_STEPS} steps, eval)")
    worst = {"loss": 0.0, "logits": 0.0, "eval": 0.0, "bn": 0.0}
    for i, want in enumerate(one["steps"]):
        got = [r["steps"][i] for r in ranks]
        worst["loss"] = max(worst["loss"], *(abs(g["loss"] - want["loss"]) /
                                             max(1.0, abs(want["loss"])) for g in got))
        logits = torch.cat([g["logits"] for g in got])
        worst["logits"] = max(worst["logits"], rel(logits, want["logits"])[1])
        counts = [g["launches"] for g in got]
        print(f"  step {i}: loss {want['loss']:.6f} one rank, "
              f"{' / '.join(f'{g['loss']:.6f}' for g in got)} ranks 0-{world - 1}; launches per "
              f"rank {counts[0]} (one rank at bs {TRAIN_BATCH}: {want['launches']})")
        if any(c != counts[0] for c in counts) or any(
                c.get(n) != 21 for c in counts for n in ("ss2d_core_n1_fwd", "ss2d_core_n1_bwd")):
            raise PhaseFailure(f"step {i}: the ranks' launches {counts} differ or miss kernels "
                               f"11 and 12 at 21 each")
    want_loss, want_logits, want_labels = one["eval"]
    for r in ranks:
        loss, logits, labels = r["eval"]
        worst["eval"] = max(worst["eval"], abs(loss - want_loss) / max(1.0, abs(want_loss)),
                            rel(torch.from_numpy(logits), torch.from_numpy(want_logits))[1])
        if labels.tolist() != want_labels.tolist():
            raise PhaseFailure("the ranks' gathered eval labels are not one rank's")
    params = {k: v for k, v in one["state"].items() if v.is_floating_point()}
    for k, want in params.items():
        if any(not torch.equal(ranks[0]["state"][k], r["state"][k]) for r in ranks[1:]):
            raise PhaseFailure(f"the ranks' {k} differ")
        if "running" in k:
            worst["bn"] = max(worst["bn"], rel(ranks[0]["state"][k], want)[1])
    diffs = [(ranks[0]["state"][k] - want).abs() for k, want in params.items()
             if "running" not in k]
    p_max = max(float(d.max()) for d in diffs)
    p_mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
    print(f"  {world} ranks against one: loss rel {worst['loss']:.3e}, logits rel "
          f"{worst['logits']:.3e}, eval loss and logits rel {worst['eval']:.3e}, BN running "
          f"statistics rel {worst['bn']:.3e} (tol {DP_TOL:.0e}); parameters after {DP_STEPS} "
          f"Adam steps max {p_max:.3e} (tol {2 * DP_STEPS * DP_LR:.0e}: a near-zero Adam input "
          f"can flip), mean {p_mean:.3e} (tol 1e-6); ranks' weights bit for bit equal")
    how = ("the steps of both ranks share the card, the gradients cross the host through gloo"
           if backend == "gloo" else "a card each, NCCL")
    print(f"  ms per step (CUDA events on each process's stream; {how}): one rank "
          f"{', '.join(f'{v:.2f}' for v in one['step_ms'])}; "
          + "; ".join(f"rank {r} " + ", ".join(f"{v:.2f}" for v in rk["step_ms"])
                      for r, rk in enumerate(ranks)) + f" ({card})")
    if max(worst.values()) > DP_TOL or p_max > 2 * DP_STEPS * DP_LR or p_mean > 1e-6:
        raise PhaseFailure(f"two ranks disagree with one: {worst}, parameters {p_max}, {p_mean}")


DP_CLI_CODE = (
    "import sys, torch\n"
    "from xfmamba_tpu_torch.cli import train\n"
    "state, history = train.main(sys.argv[2:])\n"
    "torch.save({'model': {k: v.cpu() for k, v in state['model'].items()},"
    " 'history': history}, sys.argv[1])\n")


def phase_dp_clis(card, tmp):
    """15b: ``cli.train`` for one epoch in two ranks under torchrun's
    environment (gloo, both on card 0), then a resume of rank 0's
    ``last.pt``; 15c, at the same time: ``cli.train_mutual`` with
    ``--coordinator_address`` in a world of one (NCCL)."""
    import os
    from torch_mura_tree import write_mura_tree
    from xfmamba_tpu_torch.checkpoint import io as ckpt
    from xfmamba_tpu_torch.cli import build_model_by_name
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.data import mura
    from xfmamba_tpu_torch.parallel.distributed import BACKEND_ENV, free_port
    from xfmamba_tpu_torch.train import driver

    print(f"phase 15b: cli.train, {DP_WORLD} ranks under torchrun's environment sharing the "
          f"card over gloo, one epoch of XFMamba-S on phase 11's tree; 15c at the same time: "
          f"cli.train_mutual --coordinator_address in a world of one (NCCL) ({card})")
    csvs, _ = write_mura_tree(tmp, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                              n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=11)
    data = ["--image_size", str(IMAGE), "--batch_size", str(TRAIN_BATCH), "--data_root", tmp,
            "--train_image_csv", csvs[0], "--train_label_csv", csvs[1], "--valid_image_csv",
            csvs[2], "--valid_label_csv", csvs[3], "--num_workers", "4", "--epochs", "1",
            "--device", CLI_DEVICE]
    argv = ["--model_name", CLI_MODEL, "--seed", "42"] + data
    port = free_port()
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if k != BACKEND_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_CLI_CODE, str(Path(tmp) / f"cli{r}.pt"), *argv,
         "--savemodel_path", str(Path(tmp) / f"run{r}")],
        env=env | {"RANK": str(r), "WORLD_SIZE": str(DP_WORLD), "LOCAL_RANK": "0",
                   "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   BACKEND_ENV: "gloo"},
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_WORLD)]
    mutual = subprocess.Popen(
        [sys.executable, "-m", "xfmamba_tpu_torch.cli.train_mutual", "--coordinator_address",
         f"127.0.0.1:{free_port()}", "--num_processes", "1", "--process_id", "0",
         "--savemodel_path", str(Path(tmp) / "mutual"), "--model_names", *DP_MUTUAL] + data,
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.time()
    logs = [p.communicate(timeout=600)[0] for p in procs + [mutual]]
    print(f"  {time.time() - t0:.1f} s for the three processes")
    for p, log in zip(procs + [mutual], logs):
        if p.returncode != 0:
            raise PhaseFailure(f"a CLI process failed (rc {p.returncode}):\n{log[-3000:]}")
    print("  " + "\n  ".join(line for line in logs[0].splitlines() if line.startswith(
        ("device", "epoch", "done", "data-parallel"))))
    runs = [torch.load(Path(tmp) / f"cli{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    files = sorted(str(f.relative_to(Path(tmp) / "run0")) for f in (Path(tmp) / "run0").rglob("*")
                   if f.is_file())
    differ = [k for k, v in runs[0]["model"].items() if not torch.equal(v, runs[1]["model"][k])]
    print(f"  rank 0 wrote {files}; rank 1 wrote {'nothing' if not (Path(tmp) / 'run1').exists() else 'files'}; "
          f"the ranks' weights differ in {len(differ)} tensors")
    if (Path(tmp) / "run1").exists() or differ or "last.pt" not in files \
            or "best.npz" not in files:
        raise PhaseFailure(f"15b: rank 1 wrote files, the ranks' weights differ ({differ[:3]}) "
                           f"or rank 0's files are missing ({files})")
    # last.pt resumes: one more epoch, one rank
    cfg, cfg_dict = cli_train.make_config(cli_train.parse_args(argv + ["--epochs", "2"]))
    train_loader, val_loader, _ = mura.create_data_loaders(*csvs, cfg_dict)
    model, _ = build_model_by_name(CLI_MODEL, 2, seed=42, device=CLI_DEVICE)
    state = ckpt.load_state(str(Path(tmp) / "run0" / "last.pt"))
    _, history = driver.fit(model, cfg, train_loader, val_loader, init_state=state,
                            save_checkpoints=False, log_fn=lambda *a, **k: None)
    print(f"  resumed from rank 0's last.pt: epochs {[h['epoch'] for h in history]}, epoch 1 "
          f"train loss {history[-1]['train']['loss']:.6f}, val loss "
          f"{history[-1]['val']['loss']:.6f}")
    if [h["epoch"] for h in history] != [0, 1] or not math.isfinite(history[-1]["train"]["loss"]):
        raise PhaseFailure(f"15b: the resumed run gave {history}")
    del model
    out = logs[-1]
    lines = [line for line in out.splitlines() if line.startswith(("epoch", "data-parallel"))]
    print("  15c: " + "\n  15c: ".join(lines))
    written = list((Path(tmp) / "mutual").rglob("best_model_0.npz"))
    if "nccl" not in out or len(written) != len(set(DP_MUTUAL)):
        raise PhaseFailure(f"15c: no NCCL group or no best-ROC files ({written}):\n{out[-2000:]}")


def phase_data_parallel(card):
    """Phase 15: data parallelism on the card (15a-15c)."""
    import shutil
    import tempfile
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    tmp = tempfile.mkdtemp(prefix="xfm_phase15_")
    try:
        phase_dp_fit(card, tmp)
        phase_dp_clis(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        sys.path.remove(str(Path(__file__).resolve().parent / "tests"))


# ---------------------------------------------------------------------------
# phase 16: vanilla VMamba and the other SS2D forward types
# ---------------------------------------------------------------------------

VANILLA_BATCHES = (8, 32, 1)
VANILLA_STEPS = 5
# kernel by route of an SS2D core: forward, backward
ROUTE_KERNELS = {"nk": ("nk_scan", "nk_scan_bwd"),
                 "grouped": ("selective_scan_grouped_fwd", "selective_scan_grouped_bwd")}
# (forward type, d_state, d_conv): each as one VSSBlock of phase 16d
VARIANTS = [("v2", 16, 3), ("v3", 16, 3), ("v051d_noz", 16, 3), ("v052d_noz", 16, 3),
            ("v052dc", 16, 3), ("v051d_noz", 1, 3), ("v052d_noz", 1, 3),
            ("v05_onnone_noz", 16, 3), ("v05_ondwconv3_noz", 16, 3), ("v05_oncnorm_noz", 16, 3),
            ("v05_onsoftmax_noz", 16, 3), ("v05_onsigmoid_noz", 16, 3), ("v05_oact", 16, 3),
            ("v0_nozact", 16, 3), ("v0", 16, 1), ("v0", 16, 2), ("v0", 16, 4),
            ("xv1a_ca", 16, 3), ("xv2a_ca1_ocov", 16, 3), ("xv3a_ocov2", 16, 3),
            ("xv1a_mul_act_cpos", 16, 3), ("xv3a_mul", 16, 1)]
VARIANT_MAP = 16                       # a 16 x 16 map: the nk rule groups 2 images (L, W x 2 = 0 mod 8)


def core_route(op, batch, H):
    """(route, calls) of one forward of the SS2D ``op``'s scan core on
    ``batch`` H x H maps, by the port's routing rule: the nk pair where
    ``nk_train_supported`` gives a group (one call), else the grouped scan
    (one call a direction group: four for cross2d and cascade2d, one for
    unidi and the xv family, two for bidi)."""
    if isinstance(op.mode, XVMode):
        return "grouped", 1
    scan_mode = op.mode.scan_mode
    if scan_mode == "cascade2d":
        return "grouped", 4
    if op.N == 1 and scan_mode == "cross2d":
        raise ValueError("a d_state-1 cross2d core takes kernels 11 and 12")
    if nk_scan_adjoint.nk_train_supported(batch, H * H, H, op.d_inner, 4, op.N, scan_mode):
        return "nk", 1
    return "grouped", {"cross2d": 4, "unidi": 1, "bidi": 2}[scan_mode]


def vanilla_want(model, batch, train):
    """The kernels' launches in one forward (``train``: one forward and
    backward) of a vanilla VMamba at ``batch`` images of 224 x 224, by the
    routing rule, stage by stage."""
    want, H = {}, IMAGE // 4
    for layer in model.layers:
        route, calls = core_route(layer.blocks[0].op, batch, H)
        for name in ROUTE_KERNELS[route][: 2 if train else 1]:
            want[name] = want.get(name, 0) + calls * len(layer.blocks)
        H = -(-H // 2)
    return want


# the device functions of the four kernels on vanilla VMamba's path
VANILLA_FUNCS = {"nk_scan": ("fusion_scan_kernel", "fusion_scan_sum_kernel"),
                 "nk_scan_bwd": ("nk_adjoint_kernel", "nk_adjoint_finish_kernel"),
                 "selective_scan_grouped_fwd": ("lanes_fwd_kernel",),
                 "selective_scan_grouped_bwd": ("lanes_bwd_kernel", "lanes_finish_kernel")}


def vanilla_work(model, batch, train):
    """{kernel: Work} of one forward (``train``: forward and backward) of a
    vanilla VMamba at ``batch`` images of 224 x 224, over the calls of the
    routing rule (`core_route`), float32."""
    work, H = {}, IMAGE // 4
    for layer in model.layers:
        op = layer.blocks[0].op
        route, calls = core_route(op, batch, H)
        L, f32 = H * H, torch.float32
        if route == "nk":
            parts = [nk_work(batch, L, op.d_inner, 4, op.N, f32),
                     nk_work(batch, L, op.d_inner, 4, op.N, f32, backward=True)]
        else:
            parts = [grouped_work(batch, L, 1, op.d_inner, op.N, f32),
                     grouped_work(batch, L, 1, op.d_inner, op.N, f32, backward=True)]
        for name, w in list(zip(ROUTE_KERNELS[route], parts))[: 2 if train else 1]:
            work.setdefault(name, Work())
            work[name] += w.times(calls * len(layer.blocks))
        H = -(-H // 2)
    return work


def kernel_times(label, table, work):
    """Each kernel's device ms in a profile's ``table`` beside the bound of
    its ``work``; returns {kernel: (device ms, bound ms, bound by)}."""
    out = {}
    for name, w in work.items():
        ms = sum(t for t, _, key in table if any(f + "<" in key or f + "(" in key
                                                 for f in VANILLA_FUNCS[name]))
        out[name] = (ms, *w.bound())
        print(f"    {label} {name}: {ms:.3f} ms on the device, bound {out[name][1]:.4f} ms "
              f"({out[name][2]})")
    return out


def profiled(fn, reps=3):
    """(wall ms, device ms, the device rows [(ms, calls, name)] by device
    time) per call of ``fn`` after a warm-up call, under
    ``utils.profiling.trace`` (spin kernels open the session), wall from
    CUDA events."""
    import tempfile
    from xfmamba_tpu_torch.utils.profiling import trace
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    rows = [r for r in prof.key_averages() if r.self_cpu_time_total == 0 and _device_us(r) > 0
            and not getattr(r, "is_user_annotation", False) and "spin_kernel" not in r.key]
    rows.sort(key=_device_us, reverse=True)
    table = [(_device_us(r) / 1e3 / reps, r.count / reps, r.key) for r in rows]
    return start.elapsed_time(end) / reps, sum(ms for ms, _, _ in table), table


def print_profiled(label, wall, device, table, card, top=6):
    print(f"  {label}: {wall:.3f} ms wall, {device:.3f} ms on the device (busy share "
          f"{device / wall:.3f}; torch.profiler, {card}); top device rows:")
    for ms, calls, name in table[:top]:
        print(f"    {ms:9.3f} ms {calls:6.1f} calls  {name[:100]}")


def phase_vanilla_inference(card):
    """16a: vanilla VMamba-T (seeded weights, 1000 classes, depths 2/2/9/2)
    float32 inference at bs 8, 32 and 1, each forward's launches against
    the routing rule's, ms per batch; a bfloat16 bs-8 forward on the same
    route."""
    print(f"phase 16a: vanilla VMamba-T 224x224 inference, float32, seeded weights, TF32 off "
          f"({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vssm.vanilla_vmamba_tiny(seed=0)
    fns = all_kernels()
    inputs = {bs: images(bs, torch.float32, 300 + bs) for bs in VANILLA_BATCHES}
    launches, ms = {}, {}
    with torch.no_grad():
        model(inputs[8])                                   # warm-up
        torch.cuda.synchronize()
        for bs, x in list(inputs.items()) + [("8 bfloat16", images(8, torch.bfloat16, 308))]:
            want = vanilla_want(model, 8 if bs == "8 bfloat16" else bs, False)
            counts = counted(fns)
            logits = model(x)
            torch.cuda.synchronize()
            got = {n: c for n, c in counts().items() if c}
            rows = 8 if bs == "8 bfloat16" else bs
            if got != want or logits.shape != (rows, 1000) or \
                    not torch.isfinite(logits.float()).all():
                raise PhaseFailure(f"vanilla-T bs {bs}: logits {tuple(logits.shape)} or "
                                   f"launches {got}, expected {want}")
            launches[bs] = got
            print(f"  bs {bs}: logits finite, first row [:4] {logits[0, :4].float().tolist()}; "
                  f"launches per forward {got} (the routing rule's), every other kernel 0")
        for bs in VANILLA_BATCHES:
            samples = sorted(time_ms(lambda: model(inputs[bs]), 5) for _ in range(3))
            ms[bs] = samples[1]
            print(f"  bs {bs}: {samples[1]:.2f} ms per batch (median of 3 runs of 5: "
                  f"{', '.join(f'{v:.2f}' for v in samples)}), {1000 * bs / samples[1]:.1f} "
                  f"images/s ({card})")
        for bs in (1, 32):
            profile = profiled(lambda: model(inputs[bs]))
            print_profiled(f"bs-{bs} forward", *profile, card)
            kernels = kernel_times(f"bs-{bs} forward", profile[2], vanilla_work(model, bs, False))
    return launches, ms, kernels


def phase_vanilla_train(card):
    """16b: vanilla VMamba-T float32 training at bs 16 through
    ``make_train_step(..., two_view=False)``, Adam lr 1e-4 wd 1e-5, labels
    0 as ``bench.py --train``: the loss finite at each of 5 steps on one
    batch and lower at step 5 than at step 1, each step's launches against
    the routing rule's, ms per step and peak memory."""
    print(f"phase 16b: vanilla VMamba-T training, batch {TRAIN_BATCH}, 224x224, float32, Adam "
          f"lr 1e-4 wd 1e-5, TF32 off ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vssm.vanilla_vmamba_tiny(seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, False, two_view=False)
    batch = {"image1": images(TRAIN_BATCH, torch.float32, 316),
             "label": torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")}
    fns = all_kernels()
    want = vanilla_want(model, TRAIN_BATCH, True)
    losses = []
    for _ in range(VANILLA_STEPS):
        counts = counted(fns)
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        got = {n: c for n, c in counts().items() if c}
        if got != want:
            raise PhaseFailure(f"vanilla-T step launches {got}, expected {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise PhaseFailure(f"vanilla-T training loss not finite or not falling: {losses}")
    torch.cuda.reset_peak_memory_stats()
    samples = timed_steps(step, batch)
    profile = profiled(lambda: step(batch), reps=2)
    print_profiled(f"bs-{TRAIN_BATCH} step", *profile, card, top=8)
    kernels = kernel_times(f"bs-{TRAIN_BATCH} step", profile[2],
                           vanilla_work(model, TRAIN_BATCH, True))
    print(f"  losses {', '.join(f'{v:.5f}' for v in losses)}; launches per step {want} (the "
          f"routing rule's), every other kernel 0; {samples[1]:.2f} ms per step (median of 3 "
          f"runs of 3: {', '.join(f'{v:.2f}' for v in samples)}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
    del model, optimizer, step
    return want, samples[1], kernels


def phase_vanilla_cpu_parity():
    """16c: vanilla VMamba-T widths at depths 2/2/2/2, batch 2, float32, no
    drop path: eval logits within 1e-3 of the largest and every gradient
    of one train step within 1e-3 of its largest, card against the CPU
    plain twins, with the routing rule's launches on the card."""
    print("phase 16c: vanilla VMamba-T widths at depths (2, 2, 2, 2), batch 2, float32: logits "
          "and one train step's gradients, card (kernels 2/7 and 13/14) vs CPU plain twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vssm.vanilla_vmamba_tiny(device="cpu", seed=5, depths=(2, 2, 2, 2),
                                     drop_path_rate=0.0)
    g = torch.Generator().manual_seed(23)
    x, label = torch.randn(2, IMAGE, IMAGE, 3, generator=g), torch.tensor([3, 7])
    fns = all_kernels()
    forward, step = vanilla_want(model, 2, False), vanilla_want(model, 2, True)
    want = {n: c + forward.get(n, 0) for n, c in step.items()}
    results = []
    for device in ("cpu", "cuda"):
        model.to(device).eval().zero_grad()
        t0 = time.time()
        counts = counted(fns)
        with torch.no_grad():
            logits = model(x.to(device)).cpu()
        model.train()
        loss = F.cross_entropy(model(x.to(device)), label.to(device))
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
    if launches != want or not err <= tol or not w_rel <= 1e-3:
        raise PhaseFailure(f"vanilla-T on the card disagrees with the CPU plain path, or its "
                           f"launches {launches} differ from {want}")


def phase_ss2d_variants():
    """16d: each other SS2D forward type as one VSSBlock (d_model 96, no
    MLP, conv bias) on 2 images of VARIANT_MAP x VARIANT_MAP (16 x 16),
    float32, forward and backward, card against the CPU (plain twins):
    the output, the input gradient and every parameter gradient within 1e-3
    of its largest, and the kernels the routing rule names launched on the
    card, each once a call."""
    print(f"phase 16d: the other SS2D forward types, one VSSBlock(96) at {VARIANT_MAP}x"
          f"{VARIANT_MAP}, batch 2, float32, forward and backward, card vs CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = all_kernels()
    g = torch.Generator().manual_seed(24)
    x = torch.randn(2, VARIANT_MAP, VARIANT_MAP, 96, generator=g)
    gy = torch.randn(2, VARIANT_MAP, VARIANT_MAP, 96, generator=g)
    failed = []
    for ft, N, d_conv in VARIANTS:
        block = VSSBlock(96, ssm_d_state=N, ssm_conv_bias=True, mlp_ratio=0.0,
                         forward_type=ft, ssm_conv=d_conv,
                         generator=torch.Generator().manual_seed(25))
        route, calls = core_route(block.op, 2, VARIANT_MAP)
        want = dict.fromkeys(ROUTE_KERNELS[route], calls)
        results, seconds = [], []
        for device in ("cpu", "cuda"):
            block.to(device).zero_grad()
            xl = x.to(device, copy=True).requires_grad_()
            counts = counted(fns)
            t0 = time.time()
            y = block(xl)
            y.backward(gy.to(device))
            torch.cuda.synchronize()
            seconds.append(time.time() - t0)
            launches = {n: c for n, c in counts().items() if c}
            results.append({"y": y.detach().cpu(), "dx": xl.grad.cpu()}
                           | {k: p.grad.cpu().clone() for k, p in block.named_parameters()})
        errs = {k: rel(results[1][k], w)[1] for k, w in results[0].items()}
        worst = max(errs, key=errs.get)
        ok = launches == want and errs[worst] <= 1e-3
        print(f"  {ft:20s} N {N:2d} d_conv {d_conv}: {route} route, launches {launches}; worst "
              f"relative error {errs[worst]:.3e} ({worst}) of {len(errs)}, tol 1e-03; cpu "
              f"{seconds[0]:.1f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append((ft, N, d_conv, launches, want, worst, errs[worst]))
    if failed:
        raise PhaseFailure(f"SS2D forward types on the card: {failed}")


def phase_vanilla(card):
    """Phase 16 (16a-16d); returns the launches and times of kernels 2, 7,
    13 and 14 on vanilla VMamba-T's path for the kernels line."""
    launches, ms, forward = phase_vanilla_inference(card)
    step_want, step_ms, step = phase_vanilla_train(card)
    phase_vanilla_cpu_parity()
    phase_ss2d_variants()
    names = [n for pair in ROUTE_KERNELS.values() for n in pair]
    keys = ("device_ms", "bound_ms", "bound_by")
    return {name: {"forward_launches": {str(bs): launches[bs].get(name, 0) for bs in launches},
                   "step_launches": step_want.get(name, 0),
                   "forward_ms": {str(bs): ms[bs] for bs in ms}, "step_ms": step_ms}
            | ({"bs32_forward": dict(zip(keys, forward[name]))} if name in forward else {})
            | {"step": dict(zip(keys, step[name]))}
            for name in names}


# ---------------------------------------------------------------------------
# phase 17: the rest of the model surface (no-MLP stage kernels, m0 with its
# z-gate and carried state at the widened SSD gate, the block options, the
# superseded fusion ops)
# ---------------------------------------------------------------------------

# 17b's m0 layers at 56 x 56, batch 2: (label, d_model, d_state, ssm_ratio,
# dt_rank, chunk); head width d_inner / dt_rank
M0_LAYERS = [("d_state 128, chunk 64", 96, 128, 1.0, "auto", 64),
             ("d_state 256, chunk 128", 96, 256, 1.0, "auto", 128),
             ("head width 64, chunk 32", 96, 64, 2.0, 3, 32),
             ("d_state 512, head width 128", 96, 512, 4.0, 3, 64)]
# 17c: VMamba-T s2l5 with the block options JAX's rule keeps off the kernels
OPTIONS_17C = dict(gmlp=True, post_norm=True, posembed=True, patch_norm=False, mlp_act="silu",
                   ssm_drop_rate=0.1, mlp_drop_rate=0.1)
STAGE_KERNEL_NAMES = ("vss_stage", "vss_block_v1", "vss_block_train", "vss_block_bwd",
                      "vss_stage_train")
P17 = {}   # the kernels line's phase-17 entries of rows 1, 8, 15 and 16


def nonzero(counts):
    return {n: c for n, c in counts.items() if c}


def no_mlp_want(model, batch):
    """The launches of a bfloat16 eval forward of a no-MLP v05_noz VSSM at
    ``batch`` images of 224 x 224, stage by stage by `stage_route`."""
    want, H = {}, IMAGE // 4
    for layer in model.layers:
        blk = layer.blocks[0]
        route = vss_stage.stage_route(batch, H, H, blk.norm.weight.shape[0], blk.op.d_inner, 0,
                                      len(layer.blocks))
        name = {"stage": "vss_stage", "v1": "vss_block_v1", "composable": "ss2d_core_n1_fwd"}[
            route]
        want[name] = want.get(name, 0) + (1 if route == "stage" else len(layer.blocks))
        H = -(-H // 2)
    return want


def timed_pair(fn, plain, reps=5):
    """(kernel ms, plain ms) by CUDA events, the kernel after a warm-up."""
    return time_ms(fn, reps), time_ms(plain, 1, warmup=False)


def phase_no_mlp(card):
    """17a: VMamba-S s2l15's geometry with ``mlp_ratio`` 0, bfloat16: a
    bs-32 forward on kernel 1, a bs-1 forward with kernel 8 where the rule
    gives no aligned group, a bs-16 training step on kernels 4 -> 6 per
    block, each forward's and the step's launches against the rule's; each
    kernel at its main-path shape against its plain version (5e-2), with
    its time beside the plain version's and its bound."""
    print(f"phase 17a: VMamba-S s2l15 geometry, mlp_ratio 0, bfloat16 ({card})")
    bf = torch.bfloat16
    model = vssm.vmamba_small_s2l15(seed=0, mlp_ratio=0.0)
    if not (model.stage_kernels and model.train_kernels) or model.stage_train_mlp:
        raise PhaseFailure("the no-MLP backbone is not on the stage routes")
    fns = all_kernels()
    with torch.no_grad():
        for bs in (32, 1):
            x = images(bs, bf, 400 + bs)
            model(x)
            torch.cuda.synchronize()
            counts = counted(fns)
            logits = model(x)
            torch.cuda.synchronize()
            got, want = nonzero(counts()), no_mlp_want(model, bs)
            if got != want or not torch.isfinite(logits.float()).all():
                raise PhaseFailure(f"no-MLP bs {bs}: launches {got}, expected {want}")
            print(f"  bs {bs}: logits finite, launches per forward {got} (the rule's), every "
                  f"other kernel 0; {time_ms(lambda: model(x), 3):.2f} ms per batch")
            P17.setdefault("vss_stage", {})[f"bs{bs}_forward_launches"] = got.get("vss_stage", 0)
            P17.setdefault("vss_block_v1", {})[f"bs{bs}_forward_launches"] = \
                got.get("vss_block_v1", 0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, False, two_view=False)
    batch = {"image1": images(TRAIN_BATCH, bf, 416),
             "label": torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")}
    model.train()
    step(batch)
    torch.cuda.synchronize()
    counts = counted(fns)
    loss = float(step(batch)["loss"])
    torch.cuda.synchronize()
    got, blocks = nonzero(counts()), sum(model.depths)
    want = {"vss_block_train": blocks, "vss_block_bwd": blocks}
    print(f"  bs-{TRAIN_BATCH} step: loss {loss:.5f}, launches {got}, every other kernel 0")
    if got != want or not math.isfinite(loss):
        raise PhaseFailure(f"no-MLP step launches {got}, expected {want}, loss {loss}")
    P17["vss_block_train"] = {"bs16_step_launches": blocks}
    P17["vss_block_bwd"] = {"bs16_step_launches": blocks}
    model.eval()
    g = torch.Generator().manual_seed(417)
    failed = []
    with torch.no_grad():
        layer = model.layers[0]
        packed = [pack_vss_block_params(b, bf) for b in layer.blocks]
        x = randn(g, 32, 56 * 56, 96, dtype=bf)
        args = (x, packed, 56, 56)
        err, r = rel(vss_stage.vss_stage(*args), vss_stage.vss_stage_plain(*args))
        ms, plain_ms = timed_pair(lambda: vss_stage.vss_stage(*args),
                                  lambda: vss_stage.vss_stage_plain(*args))
        work = block_work(32, 56, 96, bf, False).times(len(packed))
        P17["vss_stage"] |= {"geometry": "stage 0, 32 x 56x56x96, depth 2, no MLP",
                             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": work.bound()[0], "bound_by": work.bound()[1]}
        print(f"  kernel 1, stage 0 at bs 32 (56x56x96, 2 blocks, no MLP): rel {r:.3e}, "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {work.bound()[0]:.4f} ms "
              f"({work.bound()[1]})")
        failed += [("kernel 1", r)] if not r <= 5e-2 else []
        H, W = 56, 56
        for layer in model.layers:
            blk = layer.blocks[0]
            d = blk.norm.weight.shape[0]
            if vss_stage.stage_route(1, H, W, d, blk.op.d_inner, 0, len(layer.blocks)) == "v1":
                break
            H = W = -(-H // 2)
        p8 = vss_block_v1.pack_vss_block_v1_params(blk, bf)
        x = randn(g, 1, H * W, d, dtype=bf)
        err, r = rel(vss_block_v1.vss_block_v1(x, p8, H, W),
                     vss_block_v1.vss_block_v1_phases_plain(x, p8, H, W))
        ms, plain_ms = timed_pair(lambda: vss_block_v1.vss_block_v1(x, p8, H, W),
                                  lambda: vss_block_v1.vss_block_v1_phases_plain(x, p8, H, W))
        work = block_work(1, H, d, bf, False)
        phases = vss_block_v1.phase_ns(x, p8, H, W)
        P17["vss_block_v1"] |= {"geometry": f"1 x {H}x{W}x{d}, no MLP", "max_abs_err": err,
                                "ms": ms, "plain_ms": plain_ms, "bound_ms": work.bound()[0],
                                "bound_by": work.bound()[1], "phases": list(phases)}
        print(f"  kernel 8 at bs 1 ({H}x{W}x{d}, no MLP, phases {list(phases)}): rel {r:.3e}, "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {work.bound()[0]:.4f} ms "
              f"({work.bound()[1]})")
        failed += [("kernel 8", r)] if not r <= 5e-2 or "LN2" in phases else []
        p = pack_vss_block_params(model.layers[0].blocks[0], bf)
        x = randn(g, TRAIN_BATCH, 56 * 56, 96, dtype=bf)
        m1 = torch.ones(TRAIN_BATCH, device="cuda")
        gy = randn(g, TRAIN_BATCH, 56 * 56, 96)
        fwd = rel(vss_block_train.vss_block_train(x, p, 56, 56, m1),
                  vss_block_train.vss_block_train_plain(x, p, 56, 56, m1))[1]
        dx, grads = vss_block_train.vss_block_bwd(x, p, 56, 56, m1, gy)
        dx_p, grads_p = vss_block_train.vss_block_bwd_plain(x, p, 56, 56, m1, gy)
        bwd = max([rel(dx, dx_p)[1]] + [rel(grads[k], grads_p[k])[1] for k in grads_p
                                        if grads_p[k] is not None])
        print(f"  kernels 4 / 6 at bs {TRAIN_BATCH} (56x56x96, the SS2D half): rel {fwd:.3e} / "
              f"{bwd:.3e}")
        failed += [("kernels 4/6", fwd, bwd)] if not max(fwd, bwd) <= 5e-2 else []
    if failed:
        raise PhaseFailure(f"17a: kernels against their plain versions: {failed}")
    del model, optimizer, step


def m0_layer_run(layer, x, gy, init, device, fns):
    """Two forwards of an m0 SS2D with a carried state (the first inside
    `carry_ssm_state`, no gradient), the second with its backward; returns
    the outputs, the states after each forward and the gradients (CPU),
    and the launches."""
    from xfmamba_tpu_torch.models.ss2d import carry_ssm_state
    layer.to(device).zero_grad()
    with torch.no_grad():
        layer.initial_state.copy_(init.to(device))
    counts = counted(fns)
    with torch.no_grad(), carry_ssm_state(layer):
        y1 = layer(x[0].to(device))
    s1 = layer.initial_state.cpu().clone()
    xl = x[1].to(device, copy=True).requires_grad_()
    with carry_ssm_state(layer):
        y2 = layer(xl)
    y2.backward(gy.to(device))
    launches = nonzero(counts())
    out = {"y1": y1.cpu(), "state1": s1, "y2": y2.detach().cpu(),
           "state2": layer.initial_state.cpu().clone(), "dx": xl.grad.cpu()}
    out |= {k: q.grad.cpu().clone() for k, q in layer.named_parameters()}
    return out, launches


def ssd_call_args(g, b, L, R, P, N):
    return (randn(g, b, 4, L, R, P), randn(g, b, 4, L, R) - 4.0,
            -torch.exp(1.5 * torch.rand(4 * R, generator=g)).cuda(),
            randn(g, b, 4, L, N, scale=0.3), randn(g, b, 4, L, N, scale=0.3),
            randn(g, 4 * R, P), randn(g, 4 * R, scale=0.5), randn(g, b, 4 * R, N, P))


def phase_m0(card):
    """17b: vmamba_tiny_m2's geometry with forward type m0 (the z-gate),
    float32: a bs-32 forward (kernel 15 once a block) and a bs-16 step
    (kernels 15 and 16 once a block); then one m0 SS2D layer at 56 x 56,
    batch 2, at each of `M0_LAYERS` with a carried state over two forwards,
    card against the CPU (outputs, states, every gradient within 1e-3),
    one launch of each kernel a call whatever the slabs, and kernels 15 /
    16 on that layer's scan call against the plain twins on the card
    (1e-3) with their times and bounds."""
    print(f"phase 17b: m0 with its z-gate at vmamba_tiny_m2's geometry, float32, and m0 layers "
          f"at the widened SSD gate ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vssm.vmamba_tiny_m2(seed=0, forward_type="m0")
    fns = all_kernels()
    blocks = sum(model.depths)
    with torch.no_grad():
        x = images(32, torch.float32, 432)
        model(x)
        torch.cuda.synchronize()
        counts = counted(fns)
        logits = model(x)
        torch.cuda.synchronize()
        got = nonzero(counts())
        ms = time_ms(lambda: model(x), 3)
    print(f"  bs 32: logits finite {bool(torch.isfinite(logits).all())}, launches {got}, "
          f"{ms:.2f} ms per batch")
    if got != {"ssd_chunk_fwd": blocks} or not torch.isfinite(logits).all():
        raise PhaseFailure(f"m0 bs-32 launches {got}, expected {blocks} of kernel 15")
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, False, two_view=False)
    batch = {"image1": images(TRAIN_BATCH, torch.float32, 433),
             "label": torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")}
    model.train()
    counts = counted(fns)
    loss = float(step(batch)["loss"])
    torch.cuda.synchronize()
    got = nonzero(counts())
    print(f"  bs-{TRAIN_BATCH} step: loss {loss:.5f}, launches {got}")
    if got != {"ssd_chunk_fwd": blocks, "ssd_chunk_bwd": blocks} or not math.isfinite(loss):
        raise PhaseFailure(f"m0 step launches {got}, loss {loss}")
    P17["ssd_chunk_fwd"] = {"m0_tiny_bs32_forward_launches": blocks}
    P17["ssd_chunk_bwd"] = {"m0_tiny_bs16_step_launches": blocks}
    del model, optimizer, step
    g = torch.Generator().manual_seed(434)
    failed = []
    ssd_fns = {n: k["fn"] for n, k in SSD_KERNELS.items()}
    for label, d, N, ratio, rank, chunk in M0_LAYERS:
        layer = SS2D(d, d_state=N, ssm_ratio=ratio, dt_rank=rank, forward_type="m0",
                     initialize="v2", with_initial_state=True, chunk_size=chunk,
                     generator=torch.Generator().manual_seed(435))
        R, P = layer.R, layer.d_inner // layer.R
        x = [torch.randn(2, 56, 56, d, generator=g) for _ in range(2)]
        gy = torch.randn(2, 56, 56, d, generator=g)
        init = 0.1 * torch.randn(layer.initial_state.shape, generator=g)
        t0 = time.time()
        cpu, _ = m0_layer_run(layer, x, gy, init, "cpu", ssd_fns)
        card_out, launches = m0_layer_run(layer, x, gy, init, "cuda", ssd_fns)
        torch.cuda.synchronize()
        ns, ps = ssd_chunk.slabs(N, P)
        worst = max(cpu, key=lambda k: rel(card_out[k], cpu[k])[1])
        w = rel(card_out[worst], cpu[worst])[1]
        ok = launches == {"ssd_chunk_fwd": 2, "ssd_chunk_bwd": 1} and w <= 1e-3
        print(f"  m0 SS2D({d}) {label} (R {R}, P {P}, N {N}): {len(cpu)} outputs, states and "
              f"gradients, worst rel {w:.3e} ({worst}), tol 1e-03; launches {launches}; "
              f"{time.time() - t0:.1f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append((label, launches, worst, w))
        with torch.no_grad():
            args = ssd_call_args(g, 2, 56 * 56, R, P, N)
            got = ssd_chunk.ssd_fwd(*args, chunk, save_states=True)
            want = ssd_chunk.ssd_fwd_plain(*args, chunk=chunk, save_states=True)
            dy = randn(g, *args[0].shape)
            gb = ssd_chunk.ssd_bwd(*args[:7], want[2], dy, None, chunk)
            gp = ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy, None, chunk)
            rf = max(rel(a, b)[1] for a, b in zip(got, want))
            rb = max(rel(gb[k], gp[k])[1] for k in gp)
            ef = max(rel(a, b)[0] for a, b in zip(got, want))
            eb = max(rel(gb[k], gp[k])[0] for k in gp)
            fwd_ms, fwd_plain = timed_pair(
                lambda: ssd_chunk.ssd_fwd(*args, chunk),
                lambda: ssd_chunk.ssd_fwd_plain(*args, chunk=chunk))
            bwd_ms, bwd_plain = timed_pair(
                lambda: ssd_chunk.ssd_bwd(*args[:7], want[2], dy, None, chunk),
                lambda: ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy, None, chunk))
        pieces = min(chunk, ssd_chunk.PIECE)
        wf = ssd_work(2, 56 * 56, R, torch.float32, P=P, N=N, chunk=pieces)
        wb = ssd_work(2, 56 * 56, R, torch.float32, P=P, N=N, chunk=pieces, backward=True)
        for name, ms_, plain_, work, err in (("ssd_chunk_fwd", fwd_ms, fwd_plain, wf, ef),
                                             ("ssd_chunk_bwd", bwd_ms, bwd_plain, wb, eb)):
            P17[name][label] = {"slabs": [ns, ps], "max_abs_err": err, "ms": ms_,
                                "plain_ms": plain_, "bound_ms": work.bound()[0],
                                "bound_by": work.bound()[1]}
        print(f"    kernels 15 / 16 on its scan call (2 x 4 x 3136 x {R} x {P}, N {N}, chunk "
              f"{chunk}, {ns} x {ps} slabs): rel {rf:.3e} / {rb:.3e}; {fwd_ms:.3f} / "
              f"{bwd_ms:.3f} ms, plain {fwd_plain:.3f} / {bwd_plain:.3f} ms, bound "
              f"{wf.bound()[0]:.4f} / {wb.bound()[0]:.4f} ms ({card})")
        if not max(rf, rb) <= 1e-3:
            failed.append((label, "kernels vs plain", rf, rb))
    if failed:
        raise PhaseFailure(f"17b: {failed}")


def phase_options(card):
    """17c: a VMamba-T s2l5 geometry with `OPTIONS_17C` (the gated MLP of
    SiLU, post_norm, the position embedding, no patch norm, drop rates
    0.1): float32 eval logits at batch 2, card against the CPU (1e-3); a
    bfloat16 eval forward and a bfloat16 training step at bs 16 on the
    composable route (no stage kernel launched, as JAX's rule keeps these
    options off its megakernels), the loss finite."""
    print(f"phase 17c: VMamba-T s2l5 with {OPTIONS_17C} ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vssm.vmamba_tiny_s2l5(seed=0, device="cpu", **OPTIONS_17C)
    if model.stage_kernels or model.train_kernels:
        raise PhaseFailure("the options' backbone is on a stage route")
    x = torch.randn(2, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(440))
    with torch.no_grad():
        t0 = time.time()
        want = model(x)
        cpu_s = time.time() - t0
        model.cuda()
        got = model(x.cuda()).cpu()
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max())
    print(f"  float32 logits at batch 2: max_abs_err {err:.3e} (tol {tol:.3e}); cpu {cpu_s:.1f} s")
    if not err <= tol:
        raise PhaseFailure("17c: the options' logits on the card disagree with the CPU")
    fns = all_kernels()
    stage = {n: fns[n] for n in STAGE_KERNEL_NAMES}
    with torch.no_grad():
        counts = counted(stage)
        logits = model(images(8, torch.bfloat16, 441))
        torch.cuda.synchronize()
        forward = nonzero(counts())
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, False, two_view=False)
    batch = {"image1": images(TRAIN_BATCH, torch.bfloat16, 442),
             "label": torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")}
    model.train()
    counts, all_counts = counted(stage), counted(fns)
    loss = float(step(batch)["loss"])
    torch.cuda.synchronize()
    launched = nonzero(all_counts())
    print(f"  bfloat16 bs-8 forward: logits finite {bool(torch.isfinite(logits.float()).all())}, "
          f"stage kernels {forward}; bs-{TRAIN_BATCH} step: loss {loss:.5f}, stage kernels "
          f"{nonzero(counts())}, launched {launched}")
    if forward or nonzero(counts()) or not math.isfinite(loss) or \
            not torch.isfinite(logits.float()).all():
        raise PhaseFailure("17c: a stage kernel ran for the options' backbone, or a result is "
                           "not finite")
    del model, optimizer, step


def phase_cross_variants(card):
    """17d: CrossSS2Dv2 and CrossSS2Dv3 at XFMamba-S's deep-fusion geometry
    (d_model 768, 7 x 7, d_state 16, 16 studies), float32, training mode
    (no dropout): the output, both inputs' gradients and every parameter
    gradient, card against the CPU (1e-3), and the cores' launches of
    kernels 2 / 7 or 13 / 14 as `core_dispatch` decides."""
    from xfmamba_tpu_torch.models.fusion import CrossSS2Dv2, CrossSS2Dv3
    print(f"phase 17d: CrossSS2Dv2 / v3 (768, d_state 16) at 7x7, 16 studies, float32 ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = all_kernels()
    g = torch.Generator().manual_seed(450)
    x, x2, gy = (torch.randn(16, 7, 7, 768, generator=g) for _ in range(3))
    group = nk_scan_adjoint.nk_train_supported(16, 49, 7, 1536, 4, 16, "cross2d")
    for cls, cores in ((CrossSS2Dv2, 2), (CrossSS2Dv3, 3)):
        op = cls(768, d_state=16, generator=torch.Generator().manual_seed(451)).train()
        route = ROUTE_KERNELS["nk" if group else "grouped"]
        want = dict.fromkeys(route, cores * (1 if group else 4))
        results = []
        for device in ("cpu", "cuda"):
            op.to(device).zero_grad()
            xa, xb = (v.to(device, copy=True).requires_grad_() for v in (x, x2))
            counts = counted(fns)
            t0 = time.time()
            y = op(xa, xb)
            y.backward(gy.to(device))
            torch.cuda.synchronize()
            launches = nonzero(counts())
            results.append({"y": y.detach().cpu(), "dx": xa.grad.cpu(), "dx2": xb.grad.cpu()}
                           | {k: q.grad.cpu().clone() for k, q in op.named_parameters()})
            seconds = time.time() - t0
        errs = {k: rel(results[1][k], w)[1] for k, w in results[0].items()}
        worst = max(errs, key=errs.get)
        ok = launches == want and errs[worst] <= 1e-3
        print(f"  {cls.__name__}: launches {launches} ({'nk pair' if group else 'grouped'}); "
              f"worst rel {errs[worst]:.3e} ({worst}) of {len(errs)}, tol 1e-03; card "
              f"{seconds:.2f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"17d {cls.__name__}: launches {launches}, expected {want}, "
                               f"worst {worst} {errs[worst]}")


def phase_surface(card):
    """Phase 17 (17a-17d)."""
    phase_no_mlp(card)
    phase_m0(card)
    phase_options(card)
    phase_cross_variants(card)


def main_cards() -> int:
    """``python3 chip_smoke.py --cards``: phase 15a over every visible card
    (NCCL, one rank a card) against one rank; needs two cards or more."""
    import shutil
    import tempfile
    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --cards: {n} CUDA device(s); needs two or more", file=sys.stderr)
        return 1
    card = card_line()
    print(f"{n} cards: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.library()
    tmp = tempfile.mkdtemp(prefix="xfm_cards_")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    try:
        phase_dp_fit(card, tmp, world=n, backend="nccl", phase="15a (cards)")
        cli_over_cards(card, tmp, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "cards": n}))
    return 0


def cli_over_cards(card, tmp, n):
    """``python -m xfmamba_tpu_torch.cli.train`` started plainly with ``n``
    visible cards: it starts one NCCL rank a card itself; one epoch of
    XFMamba-S on phase 11's tree at the global batch TRAIN_BATCH."""
    from torch_mura_tree import write_mura_tree
    print(f"cli.train started plainly over {n} cards, one epoch of XFMamba-S ({card})")
    csvs, _ = write_mura_tree(tmp, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                              n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=11)
    run = Path(tmp) / "run"
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "xfmamba_tpu_torch.cli.train", "--model_name", CLI_MODEL,
         "--image_size", str(IMAGE), "--batch_size", str(TRAIN_BATCH), "--data_root", tmp,
         "--train_image_csv", csvs[0], "--train_label_csv", csvs[1], "--valid_image_csv",
         csvs[2], "--valid_label_csv", csvs[3], "--epochs", "1", "--savemodel_path", str(run)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    print("  " + "\n  ".join(line for line in out.splitlines()
                              if line.startswith(("device", "epoch", "done", "data-parallel"))))
    print(f"  {time.time() - t0:.1f} s, rc {proc.returncode}")
    if proc.returncode or f"rank 0 of {n} over nccl" not in out or \
            not (run / "last.pt").is_file():
        raise PhaseFailure(f"cli.train over {n} cards failed:\n{out[-3000:]}")


READER_SIZES = ((390, 320), FULL_XRAY)
READER_WORKERS = 2


def start_reader_files():
    """Phase 18's encodings (numpy and pure Python, tests/torch_codecs.py),
    started in spawned worker processes so that they run while the card
    runs phases 2-17, at the lowest CPU priority so that they take only
    the cores the host-bound phases leave idle: (directory, pool, {(name,
    size): future})."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_codecs

    tmp = tempfile.mkdtemp(prefix="xfm_phase18_")
    pool = concurrent.futures.ProcessPoolExecutor(
        READER_WORKERS, mp_context=multiprocessing.get_context("spawn"), initializer=os.nice,
        initargs=(19,))
    # the big files first: they take longest
    jobs = {(name, size): pool.submit(torch_codecs.corpus_job, name, size, 18,
                                      os.path.join(tmp, f"{name}_{size[0]}"))
            for size in reversed(READER_SIZES) for name in torch_codecs.CORPUS}
    return tmp, pool, jobs


def stop_reader_files(reader):
    tmp, pool, _ = reader
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for proc in procs:
        proc.terminate()
        proc.join(10)
    shutil.rmtree(tmp, ignore_errors=True)


def phase_readers(card, reader):
    """Phase 18 (see the module docstring)."""
    import statistics
    import tempfile

    import numpy as np
    import torch_codecs
    from torch_datasets_tree import encode_jpeg, write_chexpert_tree
    from torch_mura_tree import encode_png, write_mura_tree
    from xfmamba_tpu_torch import native
    from xfmamba_tpu_torch.cli import train as cli_train
    from xfmamba_tpu_torch.data import image, jpeg, png
    from xfmamba_tpu_torch.train import driver

    tmp, _, jobs = reader
    t0 = time.perf_counter()
    so = native.build()
    native.library()
    print(f"phase 18a: the readers; host library {so.name} built with g++ "
          f"({time.perf_counter() - t0:.1f} s); {os.cpu_count()} host cores")
    wrong = []
    out = {}
    for size in READER_SIZES:
        t0 = time.perf_counter()
        done = {name: jobs[(name, size)].result(timeout=900) for name in torch_codecs.CORPUS}
        waited = time.perf_counter() - t0
        # the baseline decoders on an image of the size: a baseline JPEG
        # (quality 90) and a plain 8-bit gray PNG
        plain = np.load(done["png-adam7-gray8"] + ".npy")
        baseline = {"jpeg": time_calls(jpeg.decode_gray, [encode_jpeg(plain, 90)[0]], 3)[0],
                    "png": time_calls(png.decode_gray, [encode_png(plain, 0, 8)], 3)[0]}
        print(f"  {size[0]} x {size[1]} (the encoder's files ready after a further "
              f"{waited:.1f} s):")
        for name, path in done.items():
            raw = Path(path).read_bytes()
            want = np.load(path + ".npy")
            per, (got,) = time_calls(image.decode_grayscale, [raw], repeat=3)
            base_per = baseline["png" if name.startswith("png") else "jpeg"]
            same = got.shape == want.shape and np.array_equal(got, want)
            print(f"    {name}: {len(raw) / 2 ** 20:.2f} MiB, {1e3 * per:.2f} ms on one host "
                  f"thread ({1e-6 * want.size / per:.1f} Mpixel/s; the baseline "
                  f"{'PNG' if name.startswith('png') else 'JPEG'} decoder {1e3 * base_per:.2f} "
                  f"ms on the same image); {'equal to' if same else 'DIFFERENT FROM'} the "
                  f"encoder's reconstruction")
            out[f"{name}_{size[0]}_ms"] = 1e3 * per
            out[f"{name}_{size[0]}_baseline_ms"] = 1e3 * base_per
            if not same:
                wrong.append(f"{name} at {size}")
    digests = []
    for name in torch_codecs.DAMAGED:
        got = jpeg.decode_gray(torch_codecs.damaged_file(name))
        ok = torch_codecs.gray_digest(got) == torch_codecs.DAMAGED_SHA256[name]
        digests.append(f"{name} {'held' if ok else 'DIFFERS'}")
        if not ok:
            wrong.append(name)
    print(f"  cut, corrupt and colour-model files, 390 x 320, SHA-256 of the gray image: "
          f"{'; '.join(digests)}")
    if wrong:
        raise PhaseFailure(f"phase 18a: decodes differ: {wrong}")

    # 18b: one epoch on each tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = all_kernels()
    work = tempfile.mkdtemp(prefix="xfm_phase18b_", dir=tmp)
    argv = ["--model_name", CLI_MODEL, "--image_size", str(IMAGE), "--batch_size",
            str(TRAIN_BATCH), "--num_workers", "4", "--seed", "42", "--device", CLI_DEVICE,
            "--epochs", "1"]
    t0 = time.perf_counter()
    chex_root = os.path.join(work, "chexpert")
    chex_csv, chex_images = write_chexpert_tree(chex_root, CHEX_PATIENTS, CHEX_SIZE,
                                                distinct=READER_DISTINCT, seed=18)
    kinds = ("progressive", "arith", "arith-progressive", "truncated", "cmyk")
    variants = {}
    for path in (p for p in chex_images if p.endswith(".jpg")):
        raw = Path(path).read_bytes()
        if raw[:3] != jpeg.SIGNATURE:
            continue
        if raw not in variants:
            kind = kinds[len(variants) % len(kinds)]
            variants[raw] = torch_codecs.reencode_jpeg(jpeg.decode_gray(raw), kind)
        Path(path).write_bytes(variants[raw])
    mura_root = os.path.join(work, "mura")
    csvs, mura_images = write_mura_tree(mura_root, n_studies=CLI_STUDIES, parts=CLI_PARTS,
                                        n_valid=CLI_VALID_STUDIES, kinds=CLI_KINDS, seed=18)
    png_kinds = ("adam7", "gray2", "gray4", "palette4", "rgb16")
    for k, path in enumerate(mura_images):
        gray = png.decode_gray(Path(path).read_bytes())
        Path(path).write_bytes(torch_codecs.reencode_png(gray, png_kinds[k % len(png_kinds)]))
    print(f"phase 18b: trees in {time.perf_counter() - t0:.1f} s: CheXpert {len(chex_images)} "
          f"images, {len(variants)} distinct JPEGs as {'/'.join(kinds)} in turn; MURA "
          f"{len(mura_images)} PNGs as {'/'.join(png_kinds)} in turn; XFMamba-S float32, "
          f"{IMAGE}x{IMAGE}, bs {TRAIN_BATCH} ({card})")
    runs = {"chexpert": ["--dataset", "chexpert", "--data_root", chex_root, "--chexpert_csv",
                         chex_csv, "--num_classes", "14"],
            "mura": ["--data_root", mura_root, "--train_image_csv", csvs[0],
                     "--train_label_csv", csvs[1], "--valid_image_csv", csvs[2],
                     "--valid_label_csv", csvs[3]]}
    for label, data in runs.items():
        with epoch_launches(driver, fns) as rec:
            _, history = cli_train.main(argv + data + ["--savemodel_path",
                                                       os.path.join(work, f"{label}_run")])
        bad = check_epoch_launches(rec, F32_STEP["small"], F32_FORWARD)
        steps = [v for h in history for v in h["train"]["step_ms"]]
        for h in history:
            tr, sec = h["train"], h["seconds"]
            print(f"  {label} epoch {h['epoch']}: train loss {tr['loss']:.6f}, val loss "
                  f"{h['val']['loss']:.6f}, val AUC {h['val'].get('auc', float('nan')):.4f}; "
                  f"{sum(sec.values()):.2f} s (train {sec['train_s']:.2f}, waiting on the "
                  f"loader {tr['loader_wait_s']:.2f}); {tr['steps']} steps, median "
                  f"{statistics.median(steps) if steps else float('nan'):.2f} ms per step by "
                  f"CUDA events")
        print(f"  {label} launches: {[(k, n, {a: b for a, b in c.items() if b}) for k, n, c in rec]}")
        if bad or not steps or not all(math.isfinite(h[k]["loss"]) for h in history
                                       for k in ("train", "val")) \
                or not all(math.isfinite(h["val"].get("auc", float("nan"))) for h in history):
            raise PhaseFailure(f"phase 18b {label}: launches differ from {F32_STEP['small']} per "
                               f"step and {F32_FORWARD} per eval forward ({bad}), no step, or a "
                               f"loss or a val AUC is not finite")
        out[f"{label}_step_ms"] = statistics.median(steps)
    return out


def main() -> int:
    if sys.argv[1:] == ["--cards"]:
        return main_cards()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    reader = start_reader_files()
    try:
        return run_phases(reader)
    finally:
        stop_reader_files(reader)


def run_phases(reader) -> int:
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
    phase_whole_map_scans(errors, card)
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
    t0 = time.time()
    phase_cli(card)
    print(f"  phase 11: {time.time() - t0:.1f} s")
    t0 = time.time()
    models = phase_models(errors, card)
    print(f"  phase 12: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_datasets(card)
    print(f"  phase 13: {time.time() - t0:.1f} s")
    t0 = time.time()
    pp_launches, pp_times = phase_device_pipeline(errors, card)
    launches |= pp_launches
    times |= pp_times
    print(f"  phase 14: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_data_parallel(card)
    print(f"  phase 15: {time.time() - t0:.1f} s")
    t0 = time.time()
    vanilla = phase_vanilla(card)
    print(f"  phase 16: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_surface(card)
    print(f"  phase 17: {time.time() - t0:.1f} s")
    t0 = time.time()
    phase_readers(card, reader)
    print(f"  phase 18: {time.time() - t0:.1f} s")
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
        | {"mutual_launches": models["launches"][name]}
        | ({"vanilla_t": vanilla[name]} if name in vanilla else {})
        | ({"phase17": P17[name]} if name in P17 else {})
        | ({"xfmamba_t": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                  models["kernels"][name]))} if name in models["kernels"] else {})
        for name, k in kernel_table().items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
