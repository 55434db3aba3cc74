"""Kernel 7: the training backward of the fusion scans.

Replaces ``xfmamba_tpu/ops/nk_scan_adjoint.py::_nk_scan_bwd_kernel`` (:54;
host ``nk_scan_bwd_call`` :242), the whole-map adjoint of the nk scan
(kernel 2), in dts form.  The kernel is ``csrc/nk_scan_adjoint.cu``: four
lanes per (image, kind, channel) chain, the kinds in parallel, the states
kept only at segment starts (in shared memory) and recomputed segment by
segment in the reverse walk, the sums over channels, images and kinds
taken in a fixed order by a second short launch, no atomics.

- `nk_scan_bwd`: gradients of `nk_scan` at its contract (u, dts, Bs, Cs,
  A (K*N, D), Dvec (K, D), bias (K, D)); the plain twin
  `nk_scan_bwd_segments_plain` (the kernel's phases: forward walk with
  segment checkpoints, segment recompute, reverse walk, channel-tile
  partial sums, the fixed-order finish) for CPU tensors, the kernel
  (counted in ``nk_scan_bwd.launches``) for CUDA tensors.
  `nk_scan_bwd_plain` (the serial adjoint's plain version, every state
  kept) is the oracle both are held to; `nk_scan_bwd_serial` runs the
  earlier design, the serial adjoint of ``csrc/nk_scan_bwd.cu``, which
  ``chip_smoke.py`` times beside the kernel.
- `NKScanTrain`: the autograd op, kernel 2 forward (or kernel 17 or 18
  where `nk_scan`'s route names them) and kernel 7 backward; ShallowFuse
  calls it once per swap group (K=1, row_f).  It carries the image group
  that `nk_train_supported` returned, as JAX's ``nk_scan_train`` does: the
  group picks the forward's route.
- `nk_scan_train_from_projs`: the ``ss2d_core_from_projs``-shaped entry
  that Cross_SS2Dv5 trains through (K=4 cross2d, N=16) where the routing
  rule allows it.
- The routing rule, `nk_train_supported` / `pick_nk_train_group` /
  `nk_bwd_vmem_estimate` (:202-350 of the JAX module): whether a fusion
  scan trains through this pair or through the grouped scan kernels 13/14
  (``ops/selective_scan_grouped.py``).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.cost import nk_flops, reports_cost
from xfmamba_tpu_torch.ops.fast_math import SOFTPLUS_THRESHOLD, softplus
from xfmamba_tpu_torch.ops.nk_scan import (
    _kinds_code, _nk_operands, nk_scan, scan_mode_kinds, selective_scan_bwd_cuda,
    selective_scan_bwd_plain, traversal_order)
from xfmamba_tpu_torch.ops.primitives import dtype_code, on_cpu, ptr, require, stream


# ---------------------------------------------------------------------------
# the routing rule: nk pair (kernels 2/7) or grouped scan (kernels 13/14)
# ---------------------------------------------------------------------------

def nk_bwd_vmem_estimate(L, D, K, N, G):
    """The TPU adjoint kernel's peak VMEM in bytes for a group of G images
    of L positions x D channels (``nk_bwd_vmem_estimate``, :202-224): float32
    (L * G, D) map units, 8 scratch + 3 + 2K persistent + 6 transient ones
    with Mosaic's measured 1.8x allocation factor, plus the double-buffered
    input and output windows.  N does not enter it."""
    Lg = L * G
    unit = Lg * (-(-D // 128) * 128) * 4
    stack = (8 + 3 + 2 * K + 6) * unit
    io = (1.5 + 0.5 * K) * unit * 0.5 + (1 + K) * unit
    return int(1.8 * stack + io)


NK_BWD_BUDGET = 126 * 1024 * 1024


def pick_nk_train_group(B, L, W, D, K, N):
    """The largest image group G in (8, 4, 2, 1) that divides B, keeps
    L * G and W * G multiples of 8 and fits the VMEM budget, or None."""
    for g in (8, 4, 2, 1):
        if B % g == 0 and (L * g) % 8 == 0 and (W * g) % 8 == 0 \
                and nk_bwd_vmem_estimate(L, D, K, N, g) < NK_BWD_BUDGET:
            return g
    return None


def nk_train_supported(B, L, W, D, K, N, scan_mode):
    """The group of the nk pair for a fusion scan of B images of L = H * W
    positions, or None for the grouped scan (``nk_train_supported``, :345).

    The rule is the TPU's VMEM arithmetic, kept so that the port runs the
    kernel the JAX package runs on the same shapes; the card has no such
    limit.  The JAX rule also returns None on its CPU backend; this one
    depends on the geometry only, so the CPU and the card take one route."""
    if scan_mode not in ("cross2d", "unidi", "bidi"):
        return None
    return pick_nk_train_group(B, L, W, D, K, N)


# ---------------------------------------------------------------------------
# kernel 7 and the training op
# ---------------------------------------------------------------------------

def _bwd(impl, u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    n, L, D = u.shape
    K = len(kinds)
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    g = impl(H=H, W=W, dts=dts.reshape(n, L, K, D), gy=gy.float().contiguous(), **ops)
    N = ops["A"].shape[1]
    return (g["du"], g["dz"].reshape(n, L, K * D), g["dB"].reshape(n, L, K * N),
            g["dC"].reshape(n, L, K * N), g["dA"].reshape(K * N, D),
            g["dDsum"].expand(K, D), g["dbias"])


def nk_scan_bwd_plain(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    """The serial adjoint's plain version (every state kept): the oracle."""
    return _bwd(selective_scan_bwd_plain, u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)


def nk_scan_bwd_serial(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    """The earlier design on the card: the serial adjoint of
    ``csrc/nk_scan_bwd.cu`` (a float32 state scratch, atomics), counted in
    ``nk_scan.selective_scan_bwd_cuda.launches``."""
    return _bwd(selective_scan_bwd_cuda, u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)


# ---------------------------------------------------------------------------
# the kernel's plan and its plain twin
# ---------------------------------------------------------------------------

SMEM_LIMIT = 227 * 1024
FLUSH = 8          # positions between the dB / dC flushes (kAdjFlush)
LANES = 4          # lanes per chain: lane g holds the states n = 4 j + g
LOG2E = 1.4426950408889634


def adjoint_plan(H: int, W: int, N: int, D: int) -> SimpleNamespace:
    """The kernel's segments and blocks for an H x W map, N states, D
    channels: ``clen`` positions per segment (about sqrt(L)), ``n_ck``
    segments, ``warps`` per block (8 channels each; the most, up to 8, whose
    checkpoints, segment states and flush buffer fit the shared memory) and
    ``ctiles`` channel tiles of 8 x warps."""
    L = H * W
    clen = math.isqrt(L - 1) + 1 if L > 1 else 1
    n_ck = -(-L // clen)
    ns = -(-N // LANES)
    for warps in (8, 4, 2, 1):
        # checkpoints and segment states, the flush buffer, a segment's
        # chain values (4 per position), the flush's positions, the
        # traversal's positions
        smem = ((n_ck + clen) * ns * warps * 32 + FLUSH * warps * 32 + 4 * clen * warps * 8
                + FLUSH + L) * 4
        if smem <= SMEM_LIMIT:
            return SimpleNamespace(clen=clen, n_ck=n_ck, warps=warps,
                                   ctiles=-(-D // (8 * warps)), smem=smem)
    raise ValueError(f"a {H}x{W} map with N={N}: the segment states do not fit shared memory")


@torch.no_grad()
def nk_scan_bwd_segments_plain(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    """Kernel 7's plain twin, the phases of ``csrc/nk_scan_adjoint.cu``:
    per kind, a forward walk keeping the states at segment starts, then the
    segments from the last, each recomputed from its checkpoint and walked
    back; dB / dC summed over channel tiles of the kernel's width, then
    the partials summed in the second launch's fixed order (tiles, images,
    kinds).  Returns `nk_scan_bwd`'s tuple."""
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    plan = adjoint_plan(H, W, N, D)
    width = 8 * plan.warps
    tiles, pad = plan.ctiles, plan.ctiles * 8 * plan.warps - D
    dev, f32 = u.device, torch.float32
    uf, gyf = u.float(), gy.float()
    z = dts.float().reshape(n, L, K, D)
    Bf, Cf = Bs.float().reshape(n, L, K, N), Cs.float().reshape(n, L, K, N)
    An = A.float().reshape(K, N, D).transpose(1, 2)              # (K, D, N)
    A2 = An * LOG2E
    bias = bias.float().reshape(K, D)
    Dsum = Dvec.float().reshape(K, D).sum(0)

    def tile_sums(v):
        """(n, D, N) -> (tiles, n, N): the channels summed tile by tile."""
        return F.pad(v, (0, 0, 0, pad)).view(n, tiles, width, N).sum(2).transpose(0, 1)

    du_part = torch.empty(K, n, L, D, device=dev)
    dz = torch.empty(n, L, K, D, device=dev)
    bc_part = torch.empty(tiles, n, L, K, 2, N, device=dev)
    dA_part = torch.empty(n, K, N, D, device=dev)
    dbias_part = torch.empty(n, K, D, device=dev)
    for k, kind in enumerate(kinds):
        order = traversal_order(kind, H, W, dev)
        zb = z[:, order, k] + bias[k]                             # (n, L, D)
        delta = softplus(zb)
        du_o = (delta * uf[:, order])[..., None]                  # delta u
        go = gyf[:, order]
        Bo, Co = Bf[:, order, k, None, :], Cf[:, order, k, None, :]   # (n, L, 1, N)

        def step(h, t):
            return torch.exp2(delta[:, t, :, None] * A2[k]) * h + du_o[:, t] * Bo[:, t]

        ck, h = [], torch.zeros(n, D, N, device=dev)
        for t in range(L):                                        # forward walk
            if t % plan.clen == 0:
                ck.append(h)
            h = step(h, t)
        g = a_next = torch.zeros(n, D, N, device=dev)
        dA = torch.zeros(n, D, N, device=dev)
        dus, ddelta = torch.empty(n, L, D, device=dev), torch.empty(n, L, D, device=dev)
        for s in reversed(range(plan.n_ck)):
            t0 = s * plan.clen
            hs = [ck[s]]
            for t in range(t0, min(t0 + plan.clen, L)):           # the segment again
                hs.append(step(hs[-1], t))
            for i in reversed(range(len(hs) - 1)):                # and back
                t = t0 + i
                a = torch.exp2(delta[:, t, :, None] * A2[k])
                hprev, hcur = hs[i], hs[i + 1]
                g = a_next * g + Co[:, t] * go[:, t, :, None]
                a_next = a
                dus[:, t] = (g * delta[:, t, :, None] * Bo[:, t]).sum(-1)
                ddelta[:, t] = (g * (uf[:, order[t], :, None] * Bo[:, t]
                                     + hprev * a * An[k])).sum(-1)
                dA = dA + g * hprev * a * delta[:, t, :, None]
                bc_part[:, :, order[t], k, 0] = tile_sums(g * du_o[:, t])
                bc_part[:, :, order[t], k, 1] = tile_sums(go[:, t, :, None] * hcur)
        dzk = ddelta * torch.where(zb > SOFTPLUS_THRESHOLD, torch.ones_like(zb),
                                   torch.sigmoid(zb))
        dz[:, order, k] = dzk
        du_part[k][:, order] = dus
        dA_part[:, k] = dA.transpose(1, 2)
        dbias_part[:, k] = dzk.sum(1)
        if k == 0:
            dD_part = (go * uf[:, order]).sum(1)
    # the second launch: the partials in a fixed order
    du = gyf * Dsum
    for k in range(K):
        du = du + du_part[k]
    bc = bc_part[0]
    for t in range(1, tiles):
        bc = bc + bc_part[t]
    dA, dbias, dDsum = dA_part[0], dbias_part[0], dD_part[0]
    for b in range(1, n):
        dA, dbias, dDsum = dA + dA_part[b], dbias + dbias_part[b], dDsum + dD_part[b]
    return (du, dz.to(dts.dtype).reshape(n, L, K * D), bc[..., 0, :].reshape(n, L, K * N),
            bc[..., 1, :].reshape(n, L, K * N), dA.reshape(K * N, D), dDsum.expand(K, D), dbias)


# ---------------------------------------------------------------------------
# kernel 7
# ---------------------------------------------------------------------------

def nk_scan_bwd(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    """Gradients of `nk_scan` given gy (B, L, D): (du float32, ddts in
    dts.dtype, dBs, dCs float32, dA (K*N, D), dDvec (K, D), dbias (K, D))."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias, gy):
        return nk_scan_bwd_segments_plain(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not (1 <= K <= 4 and 1 <= N <= 16):
        raise ValueError(f"K={K}, N={N}: the adjoint takes 1..4 kinds of 1..16 states")
    for name, t, width in (("u", u, D), ("dts", dts, K * D), ("Bs", Bs, K * N),
                           ("Cs", Cs, K * N)):
        require(t, (n, L, width), u.dtype, name=name)
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    gy = gy.float().contiguous()
    require(gy, (n, L, D), name="gy")
    plan = adjoint_plan(H, W, N, D)
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty(n, L, D, **f32)
    dz = torch.empty(n, L, K * D, dtype=dts.dtype, device=u.device)
    dB, dC = torch.empty(n, L, K * N, **f32), torch.empty(n, L, K * N, **f32)
    dA, dbias = torch.empty(K * N, D, **f32), torch.empty(K, D, **f32)
    dDsum = torch.empty(D, **f32)
    du_part = torch.empty(K, n * L, D, **f32)
    bc_part = torch.empty(plan.ctiles, n * L, K, 2, N, **f32)
    dA_part, dbias_part = torch.empty(n, K, N, D, **f32), torch.empty(n, K, D, **f32)
    dD_part = torch.empty(n, D, **f32)
    lib = build.library()
    build.check(lib.xfm_nk_scan_adjoint(
        ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(ops["A"]), ptr(ops["bias"]), ptr(ops["Dsum"]),
        ptr(gy), ptr(du), ptr(dz), ptr(dB), ptr(dC), ptr(dA), ptr(dDsum), ptr(dbias),
        ptr(du_part), ptr(bc_part), ptr(dA_part), ptr(dbias_part), ptr(dD_part), n, H, W, D, K,
        N, _kinds_code(kinds), plan.clen, plan.warps, dtype_code(u), stream(u)),
        "nk_scan_adjoint")
    nk_scan_bwd.launches += 1
    return du, dz, dB, dC, dA, dDsum.expand(K, D), dbias


nk_scan_bwd.launches = 0


class NKScanTrain(torch.autograd.Function):
    """`nk_scan` with kernel 7 as its backward (port of the custom VJP
    ``nk_scan_train``).  Saves the inputs; the kernel recomputes the
    forward's states."""

    @staticmethod
    def forward(ctx, u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group):
        ctx.geometry = (H, W, kinds)
        ctx.save_for_backward(u, dts, Bs, Cs, A, Dvec, bias)
        return nk_scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        grads = nk_scan_bwd(*saved, gy, *ctx.geometry)
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved)) + (None,) * 4


@reports_cost(lambda u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group=8: nk_flops(u, A, kinds))
def nk_scan_train(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group=8):
    """Training nk scan, same contract as `nk_scan` (``group`` as there)."""
    return NKScanTrain.apply(u, dts, Bs, Cs, A, Dvec, bias, H, W, tuple(kinds), group)


def nk_scan_train_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode="cross2d", group=None):
    """x (B, H, W, D); dts (B, H, W, K, D); Bs/Cs (B, H, W, K, N); A
    (K, D, N); Dmat/bias (K, D); ``group`` the image group of
    `nk_train_supported`, by default `pick_nk_train_group`'s (1 where it
    finds none: JAX asserts one there, and the group picks the route only).
    Returns (B, H, W, D) float32 (port of ``nk_scan_train_from_projs``,
    :353)."""
    B, H, W, D = x.shape
    K, _, N = A.shape
    L = H * W
    if group is None:
        group = pick_nk_train_group(B, L, W, D, K, N) or 1
    y = nk_scan_train(x.reshape(B, L, D).contiguous(), dts.reshape(B, L, K * D).contiguous(),
                      Bs.reshape(B, L, K * N).contiguous(), Cs.reshape(B, L, K * N).contiguous(),
                      A.transpose(1, 2).reshape(K * N, D), Dmat, bias, H, W,
                      scan_mode_kinds(scan_mode, K), group)
    return y.float().reshape(B, H, W, D)
