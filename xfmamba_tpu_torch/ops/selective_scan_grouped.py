"""Kernels 13 and 14: the grouped selective scan of one direction and its
adjoint (port of the grouped section of
``xfmamba_tpu/ops/selective_scan_pallas.py``, :834-1227).

- Kernel 13, `grouped_scan_fwd`: replaces ``_grouped_scan_kernel`` (:838,
  ``pallas_call`` :954).  For K groups of C channels (channel kc = k * C + c
  uses B[:, :, k] and C[:, :, k]) and N states::

      delta = softplus(delta_in + bias)              (threshold 20)
      h[n]  = exp(delta * A[kc, n]) * h[n] + delta * u * B[n]
      y     = sum_n C[n] h[n] + D[kc] * u

  walked from position 0 up, or (``reverse``) from L - 1 down.  It also
  writes the state entering each chunk of `CHUNK` positions, in scan order
  (the TPU's ``carr``, :869): the checkpoints the adjoint starts from.
- Kernel 14, `grouped_scan_bwd`: replaces ``_grouped_scan_kernel_bwd``
  (:979, ``pallas_call`` :1137): the chunks in adjoint order, h recomputed
  from each chunk's checkpoint, the adjoint lambda[t] = C[t] dy[t] +
  a[t'] lambda[t'] (t' the next position in scan order), and every
  gradient: du, the gradient of delta_in (through the softplus), dB, dC,
  dA, dD, dbias.
- `SelectiveScanGrouped` / `selective_scan_auto`: the autograd op (the
  custom VJP ``selective_scan_grouped_pallas``, :1183-1214) and its
  ``ops.selective_scan``-shaped entry (:1217-1227), which returns float32.

On the card both kernels are ``csrc/grouped_scan_lanes.cu`` (four lanes a
chain, blocks of `lanes_warps` x 8 channels, no state in device memory, no
atomics: kernel 14 is two launches, the adjoint and a fixed-order sum of
its partials, the same bits on every run).  `grouped_scan_fwd_v1` /
`grouped_scan_bwd_v1` run the first design (``csrc/
selective_scan_grouped_v1.cu``: a thread per chain, a float32 state scratch
and atomics) on CUDA tensors only, for timing beside them.

Layouts are the JAX package's: u and delta (B, L, K * C); A (K * C, N);
B and C (B, L, K, N); D and bias (K * C,) or None.  u, delta, B and C share
one dtype, float32 or bfloat16; A, D and bias are float32; state, sums and
every output are float32.  The checkpoints are (B, K, n_chunks, N, C)
float32, by data chunk: chunk j covers positions [j * chunk, (j + 1) *
chunk); a forward scan enters it with the state after position j * chunk
- 1, a reverse one with the state after position (j + 1) * chunk (zero for
the first chunk walked).  N runs from 1 to `MAX_STATE`.

Each wrapper takes its plain twin (`*_plain`, the same walk in PyTorch,
checkpoints included) only for CPU tensors; on CUDA tensors it launches
the kernel, adds one to its ``launches`` count, or raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.cost import reports_cost, scan_flops
from xfmamba_tpu_torch.ops.fast_math import SOFTPLUS_THRESHOLD, softplus
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, on_cpu, ptr, require, require_cuda, stream)

# positions per checkpointed chunk
CHUNK = 32
MAX_CHUNK = 64
MAX_STATE = 16
# blocks of at most 8 warps (64 channels), fewer while the grid would not
# give every SM two blocks
LANES_WARPS = 8
SMS = 132


def lanes_warps(B, K, C):
    """Warps per block of ``csrc/grouped_scan_lanes.cu`` (8 channels each):
    `LANES_WARPS`, halved while the B * K * slabs blocks would leave an SM
    of the H100 fewer than two."""
    warps = LANES_WARPS
    while warps > 1 and B * K * -(-C // (8 * warps)) < 2 * SMS:
        warps //= 2
    return warps


def _geometry(u, Bmat, A, chunk):
    """(B, L, K, C, N, n_chunks) of a call, checked."""
    B, L, KC = u.shape
    K, N = Bmat.shape[2], A.shape[1]
    if K < 1 or KC % K:
        raise ValueError(f"{KC} channels do not split into {K} groups")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N} outside 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    return B, L, K, KC // K, N, -(-L // chunk)


def _check(u, delta, A, Bmat, Cmat, Dvec, bias, chunk):
    B, L, K, C, N, n = _geometry(u, Bmat, A, chunk)
    require(u, (B, L, K * C), name="u")
    require(delta, (B, L, K * C), u.dtype, name="delta")
    require(Bmat, (B, L, K, N), u.dtype, name="B")
    require(Cmat, (B, L, K, N), u.dtype, name="C")
    require(A, (K * C, N), torch.float32, name="A")
    for name, t in (("D", Dvec), ("bias", bias)):
        if t is not None:
            require(t, (K * C,), torch.float32, name=name)
    dtype_code(u)
    return B, L, K, C, N, n


def _cuda_operands(u, delta, A, Bmat, Cmat, Dvec, bias, chunk, ck=None, dy=None):
    """The checks of a kernel call on CUDA tensors (the backward's with the
    checkpoints and dy): (B, L, K, C, N, n_chunks)."""
    require_cuda(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy)
    B, L, K, C, N, n = _check(u, delta, A, Bmat, Cmat, Dvec, bias, chunk)
    if ck is not None:
        require(ck, (B, K, n, N, C), torch.float32, name="ck")
        require(dy, (B, L, K * C), torch.float32, name="dy")
    return B, L, K, C, N, n


def _scan_order(L, reverse):
    return range(L - 1, -1, -1) if reverse else range(L)


def _enters_chunk(t, L, chunk, reverse):
    """Whether the scan enters a chunk at position t."""
    return (t == L - 1 or (t + 1) % chunk == 0) if reverse else t % chunk == 0


def _recurrence(u, delta, A, Bmat, bias):
    """The float32 per-position quantities, (B, L, K * C[, N]): u, the
    pre-softplus z, delta, a = exp(delta A), b = delta u B, B expanded."""
    KC, K = u.shape[2], Bmat.shape[2]
    uf = u.float()
    z = delta.float() + (0.0 if bias is None else bias.float())
    dt = softplus(z)
    Bx = Bmat.float().repeat_interleave(KC // K, dim=2)
    a = torch.exp(dt[..., None] * A.float())
    b = (dt * uf)[..., None] * Bx
    return uf, z, dt, a, b, Bx


def _to_ck(ck, K, C):
    """(B, n, K * C, N) -> the (B, K, n, N, C) checkpoint layout."""
    B, n, _, N = ck.shape
    return ck.view(B, n, K, C, N).permute(0, 2, 1, 4, 3).contiguous()


def _from_ck(ck):
    B, K, n, N, C = ck.shape
    return ck.permute(0, 2, 1, 4, 3).reshape(B, n, K * C, N)


# ---------------------------------------------------------------------------
# kernel 13: the forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def grouped_scan_fwd_plain(u, delta, A, Bmat, Cmat, Dvec=None, bias=None, reverse=False,
                           chunk=CHUNK):
    """Returns y (B, L, K * C) float32 and the checkpoints (B, K, n, N, C)."""
    B, L, K, C, N, n = _geometry(u, Bmat, A, chunk)
    uf, _, _, a, b, _ = _recurrence(u, delta, A, Bmat, bias)
    Cx = Cmat.float().repeat_interleave(C, dim=2)
    h = torch.zeros(B, K * C, N, dtype=torch.float32, device=u.device)
    ck = torch.empty(B, n, K * C, N, dtype=torch.float32, device=u.device)
    y = torch.empty(B, L, K * C, dtype=torch.float32, device=u.device)
    for t in _scan_order(L, reverse):
        if _enters_chunk(t, L, chunk, reverse):
            ck[:, t // chunk] = h
        h = a[:, t] * h + b[:, t]
        y[:, t] = (h * Cx[:, t]).sum(-1)
    if Dvec is not None:
        y += uf * Dvec.float()
    return y, _to_ck(ck, K, C)


def grouped_scan_fwd(u, delta, A, Bmat, Cmat, Dvec=None, bias=None, reverse=False,
                     chunk=CHUNK):
    """Kernel 13; see the module docstring."""
    if on_cpu(u, delta, A, Bmat, Cmat, Dvec, bias):
        return grouped_scan_fwd_plain(u, delta, A, Bmat, Cmat, Dvec, bias, reverse, chunk)
    forward_only("grouped_scan_fwd", u, delta, A, Bmat, Cmat, Dvec, bias)
    B, L, K, C, N, n = _cuda_operands(u, delta, A, Bmat, Cmat, Dvec, bias, chunk)
    y, ck = _fwd_outputs(B, L, K, C, N, n, u.device)
    lib = build.library()
    build.check(lib.xfm_grouped_scan_fwd(
        ptr(u), ptr(delta), ptr(A), ptr(Bmat), ptr(Cmat), ptr(Dvec), ptr(bias), ptr(y),
        ptr(ck), B, L, K, C, N, chunk, int(reverse), lanes_warps(B, K, C), dtype_code(u),
        stream(u)), "grouped_scan_fwd")
    grouped_scan_fwd.launches += 1
    return y, ck


grouped_scan_fwd.launches = 0


def _fwd_outputs(B, L, K, C, N, n, device):
    """y (B, L, K * C) and the checkpoints (B, K, n, N, C), float32."""
    return (torch.empty(B, L, K * C, dtype=torch.float32, device=device),
            torch.empty(B, K, n, N, C, dtype=torch.float32, device=device))


def grouped_scan_fwd_v1(u, delta, A, Bmat, Cmat, Dvec=None, bias=None, reverse=False,
                        chunk=CHUNK):
    """Kernel 13's first design on CUDA tensors, counted in its own
    ``launches``."""
    B, L, K, C, N, n = _cuda_operands(u, delta, A, Bmat, Cmat, Dvec, bias, chunk)
    y, ck = _fwd_outputs(B, L, K, C, N, n, u.device)
    lib = build.library()
    build.check(lib.xfm_grouped_scan_fwd_v1(
        ptr(u), ptr(delta), ptr(A), ptr(Bmat), ptr(Cmat), ptr(Dvec), ptr(bias), ptr(y),
        ptr(ck), B, L, K, C, N, chunk, int(reverse), dtype_code(u), stream(u)),
        "grouped_scan_fwd_v1")
    grouped_scan_fwd_v1.launches += 1
    return y, ck


grouped_scan_fwd_v1.launches = 0


# ---------------------------------------------------------------------------
# kernel 14: the backward
# ---------------------------------------------------------------------------

@torch.no_grad()
def grouped_scan_bwd_plain(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy, reverse=False,
                           chunk=CHUNK):
    """Given the forward's checkpoints and dy = dL/dy (B, L, K * C), returns
    a dict of float32 gradients: du, ddelta (of delta_in, through the
    softplus) (B, L, K * C); dA (K * C, N); dB, dC (B, L, K, N); dD, dbias
    (K * C,), whether or not D and bias were given."""
    B, L, K, C, N, n = _geometry(u, Bmat, A, chunk)
    uf, z, dt, a, b, Bx = _recurrence(u, delta, A, Bmat, bias)
    Cx = Cmat.float().repeat_interleave(C, dim=2)
    dy = dy.float()
    ckf = _from_ck(ck.float())
    # h from each chunk's checkpoint: the state before (hp) and after (hs)
    # each position
    hp, hs = torch.empty_like(a), torch.empty_like(a)
    order = _scan_order(L, reverse)
    for t in order:
        if _enters_chunk(t, L, chunk, reverse):
            h = ckf[:, t // chunk]
        hp[:, t] = h
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    # the adjoint against the scan order: lambda = C dy + g, g = a lambda
    lam = torch.empty_like(a)
    g = torch.zeros_like(a[:, 0])
    for t in reversed(order):
        lam[:, t] = Cx[:, t] * dy[:, t, :, None] + g
        g = a[:, t] * lam[:, t]
    dexp = lam * hp * a
    du = (lam * dt[..., None] * Bx).sum(-1)
    ddelta = (lam * uf[..., None] * Bx).sum(-1) + (dexp * A.float()).sum(-1)
    ddelta = ddelta * torch.where(z > SOFTPLUS_THRESHOLD, torch.ones_like(z), torch.sigmoid(z))
    if Dvec is not None:
        du += dy * Dvec.float()
    group = (lambda t: t.view(B, L, K, C, N).sum(3))
    return dict(du=du, ddelta=ddelta, dA=(dexp * dt[..., None]).sum((0, 1)),
                dB=group(lam * (dt * uf)[..., None]), dC=group(dy[..., None] * hs),
                dD=(dy * uf).sum((0, 1)), dbias=ddelta.sum((0, 1)))


def grouped_scan_bwd(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy, reverse=False, chunk=CHUNK):
    """Kernel 14; see `grouped_scan_bwd_plain` for what it returns."""
    if on_cpu(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy):
        return grouped_scan_bwd_plain(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy, reverse, chunk)
    B, L, K, C, N, n = _cuda_operands(u, delta, A, Bmat, Cmat, Dvec, bias, chunk, ck, dy)
    f32 = dict(dtype=torch.float32, device=u.device)
    warps = lanes_warps(B, K, C)
    g = _grads(B, L, K, C, N, f32)
    # the partials the second launch sums: each slab's dB / dC rows, dA,
    # dbias and dD per image
    bc_part = torch.empty(-(-C // (8 * warps)), B, L, K, 2, N, **f32)
    dA_part, dbias_part, dD_part = (torch.empty(B, K * C, N, **f32), torch.empty(B, K * C, **f32),
                                    torch.empty(B, K * C, **f32))
    lib = build.library()
    build.check(lib.xfm_grouped_scan_bwd(
        ptr(u), ptr(delta), ptr(A), ptr(Bmat), ptr(Cmat), ptr(Dvec), ptr(bias), ptr(ck),
        ptr(dy), *(ptr(g[k]) for k in GRADS), ptr(bc_part), ptr(dA_part), ptr(dbias_part),
        ptr(dD_part), B, L, K, C, N, chunk, int(reverse), warps, dtype_code(u), stream(u)),
        "grouped_scan_bwd")
    grouped_scan_bwd.launches += 1
    return g


grouped_scan_bwd.launches = 0

# the gradients in the C entry points' order
GRADS = ("du", "ddelta", "dB", "dC", "dA", "dD", "dbias")


def _grads(B, L, K, C, N, f32, zeros=False):
    new = torch.zeros if zeros else torch.empty
    shapes = dict(du=(B, L, K * C), ddelta=(B, L, K * C), dB=(B, L, K, N), dC=(B, L, K, N),
                  dA=(K * C, N), dD=(K * C,), dbias=(K * C,))
    return {k: new(*shapes[k], **f32) for k in GRADS}


def grouped_scan_bwd_v1(u, delta, A, Bmat, Cmat, Dvec, bias, ck, dy, reverse=False,
                        chunk=CHUNK):
    """Kernel 14's first design on CUDA tensors (its sums by atomics into
    zeroed outputs, its state scratch of one chunk per chain), counted in
    its own ``launches``."""
    B, L, K, C, N, n = _cuda_operands(u, delta, A, Bmat, Cmat, Dvec, bias, chunk, ck, dy)
    f32 = dict(dtype=torch.float32, device=u.device)
    hs = torch.empty(B, K, min(chunk, L), N, C, **f32)
    g = _grads(B, L, K, C, N, f32, zeros=True)
    lib = build.library()
    build.check(lib.xfm_grouped_scan_bwd_v1(
        ptr(u), ptr(delta), ptr(A), ptr(Bmat), ptr(Cmat), ptr(Dvec), ptr(bias), ptr(ck),
        ptr(dy), ptr(hs), *(ptr(g[k]) for k in GRADS), B, L, K, C, N, chunk, int(reverse),
        dtype_code(u), stream(u)), "grouped_scan_bwd_v1")
    grouped_scan_bwd_v1.launches += 1
    return g


grouped_scan_bwd_v1.launches = 0


# ---------------------------------------------------------------------------
# the autograd op
# ---------------------------------------------------------------------------

class SelectiveScanGrouped(torch.autograd.Function):
    """Kernel 13 forward, kernel 14 backward; saves the inputs and the
    checkpoints, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, Dvec, bias, reverse):
        y, ck = grouped_scan_fwd(u, delta, A, Bmat, Cmat, Dvec, bias, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, Dvec, bias, ck)
        return y

    @staticmethod
    def backward(ctx, gy):
        u, delta, A, Bmat, Cmat, Dvec, bias, ck = ctx.saved_tensors
        g = grouped_scan_bwd(u, delta, A, Bmat, Cmat, Dvec, bias, ck,
                             gy.float().contiguous(), ctx.reverse)
        grads = [g[name].to(t.dtype) for name, t in
                 (("du", u), ("ddelta", delta), ("dA", A), ("dB", Bmat), ("dC", Cmat))]
        grads += [None if t is None else g[name] for name, t in (("dD", Dvec), ("dbias", bias))]
        return (*grads, None)


@reports_cost(lambda u, delta, A, *args, **kwargs: scan_flops(*u.shape, A.shape[-1]))
def selective_scan_auto(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                        delta_softplus=True, reverse=False):
    """``ops.selective_scan`` semantics on kernels 13/14: u and delta
    (B, L, K * C), A (K * C, N), B and C (B, L, K, N), D and delta_bias
    (K * C,) or None.  Returns y (B, L, K * C) float32, differentiable in
    every tensor argument.  delta B and C are taken in u's dtype and A, D
    and the bias in float32 (casts that autograd runs back)."""
    if not delta_softplus:
        raise ValueError("the grouped scan fuses the softplus of delta")
    dtype = u.dtype

    def f32(t):
        return None if t is None else t.float().contiguous()

    return SelectiveScanGrouped.apply(
        u.contiguous(), delta.to(dtype).contiguous(), f32(A), Bmat.to(dtype).contiguous(),
        Cmat.to(dtype).contiguous(), f32(D), f32(delta_bias), bool(reverse))
