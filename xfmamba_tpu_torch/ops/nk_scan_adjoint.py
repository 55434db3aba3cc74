"""Kernel 7: the training backward of the fusion scans.

Replaces ``xfmamba_tpu/ops/nk_scan_adjoint.py::_nk_scan_bwd_kernel`` (:54;
host ``nk_scan_bwd_call`` :242), the whole-map adjoint of the nk scan
(kernel 2).  The port runs the shared adjoint kernel of
``csrc/nk_scan_bwd.cu`` in dts form (``ops/nk_scan.py::
selective_scan_bwd_cuda``).

- `nk_scan_bwd`: gradients of `nk_scan` at its contract (u, dts, Bs, Cs,
  A (K*N, D), Dvec (K, D), bias (K, D)); the plain version for CPU tensors,
  the kernel (counted in ``nk_scan_bwd.launches``) for CUDA tensors.
- `NKScanTrain`: the autograd op, kernel 2 forward and kernel 7 backward;
  ShallowFuse calls it once per swap group (K=1, row_f).
- `nk_scan_train_from_projs`: the ``ss2d_core_from_projs``-shaped entry
  that Cross_SS2Dv5 trains through (K=4 cross2d, N=16).
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.ops.nk_scan import (
    _nk_operands, nk_scan, scan_mode_kinds, selective_scan_bwd_cuda,
    selective_scan_bwd_plain)
from xfmamba_tpu_torch.ops.primitives import on_cpu, require


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
    return _bwd(selective_scan_bwd_plain, u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)


def nk_scan_bwd(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds):
    """Gradients of `nk_scan` given gy (B, L, D): (du float32, ddts in
    dts.dtype, dBs, dCs float32, dA (K*N, D), dDvec (K, D), dbias (K, D))."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias, gy):
        return nk_scan_bwd_plain(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)
    n, L, D = u.shape
    for name, t in (("u", u), ("dts", dts), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    nk_scan_bwd.launches += 1
    return _bwd(selective_scan_bwd_cuda, u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)


nk_scan_bwd.launches = 0


class NKScanTrain(torch.autograd.Function):
    """`nk_scan` with kernel 7 as its backward (port of the custom VJP
    ``nk_scan_train``).  Saves the inputs; the kernel recomputes the
    forward's states."""

    @staticmethod
    def forward(ctx, u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
        ctx.geometry = (H, W, kinds)
        ctx.save_for_backward(u, dts, Bs, Cs, A, Dvec, bias)
        return nk_scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        grads = nk_scan_bwd(*saved, gy, *ctx.geometry)
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved)) + (None, None, None)


def nk_scan_train(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Training nk scan, same contract as `nk_scan`."""
    return NKScanTrain.apply(u, dts, Bs, Cs, A, Dvec, bias, H, W, tuple(kinds))


def nk_scan_train_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode="cross2d"):
    """x (B, H, W, D); dts (B, H, W, K, D); Bs/Cs (B, H, W, K, N); A
    (K, D, N); Dmat/bias (K, D).  Returns (B, H, W, D) float32 (port of
    ``nk_scan_train_from_projs``, :353)."""
    B, H, W, D = x.shape
    K, _, N = A.shape
    L = H * W
    y = nk_scan_train(x.reshape(B, L, D).contiguous(), dts.reshape(B, L, K * D).contiguous(),
                      Bs.reshape(B, L, K * N).contiguous(), Cs.reshape(B, L, K * N).contiguous(),
                      A.transpose(1, 2).reshape(K * N, D), Dmat, bias, H, W,
                      scan_mode_kinds(scan_mode, K))
    return y.float().reshape(B, H, W, D)
