"""SS2D, the 2-D selective-scan op of VMamba (port of
``xfmamba_tpu/models/ss2d.py``), forward types ``v05_noz`` (no z-gate,
LayerNorm out-norm, cross2d scan) and ``m0_noz`` (Mamba-2 / SSD, the same
without the z-gate).

`SS2D.ss2d_core` is the scan core of ``v05_noz``, dispatched as the JAX
``ss2d_core`` does on an accelerator: with d_state 1 (cross2d) it runs
`ops.ss2d_core_n1.ss2d_core_n1` (kernels 11 and 12), otherwise
`core_dispatch`, which Cross_SS2Dv5's training scan also takes: the nk pair
(kernels 2 and 7) where the routing rule of ``ops/nk_scan_adjoint.py``
gives it a group, else the composable `ss2d_core_from_projs`, which scans
each direction with `selective_scan_auto` (kernels 13 and 14).  The
backbone runs `SS2D` block by block in float32; in bfloat16 it runs the
stage kernels instead (``models/vssm.py``).

``m0_noz`` (`SS2D._forward_m0`, the JAX ``SS2D._forward_m0``) materialises
the four cross2d traversals, projects each direction to one dt per head and
a B and a C shared by the direction's heads, and runs the chunked SSD scan
where ``ops.ssd_chunk.ssd_supported`` holds: kernel 15 alone without
gradients, kernels 15 and 16 under autograd.  Outside that gate it runs
``ops/ssd.py::ssd_chunk_scan``, the einsum form that JAX runs there too
(counted in ``ssd_chunk_scan.calls``).

Parameter layouts match the reference tensors.  ``v05_noz``:
``x_proj_weight`` (K, R + 2N, D), ``dt_projs_weight`` (K, D, R),
``dt_projs_bias`` (K, D), ``A_logs`` (K * D, N), ``Ds`` (K * D,).
``m0``: ``x_proj_weight`` (K, R + 2N, D), ``dt_projs_bias`` and ``A_logs``
(K, R), ``Ds`` (K, R, D / R), with R heads per direction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from xfmamba_tpu_torch.models.layers import (
    Conv2dSame, Dense, LayerNorm, activation, trunc_normal_init, uniform_init)
from xfmamba_tpu_torch.ops.cross_scan import cross_merge, cross_scan
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_scan_train_from_projs, nk_train_supported
from xfmamba_tpu_torch.ops.selective_scan_grouped import selective_scan_auto
from xfmamba_tpu_torch.ops.ss2d_core_n1 import ss2d_core_n1
from xfmamba_tpu_torch.ops.ssd import ssd_chunk_scan
from xfmamba_tpu_torch.ops.ssd_chunk import CHUNK, ssd_chunk_scan_heads, ssd_supported


# ---------------------------------------------------------------------------
# forward_type parsing (``ss2d.py:52-111``)
# ---------------------------------------------------------------------------

# base: scan mode
_BASE_TYPES = {
    "v0": "cross2d", "v0seq": "cross2d", "v01": "cross2d", "v02": "cross2d",
    "v03": "cross2d", "v04": "cross2d", "v05": "cross2d", "v051d": "unidi",
    "v052d": "bidi", "v052dc": "cascade2d", "v2": "cross2d", "v3": "cross2d",
    "m0": "cross2d",
}
_SCANS = {"cross2d": 0, "unidi": 1, "bidi": 2}


@dataclass(frozen=True)
class SS2DMode:
    base: str
    scan_mode: str
    disable_z: bool
    oact: bool
    out_norm: str  # "ln" | "none" | "dwconv3" | "cnorm" | "softmax" | "sigmoid"


def parse_forward_type(forward_type: str) -> SS2DMode:
    """The postfix chain of the reference's SS2D forward types: ``_no32``,
    ``_oact``, ``_noz``, ``_nozact`` and the out-norm tags, stripped from
    the end in that order, then the base type."""
    ft = forward_type

    def strip(tag):
        nonlocal ft
        if ft.endswith(tag):
            ft = ft[: -len(tag)]
            return True
        return False

    strip("_no32")   # float32 scan state is unconditional
    oact = strip("_oact")
    disable_z = strip("_noz")
    strip("_nozact")   # the z-gate's activation: no z-gate is ported
    out_norm = "ln"
    for tag, kind in [("_onnone", "none"), ("_ondwconv3", "dwconv3"),
                      ("_oncnorm", "cnorm"), ("_onsoftmax", "softmax"),
                      ("_onsigmoid", "sigmoid")]:
        if strip(tag):
            out_norm = kind
            break
    if ft not in _BASE_TYPES:
        raise ValueError(f"unsupported forward_type base {ft!r} (from {forward_type!r})")
    return SS2DMode(base=ft, scan_mode=_BASE_TYPES[ft], disable_z=disable_z, oact=oact,
                    out_norm=out_norm)


# ---------------------------------------------------------------------------
# mamba-style initialisers (``mamba_init``, vmamba.py:165-232)
# ---------------------------------------------------------------------------

def dt_proj_weight_init(t, dt_rank: int, dt_scale: float = 1.0,
                        dt_init: str = "random", generator=None):
    std = dt_rank ** -0.5 * dt_scale
    if dt_init == "constant":
        with torch.no_grad():
            return t.fill_(std)
    return uniform_init(t, std, generator)


def dt_proj_bias_init(t, dt_min: float = 0.001, dt_max: float = 0.1,
                      dt_init_floor: float = 1e-4, generator=None):
    """Inverse softplus of dt drawn log-uniformly in [dt_min, dt_max]."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = torch.clamp(dt, min=dt_init_floor)
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))


def a_log_init(t):
    """S4D-real: A = [1 .. N] for every channel of a (K * D, N) tensor."""
    with torch.no_grad():
        n = t.shape[1]
        return t.copy_(torch.log(torch.arange(1, n + 1, dtype=t.dtype)).expand_as(t))


def dt_rank_of(d_model: int, dt_rank="auto") -> int:
    return int(math.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)


class ScanParams(nn.Module):
    """Owner of the scan parameters shared by SS2D and the fusion ops:
    mixed into a module, it registers them under the reference names."""

    def init_scan_params(self, K: int, d_inner: int, R: int, N: int,
                         generator=None):
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, d_inner, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K * d_inner, N))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))
        trunc_normal_init(self.x_proj_weight, generator=generator)
        dt_proj_weight_init(self.dt_projs_weight, R, generator=generator)
        dt_proj_bias_init(self.dt_projs_bias, generator=generator)
        a_log_init(self.A_logs)

    def scan_operands(self, d_inner: int):
        """A (K, D, N) = -exp(A_logs), Ds and dt bias as (K, D), float32."""
        K = self.x_proj_weight.shape[0]
        N = self.A_logs.shape[1]
        A = -torch.exp(self.A_logs.float()).reshape(K, d_inner, N)
        return A, self.Ds.float().reshape(K, d_inner), self.dt_projs_bias.float()


# ---------------------------------------------------------------------------
# scan helpers
# ---------------------------------------------------------------------------

def _project_kdirs(x, x_proj_weight, dt_projs_weight, R, N):
    """Projections of x (B, H, W, D) for all K directions: dts
    (B, H, W, K, D), Bs and Cs (B, H, W, K, N), in x's dtype."""
    x_dbl = torch.einsum("bhwd,kcd->bhwkc", x, x_proj_weight.to(x.dtype))
    dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
    dts = torch.einsum("bhwkr,kdr->bhwkd", dts, dt_projs_weight.to(x.dtype))
    return dts, Bs, Cs


def _scan_group(x, dts, Bs, Cs, A, Ds, bias, ks, transposed, reverse):
    """Scan the directions ``ks`` that share a layout and a direction of
    traversal; returns y (B, L, len(ks) * D) in scan order."""
    B, H, W, D = x.shape
    L = H * W
    if transposed:
        x, dts, Bs, Cs = (t.transpose(1, 2) for t in (x, dts, Bs, Cs))
    nk = len(ks)
    u = x.reshape(B, L, D).repeat(1, 1, nk)
    d_sel = dts.reshape(B, L, -1, D)[:, :, ks].reshape(B, L, nk * D)
    B_sel = Bs.reshape(B, L, -1, Bs.shape[-1])[:, :, ks]
    C_sel = Cs.reshape(B, L, -1, Cs.shape[-1])[:, :, ks]
    A_sel = A[ks].reshape(nk * D, -1)
    D_sel = None if Ds is None else Ds[ks].reshape(-1)
    b_sel = None if bias is None else bias[ks].reshape(-1)
    return selective_scan_auto(u, d_sel, A_sel, B_sel, C_sel, D_sel, b_sel,
                               delta_softplus=True, reverse=reverse)


def ss2d_core_from_projs(x, dts, Bs, Cs, A, Dmat, bias,
                         scan_mode: str = "cross2d"):
    """Scan and merge from precomputed projections, each direction group
    through `selective_scan_auto` (kernels 13 and 14).  x (B, H, W, D); dts
    (B, H, W, K, D); Bs/Cs (B, H, W, K, N); A (K, D, N); Dmat/bias (K, D).
    Returns (B, H, W, D) float32.  Direction k of cross2d is row_f, col_f,
    row_r, col_r for k = 0..3; columns run over the transposed map
    flattened as t = w * H + h."""
    B, H, W, D = x.shape
    K = A.shape[0]
    L = H * W
    args = (x, dts, Bs, Cs, A, Dmat, bias)
    if scan_mode == "cross2d":
        if K != 4:
            raise ValueError("cross2d needs K = 4")
        y0 = _scan_group(*args, [0], False, False)
        y2 = _scan_group(*args, [2], False, True)
        y1 = _scan_group(*args, [1], True, False)
        y3 = _scan_group(*args, [3], True, True)
        y13 = (y1 + y3).reshape(B, W, H, D).transpose(1, 2).reshape(B, L, D)
        y = (y0 + y2) + y13
    elif scan_mode == "unidi":
        y = _scan_group(*args, list(range(K)), False, False)
        y = y.reshape(B, L, K, D).sum(2)
    elif scan_mode == "bidi":
        if K != 4:
            raise ValueError("bidi needs K = 4")
        yf = _scan_group(*args, [0, 1], False, False)
        yr = _scan_group(*args, [2, 3], False, True)
        y4 = (yf + yr).reshape(B, L, 2, D)
        y = y4[:, :, 0] + y4[:, :, 1]
    else:
        raise ValueError(f"unsupported scan_mode {scan_mode}")
    return y.reshape(B, H, W, D)


def core_dispatch(x, dts, Bs, Cs, A, Dmat, bias, scan_mode: str = "cross2d"):
    """The trainable scan core from projections (port of ``core_dispatch``,
    ``ss2d.py:312-344``, its accelerator route for cross2d without the
    backend argument): the nk pair (kernels 2 and 7) where
    `nk_train_supported` gives a group, else one `selective_scan_auto` call
    per direction group (kernels 13 and 14).  Two departures from JAX: its
    route sends N = 1 to its kernel 10, which the port does not have, and
    its "auto" backend sends the unidi and bidi modes to the XLA scan,
    which has no counterpart on the card; here both take the same rule as
    cross2d N > 1.  Shapes as `ss2d_core_from_projs`; returns (B, H, W, D)
    float32."""
    B, H, W, D = x.shape
    K, _, N = A.shape
    if nk_train_supported(B, H * W, W, D, K, N, scan_mode) is not None:
        return nk_scan_train_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode)
    return ss2d_core_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode)


# ---------------------------------------------------------------------------
# the SS2D module
# ---------------------------------------------------------------------------

class SS2D(ScanParams):
    """in_proj -> depthwise 3x3 conv -> activation -> 2-D scan -> LayerNorm
    out-norm -> out_proj, on NHWC maps: forward type ``v05_noz`` (the
    selective scan) or ``m0_noz`` (the SSD scan, `_forward_m0`).
    ``initialize`` is the reference's ``ssm_init``; m0 takes v1 or v2 (v0
    reads as v2, as in the reference)."""

    def __init__(self, d_model: int, d_state: int = 1, ssm_ratio: float = 2.0,
                 dt_rank="auto", d_conv: int = 3, conv_bias: bool = True,
                 forward_type: str = "v05_noz", act: str = "silu", initialize: str = "v0",
                 with_initial_state: bool = False, generator=None):
        super().__init__()
        mode = parse_forward_type(forward_type)
        self.m0 = mode.base == "m0"
        if d_conv != 3:
            raise ValueError("the port's SS2D takes d_conv 3 only")
        if self.m0:
            if not mode.disable_z or mode.oact or mode.out_norm != "ln":
                raise ValueError(f"forward_type {forward_type!r}: the port has m0 as m0_noz only")
            if with_initial_state:
                raise ValueError("m0 with a carried initial state is not ported")
        elif forward_type != "v05_noz":
            raise ValueError("the port has SS2D forward types v05_noz and m0_noz only")
        d_inner = int(ssm_ratio * d_model)
        self.d_inner = d_inner
        self.R = dt_rank_of(d_model, dt_rank)
        self.N = d_state
        self.scans = _SCANS[mode.scan_mode]
        self.act = activation(act)
        self.in_proj = Dense(d_model, d_inner, bias=False, init="trunc_normal",
                             generator=generator)
        self.conv2d = Conv2dSame(d_inner, d_inner, 3, padding=1, groups=d_inner,
                                 bias=conv_bias, generator=generator)
        if self.m0:
            self._init_m0_params(4, d_inner, initialize, generator)
        else:
            self.init_scan_params(4, d_inner, self.R, d_state, generator)
        self.out_norm = LayerNorm(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=False, init="trunc_normal",
                              generator=generator)

    def _init_m0_params(self, K, d_inner, initialize, generator):
        """The head-structured parameters of m0 (``ss2d.py:595-620``)."""
        R, N = self.R, self.N
        if d_inner % R:
            raise ValueError(f"m0 needs dt_rank {R} to divide d_inner {d_inner}")
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, d_inner))
        self.Ds = nn.Parameter(torch.ones(K, R, d_inner // R))
        self.A_logs = nn.Parameter(torch.empty(K, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, R))
        trunc_normal_init(self.x_proj_weight, generator=generator)
        with torch.no_grad():
            if initialize == "v1":
                self.A_logs.normal_(generator=generator)
                self.dt_projs_bias.normal_(generator=generator).mul_(0.1)
            else:
                self.A_logs.zero_()
                self.dt_projs_bias.uniform_(generator=generator).mul_(0.1)

    def ss2d_core(self, x):
        """Cross-scan, selective scan and cross-merge of x (B, H, W, D);
        returns (B, H, W, D) float32 (before the out-norm)."""
        if self.N == 1:
            return ss2d_core_n1(x, self.x_proj_weight, self.dt_projs_weight,
                                self.dt_projs_bias, self.A_logs, self.Ds)
        dts, Bs, Cs = _project_kdirs(x, self.x_proj_weight,
                                     self.dt_projs_weight, self.R, self.N)
        A, Dmat, bias = self.scan_operands(self.d_inner)
        return core_dispatch(x, dts, Bs, Cs, A, Dmat, bias)

    def _forward_m0(self, xin):
        """The SSD core of m0 on xin (B, H, W, D) after the activation:
        heads h = k * R + r of width D / R, one dt per head, B and C shared
        by the R heads of direction k.  Returns (B, H, W, D) in xin's
        dtype."""
        B_, H, W, D = xin.shape
        K, R, N, L = 4, self.R, self.N, H * W
        P = D // R
        xs = cross_scan(xin, self.scans)                                # (B, K, L, D)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight.to(xs.dtype))
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        A = -torch.exp(self.A_logs.float()).reshape(K * R)
        Dm = self.Ds.float().reshape(K * R, P)
        bias = self.dt_projs_bias.float().reshape(K * R)
        if ssd_supported(L, K * R, P, N, K, CHUNK):
            ys, _ = ssd_chunk_scan_heads(xs.view(B_, K, L, R, P), dts, A, Bs, Cs, Dm, bias)
            ys = ys.view(B_, K, L, D)
        else:
            ys = ssd_chunk_scan(xs.transpose(1, 2).reshape(B_, L, K * R, P),
                                dts.transpose(1, 2).reshape(B_, L, K * R), A,
                                Bs.transpose(1, 2), Cs.transpose(1, 2), CHUNK,
                                D=Dm, dt_bias=bias, dt_softplus=True)
            ys = ys.reshape(B_, L, K, D).transpose(1, 2)
        return cross_merge(ys, H, W, self.scans).view(B_, H, W, D)

    def forward(self, x):
        xin = self.act(self.conv2d(self.in_proj(x)))
        y = self._forward_m0(xin) if self.m0 else self.ss2d_core(xin)
        return self.out_proj(self.out_norm(y.to(x.dtype)))
