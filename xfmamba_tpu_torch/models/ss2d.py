"""SS2D, the 2-D selective-scan op of VMamba (port of
``xfmamba_tpu/models/ss2d.py``), every forward type of the JAX module: the
v2 body (base types v0, v0seq, v01-v05, v051d, v052d, v052dc, v2, v3 with
the postfixes ``_no32``, ``_oact``, ``_noz``, ``_nozact`` and the out-norm
tags ``_onnone``, ``_ondwconv3``, ``_oncnorm``, ``_onsoftmax``,
``_onsigmoid``), ``m0`` (Mamba-2 / SSD, with its z-gate or ``_noz``) and
the xv family (xv1a, xv2a, xv3a with ``_mul``, ``_act`` and the conv tags
``_ca``, ``_ca1``, ``_ocov``, ``_ocov2``, ``_cpos``).  ``d_conv`` > 1 is a depthwise conv of
that size with flax's "SAME" padding; d_conv <= 1 has none.

The v2 body: in_proj (2 * d_inner wide with the z-gate, split, the gate
activated unless ``_nozact``), the conv, the activation, the scan core,
the out-norm (`OutNorm`), GELU with ``_oact``, the gate, out_proj.  Its
core (`SS2D.ss2d_core`) is dispatched as the JAX ``ss2d_core`` does on an
accelerator: with d_state 1 and the cross2d scan it runs
`ops.ss2d_core_n1.ss2d_core_n1` (kernels 11 and 12); the unidi and bidi
scans, and d_state above 1, take `core_dispatch`, which Cross_SS2Dv5's
training scan also takes: at d_state 1 (cross2d) kernel 10
(``ops/fused_cross_scan.py``), else the nk pair (kernels 2 and 7) where the
routing rule of ``ops/nk_scan_adjoint.py`` gives it a group, else the
composable `ss2d_core_from_projs`, which scans each direction group with
`selective_scan_auto` (kernels 13 and 14).  cascade2d
(`ss2d_core_cascade2d`) and the xv family scan through
`selective_scan_auto` too (JAX's TPU runs cascade2d on its XLA scan, which
the card does not have); on CPU tensors it takes the kernels' plain
versions.  The backbone runs `SS2D` block by
block in float32; in bfloat16 the v05_noz backbone runs the stage kernels
instead (``models/vssm.py``).

``m0`` (`SS2D._forward_m0`, the JAX ``SS2D._forward_m0``) materialises
the four traversals, projects each direction to one dt per head and a B and
a C shared by the direction's heads, and runs the chunked SSD scan in
chunks of ``chunk_size`` where ``ops.ssd_chunk.ssd_supported`` holds:
kernel 15 alone without gradients, kernels 15 and 16 under autograd.
Outside that gate it runs ``ops/ssd.py::ssd_chunk_scan``, the einsum form
that JAX runs there too (counted in ``ssd_chunk_scan.calls``).  Its z-gate
is the v2 body's.  With ``with_initial_state`` the scan starts from the
float32 buffer ``initial_state`` (1, K * R, P, N) (JAX's ``ssm_state``
collection), broadcast over the batch without a gradient; inside
`carry_ssm_state` (JAX's ``mutable=["ssm_state"]``) each forward replaces
it by the sum over the batch of the final state (over the global batch in a
data-parallel step), and a plain forward leaves it as it is.

``dropout`` is flax's ``nn.Dropout`` after out_proj, in every forward type,
its masks from ``dropout_generator`` (`layers.Dropout`).

Parameter layouts match the reference tensors.  The v2 body:
``x_proj_weight`` (K, R + 2N, D), ``dt_projs_weight`` (K, D, R),
``dt_projs_bias`` (K, D), ``A_logs`` (K * D, N), ``Ds`` (K * D,); the xv
family the same without ``x_proj_weight`` (and, for xv2a, without
``dt_projs_weight``).  ``m0``: ``x_proj_weight`` (K, R + 2N, D),
``dt_projs_bias`` and ``A_logs`` (K, R), ``Ds`` (K, R, D / R), with R heads
per direction.  State-dict names are the reference's: the LayerNorm
out-norm is ``out_norm``, dwconv3's conv ``out_norm.1``, cnorm's
LayerNorm and conv ``out_norm.0`` and ``out_norm.2`` (``JAX_NAMES`` maps
them to the JAX tree for ``checkpoint/convert.py``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from xfmamba_tpu_torch.models.layers import (
    LN_EPS, Conv2dSame, Dense, Dropout, LayerNorm, _sharded, activation, gelu, softmax_spatial,
    trunc_normal_init, uniform_init)
from xfmamba_tpu_torch.ops.cross_scan import (
    cross_merge, cross_scan, cross_scan_1b1, directional_scan_2d)
from xfmamba_tpu_torch.ops.fused_cross_scan import ss2d_core_fused
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_scan_train_from_projs, nk_train_supported
from xfmamba_tpu_torch.ops.selective_scan_grouped import selective_scan_auto
from xfmamba_tpu_torch.ops.ss2d_core_n1 import ss2d_core_n1
from xfmamba_tpu_torch.ops.ssd import ssd_chunk_scan
from xfmamba_tpu_torch.ops.ssd_chunk import CHUNK, ssd_chunk_scan_heads, ssd_supported


# ---------------------------------------------------------------------------
# forward_type parsing (``ss2d.py:52-111``)
# ---------------------------------------------------------------------------

# base: scan mode (``ss2d.py:52-66``; the float32 flags of the reference
# do not apply: the scan state is always float32)
_BASE_TYPES = {
    "v0": "cross2d", "v0seq": "cross2d", "v01": "cross2d", "v02": "cross2d",
    "v03": "cross2d", "v04": "cross2d", "v05": "cross2d", "v051d": "unidi",
    "v052d": "bidi", "v052dc": "cascade2d", "v2": "cross2d", "v3": "cross2d",
}
_SCANS = {"cross2d": 0, "unidi": 1, "bidi": 2}
_OUT_NORM_TAGS = [("_onnone", "none"), ("_ondwconv3", "dwconv3"), ("_oncnorm", "cnorm"),
                  ("_onsoftmax", "softmax"), ("_onsigmoid", "sigmoid")]


@dataclass(frozen=True)
class SS2DMode:
    base: str
    scan_mode: str
    disable_z: bool
    disable_z_act: bool
    oact: bool
    out_norm: str  # "ln" | "none" | "dwconv3" | "cnorm" | "softmax" | "sigmoid"
    is_v0: bool


def _strip_out_norm(strip) -> str:
    for tag, kind in _OUT_NORM_TAGS:
        if strip(tag):
            return kind
    return "ln"


def parse_forward_type(forward_type: str) -> SS2DMode:
    """The postfix chain of the reference's SS2D forward types
    (``ss2d.py:80-111``): ``_no32``, ``_oact``, ``_noz``, ``_nozact`` and
    then one out-norm tag, stripped from the end in that order, then the
    base type (or m0)."""
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
    disable_z_act = strip("_nozact")
    out_norm = _strip_out_norm(strip)
    if ft == "m0":
        scan_mode = "cross2d"
    elif ft in _BASE_TYPES:
        scan_mode = _BASE_TYPES[ft]
    else:
        raise ValueError(f"unsupported forward_type base {ft!r} (from {forward_type!r})")
    return SS2DMode(base=ft, scan_mode=scan_mode, disable_z=disable_z,
                    disable_z_act=disable_z_act, oact=oact, out_norm=out_norm,
                    is_v0=ft in ("v0", "v0seq"))


@dataclass(frozen=True)
class XVMode:
    base: str       # xv1a | xv2a | xv3a
    out_norm: str
    omul: bool
    oact: bool
    cact: str       # "id" | "silu" | "gelu"
    iconv: bool
    oconv: bool
    oconv2: bool
    cpos: bool


def parse_xv_type(forward_type: str, with_dconv: bool = True) -> XVMode:
    """The postfix chain of the xv forward types (``ss2d.py:127-164``): an
    out-norm tag, ``_mul``, ``_act``, then (with a conv) ``_ca``, ``_ca1``,
    ``_ocov2``, ``_ocov``, ``_cpos``; the base is the first four letters,
    xv1a, xv2a or xv3a."""
    ft = forward_type

    def strip(tag):
        nonlocal ft
        if ft.endswith(tag):
            ft = ft[: -len(tag)]
            return True
        return False

    out_norm = _strip_out_norm(strip)
    omul = strip("_mul")
    oact = strip("_act")
    cact, cpos, oconv, oconv2 = "id", False, False, False
    if with_dconv:
        if strip("_ca"):
            cact = "silu"
        if strip("_ca1"):
            cact = "gelu"
        oconv2 = strip("_ocov2")
        oconv = strip("_ocov")
        cpos = strip("_cpos")
    iconv = with_dconv and not oconv and not oconv2
    base = ft[:4]
    if base not in ("xv1a", "xv2a", "xv3a"):
        raise ValueError(f"unsupported xv forward_type {forward_type!r}")
    return XVMode(base=base, out_norm=out_norm, omul=omul, oact=oact, cact=cact, iconv=iconv,
                  oconv=oconv, oconv2=oconv2, cpos=cpos)


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


def simple_init(t, kind: str, which: str, generator=None):
    """``initialize`` v1 / v2 (``ss2d.py:203-216``): Ds ones; v1 draws
    A_logs from N(0, 1) and the dt projection from 0.1 N(0, 1); v2 sets
    A_logs to 0 and draws the dt projection from 0.1 U(0, 1)."""
    with torch.no_grad():
        if which == "Ds":
            return t.fill_(1.0)
        if kind == "v1":
            t.normal_(generator=generator)
            return t if which == "A_logs" else t.mul_(0.1)
        if which == "A_logs":
            return t.zero_()
        return t.uniform_(generator=generator).mul_(0.1)


def dt_rank_of(d_model: int, dt_rank="auto") -> int:
    return int(math.ceil(d_model / 16)) if dt_rank == "auto" else int(dt_rank)


class ScanParams(nn.Module):
    """Owner of the scan parameters shared by SS2D and the fusion ops:
    mixed into a module, it registers them under the reference names."""

    def init_scan_params(self, K: int, d_inner: int, R: int, N: int, generator=None,
                         initialize: str = "v0", x_proj: bool = True, dt_proj: bool = True):
        """``initialize`` is the reference's (v0: the mamba initialisers, v1
        / v2: `simple_init`); the xv family has no ``x_proj_weight``
        (``x_proj=False``), and xv2a no ``dt_projs_weight``
        (``dt_proj=False``)."""
        if x_proj:
            self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, d_inner))
            trunc_normal_init(self.x_proj_weight, generator=generator)
        if dt_proj:
            self.dt_projs_weight = nn.Parameter(torch.empty(K, d_inner, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K * d_inner, N))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))
        if initialize == "v0":
            if dt_proj:
                dt_proj_weight_init(self.dt_projs_weight, R, generator=generator)
            dt_proj_bias_init(self.dt_projs_bias, generator=generator)
            a_log_init(self.A_logs)
        elif initialize in ("v1", "v2"):
            if dt_proj:
                simple_init(self.dt_projs_weight, initialize, "dt_w", generator)
            simple_init(self.dt_projs_bias, initialize, "dt_b", generator)
            simple_init(self.A_logs, initialize, "A_logs", generator)
        else:
            raise ValueError(f"unknown initialize {initialize!r}")

    def scan_operands(self, d_inner: int):
        """A (K, D, N) = -exp(A_logs), Ds and dt bias as (K, D), float32."""
        K = self.A_logs.shape[0] // d_inner
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


def _scan_group(x, dts, Bs, Cs, A, Ds, bias, ks: range, transposed, reverse):
    """Scan the directions ``ks`` (a range) that share a layout and a
    direction of traversal; returns y (B, L, len(ks) * D) in scan order.
    The directions are taken as slices: an index list would be copied to
    the card from pageable memory, a stream synchronisation a call."""
    B, H, W, D = x.shape
    L = H * W
    if transposed:
        x, dts, Bs, Cs = (t.transpose(1, 2) for t in (x, dts, Bs, Cs))
    nk = len(ks)
    k = slice(ks.start, ks.stop)
    u = x.reshape(B, L, D).repeat(1, 1, nk)
    d_sel = dts.reshape(B, L, -1, D)[:, :, k].reshape(B, L, nk * D)
    B_sel = Bs.reshape(B, L, -1, Bs.shape[-1])[:, :, k]
    C_sel = Cs.reshape(B, L, -1, Cs.shape[-1])[:, :, k]
    A_sel = A[k].reshape(nk * D, -1)
    D_sel = None if Ds is None else Ds[k].reshape(-1)
    b_sel = None if bias is None else bias[k].reshape(-1)
    return selective_scan_auto(u, d_sel, A_sel, B_sel, C_sel, D_sel, b_sel,
                               delta_softplus=True, reverse=reverse)


def ss2d_core_from_projs(x, dts, Bs, Cs, A, Dmat, bias,
                         scan_mode: str = "cross2d"):
    """Scan and merge from precomputed projections, each direction group
    through `selective_scan_auto` (kernels 13 and 14).  x (B, H, W, D); dts
    (B, H, W, K, D); Bs/Cs (B, H, W, K, N); A (K, D, N); Dmat/bias (K, D).
    Returns (B, H, W, D) float32.  Direction k of cross2d is row_f, col_f,
    row_r, col_r for k = 0..3; columns run over the transposed map
    flattened as t = w * H + h.  cross2d scans and merges through
    `directional_scan_2d`, one call a direction; unidi and bidi scan the
    directions that share a traversal in one call, and bidi merges in
    `directional_scan_2d`'s order, (y0 + y2) + (y1 + y3)."""
    B, H, W, D = x.shape
    K = A.shape[0]
    L = H * W
    args = (x, dts, Bs, Cs, A, Dmat, bias)
    if scan_mode == "cross2d":
        if K != 4:
            raise ValueError("cross2d needs K = 4")
        y = directional_scan_2d(
            lambda k, _, transposed, reverse: _scan_group(*args, range(k, k + 1), transposed,
                                                          reverse),
            H, W, [None] * 4)
    elif scan_mode == "unidi":
        y = _scan_group(*args, range(K), False, False)
        y = y.reshape(B, L, K, D).sum(2)
    elif scan_mode == "bidi":
        if K != 4:
            raise ValueError("bidi needs K = 4")
        yf = _scan_group(*args, range(0, 2), False, False)
        yr = _scan_group(*args, range(2, 4), False, True)
        y4 = (yf + yr).reshape(B, L, 2, D)
        y = y4[:, :, 0] + y4[:, :, 1]
    else:
        raise ValueError(f"unsupported scan_mode {scan_mode}")
    return y.reshape(B, H, W, D)


def core_dispatch(x, dts, Bs, Cs, A, Dmat, bias, scan_mode: str = "cross2d"):
    """The trainable scan core from projections (port of ``core_dispatch``,
    ``ss2d.py:312-344``, its accelerator route for cross2d without the
    backend argument): with N = 1, kernel 10 (`ss2d_core_fused`, the JAX
    ``ss2d_core_pallas``; its backward recomputes through
    `ss2d_core_from_projs`); else the nk pair (kernels 2 and 7) where
    `nk_train_supported` gives a group, else one `selective_scan_auto` call
    per direction group (kernels 13 and 14).  One departure from JAX: its
    "auto" backend sends the unidi and bidi modes to the XLA scan, which
    has no counterpart on the card, so here they take the nk/grouped rule,
    N = 1 included; kernel 10 refuses them, where JAX's Pallas backend
    computes the cross2d core whatever the mode.  Shapes as
    `ss2d_core_from_projs`; returns (B, H, W, D) float32."""
    B, H, W, D = x.shape
    K, _, N = A.shape
    if N == 1 and scan_mode == "cross2d":
        return ss2d_core_fused(x, dts, Bs, Cs, A, Dmat, bias)
    group = nk_train_supported(B, H * W, W, D, K, N, scan_mode)
    if group is not None:
        return nk_scan_train_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode, group)
    return ss2d_core_from_projs(x, dts, Bs, Cs, A, Dmat, bias, scan_mode)


def _plain_ln(v):
    """LayerNorm without parameters over the channel axis."""
    return F.layer_norm(v, v.shape[-1:], eps=LN_EPS)


def ss2d_core_cascade2d(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds,
                        d_state: int):
    """cascade2d (``ss2d.py:378-423``): a pass along the rows (directions 0
    forward and 1 reversed, the rows folded into the batch) feeding a pass
    along the columns (directions 2 forward and 3 reversed), each preceded
    by a LayerNorm without parameters.  x (B, H, W, D); returns (B, H, W, D)
    float32."""
    B, H, W, D = x.shape
    N = d_state
    R = dt_projs_weight.shape[-1]
    A = -torch.exp(A_logs.float()).reshape(4, D, N)
    Dmat = Ds.float().reshape(4, D)
    bias = dt_projs_bias.float().reshape(4, D)

    def rowcol(v, k0, transposed):
        """Directions k0 (forward) and k0 + 1 (reversed) along v's W axis."""
        if transposed:
            v = v.transpose(1, 2)
        b, h, w, d = v.shape
        vb = v.reshape(b * h, w, d)
        ks = slice(k0, k0 + 2)
        x_dbl = torch.einsum("lwd,kcd->lwkc", vb, x_proj_weight[ks].to(vb.dtype))
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("lwkr,kdr->lwkd", dts, dt_projs_weight[ks].to(vb.dtype))
        y = sum(selective_scan_auto(vb, dts[:, :, j], A[k0 + j], Bs[:, :, j, None],
                                    Cs[:, :, j, None], Dmat[k0 + j], bias[k0 + j],
                                    reverse=bool(j))
                for j in range(2))
        y = y.reshape(b, h, w, d)
        return y.transpose(1, 2) if transposed else y

    y_row = _plain_ln(rowcol(_plain_ln(x), 0, False))
    return rowcol(y_row, 2, True)


# ---------------------------------------------------------------------------
# the SS2D module
# ---------------------------------------------------------------------------

class OutNorm(nn.Module):
    """The out-norms other than the LayerNorm (``ss2d.py:430-459``): none,
    dwconv3 (a depthwise 3 x 3 conv without bias, the reference's
    ``out_norm.1``), cnorm (LayerNorm ``out_norm.0``, then that conv as
    ``out_norm.2``), softmax over the map, sigmoid."""

    KINDS = ("none", "dwconv3", "cnorm", "softmax", "sigmoid")

    def __init__(self, kind: str, d_inner: int, generator=None):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"unknown out-norm {kind!r}")
        self.kind = kind
        conv = "1" if kind == "dwconv3" else "2"
        self.JAX_NAMES = {"0": "norm", conv: "dwconv"}
        if kind == "cnorm":
            self.add_module("0", LayerNorm(d_inner))
        if kind in ("dwconv3", "cnorm"):
            self.add_module(conv, Conv2dSame(d_inner, d_inner, 3, padding="same",
                                             groups=d_inner, bias=False, generator=generator))

    def forward(self, x):
        m = self._modules
        if self.kind == "dwconv3":
            return m["1"](x)
        if self.kind == "cnorm":
            return m["2"](m["0"](x))
        if self.kind == "softmax":
            return softmax_spatial(x)
        if self.kind == "sigmoid":
            return torch.sigmoid(x)
        return x


def make_out_norm(kind: str, d_inner: int, generator=None) -> nn.Module:
    """The out-norm of kind ``kind``: a `LayerNorm` for "ln" (the
    reference's ``out_norm``), else an `OutNorm`."""
    return LayerNorm(d_inner) if kind == "ln" else OutNorm(kind, d_inner, generator)


class SS2D(ScanParams):
    """in_proj -> depthwise conv -> activation -> 2-D scan -> out-norm ->
    out_proj on NHWC maps, for every forward type of the JAX module (the
    module docstring).  ``initialize`` is the reference's ``ssm_init``
    (v0, v1, v2); m0 takes v1 or v2 (v0 reads as v2, as in the
    reference).  ``chunk_size`` and ``with_initial_state`` are m0's (the
    module docstring); ``dropout`` follows out_proj."""

    def __init__(self, d_model: int, d_state: int = 1, ssm_ratio: float = 2.0,
                 dt_rank="auto", d_conv: int = 3, conv_bias: bool = True,
                 forward_type: str = "v05_noz", act: str = "silu", initialize: str = "v0",
                 with_initial_state: bool = False, generator=None, dropout: float = 0.0,
                 chunk_size: int = CHUNK, dropout_generator=None):
        super().__init__()
        d_inner = int(ssm_ratio * d_model)
        self.d_inner = d_inner
        self.R = dt_rank_of(d_model, dt_rank)
        self.N = d_state
        self.act = activation(act)
        self.forward_type = forward_type
        self.m0 = False
        self.chunk_size = chunk_size
        self.carry = False  # set by carry_ssm_state
        self.drop = Dropout(dropout, dropout_generator)
        if forward_type.startswith("xv"):
            self.mode = parse_xv_type(forward_type, with_dconv=d_conv > 1)
            self._init_xv(d_model, d_conv, conv_bias, initialize, generator)
            return
        mode = self.mode = parse_forward_type(forward_type)
        self.m0 = mode.base == "m0"
        if with_initial_state and not self.m0:
            raise ValueError(f"forward_type {forward_type!r}: a carried state is m0's")
        self.scans = _SCANS.get(mode.scan_mode)
        d_proj = d_inner if mode.disable_z else 2 * d_inner
        self.in_proj = Dense(d_model, d_proj, bias=False, init="trunc_normal",
                             generator=generator)
        self.conv2d = self._dwconv(d_inner, d_conv, conv_bias, generator)
        if self.m0:
            self._init_m0_params(4, d_inner, initialize, generator)
            if with_initial_state:
                self.register_buffer("initial_state", torch.zeros(
                    1, 4 * self.R, d_inner // self.R, d_state))
        else:
            self.init_scan_params(4, d_inner, self.R, d_state, generator, initialize)
        self.out_norm = make_out_norm(mode.out_norm, d_inner, generator)
        self.out_proj = Dense(d_inner, d_model, bias=False, init="trunc_normal",
                              generator=generator)

    @property
    def JAX_NAMES(self):
        """The LayerNorm out-norm sits one level deeper in the JAX tree."""
        return {"out_norm": "out_norm.norm"} if isinstance(self.out_norm, LayerNorm) else {}

    @staticmethod
    def _dwconv(ch, d_conv, conv_bias, generator):
        """A depthwise d_conv x d_conv conv with "SAME" padding, or None for
        d_conv <= 1."""
        if d_conv <= 1:
            return None
        return Conv2dSame(ch, ch, d_conv, padding="same", groups=ch, bias=conv_bias,
                          generator=generator)

    def _init_xv(self, d_model, d_conv, conv_bias, initialize, generator):
        """The xv family's modules (``ss2d.py:684-782``): one in_proj to u,
        the deltas' input (R wide for xv1a, d_inner for xv2a, 4 R for xv3a)
        and four B and four C; the conv ``conv2d`` on the input (``_ca``,
        ``_ca1``, plain, or added with ``_cpos``) or on in_proj's output
        (``_ocov2``), ``oconv2d`` on u (``_ocov``)."""
        mode, d_inner, R, N = self.mode, self.d_inner, self.R, self.N
        dts_dim = dict(xv1a=R, xv2a=d_inner, xv3a=4 * R)[mode.base]
        self.xv_split = [d_inner, dts_dim, 4 * N, 4 * N]
        if (mode.iconv or mode.cpos) and mode.oconv2:
            raise ValueError(f"forward_type {self.forward_type!r} names two convs conv2d")
        self.conv2d = (self._dwconv(d_model, d_conv, conv_bias, generator)
                       if mode.iconv or mode.cpos else None)
        self.in_proj = Dense(d_model, sum(self.xv_split), bias=False, init="trunc_normal",
                             generator=generator)
        if mode.oconv2:
            self.conv2d = self._dwconv(sum(self.xv_split), d_conv, conv_bias, generator)
        self.init_scan_params(4, d_inner, R, N, generator, initialize, x_proj=False,
                              dt_proj=mode.base != "xv2a")
        self.out_norm = make_out_norm(mode.out_norm, d_inner, generator)
        self.oconv2d = self._dwconv(d_inner, d_conv, conv_bias, generator) if mode.oconv else None
        self.out_proj = Dense(d_inner, d_model, bias=False, init="trunc_normal",
                              generator=generator)
        self.cact = dict(id=lambda v: v, silu=activation("silu"), gelu=gelu)[mode.cact]

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
        """The v2 body's scan core on x (B, H, W, D) after the activation:
        cross-scan, selective scan and cross-merge, or cascade2d; returns
        (B, H, W, D) float32 (before the out-norm)."""
        scan_mode = self.mode.scan_mode
        if scan_mode == "cascade2d":
            return ss2d_core_cascade2d(x, self.x_proj_weight, self.dt_projs_weight,
                                       self.dt_projs_bias, self.A_logs, self.Ds, self.N)
        if self.N == 1 and scan_mode == "cross2d":
            return ss2d_core_n1(x, self.x_proj_weight, self.dt_projs_weight,
                                self.dt_projs_bias, self.A_logs, self.Ds)
        dts, Bs, Cs = _project_kdirs(x, self.x_proj_weight,
                                     self.dt_projs_weight, self.R, self.N)
        A, Dmat, bias = self.scan_operands(self.d_inner)
        return core_dispatch(x, dts, Bs, Cs, A, Dmat, bias, scan_mode)

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
        init = getattr(self, "initial_state", None)
        if init is not None:                                            # (1, K R, P, N)
            init = init.detach().float().expand(B_, K * R, P, N)
        if ssd_supported(L, K * R, P, N, K, self.chunk_size):
            ys, fin = ssd_chunk_scan_heads(
                xs.view(B_, K, L, R, P), dts, A, Bs, Cs, Dm, bias,
                None if init is None else init.transpose(2, 3).contiguous(),
                chunk=self.chunk_size)
            ys, fin = ys.view(B_, K, L, D), fin.transpose(2, 3)
        else:
            ys, fin = ssd_chunk_scan(xs.transpose(1, 2).reshape(B_, L, K * R, P),
                                     dts.transpose(1, 2).reshape(B_, L, K * R), A,
                                     Bs.transpose(1, 2), Cs.transpose(1, 2), self.chunk_size,
                                     D=Dm, dt_bias=bias, initial_states=init, dt_softplus=True,
                                     return_final_states=True)
            ys = ys.reshape(B_, L, K, D).transpose(1, 2)
        if init is not None and self.carry:
            self._carry(fin)
        return cross_merge(ys, H, W, self.scans).view(B_, H, W, D)

    @torch.no_grad()
    def _carry(self, fin):
        """initial_state <- the sum over the batch of the final state fin
        (b, K R, P, N): the global batch's in a data-parallel step, as JAX's
        GSPMD step sums it."""
        total = fin.detach().float().sum(0, keepdim=True)
        shard = _sharded()
        if shard is not None:
            dist.all_reduce(total, group=shard.group)
        self.initial_state.copy_(total)


    def _forward_xv(self, x):
        """The xv family (``ss2d.py:684-782``) on x (B, H, W, d_model)."""
        mode, D = self.mode, self.d_inner
        if mode.iconv:
            x = self.cact(self.conv2d(x))
        elif mode.cpos:
            x = x + self.conv2d(x)
        xall = self.in_proj(x)
        if mode.oconv2:
            xall = self.conv2d(xall)
        us, dts, Bs, Cs = torch.split(xall, self.xv_split, dim=-1)
        B_, H, W, _ = us.shape
        L = H * W

        def one_by_one(t):            # (B, H, W, 4 * n) -> (B, 4, L, n)
            return cross_scan_1b1(t.reshape(B_, H, W, 4, -1).permute(0, 3, 1, 2, 4))

        if mode.base == "xv2a":
            dts_k = cross_scan(dts)
        else:
            dts_k = torch.einsum("bklr,kdr->bkld", cross_scan(dts) if mode.base == "xv1a"
                                 else one_by_one(dts), self.dt_projs_weight.to(dts.dtype))
        u = cross_scan(us).transpose(1, 2).reshape(B_, L, 4 * D)
        delta = dts_k.transpose(1, 2).reshape(B_, L, 4 * D)
        ys = selective_scan_auto(u, delta, -torch.exp(self.A_logs.float()),
                                 one_by_one(Bs).transpose(1, 2), one_by_one(Cs).transpose(1, 2),
                                 self.Ds.float(), self.dt_projs_bias.reshape(-1))
        ys = ys.reshape(B_, L, 4, D).transpose(1, 2)
        y = self.out_norm(cross_merge(ys, H, W).reshape(B_, H, W, D).to(x.dtype))
        if mode.oact:
            y = gelu(y)
        if mode.omul:
            y = y * us
        if mode.oconv:
            y = y + self.cact(self.oconv2d(us))
        return self.drop(self.out_proj(y))

    def forward(self, x):
        if isinstance(self.mode, XVMode):
            return self._forward_xv(x)
        mode = self.mode
        xz = self.in_proj(x)
        if mode.disable_z:
            xin, z = xz, None
        else:
            xin, z = xz.chunk(2, dim=-1)
            if not mode.disable_z_act:
                z = self.act(z)
        if self.conv2d is not None:
            xin = self.conv2d(xin)
        xin = self.act(xin)
        y = self._forward_m0(xin) if self.m0 else self.ss2d_core(xin)
        y = self.out_norm(y.to(x.dtype))
        if mode.oact:
            y = gelu(y)
        if z is not None:
            y = y * z
        return self.drop(self.out_proj(y))


@contextlib.contextmanager
def carry_ssm_state(model: nn.Module):
    """JAX's ``apply(..., mutable=["ssm_state"])``: inside the block, every
    m0 SS2D of ``model`` with a carried initial state replaces it after each
    forward by the sum over the batch of its final state."""
    layers = [m for m in model.modules() if isinstance(m, SS2D)]
    saved = [m.carry for m in layers]
    for m in layers:
        m.carry = True
    try:
        yield model
    finally:
        for m, c in zip(layers, saved):
            m.carry = c
