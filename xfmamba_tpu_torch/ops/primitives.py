"""Wrappers of the dense CUDA kernels in ``csrc/vss_stage.cu`` (GEMM with
epilogue, row LayerNorm, depthwise 3x3 conv + SiLU), each beside its plain
PyTorch version.

These are the pieces of the TPU stage kernel
``xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2`` other than
its scans; ``ops/vss_stage.py`` composes them with the scan of
``ops/nk_scan.py``, and ``nk_scan_x`` uses the LayerNorm as its epilogue.

Each ``*_cuda`` wrapper checks its operands, launches its kernel on the
current stream and adds one to its ``launches`` count, or raises; the
callers pick ``*_plain`` for CPU tensors.  Activations are float32 or
bfloat16 (one type per call), small parameters (biases, norms, conv taps)
float32, and every kernel computes in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors) -> bool:
    """True when every given tensor is on the CPU, False when all are on one
    CUDA device; raises on any other mix."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors on {sorted(map(str, devices))}: expected all on "
                     "the CPU or all on one CUDA device")


def require_cuda(*tensors) -> None:
    if on_cpu(*tensors):
        raise ValueError("a CUDA kernel was given CPU tensors")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def require(t, shape, dtype=None, name="tensor", contiguous=True):
    """Check a kernel operand; ``None`` entries of ``shape`` match any size."""
    if t.dim() != len(shape) or any(s is not None and s != n
                                    for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# GEMM with epilogue
# ---------------------------------------------------------------------------

def gemm_plain(a, w, bias=None, residual=None, gelu=False):
    """Matmul against an nn.Linear weight with a bias / exact GELU /
    residual epilogue, in float32, cast to a.dtype.  a (M, K), w (N, K),
    bias (N,) float32, residual (M, N)."""
    out = a.float() @ w.float().t()
    if bias is not None:
        out = out + bias.float()
    if gelu:
        out = F.gelu(out)
    if residual is not None:
        out = out + residual.float()
    return out.to(a.dtype)


def gemm_cuda(a, w, bias=None, residual=None, gelu=False):
    require_cuda(a, w, bias, residual)
    M, K = a.shape
    N = w.shape[0]
    require(a, (M, K), name="a")
    require(w, (N, K), a.dtype, name="w")
    if bias is not None:
        require(bias, (N,), torch.float32, name="bias")
    if residual is not None:
        require(residual, (M, N), a.dtype, name="residual")
    out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    lib = build.library()
    gemm_cuda.launches += 1
    build.check(lib.xfm_gemm_nt(ptr(a), ptr(w), ptr(bias), ptr(residual),
                                ptr(out), M, N, K, dtype_code(a), int(gelu),
                                stream(a)), "gemm_nt")
    return out


gemm_cuda.launches = 0


# ---------------------------------------------------------------------------
# row LayerNorm
# ---------------------------------------------------------------------------

def layer_norm_plain(x, weight, bias, out_dtype, eps=1e-5):
    """LayerNorm over the last axis of x (rows, C) into ``out_dtype``,
    statistics in float32."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(out_dtype)


def layer_norm_cuda(x, weight, bias, out_dtype, eps=1e-5):
    require_cuda(x, weight, bias)
    rows, C = x.shape
    require(x, (rows, C), name="x")
    require(weight, (C,), torch.float32, name="weight")
    require(bias, (C,), torch.float32, name="bias")
    out = torch.empty(rows, C, dtype=out_dtype, device=x.device)
    lib = build.library()
    layer_norm_cuda.launches += 1
    build.check(lib.xfm_layer_norm(ptr(x), ptr(weight), ptr(bias), ptr(out),
                                   rows, C, dtype_code(x), dtype_code(out),
                                   eps, stream(x)), "layer_norm")
    return out


layer_norm_cuda.launches = 0


# ---------------------------------------------------------------------------
# depthwise 3x3 conv + SiLU
# ---------------------------------------------------------------------------

def dwconv3_silu_plain(x, w9, bias=None):
    """silu(depthwise 3x3 conv, zero padding 1, + bias) of an NHWC map x
    (B, H, W, C); w9 (9, C) holds tap (dy, dx) at row dy * 3 + dx."""
    C = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w9.float().t().reshape(C, 1, 3, 3),
                 None if bias is None else bias.float(), padding=1, groups=C)
    return F.silu(y).permute(0, 2, 3, 1).to(x.dtype)


def dwconv3_silu_cuda(x, w9, bias=None):
    require_cuda(x, w9, bias)
    B, H, W, C = x.shape
    require(x, (B, H, W, C), name="x")
    require(w9, (9, C), torch.float32, name="w9")
    if bias is not None:
        require(bias, (C,), torch.float32, name="bias")
    out = torch.empty_like(x)
    lib = build.library()
    dwconv3_silu_cuda.launches += 1
    build.check(lib.xfm_dwconv3_silu(ptr(x), ptr(w9), ptr(bias), ptr(out),
                                     B, H, W, C, dtype_code(x), stream(x)),
                "dwconv3_silu")
    return out


dwconv3_silu_cuda.launches = 0
