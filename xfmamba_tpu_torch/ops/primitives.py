"""Wrappers of the dense CUDA kernels in ``csrc/vss_stage.cu`` (strided
GEMM with epilogue, row LayerNorm, depthwise 3x3 conv + SiLU) and
``csrc/vss_block_bwd.cu`` (LayerNorm backward, conv + SiLU backward), each
beside its plain PyTorch version.

These are the pieces of the TPU stage kernel
``xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2`` other than
its scans; ``ops/vss_stage.py`` composes them with the scan of
``ops/nk_scan.py``, and ``nk_scan_x`` uses the LayerNorm as its epilogue.
The backward kernels are the dense parts of the TPU block adjoint
``xfmamba_tpu/ops/vss_block_v2_adjoint.py::_vss_block_bwd_kernel``, which
``ops/vss_block_train.py`` composes.

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

def _check_scale(scale, M):
    if scale is not None and (scale.dim() != 1 or M % scale.shape[0]):
        raise ValueError(f"scale: shape {tuple(scale.shape)} does not divide {M} rows")


def gemm_ab_plain(a, b, bias=None, residual=None, gelu=False, scale=None,
                  out_dtype=None, out=None):
    """out = epilogue(a @ b^T) in float32, cast to ``out_dtype`` (a.dtype by
    default).  a (M, K) and b (N, K) may be any strided views; bias (N,)
    float32; scale (S,) float32 multiplies rows in S equal groups (a
    per-sample drop-path mask); residual (M, N) float32 or bfloat16, in any
    output dtype.  The epilogue runs bias, exact GELU, scale, residual in
    that order.  With ``out`` the result is written into that (M, N) view
    and returned."""
    _check_scale(scale, a.shape[0])
    res = a.float() @ b.float().t()
    if bias is not None:
        res = res + bias.float()
    if gelu:
        res = F.gelu(res)
    if scale is not None:
        res = res * scale.float().repeat_interleave(a.shape[0] // scale.shape[0])[:, None]
    if residual is not None:
        res = res + residual.float()
    if out is not None:
        return out.copy_(res)
    return res.to(out_dtype or a.dtype)


def _splits(M, N, K, out, bm=64, bn=64):
    """K slices for a product with a small output and a long reduction
    (the weight gradients) on bm x bn output tiles: enough blocks to cover
    the card twice."""
    tiles = -(-M // bm) * -(-N // bn)
    if out is not None or tiles >= 264 or K < 4096:
        return 1
    return max(1, min(-(-264 // tiles), K // 2048))


def _gemm_operands(a, b, bias, residual, gelu, scale, out_dtype, out, bm, bn):
    """Check the operands of `gemm_ab_cuda` and allocate the output.
    Returns (M, N, K, out, splits)."""
    require_cuda(a, b, bias, residual, scale, out)
    M, K = a.shape
    N = b.shape[0]
    require(a, (M, K), name="a", contiguous=False)
    require(b, (N, K), a.dtype, name="b", contiguous=False)
    out_dtype = out.dtype if out is not None else (out_dtype or a.dtype)
    if a.dtype == torch.float32 and out_dtype != torch.float32:
        raise TypeError("float32 inputs give a float32 output")
    if bias is not None:
        require(bias, (N,), torch.float32, name="bias")
    if scale is not None:
        _check_scale(scale, M)
        require(scale, (scale.shape[0],), torch.float32, name="scale")
    epilogue = bias is not None or residual is not None or gelu or scale is not None
    # split slices add into a float32 output
    splits = 1 if epilogue or out_dtype != torch.float32 else _splits(M, N, K, out, bm, bn)
    if out is None:
        alloc = torch.zeros if splits > 1 else torch.empty
        out = alloc(M, N, dtype=out_dtype, device=a.device)
    require(out, (M, N), name="out", contiguous=False)
    if out.stride(1) != 1 and N > 1:
        raise ValueError("out: columns must be contiguous")
    if residual is not None:
        require(residual, (M, N), name="residual", contiguous=False)
        if residual.stride() != out.stride():
            raise ValueError("residual must share the output's strides")
    return M, N, K, out, splits


def gemm_simt_cuda(a, b, bias=None, residual=None, gelu=False, scale=None,
                   out_dtype=None, out=None):
    """The SIMT kernel of ``csrc/vss_stage.cu`` (float32 FMA on 64 x 64
    tiles, any strides): float32 operands, and the serial sequence of the
    bfloat16 blocks that ``ops.vss_stage.SERIAL_OPS`` keeps."""
    M, N, K, out, splits = _gemm_operands(a, b, bias, residual, gelu, scale, out_dtype, out,
                                          64, 64)
    lib = build.library()
    gemm_simt_cuda.launches += 1
    build.check(lib.xfm_gemm(
        ptr(a), ptr(b), ptr(bias), ptr(scale), ptr(residual), ptr(out), M, N, K,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), out.stride(0),
        M // scale.shape[0] if scale is not None else 1, int(gelu), splits,
        dtype_code(a), dtype_code(out), dtype_code(residual) if residual is not None else 0,
        stream(a)), "gemm")
    return out


gemm_simt_cuda.launches = 0

TC_BM = 128


def _major(t):
    """"k" where the operand (rows, K) steps 1 along K, "mn" where it steps
    1 along its rows, None where neither stride is 1."""
    if t.stride(1) == 1 or t.shape[1] == 1:
        return "k"
    if t.stride(0) == 1 or t.shape[0] == 1:
        return "mn"
    return None


def _vec_ok(t, major) -> bool:
    """16-byte copies apply: an aligned base and a row (K-major) or k
    (MN-major) stride of a multiple of 8 elements."""
    step = t.stride(0) if major == "k" else t.stride(1)
    return t.data_ptr() % 16 == 0 and (step % 8 == 0 or t.shape[0 if major == "k" else 1] == 1)


def tc_tile_n(N: int) -> int:
    """The tensor-core kernel's tile width for an output of N columns."""
    for bn in (16, 32, 64):
        if N <= bn:
            return bn
    return 128 if N % 128 == 0 or N >= 512 else 64


def gemm_plan(M, N, a_major, b_major, dtype, epilogue) -> dict:
    """Which GEMM kernel runs a product out (M, N) = A (M, K) B (N, K)^T,
    from the operands' dtype, shapes and unit strides (`_major`: "k",
    "mn" or None): "tc" (``csrc/gemm_tc.cu``) for bfloat16 operands that
    each step 1 along an axis, else "simt" (``csrc/vss_stage.cu``;
    float32 stays off the tensor cores, as TF32 is off everywhere in the
    port).  For "tc" also the tile width and whether to compute out^T
    (``swap``: a weight gradient with its short side on M and no
    epilogue, so the short side becomes the narrow tile)."""
    if dtype != torch.bfloat16 or a_major is None or b_major is None:
        return dict(route="simt")
    swap = not epilogue and M < N and M <= 64
    n = M if swap else N
    return dict(route="tc", swap=swap, bn=tc_tile_n(n))


def gemm_tc_cuda(a, b, bias=None, residual=None, gelu=False, scale=None,
                 out_dtype=None, out=None):
    """The tensor-core kernel of ``csrc/gemm_tc.cu`` (bfloat16 operands,
    mma.sync with float32 sums), `gemm_ab_plain`'s contract."""
    epilogue = bias is not None or residual is not None or gelu or scale is not None
    plan = gemm_plan(a.shape[0], b.shape[0], _major(a), _major(b), a.dtype, epilogue)
    if plan["route"] != "tc":
        raise ValueError("the tensor-core GEMM takes bfloat16 operands with a unit stride")
    swap, bn = plan["swap"], plan["bn"]
    M, N, K, out, splits = _gemm_operands(
        a, b, bias, residual, gelu, scale, out_dtype, out,
        *((bn, TC_BM) if swap else (TC_BM, bn)))
    ka, kb = (b, a) if swap else (a, b)
    am, bmj = _major(ka), _major(kb)
    ldm, ldn = out.stride()
    if swap:
        ldm, ldn = ldn, ldm
    lib = build.library()
    gemm_tc_cuda.launches += 1
    build.check(lib.xfm_gemm_tc(
        ptr(ka), ptr(kb), ptr(bias), ptr(scale), ptr(residual), ptr(out),
        ka.shape[0], kb.shape[0], K, ka.stride(0), ka.stride(1), kb.stride(0), kb.stride(1),
        ldm, ldn, M // scale.shape[0] if scale is not None else 1, int(gelu), splits,
        dtype_code(out), dtype_code(residual) if residual is not None else 0,
        int(am == "k"), int(bmj == "k"), int(_vec_ok(ka, am)), int(_vec_ok(kb, bmj)), bn,
        stream(a)), "gemm_tc")
    return out


gemm_tc_cuda.launches = 0


def gemm_ab_cuda(a, b, bias=None, residual=None, gelu=False, scale=None,
                 out_dtype=None, out=None):
    """`gemm_ab_plain`'s contract on the card: the kernel that `gemm_plan`
    names, `gemm_tc_cuda` or `gemm_simt_cuda` (each counts its own
    launches)."""
    epilogue = bias is not None or residual is not None or gelu or scale is not None
    plan = gemm_plan(a.shape[0], b.shape[0], _major(a), _major(b), a.dtype, epilogue)
    kernel = gemm_tc_cuda if plan["route"] == "tc" else gemm_simt_cuda
    return kernel(a, b, bias, residual, gelu, scale, out_dtype, out)


def gemm_plain(a, w, bias=None, residual=None, gelu=False, scale=None):
    """Matmul against an nn.Linear weight w (N, K) with the epilogue of
    `gemm_ab_plain`, cast to a.dtype."""
    return gemm_ab_plain(a, w, bias, residual, gelu, scale)


def gemm_cuda(a, w, bias=None, residual=None, gelu=False, scale=None):
    require(a, a.shape, name="a")
    require(w, w.shape, name="w")
    return gemm_ab_cuda(a, w, bias, residual, gelu, scale)


def gemm_simt(a, w, bias=None, residual=None, gelu=False, scale=None):
    """`gemm_cuda` on the SIMT kernel whatever the dtype."""
    require(a, a.shape, name="a")
    require(w, w.shape, name="w")
    return gemm_simt_cuda(a, w, bias, residual, gelu, scale)


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

def dwconv3_silu_plain(x, w9, bias=None, copy_bf16=False):
    """silu(depthwise 3x3 conv, zero padding 1, + bias) of an NHWC map x
    (B, H, W, C); w9 (9, C) holds tap (dy, dx) at row dy * 3 + dx.  With
    ``copy_bf16`` (float32 x) returns (y, y rounded to bfloat16)."""
    C = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w9.float().t().reshape(C, 1, 3, 3),
                 None if bias is None else bias.float(), padding=1, groups=C)
    y = F.silu(y).permute(0, 2, 3, 1).to(x.dtype)
    return (y, y.to(torch.bfloat16)) if copy_bf16 else y


def dwconv3_silu_cuda(x, w9, bias=None, copy_bf16=False):
    require_cuda(x, w9, bias)
    B, H, W, C = x.shape
    require(x, (B, H, W, C), name="x")
    require(w9, (9, C), torch.float32, name="w9")
    if bias is not None:
        require(bias, (C,), torch.float32, name="bias")
    if copy_bf16 and x.dtype != torch.float32:
        raise TypeError("the bfloat16 copy is of a float32 map")
    out = torch.empty_like(x)
    out16 = torch.empty(B, H, W, C, dtype=torch.bfloat16, device=x.device) if copy_bf16 else None
    lib = build.library()
    dwconv3_silu_cuda.launches += 1
    build.check(lib.xfm_dwconv3_silu(ptr(x), ptr(w9), ptr(bias), ptr(out), ptr(out16),
                                     B, H, W, C, dtype_code(x), stream(x)),
                "dwconv3_silu")
    return (out, out16) if copy_bf16 else out


dwconv3_silu_cuda.launches = 0


# ---------------------------------------------------------------------------
# row LayerNorm backward
# ---------------------------------------------------------------------------

def layer_norm_bwd_plain(g, x, weight, dres=None, eps=1e-5):
    """Backward of `layer_norm_plain` on x (rows, C) with upstream gradient
    g (rows, C) float32.  Returns (dx float32 (+ dres), dweight, dbias)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    gg = g * weight.float()
    dx = (gg - gg.mean(-1, keepdim=True) - xhat * (gg * xhat).mean(-1, keepdim=True)) * rstd
    if dres is not None:
        dx = dx + dres
    return dx, (g * xhat).sum(0), g.sum(0)


def layer_norm_bwd_cuda(g, x, weight, dres=None, eps=1e-5):
    require_cuda(g, x, weight, dres)
    rows, C = x.shape
    require(x, (rows, C), name="x")
    require(g, (rows, C), torch.float32, name="g")
    require(weight, (C,), torch.float32, name="weight")
    if dres is not None:
        require(dres, (rows, C), torch.float32, name="dres")
    dx = torch.empty(rows, C, dtype=torch.float32, device=x.device)
    dw = torch.zeros(C, dtype=torch.float32, device=x.device)
    db = torch.zeros(C, dtype=torch.float32, device=x.device)
    lib = build.library()
    layer_norm_bwd_cuda.launches += 1
    build.check(lib.xfm_layer_norm_bwd(ptr(g), ptr(x), ptr(weight), ptr(dres), ptr(dx),
                                       ptr(dw), ptr(db), rows, C, dtype_code(x), eps,
                                       stream(x)), "layer_norm_bwd")
    return dx, dw, db


layer_norm_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# depthwise 3x3 conv + SiLU backward
# ---------------------------------------------------------------------------

def dwconv3_silu_bwd_plain(du, x, w9, bias=None):
    """Backward of `dwconv3_silu_plain`: du (B, H, W, C) float32 is the
    gradient of its output.  Returns (dx float32, dw9 (9, C), dbias (C,) or
    None), computed in float32 by autograd of the float32 forward."""
    C = x.shape[-1]
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        wf = w9.detach().float().requires_grad_()
        bf = None if bias is None else bias.detach().float().requires_grad_()
        acc = F.conv2d(xf.permute(0, 3, 1, 2), wf.t().reshape(C, 1, 3, 3), bf, padding=1,
                       groups=C).permute(0, 2, 3, 1)
        leaves = (xf, wf) if bf is None else (xf, wf, bf)
        grads = torch.autograd.grad(F.silu(acc), leaves, du)
    return grads[0], grads[1], grads[2] if bf is not None else None


def dwconv3_silu_bwd_cuda(du, x, w9, bias=None):
    require_cuda(du, x, w9, bias)
    B, H, W, C = x.shape
    require(x, (B, H, W, C), name="x")
    require(du, (B, H, W, C), torch.float32, name="du")
    require(w9, (9, C), torch.float32, name="w9")
    if bias is not None:
        require(bias, (C,), torch.float32, name="bias")
    dacc = torch.empty(B, H, W, C, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(dacc)
    dw9 = torch.zeros(9, C, dtype=torch.float32, device=x.device)
    db = torch.zeros(C, dtype=torch.float32, device=x.device)
    lib = build.library()
    dwconv3_silu_bwd_cuda.launches += 1
    build.check(lib.xfm_dwconv3_silu_bwd(ptr(du), ptr(x), ptr(w9), ptr(bias), ptr(dacc),
                                         ptr(dx), ptr(dw9), ptr(db), B, H, W, C,
                                         dtype_code(x), stream(x)), "dwconv3_silu_bwd")
    return dx, dw9, db if bias is not None else None


dwconv3_silu_bwd_cuda.launches = 0
