"""The cross2d scans of the bfloat16 backbone's VSSBlock sequence: the
d_state-1 rank-form scan of the four directions and its adjoint, run on the
tile-parallel kernels of ``csrc/ss2d_core_n1.cu`` (kernels 11 and 12's
design).

They are the scans inside kernels 1 (``ops/vss_stage.py``), 4, 5 and 6
(``ops/vss_block_train.py``, ``ops/vss_stage_train.py``), the counterparts
of the scans in the TPU kernels ``vss_block_pallas_v2.py::
_vss_stage_kernel_v2`` (:542) and ``vss_block_v2_adjoint.py::
_vss_block_bwd_kernel`` (:128).  The operands are the block's own:

  u      (n, L, D) in the activation dtype (the conv + SiLU output)
  xdbl   (n, L, 4R + 8), rows [rank_0 .. rank_3 | B0 C0 .. B3 C3] (the
         x_proj output; `stage_layout`)
  A      (4, 1, D) = -exp(A_logs), bias (4, D), Dsum (D,), w_dt (4, R, D),
         all float32

and y (n, L, D) float32 = (y_0 + u Dsum + y_2) + (y_1 + y_3), each y_k =
C_k h_k: the kernels' merge with Dk = (Dsum, 0, 0, 0).  The serial scan of
``csrc/nk_scan.cu`` computes the same function with the merge u Dsum + y_0
+ y_1 + y_2 + y_3; `serial_scan` and `serial_scan_bwd` keep it (with the
SIMT GEMM, the serial sequence of ``ops.vss_stage.SERIAL_OPS``).

The adjoint also takes the block's rank products: it returns dw_dt (4, R,
D) = rank_k^T dz_k and adds d rank_k = dz_k w_dt[k]^T into the rank columns
of dxdbl, beside dB and dC, with dz (the deltas' gradient before bias and
softplus, rounded to u's dtype where the JAX kernel rounds it) kept on
chip.  The plain twin computes dz the readable way, returns it too, and
takes the products with plain GEMMs (`rank_grads`).

`stage_chunk` picks the checkpoints' chunk length from L and the number of
chains (the rule of the first design, whose threads walked the chunks);
the checkpoints' layout follows it.  The tile-parallel kernels' work does
not depend on it: their adjoint reads no checkpoint, and the forward
writes them for the plain twins and the first design (``ops/ss2d_core_n1.py``
says why they stay).  Each wrapper takes its plain twin
(``ops/ss2d_core_n1.py``) only for CPU tensors; on CUDA tensors it
launches the kernels, adds one to ``launches`` and to ``by_plan`` under
its tile plan (`ss2d_core_n1.TilePlan.key`), or raises.  `cross2d_scan_v1` /
`cross2d_scan_bwd_v1` run the first design (``csrc/ss2d_core_n1_v1.cu``,
with the rank products as 8 ``gemm_ab_cuda`` launches), for timing only.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.ops.nk_scan import (
    CROSS2D_KINDS, selective_scan_bwd_cuda, selective_scan_bwd_plain, selective_scan_cuda,
    selective_scan_plain)
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, gemm_ab_cuda, gemm_ab_plain, gemm_simt_cuda, on_cpu, require, require_cuda)
from xfmamba_tpu_torch.ops.ss2d_core_n1 import (
    CHANNELS, MAX_CHUNKS, MAX_RANK, MIN_CHUNK, N1Layout, count_plan, n1_adjoint_plain,
    n1_bwd_launch, n1_bwd_launch_v1, n1_fwd_launch, n1_fwd_launch_v1, ss2d_core_n1_fwd_plain,
    tile_plan)

# threads that fill the H100: 132 SMs x 2048 resident threads
FILL_THREADS = 132 * 2048


def stage_layout(R: int) -> N1Layout:
    """The block's projection rows: ranks of direction k at k R, then the
    (B, C) pairs from 4R."""
    return N1Layout(4 * R + 8, R, 4 * R, 2)


def stage_chunk(n: int, L: int, D: int) -> int:
    """Chunk length of the stage scan for n images of L positions x D
    channels: enough chunks per chain that the n x D chains (one thread per
    chain and chunk, 32 channels a block) fill `FILL_THREADS`, at most
    `MAX_CHUNKS`, each at least `MIN_CHUNK` positions long (but never fewer
    than one chunk)."""
    chains = n * -(-D // CHANNELS) * CHANNELS
    chunks = max(1, min(MAX_CHUNKS, -(-FILL_THREADS // chains), -(-L // MIN_CHUNK)))
    return -(-L // chunks)


def n_chunks(n: int, L: int, D: int) -> int:
    return -(-L // stage_chunk(n, L, D))


def _dk(Dsum):
    """Dk (4, D) of the kernels' merge: the skip on direction 0 only."""
    dk = torch.zeros(4, Dsum.shape[0], dtype=torch.float32, device=Dsum.device)
    dk[0] = Dsum
    return dk


def _maps(u, xdbl, H, W):
    n, L, D = u.shape
    return u.view(n, H, W, D), xdbl.view(n, H, W, xdbl.shape[-1])


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def cross2d_scan_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints=False):
    """Returns (y (n, L, D) float32, ck (n, 4, n_chunks, D) float32 or None)."""
    n, L, D = u.shape
    R = w_dt.shape[1]
    y, ck = ss2d_core_n1_fwd_plain(*_maps(u, xdbl, H, W), w_dt.float(), A.reshape(4, D).float(),
                                   _dk(Dsum.float()), bias.float(), stage_chunk(n, L, D),
                                   stage_layout(R))
    return y.view(n, L, D), ck if checkpoints else None


def _check(u, xdbl, A, bias, Dsum, w_dt, H, W):
    n, L, D = u.shape
    R = w_dt.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"dt rank {R} outside 1..{MAX_RANK}")
    require(u, (n, L, D), name="u")
    require(xdbl, (n, L, 4 * R + 8), u.dtype, name="xdbl")
    require(A, (4, 1, D), torch.float32, name="A", contiguous=False)
    require(bias, (4, D), torch.float32, name="bias")
    require(Dsum, (D,), torch.float32, name="Dsum")
    require(w_dt, (4, R, D), torch.float32, name="w_dt")
    dtype_code(u)
    return n, L, D, R


def cross2d_scan(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints=False):
    """The four directions' scan and merge; see the module docstring."""
    if on_cpu(u, xdbl, A, bias, Dsum, w_dt):
        return cross2d_scan_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints)
    out = _scan(n1_fwd_launch, cross2d_scan, u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints)
    count_plan(cross2d_scan, tile_plan(u.shape[0], H, W, u.shape[2]))
    return out


def cross2d_scan_v1(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints=False):
    """`cross2d_scan` on the first design's kernel (CUDA tensors only)."""
    return _scan(n1_fwd_launch_v1, cross2d_scan_v1, u, xdbl, A, bias, Dsum, w_dt, H, W,
                 checkpoints)


def _scan(launch, counted, u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints):
    require_cuda(u, xdbl, A, bias, Dsum, w_dt)
    n, L, D, R = _check(u, xdbl, A, bias, Dsum, w_dt, H, W)
    chunk = stage_chunk(n, L, D)
    nc = -(-L // chunk)
    counted.launches += 1
    y, ck = launch(*_maps(u, xdbl, H, W), w_dt, A.reshape(4, D).contiguous(), _dk(Dsum), bias,
                   chunk, nc, stage_layout(R), checkpoints)
    return y.view(n, L, D), ck


cross2d_scan.launches = 0
cross2d_scan.by_plan = {}
cross2d_scan_v1.launches = 0


# ---------------------------------------------------------------------------
# the adjoint
# ---------------------------------------------------------------------------

def rank_grads(dz, xdbl, w_dt, dxdbl, gemm_ab):
    """The adjoint's rank products as GEMMs: d rank_k = dz_k w_dt[k]^T into
    the rank columns of dxdbl (M, 4R + 8) float32, and dw_dt[k] = rank_k^T
    dz_k (4, R, D) float32 returned; dz (M, 4, D) and w_dt rounded to the
    activation dtype (xdbl's), as the JAX kernel takes them."""
    M = dxdbl.shape[0]
    R, D = w_dt.shape[1:]
    dz = dz.reshape(M, 4, D)
    ranks = xdbl.reshape(M, 4 * R + 8)
    w = w_dt.to(xdbl.dtype)
    dw_dt = torch.empty(4, R, D, dtype=torch.float32, device=dz.device)
    for k in range(4):
        gemm_ab(dz[:, k], w[k], out=dxdbl[:, k * R:(k + 1) * R])
        dw_dt[k] = gemm_ab(ranks[:, k * R:(k + 1) * R].t(), dz[:, k].t(), out_dtype=torch.float32)
    return dw_dt


def _bwd_result(r, n, L, D):
    return dict(du=r["du"].view(n, L, D), dw_dt=r["dw_dt"], dA=r["dA"].view(4, 1, D),
                dbias=r["dbias"], dDsum=r["dD"][0])


@torch.no_grad()
def cross2d_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """Adjoint of `cross2d_scan` given gy = dL/dy (n, L, D) float32 and the
    forward's checkpoints.  Returns du (n, L, D) float32; dz (n, L, 4, D) in
    u's dtype, the gradient of the deltas before bias and softplus; dw_dt
    (4, R, D), dA (4, 1, D), dbias (4, D), dDsum (D,) float32; adds d rank,
    dB and dC into their columns of dxdbl (n * L, 4R + 8) float32.  The
    kernel returns the same but dz, which it keeps on chip."""
    n, L, D = u.shape
    R = w_dt.shape[1]
    r = n1_adjoint_plain(*_maps(u, xdbl, H, W), w_dt.float(), A.reshape(4, D).float(),
                         _dk(Dsum.float()), bias.float(), ck, gy.reshape(n, H, W, D).float(),
                         stage_chunk(n, L, D), stage_layout(R), dxdbl)
    dz = r["dpre"].view(n, L, 4, D).to(u.dtype)
    r["dw_dt"] = rank_grads(dz, xdbl, w_dt, dxdbl, gemm_ab_plain)
    return _bwd_result(r, n, L, D) | {"dz": dz}


def cross2d_scan_bwd(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """The adjoint kernels, the rank products inside; see
    `cross2d_scan_bwd_plain` (no dz).  ``ck`` is checked, not read."""
    if on_cpu(u, xdbl, A, bias, Dsum, w_dt, gy, ck, dxdbl):
        return cross2d_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl)
    n, L, D, R, nc = _check_bwd(cross2d_scan_bwd, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck,
                                dxdbl)
    count_plan(cross2d_scan_bwd, tile_plan(n, H, W, D), backward=True)
    r = n1_bwd_launch(*_maps(u, xdbl, H, W), w_dt, A.reshape(4, D).contiguous(), _dk(Dsum), bias,
                      gy.view(n, H, W, D), stage_chunk(n, L, D), stage_layout(R),
                      dxdbl.view(n, H, W, 4 * R + 8))
    return _bwd_result(r, n, L, D)


def cross2d_scan_bwd_v1(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """`cross2d_scan_bwd` on the first design (CUDA tensors only): its
    adjoint kernel from the checkpoints, dz in device memory, then the rank
    products as `rank_grads` on ``gemm_ab_cuda`` (8 launches)."""
    n, L, D, R, nc = _check_bwd(cross2d_scan_bwd_v1, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck,
                                dxdbl)
    x, xd = _maps(u, xdbl, H, W)
    r = n1_bwd_launch_v1(x, xd, w_dt, A.reshape(4, D).contiguous(), _dk(Dsum), bias, ck,
                         gy.view(n, H, W, D), stage_chunk(n, L, D), nc, stage_layout(R),
                         dxdbl.view(n, H, W, 4 * R + 8), u.dtype)
    r["dw_dt"] = rank_grads(r["dpre"], xdbl, w_dt, dxdbl, gemm_ab_cuda)
    return _bwd_result(r, n, L, D)


def _check_bwd(counted, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    require_cuda(u, xdbl, A, bias, Dsum, w_dt, gy, ck, dxdbl)
    n, L, D, R = _check(u, xdbl, A, bias, Dsum, w_dt, H, W)
    nc = -(-L // stage_chunk(n, L, D))
    require(gy, (n, L, D), torch.float32, name="gy")
    require(ck, (n, 4, nc, D), torch.float32, name="ck")
    require(dxdbl, (n * L, 4 * R + 8), torch.float32, name="dxdbl")
    counted.launches += 1
    return n, L, D, R, nc


cross2d_scan_bwd.launches = 0
cross2d_scan_bwd.by_plan = {}
cross2d_scan_bwd_v1.launches = 0


# ---------------------------------------------------------------------------
# the serial scan of csrc/nk_scan.cu on the same operands (the serial route)
# ---------------------------------------------------------------------------

def _serial_operands(u, xdbl, A, bias, Dsum, w_dt, H, W):
    R = w_dt.shape[1]
    bc = xdbl[..., 4 * R:].unflatten(-1, (4, 2))
    return dict(u=u, Bs=bc[..., 0:1], Cs=bc[..., 1:2], A=A, bias=bias, Dsum=Dsum,
                kinds=CROSS2D_KINDS, H=H, W=W, w_dt=w_dt,
                ranks=xdbl[..., :4 * R].unflatten(-1, (4, R)))


def serial_scan_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints=False):
    """`cross2d_scan`'s function walked serially over L with the merge
    u Dsum + y_0 + y_1 + y_2 + y_3 (``selective_scan_plain``); no
    checkpoints."""
    return selective_scan_plain(**_serial_operands(u, xdbl, A, bias, Dsum, w_dt, H, W)), None


def serial_scan(u, xdbl, A, bias, Dsum, w_dt, H, W, checkpoints=False):
    """The serial kernel of ``csrc/nk_scan.cu`` (``selective_scan_cuda``)."""
    return selective_scan_cuda(**_serial_operands(u, xdbl, A, bias, Dsum, w_dt, H, W)), None


def _serial_bwd(fn, gemm_ab, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, dxdbl):
    n, L, _ = u.shape
    R = w_dt.shape[1]
    dbc = dxdbl[:, 4 * R:].view(n, L, 4, 2)
    s = fn(**_serial_operands(u, xdbl, A, bias, Dsum, w_dt, H, W), gy=gy, dB=dbc[..., 0:1],
           dC=dbc[..., 1:2])
    return dict(du=s["du"], dz=s["dz"], dw_dt=rank_grads(s["dz"], xdbl, w_dt, dxdbl, gemm_ab),
                dA=s["dA"], dbias=s["dbias"], dDsum=s["dDsum"])


def serial_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """`cross2d_scan_bwd_plain`'s contract from ``selective_scan_bwd_plain``
    and plain GEMMs (``ck`` unused)."""
    return _serial_bwd(selective_scan_bwd_plain, gemm_ab_plain, u, xdbl, A, bias, Dsum, w_dt, H,
                       W, gy, dxdbl)


def serial_scan_bwd(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """The serial adjoint kernel of ``csrc/nk_scan_bwd.cu``, then the rank
    products on the SIMT GEMM (the serial sequence's)."""
    return _serial_bwd(selective_scan_bwd_cuda, gemm_simt_cuda, u, xdbl, A, bias, Dsum, w_dt, H,
                       W, gy, dxdbl)
