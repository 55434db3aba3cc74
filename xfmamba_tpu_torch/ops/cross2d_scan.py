"""The cross2d scans of the bfloat16 backbone's VSSBlock sequence: the
d_state-1 rank-form scan of the four directions and its adjoint, run on the
chunked kernels of ``csrc/ss2d_core_n1.cu`` (kernels 11 and 12's design).

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

`stage_chunk` picks the chunk length from L and the number of chains, down
to one chunk where the chains alone fill the card.  Each wrapper takes its
plain twin (the same chunked walks, ``ops/ss2d_core_n1.py``) only for CPU
tensors; on CUDA tensors it launches the kernel, adds one to ``launches``
and to ``by_chunks[n_chunks]``, or raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.ops.nk_scan import (
    CROSS2D_KINDS, selective_scan_bwd_cuda, selective_scan_bwd_plain, selective_scan_cuda,
    selective_scan_plain)
from xfmamba_tpu_torch.ops.primitives import dtype_code, on_cpu, require, require_cuda
from xfmamba_tpu_torch.ops.ss2d_core_n1 import (
    CHANNELS, MAX_CHUNKS, MAX_RANK, MIN_CHUNK, N1Layout, n1_adjoint_plain, n1_bwd_launch,
    n1_fwd_launch, ss2d_core_n1_fwd_plain)

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
    require_cuda(u, xdbl, A, bias, Dsum, w_dt)
    n, L, D, R = _check(u, xdbl, A, bias, Dsum, w_dt, H, W)
    chunk = stage_chunk(n, L, D)
    nc = -(-L // chunk)
    cross2d_scan.launches += 1
    cross2d_scan.by_chunks[nc] = cross2d_scan.by_chunks.get(nc, 0) + 1
    y, ck = n1_fwd_launch(*_maps(u, xdbl, H, W), w_dt, A.reshape(4, D).contiguous(), _dk(Dsum),
                          bias, chunk, nc, stage_layout(R), checkpoints)
    return y.view(n, L, D), ck


cross2d_scan.launches = 0
cross2d_scan.by_chunks = {}


# ---------------------------------------------------------------------------
# the adjoint
# ---------------------------------------------------------------------------

def _bwd_result(r, n, L, D, dtype):
    return dict(du=r["du"].view(n, L, D), dz=r["dpre"].view(n, L, 4, D).to(dtype),
                dA=r["dA"].view(4, 1, D), dbias=r["dbias"], dDsum=r["dD"][0])


@torch.no_grad()
def cross2d_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """Adjoint of `cross2d_scan` given gy = dL/dy (n, L, D) float32 and the
    forward's checkpoints.  Returns du (n, L, D) float32; dz (n, L, 4, D) in
    u's dtype, the gradient of the deltas before bias and softplus; dA
    (4, 1, D), dbias (4, D), dDsum (D,) float32; adds dB and dC into their
    columns of dxdbl (n * L, 4R + 8) float32."""
    n, L, D = u.shape
    R = w_dt.shape[1]
    r = n1_adjoint_plain(*_maps(u, xdbl, H, W), w_dt.float(), A.reshape(4, D).float(),
                         _dk(Dsum.float()), bias.float(), ck, gy.reshape(n, H, W, D).float(),
                         stage_chunk(n, L, D), stage_layout(R), dxdbl)
    return _bwd_result(r, n, L, D, u.dtype)


def cross2d_scan_bwd(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """The adjoint kernel; see `cross2d_scan_bwd_plain`."""
    if on_cpu(u, xdbl, A, bias, Dsum, w_dt, gy, ck, dxdbl):
        return cross2d_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl)
    require_cuda(u, xdbl, A, bias, Dsum, w_dt, gy, ck, dxdbl)
    n, L, D, R = _check(u, xdbl, A, bias, Dsum, w_dt, H, W)
    chunk = stage_chunk(n, L, D)
    nc = -(-L // chunk)
    require(gy, (n, L, D), torch.float32, name="gy")
    require(ck, (n, 4, nc, D), torch.float32, name="ck")
    require(dxdbl, (n * L, 4 * R + 8), torch.float32, name="dxdbl")
    cross2d_scan_bwd.launches += 1
    cross2d_scan_bwd.by_chunks[nc] = cross2d_scan_bwd.by_chunks.get(nc, 0) + 1
    x, xd = _maps(u, xdbl, H, W)
    r = n1_bwd_launch(x, xd, w_dt, A.reshape(4, D).contiguous(), _dk(Dsum), bias, ck,
                      gy.view(n, H, W, D), chunk, nc, stage_layout(R),
                      dxdbl.view(n, H, W, 4 * R + 8), u.dtype)
    return _bwd_result(r, n, L, D, u.dtype)


cross2d_scan_bwd.launches = 0
cross2d_scan_bwd.by_chunks = {}


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


def _serial_bwd(fn, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, dxdbl):
    n, L, _ = u.shape
    R = w_dt.shape[1]
    dbc = dxdbl[:, 4 * R:].view(n, L, 4, 2)
    s = fn(**_serial_operands(u, xdbl, A, bias, Dsum, w_dt, H, W), gy=gy, dB=dbc[..., 0:1],
           dC=dbc[..., 1:2])
    return dict(du=s["du"], dz=s["dz"], dA=s["dA"], dbias=s["dbias"], dDsum=s["dDsum"])


def serial_scan_bwd_plain(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """`cross2d_scan_bwd_plain`'s contract from ``selective_scan_bwd_plain``
    (``ck`` unused)."""
    return _serial_bwd(selective_scan_bwd_plain, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, dxdbl)


def serial_scan_bwd(u, xdbl, A, bias, Dsum, w_dt, H, W, gy, ck, dxdbl):
    """The serial adjoint kernel of ``csrc/nk_scan_bwd.cu``."""
    return _serial_bwd(selective_scan_bwd_cuda, u, xdbl, A, bias, Dsum, w_dt, H, W, gy, dxdbl)
