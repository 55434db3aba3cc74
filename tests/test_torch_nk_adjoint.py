"""Kernel 7's plain twin (``ops/nk_scan_adjoint.py::
nk_scan_bwd_segments_plain``: the phases of ``csrc/nk_scan_adjoint.cu``,
segment checkpoints, segment recompute, channel-tile partial sums, the
fixed-order finish) against the serial plain adjoint ``nk_scan_bwd_plain``,
against ``jax.vjp`` of the JAX composable scan and (``slow``) against the
JAX Pallas kernel in interpret mode; and the kernel's plan.

Inputs are numpy arrays from fixed seeds handed to both sides.  Float32
agrees to summation order (1e-5 of each output's largest magnitude against
the serial plain version, 2e-4 against JAX, as the earlier kernel-7 tests
hold it); in bfloat16 both sides compute in float32 from the same rounded
inputs and only ddts, returned in bfloat16, rounds (1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.ops import nk_scan_adjoint as jax_adjoint
from xfmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from xfmamba_tpu_torch.ops import nk_scan, nk_scan_adjoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
OUTPUTS = ("du", "ddts", "dBs", "dCs", "dA", "dDvec", "dbias")


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _case(seed, B, H, W, D, K, N):
    """(u, dts, Bs, Cs, A (K*N, D), Dvec, bias, gy) at the port's contract,
    numpy float32."""
    rng = np.random.default_rng(seed)
    L = H * W
    return (rng.standard_normal((B, L, D), np.float32),
            0.3 * rng.standard_normal((B, L, K * D), np.float32),
            rng.standard_normal((B, L, K * N), np.float32),
            rng.standard_normal((B, L, K * N), np.float32),
            -np.exp(0.5 * rng.standard_normal((K * N, D), np.float32)),
            rng.standard_normal((K, D), np.float32),
            0.1 * rng.standard_normal((K, D), np.float32),
            rng.standard_normal((B, L, D), np.float32))


def _kinds(K):
    return nk_scan.scan_mode_kinds("cross2d") if K == 4 else ("row_f",)


def _port(case, dtype):
    """The case as torch tensors, activations in ``dtype``."""
    u, dts, Bs, Cs, A, Dvec, bias, gy = map(T, case)
    return (u.to(dtype), dts.to(dtype), Bs.to(dtype), Cs.to(dtype), A, Dvec, bias, gy)


GEOMETRIES = [(2, 7, 7, 12, 1, 16), (3, 7, 7, 10, 4, 16), (2, 5, 7, 12, 4, 4),
              (2, 5, 7, 9, 1, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,D,K,N", GEOMETRIES)
def test_kernel7_twin_matches_the_serial_plain(B, H, W, D, K, N, dtype):
    """The twin against the serial plain adjoint (every state kept): square
    and ragged (5 x 7) maps, K 1 and 4, N 4 and 16, every output."""
    args = (*_port(_case(B + K + N, B, H, W, D, K, N), dtype), H, W, _kinds(K))
    got = nk_scan_adjoint.nk_scan_bwd_segments_plain(*args)
    want = nk_scan_adjoint.nk_scan_bwd_plain(*args)
    for name, a, w in zip(OUTPUTS, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        tol = 1e-2 if name == "ddts" and dtype == torch.bfloat16 else 1e-5
        assert _rel(a, w.float()) <= tol, name


def _jax_grads(case, H, W, K, N):
    """jax.vjp of the composable scan (cross2d for K 4, unidi for K 1),
    mapped to the port's contract."""
    u, dts, Bs, Cs, A, Dvec, bias, gy = case
    B, L, D = u.shape
    projs = (u.reshape(B, H, W, D), dts.reshape(B, H, W, K, D), Bs.reshape(B, H, W, K, N),
             Cs.reshape(B, H, W, K, N), A.reshape(K, N, D).transpose(0, 2, 1), Dvec, bias)
    mode = "cross2d" if K == 4 else "unidi"
    _, vjp = jax.vjp(lambda *a: jax_core(*a, scan_mode=mode, scan_impl=jax_scan),
                     *map(jnp.asarray, projs))
    g = [np.asarray(x) for x in vjp(jnp.asarray(gy.reshape(B, H, W, D)))]
    return (g[0].reshape(B, L, D), g[1].reshape(B, L, K * D), g[2].reshape(B, L, K * N),
            g[3].reshape(B, L, K * N), g[4].transpose(0, 2, 1).reshape(K * N, D), g[5], g[6])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,D,K,N", GEOMETRIES)
def test_kernel7_twin_matches_jax_vjp(B, H, W, D, K, N, dtype):
    """The twin against jax.vjp of ``ss2d_core_from_projs`` on the same
    (rounded, in bfloat16) inputs."""
    case = _case(10 + B + K + N, B, H, W, D, K, N)
    port = _port(case, dtype)
    rounded = [t.float().numpy() for t in port]
    want = _jax_grads(rounded, H, W, K, N)
    got = nk_scan_adjoint.nk_scan_bwd_segments_plain(*port, H, W, _kinds(K))
    for name, a, w in zip(OUTPUTS, got, want):
        tol = 1e-2 if name == "ddts" and dtype == torch.bfloat16 else 2e-4
        assert _rel(a, w) <= tol, name


def test_kernel7_wrapper_takes_the_twin_on_the_cpu():
    case = _port(_case(3, 2, 5, 7, 12, 4, 4), torch.float32)
    args = (*case, 5, 7, _kinds(4))
    before = nk_scan_adjoint.nk_scan_bwd.launches
    for a, b in zip(nk_scan_adjoint.nk_scan_bwd(*args),
                    nk_scan_adjoint.nk_scan_bwd_segments_plain(*args)):
        assert torch.equal(a, b)
    assert nk_scan_adjoint.nk_scan_bwd.launches == before


@pytest.mark.slow
@pytest.mark.parametrize("K,N", [(4, 4), (1, 16)])
def test_kernel7_twin_matches_the_pallas_kernel(K, N):
    """Against ``nk_scan_bwd_call(..., interpret=True)`` (the TPU kernel in
    interpret mode) on a 6 x 8 map, one image per group; float32, 2e-4."""
    H, W = 6, 8
    case = _case(20 + K, 2, H, W, 8, K, N)
    u, dts, Bs, Cs, A, Dvec, bias, gy = case
    want = jax_adjoint.nk_scan_bwd_call(*map(jnp.asarray, case[:7]), jnp.asarray(gy), H, W,
                                        _kinds(K), group=1, interpret=True)
    got = nk_scan_adjoint.nk_scan_bwd_segments_plain(*_port(case, torch.float32), H, W,
                                                     _kinds(K))
    for name, a, w in zip(OUTPUTS, got, want):
        w = np.asarray(w, np.float32)
        a = a[:1] if name == "dDvec" else a      # the Pallas kernel returns one row
        assert _rel(a, w.reshape(a.shape)) <= 2e-4, name


@pytest.mark.parametrize("H,W,N,D,want", [
    (7, 7, 16, 1536, dict(clen=7, n_ck=7, warps=8, ctiles=24)),
    (5, 7, 4, 96, dict(clen=6, n_ck=6, warps=8, ctiles=2)),
    (40, 40, 16, 16, dict(clen=40, n_ck=40, warps=4, ctiles=1)),
    (1, 1, 1, 3, dict(clen=1, n_ck=1, warps=8, ctiles=1)),
])
def test_kernel7_plan(H, W, N, D, want):
    """Segments of about sqrt(L) positions, the most warps (up to 8) whose
    shared arrays fit the card's 227 KB, channel tiles of 8 per warp."""
    plan = nk_scan_adjoint.adjoint_plan(H, W, N, D)
    assert {k: getattr(plan, k) for k in want} == want
    assert plan.smem <= nk_scan_adjoint.SMEM_LIMIT
    assert plan.clen * plan.n_ck >= H * W > plan.clen * (plan.n_ck - 1)


def test_kernel7_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        nk_scan_adjoint.adjoint_plan(200, 200, 16, 8)
