"""Kernel 10 (the cross2d core from projections, ``ops/fused_cross_scan.py``)
and the N = 1 route of ``core_dispatch`` on the CPU against the JAX package:
the plain twin against the XLA core and, under ``slow``, the Pallas kernel
in interpret mode; the autograd op against ``jax.vjp``; which modes take
the route; a d_state-1 Cross_SS2Dv5 training forward and backward.

Inputs are numpy arrays from a seed; float32 unless a test says otherwise,
so tolerances cover summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.models.fusion import CrossSS2Dv5 as JaxCross
from xfmamba_tpu.models.ss2d import ss2d_core as jax_ss2d_core
from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.models import ss2d
from xfmamba_tpu_torch.models.fusion import CrossSS2Dv5
from xfmamba_tpu_torch.ops import fused_cross_scan as fcs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _projs(seed, B=2, H=5, W=7, D=6, N=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, D), np.float32),
            (0.5 * rng.standard_normal((B, H, W, 4, D))).astype(np.float32),
            rng.standard_normal((B, H, W, 4, N), np.float32),
            rng.standard_normal((B, H, W, 4, N), np.float32),
            -np.exp(0.3 * rng.standard_normal((4, D, N))).astype(np.float32),
            rng.standard_normal((4, D), np.float32),
            (0.1 * rng.standard_normal((4, D))).astype(np.float32))


@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("H,W", [(5, 7), (1, 6), (8, 8)])
def test_plain_matches_the_xla_core(N, H, W):
    """y within 1e-5 of JAX ``ss2d_core_from_projs`` (cross2d)."""
    args = _projs(N + H, H=H, W=W, N=N)
    want = jax.jit(jax_core)(*map(jnp.asarray, args))
    got = fcs.fused_cross_scan(*map(T, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_bfloat16_rounds_each_direction_once():
    """N = 1 in bfloat16: each direction's C h + D u is rounded to bfloat16
    (the Pallas kernel's output dtype) before the float32 merge; N > 1 keeps
    the directions in float32."""
    for N in (1, 4):
        args = [T(a) for a in _projs(30 + N, N=N)]
        args[:4] = [a.bfloat16() for a in args[:4]]
        got = fcs.fused_cross_scan(*args)
        exact = fcs.fused_cross_scan(*[a.float() for a in args])
        diff = float((got - exact).abs().max())
        assert (diff > 0) == (N == 1) and diff <= 2 ** -7 * 4 * float(exact.abs().max())


@pytest.mark.parametrize("N", [1, 4])
def test_autograd_matches_jax_vjp(N):
    """`ss2d_core_fused` (kernel 10 forward, the backward recomputed through
    ``ss2d_core_from_projs``) under autograd: y within 1e-5 and every input
    gradient within 1e-4 of ``jax.vjp`` of the XLA core."""
    args = _projs(40 + N, N=N)
    gy = np.random.default_rng(N).standard_normal(args[0].shape).astype(np.float32)
    y_ref, vjp = jax.vjp(jax.jit(jax_core), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    leaves = [T(a).requires_grad_() for a in args]
    y = fcs.ss2d_core_fused(*leaves)
    y.backward(T(gy))
    assert _rel(y, y_ref) <= 1e-5
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_core_dispatch_n1_route(monkeypatch, scan_mode):
    """At d_state 1, cross2d takes kernel 10; unidi and bidi keep the
    nk/grouped rule (JAX's Pallas backend would compute the cross2d core
    for them).  Output and gradients against JAX ``ss2d_core(...,
    backend="xla")`` from the same parameters (1e-5 / 1e-4)."""
    calls = []
    fused = ss2d.ss2d_core_fused
    monkeypatch.setattr(ss2d, "ss2d_core_fused", lambda *a: calls.append(1) or fused(*a))
    rng = np.random.default_rng(7)
    B, H, W, D, R = 2, 4, 6, 8, 3
    x = rng.standard_normal((B, H, W, D)).astype(np.float32)
    xw = (rng.standard_normal((4, R + 2, D)) / np.sqrt(D)).astype(np.float32)
    dtw = (rng.standard_normal((4, D, R)) / np.sqrt(R)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((4, D))).astype(np.float32)
    A_logs = (0.3 * rng.standard_normal((4 * D, 1))).astype(np.float32)
    Ds = rng.standard_normal(4 * D).astype(np.float32)
    gy = rng.standard_normal((B, H, W, D)).astype(np.float32)
    params = (x, xw, dtw, bias, A_logs, Ds)
    y_ref, vjp = jax.vjp(jax.jit(lambda *a: jax_ss2d_core(
        *a, d_state=1, scan_mode=scan_mode, backend="xla")), *map(jnp.asarray, params))
    want = vjp(jnp.asarray(gy))
    leaves = [T(p).requires_grad_() for p in params]
    xt, xwt, dtwt, biast, A_logst, Dst = leaves
    dts, Bs, Cs = ss2d._project_kdirs(xt, xwt, dtwt, R, 1)
    y = ss2d.core_dispatch(xt, dts, Bs, Cs, -torch.exp(A_logst).reshape(4, D, 1),
                           Dst.reshape(4, D), biast, scan_mode)
    y.backward(T(gy))
    assert len(calls) == (scan_mode == "cross2d")
    assert _rel(y, y_ref) <= 1e-5
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4


def test_cross_ss2dv5_d_state1_training_matches_jax(monkeypatch):
    """A Cross_SS2Dv5 layer with d_state 1 in training mode, the model-level
    way to the route (``core_dispatch`` -> kernel 10): output and every
    parameter and input gradient against ``jax.vjp`` of the JAX layer in
    training mode (1e-5 / 1e-4)."""
    calls = []
    fused = ss2d.ss2d_core_fused
    monkeypatch.setattr(ss2d, "ss2d_core_fused", lambda *a: calls.append(1) or fused(*a))
    jmodel = JaxCross(d_model=16, d_state=1)
    rng = np.random.default_rng(8)
    x, x2, gy = (rng.standard_normal((2, 5, 6, 16)).astype(np.float32) for _ in range(3))
    variables = jax_variables(jmodel, 8, jnp.zeros((1, 5, 6, 16)), jnp.zeros((1, 5, 6, 16)))
    y_ref, vjp = jax.vjp(jax.jit(lambda v, a, b: jmodel.apply(
        {"params": v}, a, b, deterministic=False)), variables["params"], jnp.asarray(x),
        jnp.asarray(x2))
    dparams, dx, dx2 = vjp(jnp.asarray(gy))
    port = CrossSS2Dv5(16, d_state=1).train()
    load_jax_variables(port, variables)
    xt, x2t = T(x).requires_grad_(), T(x2).requires_grad_()
    y = port(xt, x2t)
    y.backward(T(gy))
    assert calls == [1]
    assert _rel(y, y_ref) <= 1e-5 and _rel(xt.grad, dx) <= 1e-4 and _rel(x2t.grad, dx2) <= 1e-4
    params = dict(port.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(port).items():
        leaf = {"params": dparams}
        for name in jpath:
            leaf = leaf[name]
        assert _rel(params[key].grad, to_port(np.asarray(leaf))) <= 1e-4, key


@pytest.mark.slow
@pytest.mark.parametrize("N,chunk", [(1, 8), (4, 8), (1, None)])
def test_plain_matches_the_pallas_kernel(N, chunk):
    """Against ``_core_pallas_fwd_impl(..., interpret=True)`` (the fused
    Pallas kernel and its float32 merge), L 35 in chunks of 8 (the last
    ragged) or the kernel's own chunk: float32 within 1e-5, and bfloat16
    inputs (N = 1: each direction rounded to bfloat16) within 1e-2 of the
    largest output (the two round the same values, summed in other orders)."""
    from xfmamba_tpu.ops.selective_scan_pallas import _core_pallas_fwd_impl
    args = _projs(50 + N, H=5, W=7, N=N)
    want = _core_pallas_fwd_impl(*map(jnp.asarray, args), interpret=True, chunk=chunk)
    assert _rel(fcs.fused_cross_scan(*map(T, args)), want) <= 1e-5
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:4]] + list(map(jnp.asarray, args[4:]))
    want = _core_pallas_fwd_impl(*jargs, interpret=True, chunk=chunk)
    targs = [T(a).bfloat16() for a in args[:4]] + list(map(T, args[4:]))
    assert _rel(fcs.fused_cross_scan(*targs), want) <= 1e-2
