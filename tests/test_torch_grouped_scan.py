"""Kernels 13 and 14 (the grouped selective scan and its adjoint) and the
routing of the fusion scans, on the CPU against the JAX package.

The plain twins of ``ops/selective_scan_grouped.py`` (what the CUDA
wrappers take for CPU tensors) against JAX ``ops.selective_scan`` and its
``jax.vjp``, against the Pallas kernels in interpret mode (checkpoints
included), the port's routing rule against JAX's, and
``models.ss2d.core_dispatch`` on both of its routes against JAX
``ss2d_core_from_projs``.  Inputs are numpy arrays from a seed; float32
throughout, so tolerances cover summation order only.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.ops import nk_scan_adjoint as jax_nka
from xfmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from xfmamba_tpu_torch.models import ss2d
from xfmamba_tpu_torch.ops import nk_scan_adjoint as nka
from xfmamba_tpu_torch.ops import selective_scan_grouped as ssg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
CHUNK = 4           # several chunks at the tests' lengths


def _operands(rng, B, L, K, C, N):
    """u, delta, A (K * C, N), B, C (B, L, K, N), D, bias as float32 numpy."""
    KC = K * C
    return (rng.standard_normal((B, L, KC)).astype(np.float32),
            (0.5 * rng.standard_normal((B, L, KC))).astype(np.float32),
            -np.exp(0.3 * rng.standard_normal((KC, N))).astype(np.float32),
            rng.standard_normal((B, L, K, N)).astype(np.float32),
            rng.standard_normal((B, L, K, N)).astype(np.float32),
            rng.standard_normal(KC).astype(np.float32),
            (0.1 * rng.standard_normal(KC)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_forward_plain_matches_jax(K, N, reverse):
    """y at an exact (16) and a ragged (13) length, 1e-5 of its largest
    magnitude, with the checkpoints' shape."""
    rng = np.random.default_rng(K * 100 + N)
    for L in (16, 13):
        args = _operands(rng, 2, L, K, 3, N)
        want = jax.jit(jax_scan, static_argnames=("delta_softplus", "reverse"))(
            *map(jnp.asarray, args), delta_softplus=True, reverse=reverse)
        y, ck = ssg.grouped_scan_fwd(*map(T, args), reverse=reverse, chunk=CHUNK)
        assert y.dtype == torch.float32 and ck.shape == (2, K, -(-L // CHUNK), N, 3)
        assert _rel(y, want) <= 1e-5, L


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N", [1, 4, 16])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_backward_plain_matches_jax_vjp(K, N, reverse):
    """Every gradient (u, delta, A, B, C, D, bias) from the forward's own
    checkpoints, at a ragged length, within 1e-4 of its largest magnitude."""
    rng = np.random.default_rng(K * 100 + N + 7)
    L = 13
    args = _operands(rng, 2, L, K, 3, N)
    gy = rng.standard_normal((2, L, K * 3)).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda *a: jax_scan(*a, delta_softplus=True, reverse=reverse)),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    ta = list(map(T, args))
    _, ck = ssg.grouped_scan_fwd(*ta, reverse=reverse, chunk=CHUNK)
    got = ssg.grouped_scan_bwd(*ta, ck, T(gy), reverse=reverse, chunk=CHUNK)
    for name, w in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dbias"), want):
        assert got[name].shape == w.shape, name
        assert _rel(got[name], w) <= 1e-4, name


@pytest.mark.parametrize("reverse", [False, True])
def test_autograd_op_matches_jax_vjp(reverse):
    """`selective_scan_auto` through torch autograd (kernel 13 forward,
    kernel 14 backward, plain here), with D and bias absent as well."""
    rng = np.random.default_rng(3)
    args = _operands(rng, 2, 37, 2, 5, 4)      # two chunks of 32, the last of 5
    gy = rng.standard_normal((2, 37, 10)).astype(np.float32)
    for with_d in (True, False):
        a = args if with_d else args[:5] + (None, None)
        f = (lambda *x: jax_scan(*x, delta_softplus=True, reverse=reverse)) if with_d else \
            (lambda *x: jax_scan(*x, None, None, delta_softplus=True, reverse=reverse))
        y_ref, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, a[:7 if with_d else 5]))
        want = vjp(jnp.asarray(gy))
        leaves = [None if v is None else T(v).requires_grad_() for v in a]
        y = ssg.selective_scan_auto(*leaves, reverse=reverse)
        y.backward(T(gy))
        assert y.dtype == torch.float32 and _rel(y.detach(), y_ref) <= 1e-5
        for leaf, w in zip(leaves, want):
            assert _rel(leaf.grad, w) <= 1e-4


def test_limits():
    rng = np.random.default_rng(4)
    args = list(map(T, _operands(rng, 1, 5, 1, 2, 16)))
    big = list(args)
    big[2], big[3], big[4] = torch.zeros(2, 17), torch.zeros(1, 5, 1, 17), torch.zeros(1, 5, 1, 17)
    with pytest.raises(ValueError, match="d_state 17"):
        ssg.grouped_scan_fwd(*big)
    with pytest.raises(ValueError, match="chunk"):
        ssg.grouped_scan_fwd(*args, chunk=ssg.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="softplus"):
        ssg.selective_scan_auto(*args, delta_softplus=False)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_twins_match_the_pallas_kernels(reverse):
    """Kernel 13's y and checkpoints and kernel 14's gradients (from the
    same checkpoints) against ``grouped_scan_pallas_fwd``/``_bwd`` in
    interpret mode at one chunk length: three chunks of 8, the last of 4."""
    from xfmamba_tpu.ops.selective_scan_pallas import (
        grouped_scan_pallas_bwd, grouped_scan_pallas_fwd)
    rng = np.random.default_rng(5)
    B, L, K, C, N, chunk = 1, 20, 2, 8, 3, 8
    args = _operands(rng, B, L, K, C, N)
    gy = rng.standard_normal((B, L, K * C)).astype(np.float32)
    jargs = list(map(jnp.asarray, args))
    y_ref, carr = grouped_scan_pallas_fwd(*jargs, delta_softplus=True, reverse=reverse,
                                          interpret=True, chunk=chunk)
    y, ck = ssg.grouped_scan_fwd(*map(T, args), reverse=reverse, chunk=chunk)
    assert _rel(y, y_ref) <= 1e-5
    np.testing.assert_allclose(ck.numpy(), np.asarray(carr)[:, :, :, :N], rtol=1e-5, atol=1e-5)
    want = grouped_scan_pallas_bwd(*jargs, carr, jnp.asarray(gy), reverse=reverse,
                                   interpret=True, chunk=chunk)
    got = ssg.grouped_scan_bwd(*map(T, args), ck, T(gy), reverse=reverse, chunk=chunk)
    for name, w in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dbias"), want):
        assert _rel(got[name], w) <= 1e-4, name


# ---------------------------------------------------------------------------
# the routing rule and core_dispatch
# ---------------------------------------------------------------------------

# (B, L, W, D, K, N, group): the fusion scans of XFMamba-S (D 1536) and -B
# (D 2048) at batches 2, 12 and 16 per view; ShallowFuse is K=1 over B
# images, Cross_SS2Dv5 K=4 over 3B
MODEL_SHAPES = [
    (16, 49, 7, 1536, 1, 16, 8), (48, 49, 7, 1536, 4, 16, 8),
    (16, 49, 7, 2048, 1, 16, 8), (48, 49, 7, 2048, 4, 16, None),
    (12, 49, 7, 1536, 1, 16, None), (36, 49, 7, 1536, 4, 16, None),
    (12, 49, 7, 2048, 1, 16, None), (36, 49, 7, 2048, 4, 16, None),
    (2, 49, 7, 1536, 1, 16, None), (6, 49, 7, 2048, 4, 16, None),
]


def test_routing_rule_matches_jax():
    """The port's `pick_nk_train_group` and VMEM estimate equal JAX's on a
    grid of (B, L, W, D, K, N) and at the models' shapes; the port's
    `nk_train_supported` is JAX's rule without its CPU-backend test."""
    grid = itertools.product((1, 2, 3, 4, 6, 8, 12, 16, 24, 48, 96),
                             ((1, 1), (4, 2), (16, 4), (49, 7), (196, 14), (3136, 56)),
                             (96, 128, 192, 1536, 2048, 4096), (1, 2, 4), (4, 16))
    for B, (L, W), D, K, N in grid:
        assert nka.pick_nk_train_group(B, L, W, D, K, N) == \
            jax_nka.pick_nk_train_group(B, L, W, D, K, N), (B, L, W, D, K, N)
        assert nka.nk_bwd_vmem_estimate(L, D, K, N, 8) == \
            jax_nka.nk_bwd_vmem_estimate(L, D, K, N, 8)
    for B, L, W, D, K, N, group in MODEL_SHAPES:
        assert jax_nka.pick_nk_train_group(B, L, W, D, K, N) == group
        assert nka.nk_train_supported(B, L, W, D, K, N, "cross2d") == group
    assert nka.nk_train_supported(16, 49, 7, 1536, 4, 16, "cascade2d") is None


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
@pytest.mark.parametrize("B,route", [(2, "nk"), (3, "grouped")])
def test_core_dispatch_matches_jax(B, route, scan_mode):
    """`core_dispatch` at 4 x 4 maps: two images take the nk pair (group 2),
    three the grouped scan; output and every input gradient against JAX
    ``ss2d_core_from_projs`` (1e-5 / 1e-4 of the largest magnitude)."""
    H = W = 4
    D, K, N = 6, 4, 4
    assert (nka.nk_train_supported(B, H * W, W, D, K, N, scan_mode) is not None) == \
        (route == "nk")
    rng = np.random.default_rng(B)
    args = (rng.standard_normal((B, H, W, D)).astype(np.float32),
            (0.5 * rng.standard_normal((B, H, W, K, D))).astype(np.float32),
            rng.standard_normal((B, H, W, K, N)).astype(np.float32),
            rng.standard_normal((B, H, W, K, N)).astype(np.float32),
            -np.exp(0.3 * rng.standard_normal((K, D, N))).astype(np.float32),
            rng.standard_normal((K, D)).astype(np.float32),
            (0.1 * rng.standard_normal((K, D))).astype(np.float32))
    gy = rng.standard_normal((B, H, W, D)).astype(np.float32)
    y_ref, vjp = jax.vjp(jax.jit(lambda *a: jax_core(*a, scan_mode=scan_mode)),
                         *map(jnp.asarray, args))
    want = vjp(jnp.asarray(gy))
    leaves = [T(a).requires_grad_() for a in args]
    y = ss2d.core_dispatch(*leaves, scan_mode=scan_mode)
    y.backward(T(gy))
    assert _rel(y.detach(), y_ref) <= 1e-5
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4
