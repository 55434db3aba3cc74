"""Tensor functions of the PyTorch port against their JAX counterparts
(CPU, float32).  Inputs are drawn with numpy from fixed seeds and handed to
both sides as arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.ops import fast_math as jax_fm
from xfmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from xfmamba_tpu.ops.selective_scan import selective_scan_seq as jax_scan_seq
from xfmamba_tpu_torch.models import layers
from xfmamba_tpu_torch.models.ss2d import (
    a_log_init, dt_proj_bias_init, ss2d_core_from_projs)
from xfmamba_tpu_torch.ops import fast_math, nk_scan, primitives
from xfmamba_tpu_torch.ops.selective_scan import selective_scan_seq
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def test_softplus_threshold_20():
    z = np.array([-30.0, -1.0, 0.0, 5.0, 19.99, 20.0, 20.01, 40.0], np.float32)
    got = fast_math.softplus(T(z)).numpy()
    np.testing.assert_array_equal(got[z > 20], z[z > 20])   # identity above 20
    np.testing.assert_allclose(got, np.asarray(jax_fm.softplus(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        got, torch.nn.functional.softplus(T(z), threshold=20).numpy(), rtol=1e-6)


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = layers.gelu(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x, approximate=False)),
                               rtol=1e-6, atol=1e-6)
    # the tanh form differs by ~1e-4 at |x| ~ 2: the test tells them apart
    assert np.abs(got - np.asarray(jax.nn.gelu(x, approximate=True))).max() > 1e-4


def _scan_inputs(seed, B=2, L=11, K=2, C=3, N=4):
    rng = np.random.default_rng(seed)
    KC = K * C
    return (rng.standard_normal((B, L, KC), np.float32),
            0.5 * rng.standard_normal((B, L, KC), np.float32),
            -np.exp(0.5 * rng.standard_normal((KC, N), np.float32)),
            rng.standard_normal((B, L, K, N), np.float32),
            rng.standard_normal((B, L, K, N), np.float32),
            rng.standard_normal((KC,), np.float32),
            0.1 * rng.standard_normal((KC,), np.float32))


def test_selective_scan_seq_matches_jax():
    args = _scan_inputs(0)
    want = np.asarray(jax_scan_seq(*map(jnp.asarray, args)))
    got = selective_scan_seq(*map(T, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_selective_scan_seq_reverse_matches_jax():
    args = _scan_inputs(1)
    want = np.asarray(jax_scan(*map(jnp.asarray, args), reverse=True))
    got = selective_scan_seq(*map(T, args), reverse=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["row_f", "row_r", "col_f", "col_r"])
def test_traversal_orders_are_flat_over_the_map(kind):
    H, W = 3, 5
    grid = np.arange(H * W).reshape(H, W)
    want = {"row_f": grid.reshape(-1), "row_r": grid.reshape(-1)[::-1],
            "col_f": grid.T.reshape(-1), "col_r": grid.T.reshape(-1)[::-1]}[kind]
    np.testing.assert_array_equal(nk_scan.traversal_order(kind, H, W).numpy(), want)


def test_scan_mode_kinds():
    assert nk_scan.scan_mode_kinds("cross2d") == ("row_f", "col_f", "row_r", "col_r")
    assert nk_scan.scan_mode_kinds("unidi", 2) == ("row_f", "row_f")
    assert nk_scan.scan_mode_kinds("bidi") == ("row_f", "row_f", "row_r", "row_r")
    with pytest.raises(ValueError):
        nk_scan.scan_mode_kinds("cascade2d")
    with pytest.raises(ValueError):
        nk_scan.traversal_order("diag", 2, 2)


def core_inputs(seed, B=2, H=4, W=5, D=6, K=4, N=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, D), np.float32),
            0.3 * rng.standard_normal((B, H, W, K, D), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            -np.exp(0.5 * rng.standard_normal((K, D, N), np.float32)),
            rng.standard_normal((K, D), np.float32),
            0.1 * rng.standard_normal((K, D), np.float32))


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_ss2d_core_from_projs_matches_jax(scan_mode):
    args = core_inputs(2)
    want = np.asarray(jax_core(*map(jnp.asarray, args), scan_mode=scan_mode))
    got = ss2d_core_from_projs(*map(T, args), scan_mode=scan_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_primitive_plain_versions():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 5), np.float32)
    w = rng.standard_normal((4, 5), np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    r = rng.standard_normal((7, 4), np.float32)
    h = a @ w.T + b
    want = np.asarray(jax.nn.gelu(h, approximate=False)) + r
    got = primitives.gemm_plain(T(a), T(w), T(b), T(r), gelu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    x = rng.standard_normal((2, 4, 5, 3), np.float32)
    w9 = rng.standard_normal((9, 3), np.float32)
    cb = rng.standard_normal(3).astype(np.float32)
    conv = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w9.reshape(3, 3, 1, 3)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=3) + cb
    got = primitives.dwconv3_silu_plain(T(x), T(w9), T(cb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.silu(conv)), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_mixed_and_cpu_devices():
    u = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):      # one operand elsewhere than the rest
        nk_scan.nk_scan(u, u, torch.zeros(1, 4, 1), torch.zeros(1, 4, 1),
                        torch.zeros(1, 3, device="meta"), torch.ones(1, 3),
                        torch.zeros(1, 3), 2, 2, ("row_f",))
    with pytest.raises(ValueError):      # a CUDA launcher never runs on the CPU
        primitives.layer_norm_cuda(u[0], torch.ones(3), torch.zeros(3), u.dtype)


def test_ss2d_initialisers():
    g = torch.Generator().manual_seed(0)
    bias = dt_proj_bias_init(torch.empty(4, 8), generator=g)
    dt = fast_math.softplus(bias)
    assert float(dt.min()) >= 1e-4 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
    a = a_log_init(torch.empty(6, 3))
    np.testing.assert_allclose(torch.exp(a).numpy(), np.tile([1.0, 2.0, 3.0], (6, 1)),
                               rtol=1e-6)
    w1 = layers.Dense(8, 4, init="trunc_normal", generator=torch.Generator().manual_seed(1))
    w2 = layers.Dense(8, 4, init="trunc_normal", generator=torch.Generator().manual_seed(1))
    assert torch.equal(w1.weight, w2.weight)
    assert float(w1.weight.detach().abs().max()) <= 0.04


def test_scan_operand_strides_ignore_size_one_axes():
    """The CUDA scan reads B/C/rank views of one (rows, C) buffer by
    strides; a 1x1 map (L = 1) or a single kind must not trip the check."""
    xdbl = torch.zeros(3, 1, 4 * 2 + 8)              # n=3 images, L=1, R=2
    bc = xdbl[..., 8:].unflatten(-1, (4, 2))
    assert nk_scan._row_strides(bc[..., 0:1], "Bs") == (16, 2, 1)
    assert nk_scan._row_strides(xdbl[..., :8].unflatten(-1, (4, 2)), "ranks") == (16, 2, 1)
    dts = torch.zeros(2, 6, 1, 5)
    assert nk_scan._row_strides(dts, "dts") == (5, 0, 1)
    with pytest.raises(ValueError):
        nk_scan._row_strides(torch.zeros(6, 2, 3, 4).transpose(0, 1), "Bs")
