"""Kernels 11 and 12 (``xfmamba_tpu_torch/ops/ss2d_core_n1.py``) on the CPU,
through their plain twins, against the JAX package: the XLA core
(``ss2d_core(..., backend="xla")`` and ``jax.vjp`` of it) and the Pallas
kernels in interpret mode (``_core_fused_proj_parts`` and
``_core_fused_proj_bwd_impl``), at the sizes of ``tests/test_pallas_scan.py``.

Inputs are drawn with numpy and handed to both sides.  Tolerances are
those of the JAX package's own tests of these kernels: 2e-4 forward, 5e-4
backward (float32 sums in other orders: the chunk walks are sequential
here, Hillis-Steele trees on the TPU, associative scans in XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import ss2d_core as jax_ss2d_core
from xfmamba_tpu.ops.selective_scan_pallas import (
    _core_fused_proj_bwd_impl, _core_fused_proj_parts)
from xfmamba_tpu_torch.ops import ss2d_core_n1 as n1

T = torch.from_numpy
NAMES = ("dx", "d_x_proj_weight", "d_dt_projs_weight", "d_dt_projs_bias", "d_A_logs", "d_Ds")


def _inputs(seed, H, W, B=2, D=16, R=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return ([rng.standard_normal((B, H, W, D)).astype(f),
             (rng.standard_normal((4, R + 2, D)) * 0.1).astype(f),
             (rng.standard_normal((4, D, R)) * 0.1).astype(f),
             (rng.standard_normal((4, D)) * 0.1).astype(f),
             (rng.standard_normal((4 * D, 1)) * 0.2).astype(f),
             rng.standard_normal((4 * D,)).astype(f)],
            rng.standard_normal((B, H, W, D)).astype(f))


def _jax_core(*args):
    return jax_ss2d_core(*args, d_state=1, backend="xla")


def assert_close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize("chunk", [90, 32, 7, None])
def test_forward_matches_xla_core(chunk):
    """One chunk (90 = L), several with a ragged last one (32: 32/32/26;
    7: thirteen chunks, the last of 6), and the port's own pick."""
    args, _ = _inputs(7, 10, 9)
    want = jax.jit(_jax_core)(*map(jnp.asarray, args))
    y, (xdbl, ck) = n1.core_n1_parts(*map(T, args), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (2, 10, 9, 16)
    assert ck.shape == (2, 4, -(-90 // (chunk or n1.pick_chunk(90))), 16)
    assert_close(y, want, 2e-4)


@pytest.mark.parametrize("H,W,chunk", [(10, 9, 32), (12, 8, 32), (10, 9, 96)])
def test_checkpoints_match_pallas_interpret(H, W, chunk):
    """y and the state entering every chunk of each direction against the
    Pallas forward in interpret mode at the same chunk length (JAX ``cf``
    holds k0 | k1 and ``cr`` k2 | k3 in row 0 of each chunk's slot)."""
    args, _ = _inputs(11, H, W)
    D = args[0].shape[-1]
    want_y, (_, _, cf, cr) = _core_fused_proj_parts(*map(jnp.asarray, args), interpret=True,
                                                     chunk=chunk)
    y, (_, ck) = n1.core_n1_parts(*map(T, args), chunk=chunk)
    assert_close(y, want_y, 2e-4)
    cf, cr = np.asarray(cf)[:, :, 0], np.asarray(cr)[:, :, 0]
    for k, ref in enumerate((cf[..., :D], cf[..., D:], cr[..., :D], cr[..., D:])):
        assert ck.shape[2] == ref.shape[1]
        assert_close(ck[:, k], ref, 2e-4, f"direction {k}")


@pytest.mark.parametrize("H,W,chunk", [(10, 9, None), (12, 8, 32), (10, 9, 7)])
def test_backward_matches_jax_vjp(H, W, chunk):
    """The plain kernel 12 with its glue, and `SS2DCoreN1`'s autograd,
    against ``jax.vjp`` of the XLA core, all six gradients."""
    args, g = _inputs(11, H, W)
    _, vjp = jax.vjp(jax.jit(_jax_core), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    _, (xdbl, ck) = n1.core_n1_parts(*map(T, args), chunk=chunk)
    got = n1.core_n1_bwd(*map(T, args), xdbl, ck, T(g), chunk=chunk)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert_close(a, b, 5e-4, name)
    leaves = [T(a).requires_grad_() for a in args]
    n1.ss2d_core_n1(*leaves).backward(T(g))
    for name, leaf, b in zip(NAMES, leaves, want):
        assert_close(leaf.grad, b, 5e-4, f"autograd {name}")


@pytest.mark.parametrize("H,W,chunk", [(10, 9, None), (12, 8, 32)])
def test_backward_matches_pallas_interpret(H, W, chunk):
    """The same gradients against the Pallas backward in interpret mode,
    from the Pallas forward's residuals."""
    args, g = _inputs(11, H, W)
    jargs = list(map(jnp.asarray, args))
    _, (xd_f, xd_r, cf, cr) = _core_fused_proj_parts(*jargs, interpret=True, chunk=chunk)
    want = _core_fused_proj_bwd_impl(*jargs, xd_f, xd_r, cf, cr, jnp.asarray(g),
                                     interpret=True, chunk=chunk)
    _, (xdbl, ck) = n1.core_n1_parts(*map(T, args), chunk=chunk)
    got = n1.core_n1_bwd(*map(T, args), xdbl, ck, T(g), chunk=chunk)
    for name, a, b in zip(NAMES, got, want):
        assert_close(a, b, 5e-4, name)


def test_plain_twins_on_cpu_count_no_launch():
    """CPU tensors take the plain twins; only a kernel launch counts."""
    args, g = _inputs(3, 6, 5)
    before = (n1.ss2d_core_n1_fwd.launches, n1.ss2d_core_n1_bwd.launches)
    leaves = [T(a).requires_grad_() for a in args]
    n1.ss2d_core_n1(*leaves).backward(T(g))
    assert (n1.ss2d_core_n1_fwd.launches, n1.ss2d_core_n1_bwd.launches) == before
    assert all(torch.isfinite(leaf.grad).all() for leaf in leaves)


def test_chunk_choice_and_limits():
    """`pick_chunk` keeps at most 16 chunks of at least 8 positions at the
    XFMamba-S stage maps; more chunks than a kernel block holds raise."""
    for L, want in ((3136, 196), (784, 49), (196, 13), (49, 7), (90, 8)):
        assert n1.pick_chunk(L) == want
        assert -(-L // want) <= n1.MAX_CHUNKS
    args, _ = _inputs(3, 6, 5)
    with pytest.raises(ValueError, match="chunks"):
        n1.core_n1_parts(*map(T, args), chunk=1)


def test_bfloat16_inputs_round_once():
    """bfloat16 x: the projections and w_dt are rounded to bfloat16, the
    state and the output stay float32, equal to the float32 twin fed the
    rounded operands."""
    args, _ = _inputs(5, 6, 5)
    x = T(args[0]).bfloat16()
    xdbl, w_dt, A, Ds, bias = n1.pack_n1_inputs(x, *map(T, args[1:]))
    assert xdbl.dtype == torch.bfloat16 and w_dt.dtype == torch.float32
    y, ck = n1.ss2d_core_n1_fwd(x, xdbl, w_dt, A, Ds, bias)
    y32, ck32 = n1.ss2d_core_n1_fwd(x.float(), xdbl.float(), w_dt, A, Ds, bias)
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(ck, ck32)


def test_tile_plan_splits_the_maps():
    """The tiling of the tile-parallel kernels: tiles of at most 8 x 8 that
    split the stage maps evenly (56 -> 8, 28, 14 and 7 -> 7) and others as
    evenly as they can (9 -> 5 + 4); slabs of 32 channels; blocks per slab
    enough for `TARGET_BLOCKS`, never more than the (image, tile) items; NS
    the longer of the row and column chains' segment counts."""
    for H, TH, nt in ((56, 8, 7), (28, 7, 4), (14, 7, 2), (7, 7, 1), (9, 5, 2), (17, 6, 3),
                      (1, 1, 1)):
        p = n1.tile_plan(2, H, H, 32)
        assert (p.TH, p.TW, p.nth, p.ntw, p.n_slabs) == (TH, TH, nt, nt, 1)
    p = n1.tile_plan(32, 56, 56, 192)              # the float32 step's stage 0
    assert (p.n_slabs, p.P, p.NS) == (6, 132, 392)
    p = n1.tile_plan(32, 7, 7, 1536)               # its stage 3: 32 items a slab
    assert (p.n_slabs, p.P, p.NS) == (48, 17, 7)
    p = n1.tile_plan(1, 9, 17, 70)
    assert (p.TH, p.TW, p.nth, p.ntw, p.NS, p.n_slabs, p.P) == (5, 6, 2, 3, 34, 3, 6)
    assert n1.TARGET_BLOCKS == 2 * 3 * 132 and n1.SLAB == 32 and n1.TILE == 8


def test_tile_plan_fuses_the_small_maps():
    """The forward is one launch of clusters (an image's tiles) where a map
    has at most `FUSE_TILES` tiles: the 14 x 14 and 7 x 7 stages (2 x 2
    and one 7 x 7 tile), not 28 x 28 (16 tiles) or 56 x 56 (49); the route
    counter's key names the plan."""
    assert n1.FUSE_TILES == 8
    for H, fused in ((56, False), (28, False), (14, True), (7, True), (8, True), (16, True),
                     (17, False), (24, False)):
        assert n1.tile_plan(32, H, H, 768).fused == fused
    assert n1.tile_plan(16, 8, 64, 64).fused          # 1 x 8 tiles
    assert not n1.tile_plan(16, 9, 64, 64).fused      # 2 x 8
    assert not n1.tile_plan(65536 // 4 + 1, 14, 14, 32).fused   # more clusters than a grid row
    assert n1.tile_plan(2, 14, 14, 32).key() == "7x7 one launch"
    assert n1.tile_plan(2, 56, 56, 32).key() == "8x8 three launches"
    assert n1.tile_plan(2, 14, 14, 32).key(backward=True) == "7x7 four launches"

