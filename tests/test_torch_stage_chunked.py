"""The bfloat16 backbone's redesigned pieces on the CPU (plain twins): the
chunked cross2d scan and its adjoint (``ops/cross2d_scan.py``) against the
serial plain scans, the VSSBlock built on them against the JAX package,
and the route functions of the GEMM and of the chunk count.

Inputs are numpy arrays from fixed seeds.  The maps are tiny, with a
ragged last chunk; the dt ranks are the backbone's smallest, 6 (d 96) and
12 (d 192); the chunk counts both one and several (`FILL_THREADS` set low
forces one chunk).  Tolerances are for float32 with other summation
orders: the chunked walk composes each chunk's products, the serial walk
steps once per position, and the merges add the four directions in other
orders.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import _blocks, assert_close
from test_torch_train_ops import _jax_grads_at_port, _jax_packed
from xfmamba_tpu.ops.vss_block_pallas import vss_block_ref as jax_vss_block_ref
from xfmamba_tpu_torch.ops import cross2d_scan as cs
from xfmamba_tpu_torch.ops import primitives, ss2d_core_n1
from xfmamba_tpu_torch.ops.vss_block import (
    PLAIN_OPS, SS2D_FIELDS, pack_vss_block_train_params, vss_block_ref)
from xfmamba_tpu_torch.ops.vss_block_train import vss_block_bwd_body, vss_block_bwd_plain
from xfmamba_tpu_torch.ops.vss_stage import vss_stage_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _scan_operands(seed, n, H, W, R, D=24):
    """u (n, L, D), the projection rows (n, L, 4R + 8), A (4, 1, D), bias,
    Dsum, w_dt, as the block's x_proj output hands them to the scan."""
    rng = np.random.default_rng(seed)
    L = H * W
    f = (lambda *s, scale=1.0: T((scale * rng.standard_normal(s)).astype(np.float32)))
    return (f(n, L, D), f(n, L, 4 * R + 8), -torch.exp(f(4, 1, D, scale=0.5)),
            f(4, D, scale=0.5) - 1.0, f(D), f(4, R, D, scale=R ** -0.5), H, W)


@pytest.fixture(params=["several", "one"])
def chunks(request, monkeypatch):
    """The chunk count: the rule's own (several at these sizes), or one
    (the chains alone fill the card)."""
    if request.param == "one":
        monkeypatch.setattr(cs, "FILL_THREADS", 1)
    return request.param


@pytest.mark.parametrize("H,W,R", [(5, 9, 6), (6, 6, 12), (3, 11, 6)])
def test_chunked_scan_matches_serial_plain(chunks, H, W, R):
    """y of the chunked plain scan against the serial plain scan
    (``selective_scan_plain``), and its checkpoints: the state entering
    each chunk is the serial walk's state at the chunk's edge."""
    args = _scan_operands(1, 2, H, W, R)
    n, L, D = args[0].shape
    nc = cs.n_chunks(n, L, D)
    assert (nc == 1) == (chunks == "one") and (nc == 1 or L % cs.stage_chunk(n, L, D))
    y, ck = cs.cross2d_scan(*args, checkpoints=True)
    want, none = cs.serial_scan_plain(*args)
    assert none is None and y.dtype == torch.float32
    assert_close(y, want, 2e-5)
    assert ck.shape == (n, 4, nc, D)
    assert not ck[:, 0, 0].any()                   # the row_f chain enters chunk 0 at zero
    if nc > 1:
        assert ck[:, 0, 1].abs().max() > 0


@pytest.mark.parametrize("H,W,R", [(5, 9, 6), (6, 6, 12)])
def test_chunked_adjoint_matches_serial_plain(chunks, H, W, R):
    """Every output of the chunked plain adjoint against the serial plain
    adjoint (``selective_scan_bwd_plain``): du, dz, dw_dt, dA, dbias, dDsum
    and the projections' gradient, the rank columns (dz w_dt^T, from the
    same plain GEMMs on both sides) as well as dB and dC."""
    args = _scan_operands(2, 2, H, W, R)
    n, L, D = args[0].shape
    gy = T(np.random.default_rng(3).standard_normal((n, L, D)).astype(np.float32))
    _, ck = cs.cross2d_scan(*args, checkpoints=True)
    dx = torch.zeros(n * L, 4 * R + 8)
    dx_s = torch.zeros_like(dx)
    got = cs.cross2d_scan_bwd(*args, gy, ck, dx)
    want = cs.serial_scan_bwd_plain(*args, gy, None, dx_s)
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name].reshape(want[name].shape), want[name], 2e-4)
    assert_close(dx, dx_s, 2e-4)
    assert dx[:, :4 * R].abs().max() > 0 and dx[:, 4 * R:].abs().max() > 0


def test_chunked_scan_bfloat16_rounds_dz_only():
    """In bfloat16 the scan reads bfloat16 u and projections and computes
    in float32: y float32, dz in bfloat16, the rest float32."""
    args = _scan_operands(4, 2, 4, 6, 6)
    bf = [a.to(torch.bfloat16) if i < 2 else a for i, a in enumerate(args)]
    y, ck = cs.cross2d_scan(*bf, checkpoints=True)
    assert y.dtype == torch.float32
    gy = torch.ones_like(y)
    r = cs.cross2d_scan_bwd(*bf, gy, ck, torch.zeros(48, 32))
    assert r["dz"].dtype == torch.bfloat16 and r["du"].dtype == torch.float32
    want = cs.cross2d_scan_bwd(*[a.float() if i < 2 else a for i, a in enumerate(bf)], gy, ck,
                               torch.zeros(48, 32))
    assert_close(r["dz"].float(), want["dz"].to(torch.bfloat16).float(), 1e-6)


def test_stage_chunk_rule():
    """Chunks from L and the chains: 16 where few chains walk long maps,
    fewer as the chains fill the card, one where they fill it alone; never
    more than ceil(L / 8)."""
    assert cs.n_chunks(64, 3136, 192) == 16         # bs-32 stage 0: 12,288 chains
    assert cs.n_chunks(64, 196, 768) == 6           # stage 2: 49,152 chains
    assert cs.n_chunks(64, 49, 1536) == 3           # stage 3: 98,304 chains
    assert cs.n_chunks(32, 49, 1536) == 6           # the bs-16 step's stage 3
    assert cs.n_chunks(512, 49, 1536) == 1          # 786,432 chains fill the card
    assert cs.n_chunks(1, 20, 32) == 3              # short maps: chunks of >= 8
    for n, L, D in ((1, 1, 32), (3, 3127, 100), (200, 784, 384)):
        chunk = cs.stage_chunk(n, L, D)
        assert 1 <= -(-L // chunk) <= ss2d_core_n1.MAX_CHUNKS and chunk <= L


def test_cache_rule_matches_the_kernel_budget():
    """The shared-memory cache holds where the chunk's values fit: the
    bs-32 forward's stages 2 and 3, not stages 0 and 1."""
    for (n, L, D, R), fits in (((64, 3136, 192, 6), False), ((64, 784, 384, 12), False),
                               ((64, 196, 768, 24), True), ((64, 49, 1536, 48), True)):
        chunk = cs.stage_chunk(n, L, D)
        assert ss2d_core_n1.use_cache(R, chunk, -(-L // chunk), False) == fits


# ---------------------------------------------------------------------------
# the block and stage on the chunked scans, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,H,W", [(96, 5, 7), (192, 4, 5)])
def test_block_on_chunked_scan_matches_jax_ref(d, H, W):
    """`vss_block_ref` (the plain twins, the chunked scan) against the JAX
    ``vss_block_ref`` at dt ranks 6 and 12, a ragged last chunk; float32."""
    B = 2
    _, params, ports = _blocks(False, depth=1, d=d, H=H, W=W, seed=21)
    x = np.random.default_rng(22).standard_normal((B, H * W, d)).astype(np.float32)
    want = jax.jit(jax_vss_block_ref, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x), params[0], H, W, False, True)
    from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params
    p = pack_vss_block_params(ports[0], torch.float32)
    assert p.rank == -(-d // 16)
    assert_close(vss_block_ref(T(x), p, H, W), want, 1e-4)
    assert_close(vss_stage_plain(T(x), [p], H, W), want, 1e-4)


def test_block_backward_on_chunked_adjoint_matches_jax_vjp():
    """Kernel 6's plain twin (the chunked adjoint from the recompute's
    checkpoints) at dt rank 12 with a drop-path mask against jax.vjp of
    the JAX ``vss_block_ref``; float32, 3e-4."""
    B, H, W, d = 3, 4, 5, 192
    _, params, ports = _blocks(True, depth=1, d=d, H=H, W=W, seed=23)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((B, H * W, d)).astype(np.float32)
    g = rng.standard_normal((B, H * W, d)).astype(np.float32)
    m1 = np.array([1 / 0.7, 0.0, 1 / 0.7], np.float32)
    m1_j = jnp.broadcast_to(jnp.asarray(m1)[:, None, None], (B, H * W, 1))
    f = jax.jit(lambda xx, pp: jax_vss_block_ref(xx, pp, H, W, True, False, m1=m1_j))
    _, vjp = jax.vjp(f, jnp.asarray(x), params[0])
    dx_ref, dp_ref = vjp(jnp.asarray(g))
    blk = ports[0]
    p = pack_vss_block_train_params(blk, torch.float32)
    dx, grads = vss_block_bwd_plain(T(x), p, H, W, T(m1), T(g))
    torch.autograd.backward([getattr(p, n) for n in SS2D_FIELDS], [grads[n] for n in SS2D_FIELDS])
    assert_close(dx, dx_ref, 3e-4)
    for key, w in _jax_grads_at_port(blk, dp_ref, skip=("norm2", "mlp")).items():
        assert_close(blk.get_parameter(key).grad, w, 3e-4)


def test_block_backward_matches_pallas_adjoint_interpret_rank6():
    """Kernel 6's plain twin at dt rank 6 (d 96) against the TPU kernel
    ``vss_block_bwd_call`` in interpret mode: dx and the packed-operand
    gradients; float32, 3e-4."""
    from xfmamba_tpu.ops.vss_block_v2_adjoint import vss_block_bwd_call
    B, H, W, d = 2, 4, 4, 96
    _, params, ports = _blocks(False, depth=1, d=d, H=H, W=W, seed=25)
    rng = np.random.default_rng(26)
    x = rng.standard_normal((B, H * W, d)).astype(np.float32)
    g = rng.standard_normal((B, H * W, d)).astype(np.float32)
    m1 = np.array([1 / 0.7, 1 / 0.7], np.float32)
    mask = jnp.broadcast_to(jnp.asarray(m1)[:, None, None], (B, H * W, 1))
    jp = _jax_packed(params[0], False, False)
    outs = vss_block_bwd_call(jnp.asarray(x), *jp, mask, jnp.ones_like(mask), jnp.asarray(g),
                              H=H, W=W, conv_bias=False, fuse_mlp=False, group=2,
                              interpret=True)
    with torch.no_grad():
        p = pack_vss_block_train_params(ports[0], torch.float32)
        dx, grads = vss_block_bwd_plain(T(x), p, H, W, T(m1), T(g))
    assert_close(dx, outs[0], 3e-4)
    di, R = p.w_in.shape[0], p.rank
    d_w_xp, d_w_dt, d_b_dt, d_A, d_Dsum = outs[5:10]
    for got, want in ((grads["w_xp"].t(), d_w_xp), (grads["w_dt"].reshape(4 * R, di), d_w_dt),
                      (grads["b_dt"], d_b_dt), (grads["A"].reshape(4, di), d_A),
                      (grads["Dsum"][None], d_Dsum)):
        assert_close(got, want, 3e-4)


# ---------------------------------------------------------------------------
# the GEMM route
# ---------------------------------------------------------------------------

def _recorded_gemms(d, dtype, H=2, W=2, n=1):
    """(a, b, epilogue) of every GEMM of a block's forward (with its MLP) and
    of its backward, as the block hands them to ``ops.gemm_ab``, recorded
    on the CPU around the plain twins."""
    seen = []

    def gemm_ab(a, b, bias=None, residual=None, gelu=False, scale=None, out_dtype=None,
                out=None):
        seen.append((a, b, bias is not None or residual is not None or gelu or scale is not None))
        return primitives.gemm_ab_plain(a, b, bias, residual, gelu, scale, out_dtype, out)

    ops = SimpleNamespace(**vars(PLAIN_OPS))
    ops.gemm_ab = gemm_ab
    ops.gemm = lambda a, w, bias=None, residual=None, gelu=False, scale=None: gemm_ab(
        a, w, bias, residual, gelu, scale)
    _, _, ports = _blocks(True, depth=1, d=d, H=H, W=W, seed=27)
    with torch.no_grad():
        p = pack_vss_block_train_params(ports[0], dtype)
        x = torch.randn(n, H * W, d).to(dtype)
        from xfmamba_tpu_torch.ops.vss_block import vss_block_body
        vss_block_body(x, p, H, W, ops)
        vss_block_bwd_body(x, p, H, W, None, torch.randn(n, H * W, d), ops)
    return seen


@pytest.mark.parametrize("d", [96, 192, 384, 768, 128, 256, 512, 1024])
def test_every_bf16_block_gemm_takes_the_tensor_cores(d):
    """At XFMamba-S's (96-768) and XFMamba-B's (128-1024) widths, each of a
    bfloat16 block's 5 forward and 9 backward GEMMs maps to the
    tensor-core kernel; in float32 each maps to the SIMT kernel.  (The 8
    rank-gradient products are the adjoint scan's own.)"""
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        gemms = _recorded_gemms(d, dtype)
        assert len(gemms) == 5 + 9
        for a, b, epilogue in gemms:
            plan = primitives.gemm_plan(a.shape[0], b.shape[0], primitives._major(a),
                                        primitives._major(b), a.dtype, epilogue)
            assert plan["route"] == route, (tuple(a.shape), tuple(b.shape), a.stride(), b.stride())
            if route == "tc":
                assert plan["bn"] in (16, 32, 64, 128)
                assert not (plan["swap"] and epilogue)


def test_gemm_plan_tiles_and_swaps():
    """The tile width follows N (the rank gradients' N = R take the
    16-wide tile), a weight gradient with a short M computes out^T, and
    an operand with no unit stride stays on the SIMT kernel."""
    bf = torch.bfloat16
    assert [primitives.tc_tile_n(n) for n in (6, 12, 32, 56, 96, 192, 384, 200, 3072)] == \
        [16, 16, 32, 64, 64, 64, 128, 64, 128]
    assert primitives.gemm_plan(6, 192, "mn", "mn", bf, False) == \
        dict(route="tc", swap=True, bn=16)
    assert primitives.gemm_plan(6, 192, "mn", "mn", bf, True)["swap"] is False
    assert primitives.gemm_plan(100352, 6, "k", "k", bf, False) == \
        dict(route="tc", swap=False, bn=16)
    assert primitives.gemm_plan(64, 64, None, "k", bf, False) == dict(route="simt")
    a = torch.zeros(10, 4, 8, dtype=bf)[:, 1]                 # (10, 8), unit stride on K
    assert primitives._major(a) == "k" and primitives._major(a.t()) == "mn"
    assert primitives._major(torch.zeros(8, 8, 8)[:, :, 0]) is None
