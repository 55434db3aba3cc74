"""The rest of ``ops/ssd.py`` and ``ops/layer_norm.py`` in the port against
the JAX package on the CPU: ``selective_state_update``, the gated norms,
``swiglu``, ``causal_conv1d``, ``mamba_split_conv1d_scan`` (its scan on
kernels 15/16's plain twins inside ``ssd_supported``, on the einsum form
with a dt limit), ``layer_norm_fn`` / ``rms_norm_fn`` (dropout from the
caller's generator, ``return_dropout_mask``) and ``layer_norm_linear_fn``.
Inputs from numpy seeds; float32, tolerance 1e-5 of each output's largest
magnitude for the elementwise ops and norms, 1e-4 through the chunked
scan (its sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.ops import layer_norm as jln
from xfmamba_tpu.ops import ssd as jssd
from xfmamba_tpu_torch import ops as port_ops
from xfmamba_tpu_torch.ops import layer_norm as pln
from xfmamba_tpu_torch.ops import ssd as pssd
from xfmamba_tpu_torch.ops import ssd_chunk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
f32 = np.float32


def _rel(got, want):
    got = torch.as_tensor(np.array(got)).double()
    want = torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("per_channel_A,gate", [(True, True), (False, False)])
def test_selective_state_update_matches_jax(per_channel_A, gate):
    rng = _rng(1)
    b, h, d, n = 2, 3, 8, 4
    state = rng.standard_normal((b, h, d, n)).astype(f32)
    x, dt = rng.standard_normal((b, h, d)).astype(f32), rng.standard_normal((b, h, d)).astype(f32)
    A = -np.exp(rng.standard_normal((h, d) if per_channel_A else (h, d, n))).astype(f32)
    B, C = rng.standard_normal((b, h, n)).astype(f32), rng.standard_normal((b, h, n)).astype(f32)
    D, bias = rng.standard_normal((h, d)).astype(f32), rng.standard_normal((h, d)).astype(f32)
    z = rng.standard_normal((b, h, d)).astype(f32) if gate else None
    args = (state, x, dt, A, B, C, D, z, bias)
    want = jssd.selective_state_update(*[None if a is None else jnp.asarray(a) for a in args],
                                       dt_softplus=True)
    got = pssd.selective_state_update(*[None if a is None else T(a) for a in args],
                                      dt_softplus=True)
    assert _rel(got[0], want[0]) < 1e-5 and _rel(got[1], want[1]) < 1e-5


@pytest.mark.parametrize("rms,before,group", [(False, True, None), (False, False, 4),
                                              (True, True, 8), (True, False, None)])
def test_gated_norms_match_jax(rms, before, group):
    rng = _rng(2)
    x, z = rng.standard_normal((2, 5, 16)).astype(f32), rng.standard_normal((2, 5, 16)).astype(f32)
    w, b = rng.standard_normal(16).astype(f32), rng.standard_normal(16).astype(f32)
    if rms:
        want = jssd.rmsnorm_gated(jnp.asarray(x), jnp.asarray(w), jnp.asarray(z),
                                  group_size=group, norm_before_gate=before)
        got = pssd.rmsnorm_gated(T(x), T(w), T(z), group_size=group, norm_before_gate=before)
    else:
        want = jssd.layernorm_gated(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(z), group_size=group, norm_before_gate=before)
        got = pssd.layernorm_gated(T(x), T(w), T(b), T(z), group_size=group,
                                   norm_before_gate=before)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("activation,bias", [("silu", True), (None, False)])
def test_swiglu_and_causal_conv1d_match_jax(activation, bias):
    rng = _rng(3)
    e, g = rng.standard_normal((2, 7, 6)).astype(f32), rng.standard_normal((2, 7, 6)).astype(f32)
    assert _rel(pssd.swiglu(T(e), T(g)), jssd.swiglu(jnp.asarray(e), jnp.asarray(g))) < 1e-6
    x, w = rng.standard_normal((2, 11, 6)).astype(f32), rng.standard_normal((6, 4)).astype(f32)
    bb = rng.standard_normal(6).astype(f32) if bias else None
    want = jssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if bb is None else jnp.asarray(bb), activation)
    got = pssd.causal_conv1d(T(x), T(w), None if bb is None else T(bb), activation)
    assert _rel(got, want) < 1e-5


# (d_nonssm, rmsnorm + out projection, dt limit, chunk): the gate on the
# kernels' y; the group RMSNorm and the projection; a dt limit (the
# einsum route)
SPLIT_CASES = [(4, False, False, 16), (0, True, False, 32), (2, True, True, 16)]


@pytest.mark.parametrize("d_nonssm,normed,limited,chunk", SPLIT_CASES)
def test_mamba_split_conv1d_scan_matches_jax(monkeypatch, d_nonssm, normed, limited, chunk):
    rng = _rng(4 + d_nonssm)
    b, s, nheads, headdim, ngroups, dstate, width = 2, 40, 4, 8, 2, 8, 4
    dim = nheads * headdim
    packed = 2 * d_nonssm + 2 * dim + 2 * ngroups * dstate + nheads
    zx = (0.5 * rng.standard_normal((b, s, packed))).astype(f32)
    cw = (0.3 * rng.standard_normal((dim + 2 * ngroups * dstate, width))).astype(f32)
    cb = (0.1 * rng.standard_normal(dim + 2 * ngroups * dstate)).astype(f32)
    dt_bias, A = (0.1 * rng.standard_normal(nheads)).astype(f32), \
        -np.exp(0.3 * rng.standard_normal(nheads)).astype(f32)
    D = rng.standard_normal(nheads).astype(f32)
    init = (0.3 * rng.standard_normal((b, nheads, headdim, dstate))).astype(f32)
    kw = dict(headdim=headdim, ngroups=ngroups, return_final_states=True)
    if normed:
        kw.update(rmsnorm_weight=rng.standard_normal(dim).astype(f32),
                  outproj_weight=(0.2 * rng.standard_normal((5, dim + d_nonssm))).astype(f32),
                  outproj_bias=rng.standard_normal(5).astype(f32))
    if limited:
        kw["dt_limit"] = (0.01, 2.0)
    arrays = [zx, cw, cb, dt_bias, A, D]
    calls = pssd.ssd_chunk_scan.calls
    heads_calls = []
    real = ssd_chunk.ssd_chunk_scan_heads
    monkeypatch.setattr(ssd_chunk, "ssd_chunk_scan_heads",
                        lambda *a, **k: heads_calls.append(1) or real(*a, **k))
    want = jssd.mamba_split_conv1d_scan(*map(jnp.asarray, arrays), chunk,
                                        initial_states=jnp.asarray(init),
                                        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                           for k, v in kw.items()})
    got = pssd.mamba_split_conv1d_scan(*map(T, arrays), chunk, initial_states=T(init),
                                       **{k: T(v) if isinstance(v, np.ndarray) else v
                                          for k, v in kw.items()})
    assert _rel(got[0], want[0]) < 1e-4 and _rel(got[1], want[1]) < 1e-4
    # the kernels' route inside the gate, the einsum form with a dt limit
    assert (len(heads_calls), pssd.ssd_chunk_scan.calls - calls) == \
        ((0, 1) if limited else (1, 0))


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("branch", ["plain", "parallel", "rowscale"])
def test_layer_norm_fn_matches_jax(rms, branch):
    """Every output of `layer_norm_fn` / `rms_norm_fn` without dropout:
    the second weight set, the prenorm residual stream in float32."""
    rng = _rng(5)
    x, res = (rng.standard_normal((3, 4, 16)).astype(f32) for _ in range(2))
    w, b, w1, b1 = (rng.standard_normal(16).astype(f32) for _ in range(4))
    kw = dict(residual=res, weight1=w1, bias1=b1, prenorm=True, residual_in_fp32=True)
    if branch == "parallel":
        kw["x1"] = rng.standard_normal((3, 4, 16)).astype(f32)
    if branch == "rowscale":
        kw["rowscale"] = rng.standard_normal((3, 4)).astype(f32)
    jfn, pfn = (jln.rms_norm_fn, pln.rms_norm_fn) if rms else (jln.layer_norm_fn,
                                                                pln.layer_norm_fn)
    want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    got = pfn(T(x), T(w), T(b), **{k: T(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    assert len(got) == len(want) == 3
    for g, wnt in zip(got, want):
        assert _rel(g, wnt) < 1e-5
    assert got[2].dtype == torch.float32


def test_layer_norm_fn_dropout_from_generator():
    """Dropout draws from the caller's generator (the same seed, the same
    masks; the global generator untouched), keeps JAX's
    ``return_dropout_mask`` contract, and equals JAX's function run
    without dropout on the inputs the masks leave."""
    rng = _rng(6)
    x, x1 = rng.standard_normal((4, 32)).astype(f32), rng.standard_normal((4, 32)).astype(f32)
    res, w, b = (rng.standard_normal(s).astype(f32) for s in ((4, 32), 32, 32))
    p = 0.25
    state = torch.random.get_rng_state()
    out, mask, mask1 = pln.layer_norm_fn(T(x), T(w), T(b), T(res), x1=T(x1), dropout_p=p,
                                         dropout_generator=torch.Generator().manual_seed(3),
                                         return_dropout_mask=True)
    assert torch.equal(torch.random.get_rng_state(), state)
    again = pln.layer_norm_fn(T(x), T(w), T(b), T(res), x1=T(x1), dropout_p=p,
                              dropout_generator=torch.Generator().manual_seed(3),
                              return_dropout_mask=True)
    assert torch.equal(out, again[0]) and torch.equal(mask, again[1])
    assert mask.dtype == torch.bool and 0 < mask.float().mean() < 1 and \
        not torch.equal(mask, mask1)
    kept = np.where(mask.numpy(), x / (1 - p), 0).astype(f32)
    kept1 = np.where(mask1.numpy(), x1 / (1 - p), 0).astype(f32)
    want = jln.layer_norm_fn(jnp.asarray(kept), jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(res), x1=jnp.asarray(kept1))
    assert _rel(out, want) < 1e-5
    with pytest.raises(ValueError, match="dropout_generator"):
        pln.layer_norm_fn(T(x), T(w), dropout_p=p)


@pytest.mark.parametrize("rms,prenorm", [(False, True), (True, False)])
def test_layer_norm_linear_fn_matches_jax(rms, prenorm):
    rng = _rng(7)
    x, res = rng.standard_normal((3, 16)).astype(f32), rng.standard_normal((3, 16)).astype(f32)
    nw, nb = rng.standard_normal(16).astype(f32), rng.standard_normal(16).astype(f32)
    lw, lb = rng.standard_normal((16, 8)).astype(f32), rng.standard_normal(8).astype(f32)
    want = jln.layer_norm_linear_fn(*map(jnp.asarray, (x, nw, nb, lw, lb, res)),
                                    prenorm=prenorm, is_rms_norm=rms)
    got = port_ops.layer_norm_linear_fn(*map(T, (x, nw, nb, lw, lb, res)), prenorm=prenorm,
                                        is_rms_norm=rms)
    for g, wnt in zip(got if prenorm else (got,), want if prenorm else (want,)):
        assert _rel(g, wnt) < 1e-5
    assert jax.default_backend() == "cpu"
