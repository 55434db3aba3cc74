"""The superseded fusion ops and the two-view sequence helpers of
``models/fusion.py`` in the port against the JAX package on the CPU:
`CrossSS2Dv2` and `CrossSS2Dv3` (output, input and parameter gradients
against ``jax.vjp``; d_state 4 through the nk pair's or the grouped scan's
plain twins, d_state 1 through kernel 10's), `concat_scan` /
`concat_merge`, and `swapping_scan_adjoint`'s gradient (the true adjoint,
which swaps back, unlike `swapping_scan`'s straight-through one).  Inputs
from numpy seeds; float32, tolerance 1e-4 of each output's largest
magnitude (the scans sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.models import fusion as jfusion
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.models import fusion as pfusion
from xfmamba_tpu_torch.models import ss2d as pss2d
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_train_supported
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _rel(got, want):
    got = torch.as_tensor(np.array(got)).double()
    want = torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


# (op, d_state, batch, H, W): d_state 4 on 7 x 7 maps at a batch of 2 (the
# grouped scan: the routing rule finds no nk group) and on 6 x 8 maps at 8
# (the nk pair), d_state 1 (kernel 10)
CASES = [("CrossSS2Dv2", 4, 2, 7, 7), ("CrossSS2Dv2", 1, 2, 6, 8), ("CrossSS2Dv3", 4, 8, 6, 8),
         ("CrossSS2Dv3", 1, 2, 7, 7)]


@pytest.mark.parametrize("name,d_state,batch,H,W", CASES)
def test_cross_ss2d_variants_match_jax(monkeypatch, name, d_state, batch, H, W):
    """Output, both inputs' gradients and every parameter gradient, and the
    scan route `core_dispatch` takes (counted by route)."""
    jmodel = getattr(jfusion, name)(d_model=16, d_state=d_state)
    rng = np.random.default_rng(d_state + batch)
    x, x2 = (rng.standard_normal((batch, H, W, 16)).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal((batch, H, W, 16)).astype(np.float32)
    variables = jax_variables(jmodel, d_state, jnp.asarray(x), jnp.asarray(x2))
    y_ref, vjp = jax.vjp(lambda v, a, b: jmodel.apply({"params": v}, a, b),
                         variables["params"], jnp.asarray(x), jnp.asarray(x2))
    dparams, dx, dx2 = vjp(jnp.asarray(gy))
    port = getattr(pfusion, name)(16, d_state=d_state).train()
    load_jax_variables(port, variables)
    routes = []
    for fn in ("ss2d_core_fused", "nk_scan_train_from_projs", "ss2d_core_from_projs"):
        real = getattr(pss2d, fn)
        monkeypatch.setattr(pss2d, fn, lambda *a, _r=real, _n=fn, **k: routes.append(_n)
                            or _r(*a, **k))
    xt, x2t = T(x).requires_grad_(), T(x2).requires_grad_()
    y = port(xt, x2t)
    forward_routes = list(routes)  # kernel 10's backward recomputes through the composable core
    y.backward(T(gy))
    group = nk_train_supported(batch, H * W, W, 32, 4, d_state, "cross2d")
    assert (group is None) == (H == 7)
    want = {1: "ss2d_core_fused"}.get(d_state, "nk_scan_train_from_projs" if group
                                      else "ss2d_core_from_projs")
    assert forward_routes == [want] * (2 if name == "CrossSS2Dv2" else 3)
    assert _rel(y.detach(), y_ref) <= 1e-4
    assert _rel(xt.grad, dx) <= 1e-4 and _rel(x2t.grad, dx2) <= 1e-4
    params = dict(port.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(port).items():
        assert _rel(params[key].grad, to_port(np.asarray(_leaf({"params": dparams}, jpath)))) \
            <= 1e-4, key


def test_cross_ss2d_dropout_and_eval():
    """Dropout after out_proj: eval equals the JAX deterministic output of
    a layer with dropout; in training the mask comes from the port's
    generator (the same seed, the same output; the global generator
    untouched)."""
    jmodel = jfusion.CrossSS2Dv3(d_model=16, d_state=4, dropout=0.25)
    rng = np.random.default_rng(3)
    x, x2 = (rng.standard_normal((2, 4, 4, 16)).astype(np.float32) for _ in range(2))
    variables = jax_variables(jmodel, 3, jnp.asarray(x), jnp.asarray(x2))
    y_ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x2))

    def port(seed):
        m = pfusion.CrossSS2Dv3(16, d_state=4, dropout=0.25,
                                dropout_generator=torch.Generator().manual_seed(seed))
        load_jax_variables(m, variables)
        return m

    with torch.no_grad():
        assert _rel(port(0).eval()(T(x), T(x2)), y_ref) <= 1e-4
        m1, m2 = port(5).train(), port(5).train()
        state = torch.random.get_rng_state()
        a, b = m1(T(x), T(x2)), m2(T(x), T(x2))
        assert torch.equal(torch.random.get_rng_state(), state)
        assert torch.equal(a, b)
        full = port(0).eval()(T(x), T(x2))
        dropped = a == 0
        assert 0 < dropped.float().mean() < 1
        torch.testing.assert_close(a[~dropped], full[~dropped] / 0.75, rtol=1e-5, atol=1e-6)


def test_concat_scan_and_merge_match_jax():
    rng = np.random.default_rng(4)
    x, x2 = (rng.standard_normal((2, 3, 5, 6)).astype(np.float32) for _ in range(2))
    seq, rev = pfusion.concat_scan(T(x), T(x2))
    jseq, jrev = jfusion.concat_scan(jnp.asarray(x), jnp.asarray(x2))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    y1, y2 = (rng.standard_normal((2, 30, 6)).astype(np.float32) for _ in range(2))
    got = pfusion.concat_merge(T(y1), T(y2), 3, 5)
    want = jfusion.concat_merge(jnp.asarray(y1), jnp.asarray(y2), 3, 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_swapping_scan_adjoint_gradient_swaps_back():
    """Forward as `swapping_scan`; the gradient is the swap's adjoint (the
    JAX function under ``jax.vjp``), where `swapping_scan` passes the
    gradients through un-swapped."""
    rng = np.random.default_rng(5)
    x, x2, g1, g2 = (rng.standard_normal((2, 3, 3, 6)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(jfusion.swapping_scan_adjoint, jnp.asarray(x), jnp.asarray(x2))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt, x2t = T(x).requires_grad_(), T(x2).requires_grad_()
    got = pfusion.swapping_scan_adjoint(xt, x2t)
    for a, b in zip(got, out):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    torch.autograd.backward(got, (T(g1), T(g2)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(x2t.grad.numpy(), np.asarray(want[1]))
    even = np.arange(6) % 2 == 0
    np.testing.assert_array_equal(xt.grad.numpy(), np.where(even, g2, g1))
    xs, x2s = T(x).requires_grad_(), T(x2).requires_grad_()
    torch.autograd.backward(pfusion.swapping_scan(xs, x2s), (T(g1), T(g2)))
    np.testing.assert_array_equal(xs.grad.numpy(), g1)
