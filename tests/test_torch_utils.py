"""The port's utilities (``utils/flops.py``, ``utils/saliency.py``,
``utils/profiling.py``) against the JAX package's, on ``tests/test_utils.py``'s
tiny model (hidden 128, d_state 4, depths 1/1/1/1, dims 16) with JAX's
weights carried across; and the fusion layers' route in eval mode with a
gradient.

- The analytic formulas and ``count_params`` equal JAX's.
- ``model_flops`` equals a count by hand of the tiny geometry (`hand_flops`:
  2 per multiply-add of every product and convolution, the scans' analytic
  terms), on every route the port has (the backbone's composable blocks and
  its stage kernels, both fusion-scan routes of eval mode) and for float32
  and bfloat16 views.  JAX's ``model_flops`` is XLA's cost analysis, which
  also counts elementwise work: their ratio is held in a band.  The
  scan and stage ops report their own costs (``ops/cost.py``), once for
  the outermost call, to the count open on their thread.
- Grad-CAM (features, gradients and CAMs) and the input saliency within
  1e-4 of JAX's in float32, at 64² (the stage-3 map 2 x 2); ``overlay``
  exact; ``do_bench``'s keys; ``trace`` writes a Chrome trace.
- The route: with the routing rules made to give the card's eval kernels
  a group (monkeypatched), an eval-mode forward under grad that reaches the
  fusion layers with a gradient calls only the differentiable scans
  (``nk_scan_train``, the grouped scan, ``core_dispatch``) and never
  ``nk_scan_x`` / ``nk_scan_v1``; without grad the eval kernels' routes
  stay.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.utils import flops as jflops
from xfmamba_tpu.utils import saliency as jsal
from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables
from xfmamba_tpu_torch.models import fusion, ss2d, vssm
from xfmamba_tpu_torch.ops import cost
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.utils import flops, profiling, saliency
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
TINY = dict(outputs=2, model_type="tiny", hidden_dim=128, d_state=4,
            backbone_overrides=dict(depths=(1, 1, 1, 1), dims=16))
# JAX's XLA cost analysis against the port's count at batch 1, 32²: 1.4592
# with JAX 0.9.0 on the CPU.  XLA adds to the same products the elementwise work
# (norms, activations, the scans' exponentials and the merge of their
# directions, the SE gate), about half as much again at this geometry, where
# the maps are small and the widths narrow; the band allows for other XLA
# versions' accounting
XLA_RATIO = (1.35, 1.6)


def test_formulas_match_jax():
    for args in [(2, 10, 8, 4), (1, 5, 3, 2), (3, 49, 1536, 16), (1, 3136, 192, 1)]:
        for with_D in (True, False):
            for with_Z in (True, False):
                assert flops.flops_selective_scan_fn(*args, with_D=with_D, with_Z=with_Z) == \
                    jflops.flops_selective_scan_fn(*args, with_D=with_D, with_Z=with_Z)
    for args in [(2, 3136, 8, 24, 64, 64), (1, 49, 4, 16, 1, 256), (3, 100, 2, 8, 16, 1)]:
        assert flops.flops_ssd_chunk_scan(*args) == jflops.flops_ssd_chunk_scan(*args)
    tree = {"a": np.zeros((2, 3)), "b": {"c": np.zeros((4,)), "d": [torch.zeros(5)]}}
    assert flops.count_params(tree) == 15
    assert flops.count_params({"a": np.zeros((2, 3)), "b": {"c": np.zeros((4,))}}) == \
        jflops.count_params({"a": np.zeros((2, 3)), "b": {"c": np.zeros((4,))}})


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX model, its weights drawn from numpy, and the port's
    model with the same weights, in eval mode on the CPU."""
    jmodel = JaxTwoView(**TINY)
    zeros = jnp.zeros((1, 32, 32, 1))
    variables = jax_variables(jmodel, 5, zeros, zeros)
    model = TwoViewXFMamba(**TINY)
    load_jax_variables(model, variables)
    return jmodel, variables, model.eval()


def hand_flops(model, B, image):
    """The tiny two-view model's FLOPs by hand: both views through the
    backbone as one batch of 2B (PatchEmbedV2's two stride-2 3x3 convs,
    per stage a block and a stride-2 downsample conv), ShallowFuse (K=2)
    and Cross_SS2Dv5 (K=4, 3B streams) at the stage-3 map, the final 1x1
    conv and the head; 2 per multiply-add, the scans' analytic terms."""
    def scan(b, L, KD, N):
        return 9 * b * L * KD * N + b * KD * L

    bb = model.mamba_feature_extrac
    n, s = 2 * B, image // 2
    total = 2 * n * s * s * 8 * 3 * 9                      # patch_embed.0
    s //= 2
    total += 2 * n * s * s * 16 * 8 * 9                    # patch_embed.5
    for i, layer in enumerate(bb.layers):
        L = s * s
        for blk in layer.blocks:
            op = blk.op
            d, di = blk.norm.weight.shape[0], op.d_inner
            K, C, _ = op.x_proj_weight.shape
            R, N = op.dt_projs_weight.shape[2], op.A_logs.shape[1]
            total += 2 * n * L * d * di + 2 * n * L * di * 9        # in_proj, dwconv
            total += 2 * n * L * K * C * di + 2 * n * L * K * di * R  # x_proj, dt
            total += scan(n, L, K * di, N) + 2 * n * L * di * d      # scan, out_proj
            hid = blk.mlp.fc1.weight.shape[0]
            total += 2 * 2 * n * L * d * hid                         # fc1, fc2
        if layer.downsample is not None:
            d = layer.blocks[0].norm.weight.shape[0]
            s //= 2
            total += 2 * n * s * s * 2 * d * d * 9
    L, hd = s * s, model.final_conv.weight.shape[0]
    sf = model.shallow_mamba_fusion.shallowfuseSS2D
    di, R, N = sf.d_inner, sf.R, sf.N
    total += 2 * 2 * B * L * hd * di + 2 * 2 * B * L * di * 9        # in_proj, dwconv
    total += 2 * B * L * 2 * (R + 2 * N) * di + 2 * B * L * 2 * di * R
    total += scan(B, L, 2 * di, N)
    total += 2 * (2 * B * di * (di // 16) * 2)                       # SE, both views
    total += 2 * 2 * B * L * di * hd                                 # out_proj, both views
    cr = model.fusemamba.blocks[0].self_attention
    di, R, N = cr.d_inner, cr.R, cr.N
    total += 2 * 3 * B * L * hd * di + 2 * 3 * B * L * di * 9
    total += 2 * 3 * B * L * 4 * (R + 2 * N) * di + 2 * 3 * B * L * 4 * di * R
    total += scan(3 * B, L, 4 * di, N) + 2 * B * L * di * hd
    total += 2 * B * L * hd * hd + 2 * B * hd * 2                    # final conv, head
    return total


ROUTES = {
    "composable, v2 groups": dict(stage=False, shallow_v2=True, cross_group=8),
    "composable, kernel 9": dict(stage=False, shallow_v2=False, cross_group=None),
    "stage kernels, v2 groups": dict(stage=True, shallow_v2=True, cross_group=8),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_flops_by_hand(tiny, route, dtype, monkeypatch):
    """``model_flops`` of a batch of 2 at 32² equals `hand_flops` on each
    route, in both dtypes; params are the port's parameters, JAX's count."""
    _, variables, model = tiny
    r = ROUTES[route]
    monkeypatch.setattr(vssm, "_uses_stage_route", lambda dtype: r["stage"])
    monkeypatch.setattr(fusion, "shallow_group", lambda B, L: 8)
    monkeypatch.setattr(fusion, "shallow_takes_v2", lambda B, L, W: r["shallow_v2"])
    monkeypatch.setattr(fusion, "cross_v2_group", lambda B, H, W: r["cross_group"])
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0)).to(dtype)
    out = flops.model_flops(model, x, x.flip(0))
    assert out["flops"] == hand_flops(model, 2, 32)
    assert out["params"] == jflops.count_params(variables["params"])
    assert out["bytes_accessed"] > 4 * out["params"]
    assert not model.training


def test_ops_report_their_own_cost():
    """A reporting op books its formula with the count open on its thread,
    once for the outermost call: calls inside it, calls with no count open
    and calls on another thread report nothing; the scan and stage entry
    points that the models call are reporting ops."""
    booked = []

    class Count:
        def add(self, fn, flops, args, kwargs):
            booked.append((fn.__name__, flops(*args, **kwargs)))
            return fn(*args, **kwargs)

    @cost.reports_cost(lambda x: 7)
    def inner(x):
        return x + 1

    @cost.reports_cost(lambda x: 5)
    def outer(x):
        return inner(x) * 2

    assert outer(1) == 4 and not booked
    with cost.open_count(Count()):
        assert outer(1) == 4 and inner(1) == 2
        other = threading.Thread(target=outer, args=(1,))
        other.start()
        other.join()
    assert booked == [("outer", 5), ("inner", 7)]
    assert outer(1) == 4 and len(booked) == 2
    # (core_dispatch's nk route reaches nk_scan_train)
    for fn in (ss2d.ss2d_core_n1, ss2d.ss2d_core_fused, ss2d.selective_scan_auto,
               ss2d.ssd_chunk_scan, ss2d.ssd_chunk_scan_heads, fusion.nk_scan_train,
               fusion.nk_scan_v1, fusion.nk_scan_x, fusion.selective_scan_auto,
               vssm.vss_stage, vssm.vss_block_v1):
        assert fn.__code__ is outer.__code__, fn.__name__


def test_model_flops_against_xla(tiny):
    """JAX's ``model_flops`` (XLA's cost analysis) counts the same
    products and the elementwise work besides: its ratio to the port's
    count at batch 1, 32², lies in `XLA_RATIO`."""
    jmodel, variables, model = tiny
    x = jnp.ones((1, 32, 32, 1))
    theirs = jflops.model_flops(jmodel, variables, x, x)
    ours = flops.model_flops(model, torch.ones(1, 32, 32, 1), torch.ones(1, 32, 32, 1))
    ratio = theirs["flops"] / ours["flops"]
    print(f"XLA / port FLOPs at batch 1, 32x32: {theirs['flops']:.0f} / {ours['flops']:.0f} "
          f"= {ratio:.4f}")
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1]
    assert ours["params"] == theirs["params"]


@pytest.fixture(scope="module")
def saliency_case(tiny):
    """Two studies at 64² (the stage-3 map 2 x 2) and JAX's Grad-CAM and
    input saliency of class 1 on them."""
    jmodel, variables, _ = tiny
    rng = np.random.default_rng(7)
    x1, x2 = (rng.standard_normal((2, 64, 64, 1)).astype(np.float32) for _ in range(2))
    # jitted: eager, the two functions take minutes on the CPU
    cams = jax.jit(lambda v, a, b: jsal.grad_cam_two_view(jmodel, v, a, b, 1))(
        variables, jnp.asarray(x1), jnp.asarray(x2))
    sal = jax.jit(lambda v, a, b: jsal.input_saliency(lambda p, q: jmodel.apply(v, p, q), a, b,
                                                      1))(variables, jnp.asarray(x1),
                                                          jnp.asarray(x2))
    return x1, x2, [np.asarray(c) for c in cams], [np.asarray(s) for s in sal]


def test_grad_cam_matches_jax(tiny, saliency_case):
    """Both views' CAMs within 1e-4 of JAX's, in [0, 1], not flat; the
    model stays in eval mode and autograd's mode is restored."""
    _, _, model = tiny
    x1, x2, want, _ = saliency_case
    cam_a, cam_b, (feats, grads) = saliency.grad_cam_two_view(model, T(x1), T(x2), 1,
                                                               return_gradients=True)
    assert feats.shape == grads.shape == (4, 2, 2, 128)
    for got, ref in zip((cam_a, cam_b), want):
        assert got.shape == (2, 64, 64)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
        assert float(got.min()) >= 0 and float(got.max()) <= 1 + 1e-6 and float(got.max()) > 0.5
    assert torch.is_grad_enabled() and not model.training
    # the CAM's own arithmetic against JAX's on the same features
    f, g = feats.numpy(), grads.numpy()
    np.testing.assert_allclose(saliency._cam_from(feats, grads, (64, 64)).numpy(),
                               np.asarray(jsal._cam_from(jnp.asarray(f), jnp.asarray(g),
                                                         (64, 64))), rtol=0, atol=1e-5)


def test_input_saliency_matches_jax(tiny, saliency_case):
    _, _, model = tiny
    x1, x2, _, want = saliency_case
    got = saliency.input_saliency(lambda a, b: model(a, b), T(x1), T(x2), 1)
    for a, b in zip(got, want):
        assert a.shape == (2, 64, 64)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * max(1.0, np.abs(b).max()))


def test_overlay_is_jax_exact():
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, (16, 12)).astype(np.float32)
    cam = rng.uniform(0, 1, (16, 12)).astype(np.float32)
    for alpha in (0.5, 0.3):
        got = saliency.overlay(img, cam, alpha).numpy()
        want = np.asarray(jsal.overlay(jnp.asarray(img), jnp.asarray(cam), alpha))
        np.testing.assert_array_equal(got, want)


def test_do_bench_and_trace(tmp_path):
    """``do_bench`` returns JAX's keys; ``trace`` writes a Chrome trace that
    holds the profiled operations."""
    x = torch.ones(64, 64)
    res = profiling.do_bench(lambda a: (a @ a).sum(), x, warmup=1, iters=3)
    assert set(res) == {"median_s", "mean_s", "min_s", "max_s", "iters"}
    assert res["iters"] == 3 and 0 < res["min_s"] <= res["median_s"] <= res["max_s"]
    with profiling.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# the fusion layers' route in eval mode with a gradient
# ---------------------------------------------------------------------------

@pytest.fixture
def scan_calls(monkeypatch):
    """Counts of the fusion layers' scan entry points, with the routing
    rules made to give the card's eval kernels a group: ShallowFuse's v2
    group (``nk_scan_train`` as kernel 2) or kernel 9, Cross_SS2Dv5's
    ``nk_scan_x`` (kernel 3)."""
    counts = {}

    def counted(name):
        fn = getattr(fusion, name)

        def wrapper(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(fusion, name, wrapper)

    for name in ("nk_scan_x", "nk_scan_v1", "nk_scan_train", "selective_scan_auto",
                 "core_dispatch"):
        counted(name)
    monkeypatch.setattr(fusion, "shallow_group", lambda B, L: 8)
    monkeypatch.setattr(fusion, "cross_v2_group", lambda B, H, W: 8)
    monkeypatch.setattr(fusion, "nk_train_supported", lambda *args: None)
    return counts


@pytest.mark.parametrize("shallow_v2", [True, False])
def test_eval_forward_with_a_gradient_takes_differentiable_scans(tiny, scan_calls, monkeypatch,
                                                                 shallow_v2):
    """Grad-CAM's forward (stage-3 features a leaf that requires grad,
    eval mode) reaches only ``selective_scan_auto`` (ShallowFuse, by the
    training rule, which here gives no nk group) and ``core_dispatch``
    (Cross_SS2Dv5); the same forward without grad takes kernel 2 or 9 and
    kernel 3.  On the CPU the eval kernels' plain versions are
    differentiable: through them (the route kept under grad) the gradient
    and the logits are the differentiable route's."""
    _, _, model = tiny
    monkeypatch.setattr(fusion, "shallow_takes_v2", lambda B, L, W: shallow_v2)
    x1, x2 = (torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(s))
              for s in (1, 2))
    with torch.no_grad():
        plain = model(x1, x2)
    eval_kernels = {"nk_scan_x": 1, ("nk_scan_train" if shallow_v2 else "nk_scan_v1"): 2}
    assert scan_calls == eval_kernels
    scan_calls.clear()
    _, _, (feats, grads) = saliency.grad_cam_two_view(model, x1, x2, 1, return_gradients=True)
    assert scan_calls == {"selective_scan_auto": 1, "core_dispatch": 1}
    scan_calls.clear()
    # the eval kernels' route under grad: their plain twins, differentiable
    monkeypatch.setattr(fusion, "needs_grad", lambda *t: False)
    leaf = feats.clone().requires_grad_()
    with torch.enable_grad():
        za, zb = model.shallow_mamba_fusion(leaf[:2], leaf[2:])
        z = model.fusemamba(za, zb)
        logits = model.classifier["head"](model.final_conv(z).mean((1, 2)))
        (want,) = torch.autograd.grad(logits[:, 1].sum(), leaf)
    np.testing.assert_allclose(grads.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(logits.detach().numpy(), plain.numpy(), rtol=0, atol=1e-5)
    assert scan_calls == eval_kernels


def test_eval_forward_under_no_grad_keeps_the_eval_kernels(tiny, scan_calls, monkeypatch):
    """An eval forward whose parameters require grad, under ``no_grad``,
    keeps kernel 3's route (the CLIs' eval steps and inference)."""
    _, _, model = tiny
    monkeypatch.setattr(fusion, "shallow_takes_v2", lambda B, L, W: False)
    assert all(p.requires_grad for p in model.parameters())
    x = torch.randn(1, 64, 64, 1, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model(x, x)
    assert scan_calls == {"nk_scan_x": 1, "nk_scan_v1": 2}
