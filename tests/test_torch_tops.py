"""The port's model tops and v05_noz factories against the JAX package on the
CPU, float32.

- Parameter trees: every factory of ``models/vssm.py`` (the six v05_noz
  classifiers and ``backbone_vssm``; ``build_model`` and
  ``single_channel_feature_extract_mamba`` are VMamba-S s2l15 in both
  packages), each top at full width and XFMamba-T have JAX's
  parameters and batch statistics, name for name and shape for shape
  (``jax.eval_shape`` of the JAX init, nothing materialised there), through
  ``checkpoint.convert.jax_paths``.
- The three baselines at a tiny geometry (both packages'
  ``_BACKBONE_CFG["small"]`` and the ``build_model`` that SingleViewMamba
  calls shrunk with ``monkeypatch``, drop path 0): eval logits, and one
  ``make_train_step`` step (loss, every gradient leaf by leaf, the
  parameters after Adam, EarlyFusion's ``fusion_bn`` statistics unchanged)
  against JAX's, on both backbone routes; a ``train_bn=True`` call;
  ``ModelWrapper``.

JAX variables are drawn from numpy (``test_torch_parity.jax_variables``)
and loaded with ``load_jax_variables``.  Tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity import assert_close, jax_variables, route  # noqa: F401 (fixture)
from xfmamba_tpu.models import tops as jtops
from xfmamba_tpu.models import vssm as jvssm
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.models import tops, vssm
from xfmamba_tpu_torch.train import loop
from xfmamba_tpu_torch.train.config import TrainConfig

T = torch.from_numpy
BATCH, IMAGE, LR = 3, 32, 1e-3
# the tiny backbone of the baselines (stage maps 8, 4, 2, 1 at 32 x 32)
TINY_SMALL = dict(depths=(1, 1, 1, 1), dims=16, drop_path_rate=0.0, ssm_ratio=2.0)
BASELINES = {"singleviewmamba": ("SingleViewMamba", False),
             "twoviewlatejoinmamba": ("TwoViewLateJoinMamba", True),
             "twoviewearlyfusionmamba": ("TwoViewEarlyFusionMamba", True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's thread pools then slow each other down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tiny_build_model(num_classes=1000):
    return jvssm._vssm(TINY_SMALL["depths"], 16, 0.0, 1, 2.0, "v05_noz", "v3", "v2", False,
                       4.0, num_classes)


def _port_tiny_build_model(num_classes=1000, **kw):
    return vssm.vmamba_small_s2l15(num_classes, **(TINY_SMALL | kw))


def _shrink(mp):
    """Both packages' baselines at the tiny geometry while ``mp`` is open."""
    mp.setitem(jtops._BACKBONE_CFG, "small", dict(TINY_SMALL))
    mp.setitem(tops._BACKBONE_CFG, "small", dict(TINY_SMALL))
    mp.setattr(jtops, "build_model", _jax_tiny_build_model)
    mp.setattr(tops, "build_model", _port_tiny_build_model)


def _shapes(init, *inputs):
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *inputs)
    return {tuple(k.key for k in path): leaf.shape
            for coll in ("params", "batch_stats") if coll in shapes
            for path, leaf in jax.tree_util.tree_leaves_with_path({coll: shapes[coll]})}


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# parameter trees at full width
# ---------------------------------------------------------------------------

GRAY = jax.ShapeDtypeStruct((1, 64, 64, 1), jnp.float32)
RGB = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
FACTORIES = ["vmamba_tiny_s2l5", "vmamba_small_s2l15", "vmamba_base_s2l15", "vmamba_tiny_s1l8",
             "vmamba_small_s1l20", "vmamba_base_s1l20", "backbone_vssm"]


def _tree_case(name):
    """(JAX init, its inputs, the port model with its parameters on the meta
    device: shapes without values) of a tree case."""
    with torch.device("meta"):
        if name in FACTORIES:
            return getattr(jvssm, name)().init, (RGB,), getattr(vssm, name)(device=None)
        if name == "twoviewxfmamba_tiny":
            return (jtops.two_view_xfmamba("tiny").init, (GRAY, GRAY),
                    tops.two_view_xfmamba("tiny", device=None))
        cls, two_view = BASELINES[name]
        return (getattr(jtops, cls)().init, (GRAY, GRAY) if two_view else (GRAY,),
                getattr(tops, cls)())


@pytest.mark.parametrize("name", FACTORIES + list(BASELINES) + ["twoviewxfmamba_tiny"])
def test_parameter_tree_matches_jax(name):
    """Names and shapes of every parameter and batch statistic, leaf for
    leaf (the baselines' backbone is VMamba-S s2l15 whatever the size; the
    s1l* factories and XFMamba-T have d_inner = d)."""
    init, inputs, model = _tree_case(name)
    assert next(model.parameters()).is_meta
    want = _shapes(init, *inputs)
    state = model.state_dict()
    got = {jpath: to_jax(np.zeros(state[key].shape, np.float32)).shape
           for key, (jpath, _, to_jax) in jax_paths(model).items()}
    assert got == want
    if name in ("vmamba_tiny_s1l8", "twoviewxfmamba_tiny"):
        backbone = model if name in FACTORIES else model.mamba_feature_extrac
        assert [layer.blocks[0].op.d_inner for layer in backbone.layers] == [96, 192, 384, 768]


@pytest.mark.parametrize("name", ["build_model", "single_channel_feature_extract_mamba"])
def test_default_classifiers_are_s2l15(name):
    """``build_model`` and ``single_channel_feature_extract_mamba`` are
    VMamba-S s2l15 in both packages (its tree is checked above)."""
    assert getattr(jvssm, name)(7) == jvssm.vmamba_small_s2l15(7)
    kw = dict(device="cpu", depths=(1, 1, 1, 1), dims=8)
    got, want = getattr(vssm, name)(7, **kw), vssm.vmamba_small_s2l15(7, **kw)
    assert {k: v.shape for k, v in got.state_dict().items()} == \
        {k: v.shape for k, v in want.state_dict().items()}
    assert (got.depths, got.layers[0].blocks[0].op.d_inner, got.classifier.head.weight.shape) == \
        (want.depths, 16, (7, 64))


def test_factories_are_seeded_on_the_device_asked_and_eval():
    kw = dict(depths=(1, 1, 1, 1), dims=8)
    a = vssm.vmamba_tiny_s1l8(5, device="cpu", seed=3, **kw)
    b = vssm.vmamba_tiny_s1l8(5, device="cpu", seed=3, **kw)
    assert not a.training and a.classifier.head.weight.shape == (5, 64)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    feats = vssm.backbone_vssm(device="cpu", out_indices=(1, 3), **kw)
    with torch.no_grad():
        outs = feats(torch.randn(2, 32, 32, 3))
    assert [tuple(o.shape) for o in outs] == [(2, 4, 4, 16), (2, 1, 1, 64)]


def test_vanilla_factories_raise():
    """The vanilla factories (v0, PatchEmbedV1, PatchMerging2D) name the
    model-surface item."""
    for fn in (vssm.vanilla_vmamba_tiny, vssm.vanilla_vmamba_small, vssm.vanilla_vmamba_base):
        with pytest.raises(NotImplementedError, match="model surface"):
            fn()


# ---------------------------------------------------------------------------
# the baselines at a tiny geometry against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tops():
    """Per baseline: its variables, a batch, and JAX's logits, loss,
    gradients, parameters and batch statistics of one Adam step (lr 1e-3,
    weight decay 1e-5) of ``make_train_step(two_view=...)``.  The step's
    logits are JAX's eval logits: drop path is 0, and no baseline
    normalises with batch statistics in a step (EarlyFusion's ``fusion_bn``
    takes them only with ``train_bn``)."""
    rng = np.random.default_rng(4)
    batch = {"image1": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "image2": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "label": np.array([0, 1, 1], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # an identity transformation ahead of Adam keeps the step's gradients
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        for seed, (name, (cls, two_view)) in enumerate(BASELINES.items()):
            jmodel = getattr(jtops, cls)()
            inputs = (jbatch["image1"], jbatch["image2"]) if two_view else (jbatch["image1"],)
            variables = jax_variables(jmodel, 10 + seed, *inputs)
            opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
            step, _ = jax_make_train_step(jmodel, opt, multilabel=False, two_view=two_view,
                                          jit_compile=False)
            state = TrainState(step=0, params=variables["params"],
                               batch_stats=variables.get("batch_stats", {}),
                               opt_state=opt.init(variables["params"]))
            new, metrics = jax.jit(step)(state, jbatch, jax.random.PRNGKey(0), LR)
            bn = None
            if name == "twoviewearlyfusionmamba":
                y, upd = jax.jit(lambda v, *x: jmodel.apply(v, *x, train_bn=True,
                                                            mutable=["batch_stats"]))(
                    variables, *inputs)
                bn = (np.asarray(y), upd["batch_stats"]["fusion_bn"])
            out[name] = dict(variables=variables, logits=np.asarray(metrics["logits"]),
                             loss=float(metrics["loss"]), grads=new.opt_state[0],
                             params=new.params, stats=new.batch_stats, train_bn=bn)
    return batch, out


def _port_top(name, monkeypatch):
    _shrink(monkeypatch)
    cls, two_view = BASELINES[name]
    return getattr(tops, cls)(), two_view


def _views(batch, two_view):
    return (T(batch["image1"]), T(batch["image2"])) if two_view else (T(batch["image1"]),)


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_logits_match_jax(jax_tops, name, monkeypatch):
    """Eval logits against JAX's (those of its step, see `jax_tops`)
    within 1e-5 (float32 sums in other orders)."""
    batch, ref = jax_tops
    model, two_view = _port_top(name, monkeypatch)
    load_jax_variables(model, ref[name]["variables"])
    with torch.no_grad():
        got = model.eval()(*_views(batch, two_view))
    assert got.shape == (BATCH, 2)
    assert_close(got, ref[name]["logits"], 1e-5)


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_train_step_matches_jax(jax_tops, name, route, monkeypatch):
    """One ``make_train_step`` step against JAX: the loss (1e-5), every
    parameter's gradient (2e-4 of the largest gradient of its tensor), the
    parameters after Adam (2 lr where a gradient near zero may flip the
    first update's sign; 1e-6 where Adam's input is well above the gradient
    tolerance), and EarlyFusion's ``fusion_bn`` statistics unchanged, as
    in JAX, whose step never passes ``train_bn``."""
    batch, ref = jax_tops
    ref = ref[name]
    model, two_view = _port_top(name, monkeypatch)
    load_jax_variables(model, ref["variables"])
    optimizer = loop.make_optimizer(TrainConfig(lr=LR), model.parameters())
    train_step, _ = loop.make_train_step(model, optimizer, multilabel=False, two_view=two_view)
    tb = dict(zip(("image1", "image2"), _views(batch, two_view)), label=T(batch["label"]).long())
    out = train_step(tb)
    assert abs(float(out["loss"]) - ref["loss"]) <= 1e-5 * max(1.0, abs(ref["loss"]))
    params = dict(model.named_parameters())
    n = 0
    for key, (jpath, to_port, _) in jax_paths(model).items():
        if jpath[0] != "params":
            continue
        want = to_port(_leaf(ref["grads"], jpath[1:]))
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(params[key].grad.numpy(), want, rtol=0, atol=2e-4 * scale,
                                   err_msg=key)
        diff = np.abs(params[key].detach().numpy() - to_port(_leaf(ref["params"], jpath[1:])))
        assert diff.max() <= 2 * LR, key
        step_in = want + 1e-5 * to_port(_leaf(ref["variables"]["params"], jpath[1:]))
        assert diff[np.abs(step_in) > 100 * 2e-4 * scale].max(initial=0) <= 1e-6, key
        n += 1
    assert n == len(params)
    if name == "twoviewearlyfusionmamba":
        bn = model.fusion_bn
        before = ref["variables"]["batch_stats"]["fusion_bn"]
        for got, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_array_equal(got.numpy(), before[key])
            np.testing.assert_array_equal(_leaf(ref["stats"], ("fusion_bn", key)), before[key])
        assert int(bn.num_batches_tracked) == 0
    else:
        assert not ref["stats"] and not list(model.buffers())


def test_early_fusion_train_bn_matches_flax(jax_tops, monkeypatch):
    """``train_bn=True`` (here in eval mode): the batch's statistics, the
    logits within 1e-5, the running mean moved with flax momentum 0.9 and
    the running variance up to n / (n - 1) (torch keeps the unbiased one;
    ``test_batchnorm_training_statistics``)."""
    batch, ref = jax_tops
    ref = ref["twoviewearlyfusionmamba"]
    model, _ = _port_top("twoviewearlyfusionmamba", monkeypatch)
    load_jax_variables(model, ref["variables"])
    with torch.no_grad():
        got = model.eval()(T(batch["image1"]), T(batch["image2"]), train_bn=True)
    y, stats = ref["train_bn"]
    before = ref["variables"]["batch_stats"]["fusion_bn"]
    n = BATCH * IMAGE * IMAGE
    assert_close(got, y, 1e-5)
    assert_close(model.fusion_bn.running_mean, stats["mean"], 1e-6)
    assert_close(model.fusion_bn.running_var.numpy() - 0.9 * before["var"],
                 (np.asarray(stats["var"]) - 0.9 * before["var"]) * n / (n - 1), 1e-6)
    assert int(model.fusion_bn.num_batches_tracked) == 1


def test_model_wrapper_is_the_two_view_call(monkeypatch):
    """``ModelWrapper`` splits (B, H, W, 2C) into the two views: the same
    logits as the two-view call, and a tuple output's chosen item."""
    model, _ = _port_top("twoviewlatejoinmamba", monkeypatch)
    g = torch.Generator().manual_seed(2)
    xa, xb = torch.randn(2, IMAGE, IMAGE, 1, generator=g), torch.randn(2, IMAGE, IMAGE, 1,
                                                                     generator=g)
    with torch.no_grad():
        model.eval()
        assert torch.equal(tops.ModelWrapper(model)(torch.cat([xa, xb], -1)), model(xa, xb))

    class Pair(torch.nn.Module):
        def forward(self, a, b):
            return a, b

    stacked = torch.cat([xa, xb], -1)
    assert torch.equal(tops.ModelWrapper(Pair(), output_index=1)(stacked), xb)
