"""Vanilla VMamba in the port on the CPU against the JAX package: a tiny
vanilla classifier (forward type v0, d_state 16, no MLP, PatchEmbedV1,
PatchMerging2D; depths 2/2/2/2, dims 16) its eval logits and one
``make_train_step(two_view=False)`` step, the weight bridge both ways, the
patch-embed and downsample versions, and the full-size factories'
parameter shapes.

Inputs and parameters are numpy arrays from a seed handed to both sides;
JAX runs under ``jax.jit`` on the CPU.  float32, the tolerances of the m2
classifier's tests (``tests/test_torch_ssd.py``): logits within 1e-5 of
the largest, the loss within 1e-5, each gradient within 2e-4 of its
tensor's largest, the parameters after Adam within 2 lr (a gradient near
zero may flip the sign of the first update).  At batch 4 and 40 x 40 the
stage maps are 10, 5, 3 and 2 (PatchMerging2D pads the odd ones); the
10 x 10 and 2 x 2 stages' cores take the nk route (kernels 2/7's plain
twins), the 5 x 5 and 3 x 3 ones the grouped scan (13/14's)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.checkpoint.convert import convert_vssm_state_dict, verify_tree_matches
from xfmamba_tpu.models import vssm as jax_vssm
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables, jax_paths, load_jax_variables
from xfmamba_tpu_torch.models import ss2d, vssm
from xfmamba_tpu_torch.train import loop
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
TINY = dict(depths=(2, 2, 2, 2), dims=16, num_classes=10, ssm_d_state=16, ssm_ratio=2.0,
            ssm_act="silu", ssm_conv_bias=True, ssm_init="v0", forward_type="v0",
            mlp_ratio=0.0, drop_path_rate=0.0, patchembed_version="v1", downsample_version="v1")
BATCH, IMAGE, LR = 4, 40, 1e-3


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


@pytest.fixture(scope="module")
def tiny_step():
    """The tiny vanilla classifier's variables, a batch, and JAX's logits,
    loss, gradients and parameters after one Adam step.  With drop path 0
    and no batch statistics the step's logits are the eval logits."""
    jmodel = jax_vssm.VSSM(**TINY)
    variables = jax_variables(jmodel, 6, jnp.zeros((1, IMAGE, IMAGE, 3)))
    rng = np.random.default_rng(8)
    batch = {"image1": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             "label": np.array([0, 3, 9, 4], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
    train_step, _ = jax_make_train_step(jmodel, opt, multilabel=False, two_view=False,
                                        jit_compile=False)
    state = TrainState(step=0, params=variables["params"], batch_stats={},
                       opt_state=opt.init(variables["params"]))
    new_state, metrics = jax.jit(train_step)(state, jbatch, jax.random.PRNGKey(0), LR)
    return (variables, batch, np.asarray(metrics["logits"]), float(metrics["loss"]),
            new_state.opt_state[0],
            new_state.params)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the SS2D cores' routes: the nk pair and the composable
    grouped scan."""
    counts = {"nk": 0, "grouped": 0}

    def counting(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ss2d, "nk_scan_train_from_projs",
                        counting("nk", ss2d.nk_scan_train_from_projs))
    monkeypatch.setattr(ss2d, "ss2d_core_from_projs",
                        counting("grouped", ss2d.ss2d_core_from_projs))
    return counts


def _model(variables):
    model = vssm.VSSM(out_indices=None, **TINY)
    load_jax_variables(model, variables)
    return model


def test_vanilla_logits_match_jax(tiny_step, routes):
    """Eval logits within 1e-5, four blocks on each route."""
    variables, batch, logits, *_ = tiny_step
    model = _model(variables).eval()
    assert not model.stage_kernels and model.layers[0].blocks[0].mlp is None
    with torch.no_grad():
        got = model(T(batch["image1"]))
    assert got.shape == (BATCH, 10) and _rel(got, logits) <= 1e-5
    assert routes == {"nk": 4, "grouped": 4}


def test_vanilla_train_step_matches_jax(tiny_step, routes):
    """One ``make_train_step(..., two_view=False)`` step: the loss (1e-5),
    every gradient (2e-4 of its tensor's largest) and the parameters after
    Adam (2 lr)."""
    variables, batch, _, loss_ref, grads_ref, params_ref = tiny_step
    model = _model(variables)
    optimizer = loop.make_optimizer(TrainConfig(lr=LR), model.parameters())
    train_step, _ = loop.make_train_step(model, optimizer, multilabel=False, two_view=False)
    out = train_step({"image1": T(batch["image1"]), "label": T(batch["label"]).long()})
    assert routes == {"nk": 4, "grouped": 4}
    assert abs(float(out["loss"]) - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))
    params = dict(model.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(model).items():
        want = to_port(np.asarray(_leaf(grads_ref, jpath[1:])))
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(params[key].grad.numpy(), want, rtol=0, atol=2e-4 * scale,
                                   err_msg=key)
        diff = np.abs(params[key].detach().numpy() - to_port(np.asarray(_leaf(params_ref,
                                                                                jpath[1:]))))
        assert diff.max() <= 2 * LR, key


def test_vanilla_weight_bridge_both_ways(tiny_step):
    """The port's variables export to the JAX tree bit for bit and load
    back into a fresh model bit for bit; its state dict, in the
    reference's names (``patch_embed.0`` / ``.2``, ``layers.i.downsample.
    norm`` / ``.reduction``), converts to that tree with the JAX package's
    ``convert_vssm_state_dict``."""
    variables = tiny_step[0]
    model = _model(variables)
    state = model.state_dict()
    assert {"patch_embed.0.weight", "patch_embed.2.weight", "layers.0.downsample.norm.weight",
            "layers.2.downsample.reduction.weight"} <= set(state)
    exported = export_jax_variables(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(_leaf(exported, [k.key for k in path]), leaf)
    converted = convert_vssm_state_dict({k: v.numpy() for k, v in state.items()})
    verify_tree_matches(converted, variables["params"])
    fresh = vssm.VSSM(out_indices=None, **TINY)
    load_jax_variables(fresh, exported)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, state[key]), key


@pytest.mark.parametrize("patchembed,downsample,dims", [("v1", "v2", 16), ("v2", "none", (16, 16)),
                                                        ("v1", "v3", 16)])
def test_vssm_versions_match_jax(patchembed, downsample, dims):
    """The patch-embed and downsample versions on a two-stage v05_noz
    classifier with its MLP: logits within 1e-5."""
    cfg = dict(depths=(1, 1), dims=dims, num_classes=5, ssm_d_state=1, forward_type="v05_noz",
               mlp_ratio=2.0, drop_path_rate=0.0, patchembed_version=patchembed,
               downsample_version=downsample)
    jmodel = jax_vssm.VSSM(**cfg)
    variables = jax_variables(jmodel, 3, jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(x))
    model = vssm.VSSM(out_indices=None, **cfg).eval()
    load_jax_variables(model, variables)
    with torch.no_grad():
        assert _rel(model(T(x)), want) <= 1e-5


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_vanilla_factories_match_jax_shapes(size):
    """``vanilla_vmamba_{tiny,small,base}`` have the JAX factories'
    parameters, name for name and shape for shape: JAX's tree from
    ``jax.eval_shape``, the port's model on the meta device (nothing is
    materialised on either side)."""
    jfactory = getattr(jax_vssm, f"vanilla_vmamba_{size}")
    shapes = jax.eval_shape(jfactory().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path({"params": shapes["params"]})}
    with torch.device("meta"):
        model = getattr(vssm, f"vanilla_vmamba_{size}")(device="meta")
    assert not model.training and not model.stage_kernels
    state = model.state_dict()
    seen = set()
    for key, (jpath, to_port, _) in jax_paths(model).items():
        assert jpath in want, key
        assert tuple(state[key].shape) == to_port(np.zeros(want[jpath], np.float32)).shape, key
        seen.add(jpath)
    assert seen == set(want)
    depth = 9 if size == "tiny" else 27
    d = 128 if size == "base" else 96
    op = model.layers[2].blocks[depth - 1].op
    assert op.in_proj.weight.shape == (16 * d, 4 * d) and op.A_logs.shape == (32 * d, 16)
    assert model.layers[0].downsample.reduction.weight.shape == (2 * d, 4 * d)
