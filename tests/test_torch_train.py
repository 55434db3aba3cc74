"""The port's training path on the CPU, float32: one train step of the tiny
two-view model against the JAX package's ``make_train_step``, the repairs
of the port's faults against the JAX package (drop-path generator and the
mask shared by both views, BatchNorm in training mode, the differentiable
operand packing, the straight-through swap), and the train-loop helpers.

JAX parameters and batch statistics are drawn from numpy and loaded into
the port with ``load_jax_variables``; gradients are mapped back leaf by
leaf with ``checkpoint.convert.jax_paths``.  The JAX model runs its
composable path on the CPU (its kernels are TPU-only); the port runs the
plain versions of its kernels, in both ``use_checkpoint`` modes, on both
backbone routes (the float32 composable one, and the bfloat16 stage one
selected with the ``route`` fixture) and on both fusion-scan routes (the
grouped scan the rule picks at the tiny step's shapes, and the nk pair).
The base model's parameter tree is held against JAX's at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity import assert_close, jax_variables, route  # noqa: F401 (fixture)
from xfmamba_tpu.models.fusion import ShallowFusionBlock as JaxShallowFusionBlock
from xfmamba_tpu.models.fusion import swapping_scan as jax_swapping_scan
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.models.tops import two_view_xfmamba as jax_two_view_xfmamba
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
from xfmamba_tpu.train.loop import lr_schedule as jax_lr_schedule
from xfmamba_tpu_torch.checkpoint.convert import (
    export_jax_variables, jax_paths, load_jax_variables)
from xfmamba_tpu_torch.models import fusion, ss2d
from xfmamba_tpu_torch.models.fusion import ShallowFusionBlock, swapping_scan
from xfmamba_tpu_torch.models.layers import BatchNorm, DropPath
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba, two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import VSSM, VSSBlock
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_train_supported
from xfmamba_tpu_torch.ops.vss_block import (
    SS2D_FIELDS, pack_vss_block_params, pack_vss_block_train_params, vss_block_ref)
from xfmamba_tpu_torch.train import loop
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
TINY = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
            backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16, drop_path_rate=0.0))
BATCH, IMAGE, LR = 3, 32, 1e-3


# ---------------------------------------------------------------------------
# one train step of the whole slice
# ---------------------------------------------------------------------------

def jax_train_step(model_kw=TINY, label=np.array([0, 1, 1], np.int32)):
    """Variables, batch, and JAX's loss, gradients, batch statistics,
    parameters and logits after one Adam step (lr 1e-3, weight decay 1e-5)
    of ``JaxTwoView(**model_kw)`` on ``label``: integer classes train with
    the cross-entropy, float label vectors (multilabel) with the BCE."""
    jmodel = JaxTwoView(**model_kw)
    zeros = jnp.zeros((BATCH, IMAGE, IMAGE, 1))
    variables = jax_variables(jmodel, 0, zeros, zeros)
    rng = np.random.default_rng(1)
    batch = {"image1": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "image2": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "label": label}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # one compile: an identity transformation ahead of Adam keeps the step's
    # gradients in the optimizer state
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
    train_step, _ = jax_make_train_step(jmodel, opt, multilabel=label.ndim == 2,
                                        jit_compile=False)
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))
    new_state, metrics = jax.jit(train_step)(state, jbatch, jax.random.PRNGKey(0), LR)
    return (variables, batch, new_state, float(metrics["loss"]), new_state.opt_state[0],
            np.asarray(metrics["logits"]))


@pytest.fixture(scope="module")
def jax_step():
    """`jax_train_step` of the tiny model on three integer labels."""
    return jax_train_step()


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return np.asarray(tree)


@pytest.fixture
def fusion_scans(monkeypatch):
    """Counts of the fusion scans' entry points in one run: the grouped scan
    (kernels 13/14) from ShallowFuse and from ``core_dispatch``, the nk
    pair (kernels 2/7) from each."""
    counts = dict.fromkeys(("shallow_grouped", "cross_grouped", "shallow_nk", "cross_nk"), 0)

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(fusion, "selective_scan_auto", "shallow_grouped")
    counted(ss2d, "selective_scan_auto", "cross_grouped")
    counted(fusion, "nk_scan_train", "shallow_nk")
    counted(ss2d, "nk_scan_train_from_projs", "cross_nk")
    return counts


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_train_step_matches_jax(jax_step, use_checkpoint, route, fusion_scans):
    """One train step against JAX (`_check_train_step`) with the fusion
    scans on the route the rule picks at these shapes (batch 3, 1 x 1 maps,
    no aligned image group): the grouped scan, once in ShallowFuse (K=2)
    and once per cross2d direction in Cross_SS2Dv5."""
    assert nk_train_supported(BATCH, 1, 1, 256, 1, 4, "unidi") is None
    assert nk_train_supported(3 * BATCH, 1, 1, 256, 4, 4, "cross2d") is None
    _check_train_step(jax_step, use_checkpoint)
    assert fusion_scans == dict(shallow_grouped=1, cross_grouped=4, shallow_nk=0, cross_nk=0)


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_train_step_matches_jax_on_the_nk_route(jax_step, use_checkpoint, route, fusion_scans,
                                               monkeypatch):
    """The same step, against the same JAX fixture, with the port's rule
    made to give every fusion scan a group: the nk pair, twice in
    ShallowFuse (K=1 each) and once in Cross_SS2Dv5 (K=4)."""
    for module in (fusion, ss2d):
        monkeypatch.setattr(module, "nk_train_supported", lambda *args: 1)
    _check_train_step(jax_step, use_checkpoint)
    assert fusion_scans == dict(shallow_grouped=0, cross_grouped=0, shallow_nk=2, cross_nk=1)


def test_base_model_parameters_match_jax():
    """``two_view_xfmamba("base")`` at full width (dims 128-1024, hidden
    1024, d_inner 2048, dt rank 64) has JAX ``two_view_xfmamba("base")``'s
    parameters and batch statistics, name for name and shape for shape
    (``jax.eval_shape``, nothing materialised on the JAX side)."""
    zeros = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(jax_two_view_xfmamba("base").init, jax.random.PRNGKey(0),
                            zeros, zeros)
    want = {tuple(k.key for k in path): leaf.shape
            for coll in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_leaves_with_path({coll: shapes[coll]})}
    model = two_view_xfmamba("base", device="cpu")
    state = model.state_dict()
    seen = set()
    for key, (jpath, to_port, _) in jax_paths(model).items():
        assert jpath in want, key
        assert tuple(state[key].shape) == to_port(np.broadcast_to(np.float32(0),
                                                                  want[jpath])).shape, key
        seen.add(jpath)
    assert seen == set(want)
    assert model.fusemamba.blocks[0].self_attention.x_proj_weight.shape == (4, 64 + 32, 2048)


def _check_train_step(jax_step, use_checkpoint, model_kw=TINY):
    """Loss (1e-5), the step's logits (1e-5 of the largest), every
    parameter gradient (2e-4 of the largest gradient of its tensor, float32
    sums in other orders through the whole model), the BatchNorm
    statistics (the running variance up to n/(n-1), see
    `test_batchnorm_training_statistics`) and the parameters after one Adam
    step.  The first Adam update is lr * s / (|s| + eps), about lr *
    sign(s), with s = g + 1e-5 * p (the weight decay): where |s| is above
    100 times the gradient tolerance the parameters agree to 1e-6;
    elsewhere an s within its tolerance of zero may flip the sign, so they
    agree to 2 * lr.  A batch of float label vectors trains multilabel."""
    variables, batch, new_state, loss_ref, grads_ref, logits_ref = jax_step
    multilabel = batch["label"].ndim == 2
    model = TwoViewXFMamba(**model_kw, use_checkpoint=use_checkpoint)
    load_jax_variables(model, variables)
    optimizer = loop.make_optimizer(TrainConfig(lr=LR), model.parameters())
    train_step, _ = loop.make_train_step(model, optimizer, multilabel=multilabel)
    label = T(batch["label"])
    tb = {"image1": T(batch["image1"]), "image2": T(batch["image2"]),
          "label": label if multilabel else label.long()}
    out = train_step(tb)
    assert abs(float(out["loss"]) - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))
    assert out["logits"].shape == logits_ref.shape
    assert_close(out["logits"], logits_ref, 1e-5 * max(1.0, np.abs(logits_ref).max()))
    params = dict(model.named_parameters())
    n_params = 0
    for key, (jpath, to_port, _) in jax_paths(model).items():
        if jpath[0] == "params":
            want = to_port(_leaf(grads_ref, jpath[1:]))
            got = params[key].grad.numpy()
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale, err_msg=key)
            diff = np.abs(params[key].detach().numpy()
                          - to_port(_leaf(new_state.params, jpath[1:])))
            assert diff.max() <= 2 * LR, key
            # Adam's input is g + wd * p: where that is well above the
            # gradient tolerance the step is determined to float32 rounding
            step_in = want + 1e-5 * to_port(_leaf(variables["params"], jpath[1:]))
            assert diff[np.abs(step_in) > 100 * 2e-4 * scale].max(initial=0) <= 1e-6, key
            n_params += 1
    assert n_params == len(params)
    bn = model.shallow_mamba_fusion.norm
    stats = variables["batch_stats"]["shallow_mamba_fusion"]["norm"]
    new = new_state.batch_stats["shallow_mamba_fusion"]["norm"]
    n = BATCH * 1 * 1          # one view's stage-3 map at 32x32 is 1x1
    assert_close(bn.running_mean, new["mean"], 1e-5)
    # two updates (one per view): var = 0.81 var0 + 0.09 b1 + 0.1 b2
    assert_close(bn.running_var.numpy() - 0.81 * stats["var"],
                 (np.asarray(new["var"]) - 0.81 * stats["var"]) * n / (n - 1), 1e-5)
    assert int(bn.num_batches_tracked) == 2


def test_export_round_trip(jax_step):
    variables = jax_step[0]
    model = TwoViewXFMamba(**TINY)
    load_jax_variables(model, variables)
    back = export_jax_variables(model)
    for coll in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        got = jax.tree_util.tree_leaves_with_path(back[coll])
        assert len(got) == len(want)
        for path, value in got:
            np.testing.assert_array_equal(value, want[path], err_msg=str(path))


# ---------------------------------------------------------------------------
# repairs of the port against the JAX package
# ---------------------------------------------------------------------------

def test_droppath_draws_from_its_generator():
    """Repair 1: the masks come from the given generator, not the global
    RNG, and a rate-0 or eval DropPath is the identity."""
    x = torch.ones(64, 3)
    a = DropPath(0.5, torch.Generator().manual_seed(4)).train()
    b = DropPath(0.5, torch.Generator().manual_seed(4)).train()
    torch.manual_seed(0)
    ya = a(x)
    torch.manual_seed(1)
    assert torch.equal(ya, b(x))
    assert set(ya.unique().tolist()) <= {0.0, 2.0} and 0 < int((ya == 0).sum()) < 192
    assert DropPath(0.5, torch.Generator()).eval()(x) is x
    with pytest.raises(RuntimeError):
        DropPath(0.5).train()(x)


def test_shallow_fusion_shares_one_mask_across_views():
    """Repair 1: with a fixed generator, ShallowFusionBlock zeroes the
    residual branch of both views on the same samples, as the JAX DropPath
    on the tuple (y1, y2) does."""
    g = torch.Generator().manual_seed(0)
    blk = ShallowFusionBlock(32, drop_path=0.5, d_state=2, generator=g,
                             dropout_generator=torch.Generator().manual_seed(3)).train()
    x1, x2 = torch.randn(16, 2, 3, 32, generator=g), torch.randn(16, 2, 3, 32, generator=g)
    with torch.no_grad():
        y1, y2 = blk(x1, x2)
    kept1 = (y1 - x1).flatten(1).abs().amax(1) > 0
    kept2 = (y2 - x2).flatten(1).abs().amax(1) > 0
    assert torch.equal(kept1, kept2)
    assert 0 < int(kept1.sum()) < 16


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_backbone_draws_drop_path_scales_in_block_order(use_checkpoint, route):
    """The training backbone draws every block's two drop-path scales (SS2D
    half, then MLP half) from its dropout generator in block order, once per
    forward: the generator ends where a replay of those draws ends, and the
    features equal the plain blocks chained with the replayed scales (1e-5),
    on both routes: the stage path and its per-block (``use_checkpoint``)
    path, and the composable blocks with and without checkpointing."""
    g = torch.Generator().manual_seed(5)
    model = VSSM(depths=(3, 1), dims=8, in_chans=1, drop_path_rate=0.5, out_indices=(1,),
                 use_checkpoint=use_checkpoint, generator=torch.Generator().manual_seed(0),
                 dropout_generator=g).train()
    x = torch.randn(4, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        (got,) = model(x)
    replay = torch.Generator().manual_seed(5)
    blocks = [blk for layer in model.layers for blk in layer.blocks]
    for blk in blocks:
        blk.drop_path.generator = replay
    scales = [(blk.drop_path.scales(4), blk.drop_path.scales(4)) for blk in blocks]
    assert torch.equal(g.get_state(), replay.get_state())
    assert min(float(s.min()) for pair in scales for s in pair) == 0.0     # a branch dropped
    scales = iter(scales)
    with torch.no_grad():
        h = model.patch_embed(x)
        for layer in model.layers:
            B, H, W, d = h.shape
            hl = h.reshape(B, H * W, d)
            for blk in layer.blocks:
                m1, m2 = next(scales)
                hl = vss_block_ref(hl, pack_vss_block_params(blk, torch.float32), H, W, m1, m2)
            h = hl.reshape(B, H, W, d)
            if layer.downsample is not None:
                h = layer.downsample(h)
        assert_close(got, model.outnorm1(h), 1e-5)


def test_batchnorm_training_statistics():
    """Repair 2: in training mode BatchNorm normalises with the batch's
    statistics and moves the running ones with momentum 0.1, keeping the
    unbiased variance (torch); flax keeps the biased one, so the port's
    update of the variance is flax's times n / (n - 1)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 5, 8)).astype(np.float32)
    mean0 = rng.standard_normal(8).astype(np.float32)
    var0 = 1 + rng.random(8).astype(np.float32)
    import flax.linen as fnn
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jvars = {"params": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
             "batch_stats": {"mean": mean0, "var": var0}}
    y_ref, upd = jbn.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(8)
    bn.running_mean.copy_(T(mean0))
    bn.running_var.copy_(T(var0))
    y = bn.train()(T(x))
    n = 4 * 3 * 5
    assert_close(y.detach(), y_ref, 1e-5)
    assert_close(bn.running_mean, upd["batch_stats"]["mean"], 1e-6)
    assert_close(bn.running_var.numpy() - 0.9 * var0,
                 (np.asarray(upd["batch_stats"]["var"]) - 0.9 * var0) * n / (n - 1), 1e-6)
    with torch.no_grad():
        assert_close(bn.eval()(T(x)), (x - bn.running_mean.numpy()) /
                     np.sqrt(bn.running_var.numpy() + 1e-5), 1e-5)


def test_training_packing_chains_to_parameters():
    """Repair 3: the training packing stays on the autograd graph (A, the
    sum of Ds, transposes and casts included); the inference packing is
    detached."""
    blk = VSSBlock(16, ssm_conv_bias=True, generator=torch.Generator().manual_seed(0))
    p = pack_vss_block_train_params(blk, torch.float32)
    total = sum(getattr(p, n).sum() for n in SS2D_FIELDS)
    total.backward()
    grads = {k: v.grad for k, v in blk.named_parameters() if not k.startswith(("norm2", "mlp"))}
    assert all(g is not None for g in grads.values()), [k for k, g in grads.items() if g is None]
    A = -torch.exp(blk.op.A_logs.detach())
    assert_close(blk.op.A_logs.grad, A, 1e-6)        # d/dA_logs of sum(-exp(A_logs))
    assert_close(blk.op.Ds.grad, torch.ones_like(blk.op.Ds), 0)
    q = pack_vss_block_params(blk, torch.float32)
    assert not any(t.requires_grad for t in q.tensors() if t is not None)


def test_swapping_scan_backward_is_straight_through():
    """Repair 4: the swap's gradients pass through un-swapped, as the JAX
    custom VJP (not the true adjoint) does."""
    rng = np.random.default_rng(6)
    x, x2, g1, g2 = (rng.standard_normal((2, 3, 4, 6)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(jax_swapping_scan, jnp.asarray(x), jnp.asarray(x2))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    a, b = T(x).requires_grad_(), T(x2).requires_grad_()
    ya, yb = swapping_scan(a, b)
    torch.autograd.backward([ya, yb], [T(g1), T(g2)])
    assert_close(a.grad, want[0], 0)
    assert_close(b.grad, want[1], 0)
    assert_close(ya.detach(), np.where(np.arange(6) % 2 == 0, x2, x), 0)


def test_shallow_fusion_block_training_matches_flax():
    """Both BatchNorm calls in training mode and the ShallowFuse scans
    (kernels 2 and 7, plain) against the flax block, forward and
    gradients with respect to both inputs; float32, 2e-4."""
    jblk = JaxShallowFusionBlock(hidden_dim=32, d_state=2)
    rng = np.random.default_rng(7)
    z1, z2, g1, g2 = (rng.standard_normal((3, 2, 3, 32)).astype(np.float32) for _ in range(4))
    variables = jax_variables(jblk, 2, jnp.asarray(z1), jnp.asarray(z2))

    def f(a, b):
        return jblk.apply(variables, a, b, deterministic=False, mutable=["batch_stats"])[0]
    y_ref, vjp = jax.vjp(jax.jit(f), jnp.asarray(z1), jnp.asarray(z2))
    d_ref = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    blk = ShallowFusionBlock(32, d_state=2, dropout_generator=torch.Generator()).train()
    load_jax_variables(blk, variables)
    a, b = T(z1).requires_grad_(), T(z2).requires_grad_()
    y1, y2 = blk(a, b)
    torch.autograd.backward([y1, y2], [T(g1), T(g2)])
    for got, want in zip((y1.detach(), y2.detach(), a.grad, b.grad), (*y_ref, *d_ref)):
        assert_close(got, want, 2e-4)


# ---------------------------------------------------------------------------
# the train-loop helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["step", "cos", "none"])
def test_lr_schedule_matches_jax(scheduler):
    cfg = dict(lr=3e-4, scheduler=scheduler, step_size=4, gamma=0.5, epochs=10)
    mine, ref = loop.lr_schedule(TrainConfig(**cfg)), jax_lr_schedule(JaxTrainConfig(**cfg))
    for epoch in range(12):
        assert mine(epoch) == pytest.approx(float(ref(epoch)), rel=1e-12)


def test_losses_match_optax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((5, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 1, 0])
    multi = (rng.random((5, 3)) > 0.5).astype(np.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    bce = optax.sigmoid_binary_cross_entropy(logits, multi).mean()
    assert float(loop.cross_entropy_loss(T(logits), T(labels))) == pytest.approx(float(ce), rel=1e-6)
    assert float(loop.bce_with_logits_loss(T(logits), T(multi))) == pytest.approx(float(bce),
                                                                                  rel=1e-6)


def test_mixup_with_given_lambda_and_permutation():
    x = torch.arange(12.0).reshape(4, 3)
    y = torch.tensor([0, 1, 1, 0])
    perm = torch.tensor([2, 0, 3, 1])
    mx, my, lam = loop.mixup(x, y, torch.Generator(), num_classes=2, lam=0.25, perm=perm)
    assert lam == 0.25
    assert_close(mx, 0.25 * x + 0.75 * x[perm], 0)
    onehot = torch.nn.functional.one_hot(y, 2).float()
    assert_close(my, 0.25 * onehot + 0.75 * onehot[perm], 0)
    a = loop.mixup(x, y, torch.Generator().manual_seed(1), alpha=0.4, num_classes=2)
    b = loop.mixup(x, y, torch.Generator().manual_seed(1), alpha=0.4, num_classes=2)
    assert a[2] == b[2] and 0.0 <= a[2] <= 1.0 and torch.equal(a[0], b[0])


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizers_match_optax(name):
    """Two steps of each optimizer on the same gradients: torch's
    weight-decay semantics as the JAX package builds them with optax."""
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    gs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2)]
    cfg = dict(optimizer=name, lr=1e-2, weight_decay=1e-2)
    opt = jax_make_optimizer(JaxTrainConfig(**cfg))
    w, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    p = torch.nn.Parameter(T(w0.copy()))
    topt = loop.make_optimizer(TrainConfig(**cfg), [p])
    for g in gs:
        upd, state = opt.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
        p.grad = T(g)
        topt.step()
    assert_close(p.detach(), w, 1e-6)
    loop.set_lr(topt, 5e-3)
    assert all(group["lr"] == 5e-3 for group in topt.param_groups)
