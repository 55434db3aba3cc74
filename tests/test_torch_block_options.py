"""The VSSBlock and VSSM options in the port against the JAX package on the
CPU: the gated MLP, ``mlp_act``, MLP-only blocks (``ssm_ratio`` 0), blocks
without the MLP half, ``patch_norm``, ``posembed`` and the drop rates
(eval logits and parameter gradients against ``jax.vjp``; in training the
dropout masks come from the port's generator), ``post_norm`` against
VMamba's formula (the JAX block cannot build one: named below), the
stage-kernel rule against JAX's conditions over a grid of options, kernels
1 and 8's plain versions without the MLP half against JAX's
``vss_block_ref(..., fuse_mlp=False)``, a bfloat16 backbone without MLP on
the stage routes, ``backbone_vssm`` with every JAX option, and the weight
bridge both ways for models with every new option.  Float32 tolerances
1e-5 (logits) and 1e-4 (gradients, block twins); bfloat16 5e-2.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.models import fusion as jfusion
from xfmamba_tpu.models import vssm as jvssm
from xfmamba_tpu.models.ss2d import SS2D as JaxSS2D
from xfmamba_tpu.ops import vss_block_pallas as jax_vbp
from xfmamba_tpu_torch.checkpoint.convert import (
    export_jax_variables, jax_paths, load_jax_variables)
from xfmamba_tpu_torch.models import fusion as pfusion
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops import vss_block, vss_block_v1, vss_stage
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
IMAGE = 32
TINY = dict(depths=(1, 1, 1, 1), dims=16, num_classes=5, drop_path_rate=0.0, ssm_d_state=1,
            ssm_ratio=2.0, forward_type="v05_noz", mlp_ratio=2.0, ssm_conv_bias=False)


def _rel(got, want):
    got = torch.as_tensor(np.array(torch.as_tensor(got).float())).double()
    want = torch.as_tensor(np.array(jnp.asarray(want, jnp.float32))).double()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _images(seed, n=2):
    return np.random.default_rng(seed).standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)


def _pair(seed, **options):
    """A tiny JAX VSSM classifier with ``options``, its variables from a
    numpy seed, and the port model loaded from them."""
    cfg = TINY | options
    jmodel = jvssm.VSSM(**cfg)
    variables = jax_variables(jmodel, seed, jnp.zeros((1, IMAGE, IMAGE, 3)))
    port = vssm.VSSM(out_indices=None, **cfg)
    load_jax_variables(port, variables)
    return jmodel, variables, port


# each VSSBlock / VSSM option on its own, and some together
OPTIONS = [dict(gmlp=True, mlp_act="silu"), dict(mlp_act="relu", patch_norm=False),
           dict(posembed=True, imgsize=IMAGE, patchembed_version="v1", patch_norm=False),
           dict(ssm_ratio=0.0), dict(mlp_ratio=0.0),
           dict(ssm_drop_rate=0.1, mlp_drop_rate=0.1, gmlp=True),
           dict(forward_type="v2", ssm_d_state=4, mlp_act="sigmoid")]


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(map(str, o.items())))
def test_vssm_options_match_jax(options):
    """Eval logits against the JAX model with the same options (1e-5)."""
    jmodel, variables, port = _pair(3, **options)
    x = _images(4)
    logits = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(port.eval()(T(x)), logits) <= 1e-5
    blk = port.layers[0].blocks[0]
    assert (blk.op is None) == (options.get("ssm_ratio") == 0.0)
    assert (blk.mlp is None) == (options.get("mlp_ratio") == 0.0)


# the options together, where they can be: the gated MLP of activation
# silu, the position embedding, no patch norm; MLP-only blocks
GRAD_OPTIONS = [dict(gmlp=True, mlp_act="silu", posembed=True, imgsize=IMAGE,
                     patch_norm=False),
                pytest.param(dict(ssm_ratio=0.0, mlp_act="relu"), marks=pytest.mark.slow)]


@pytest.mark.parametrize("options", GRAD_OPTIONS, ids=["gmlp-posembed", "mlp-only"])
def test_vssm_option_gradients_match_jax(options):
    """Every parameter gradient of sum(logits * g) (1e-4) against
    ``jax.vjp`` of the JAX model with the same options."""
    jmodel, variables, port = _pair(3, **options)
    x = _images(4)
    g = np.random.default_rng(5).standard_normal((2, 5)).astype(np.float32)

    def logits_and_grads(v, x, g):
        logits, vjp = jax.vjp(lambda v: jmodel.apply({"params": v}, x), v)
        return logits, vjp(g)[0]

    logits, grads = jax.jit(logits_and_grads)(variables["params"], jnp.asarray(x),
                                              jnp.asarray(g))
    out = port.eval()(T(x))
    assert _rel(out.detach(), logits) <= 1e-5
    out.backward(T(g))
    params = dict(port.named_parameters())
    assert len(params) == len(jax_paths(port))
    for key, (jpath, to_port, _) in jax_paths(port).items():
        assert _rel(params[key].grad, to_port(np.asarray(_leaf(grads, jpath[1:])))) <= 1e-4, key


def test_dropout_masks_come_from_the_generator():
    """Drop rates above 0: in training the masks are drawn from the model's
    dropout generator (the same seed, the same logits; the global
    generator untouched; other logits than eval's), in eval mode none."""
    def model(seed):
        return vssm.VSSM(out_indices=None, generator=torch.Generator().manual_seed(0),
                         dropout_generator=torch.Generator().manual_seed(seed),
                         **(TINY | dict(ssm_drop_rate=0.2, mlp_drop_rate=0.2)))

    x = T(_images(6))
    a, b, c = model(1).train(), model(1).train(), model(2).train()
    state = torch.random.get_rng_state()
    with torch.no_grad():
        ya, yb, yc = a(x), b(x), c(x)
        ye = a.eval()(x)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(ya, yb) and not torch.equal(ya, yc) and not torch.equal(ya, ye)
    with pytest.raises(RuntimeError, match="Generator"):
        vssm.VSSM(out_indices=None, **(TINY | dict(mlp_drop_rate=0.2))).train()(x)


def test_post_norm_follows_vmamba():
    """``post_norm``: x + norm(op(x)), then x + norm2(mlp(x)) (VMamba's
    ``VSSBlock._forward``).  The JAX block with ``post_norm`` makes a second
    submodule named ``norm`` (``vssm.py:253-255``), which flax refuses: the
    port does not follow it there."""
    port = vssm.VSSBlock(16, ssm_d_state=1, mlp_ratio=2.0, post_norm=True,
                         generator=torch.Generator().manual_seed(1)).eval()
    x = torch.randn(2, 5, 6, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        h = x + port.norm(port.op(x))
        want = h + port.norm2(port.mlp(h))
        torch.testing.assert_close(port(x), want, rtol=0, atol=0)
        pre = vssm.VSSBlock(16, ssm_d_state=1, mlp_ratio=2.0,
                            generator=torch.Generator().manual_seed(1)).eval()
        assert not torch.allclose(pre(x), want)
    jblock = jvssm.VSSBlock(hidden_dim=16, ssm_d_state=1, forward_type="v05_noz",
                            post_norm=True)
    with pytest.raises(Exception, match="norm"):
        jblock.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 6, 16)))
    assert vssm.VSSM(post_norm=True, **TINY).stage_kernels is False


def _jax_conditions(o):
    """JAX's conditions (``vssm.py:149-153, :192-197, :322-327, :364-370``)
    for the stage route (eval), the per-block training kernels and the
    stage-training kernel; post_norm is tested by JAX's block routes
    only, and the port refuses it on every route (the JAX block cannot
    build it)."""
    base = (o["forward_type"] == "v05_noz" and o["ssm_d_state"] == 1 and o["ssm_ratio"] > 0
            and o["ssm_act"] == "silu" and o["ssm_conv"] == 3 and not o["gmlp"]
            and o["mlp_act"] == "gelu" and not o["post_norm"])
    train = base and o["ssm_drop_rate"] == 0.0 and o["mlp_drop_rate"] == 0.0
    return base, train, train and o["mlp_ratio"] > 0


GRID = dict(forward_type=["v05_noz", "v2"], ssm_d_state=[1, 4], ssm_ratio=[2.0, 0.0],
            ssm_act=["silu", "gelu"], ssm_conv=[3, 5], gmlp=[False, True],
            mlp_act=["gelu", "silu"], post_norm=[False, True], mlp_ratio=[4.0, 0.0],
            ssm_drop_rate=[0.0, 0.1], mlp_drop_rate=[0.0, 0.1])


def test_stage_kernel_rule_matches_jax_conditions():
    """`stage_kernels_apply` and the training terms of `VSSM` over every
    option one at a time off the kernels' configuration, and pairs."""
    names = list(GRID)
    base = {k: v[0] for k, v in GRID.items()}
    cases = [base] + [base | {k: GRID[k][1]} for k in names] + \
        [base | {a: GRID[a][1], b: GRID[b][1]} for a, b in itertools.combinations(names, 2)]
    for o in cases:
        got = vssm.stage_kernels_apply(o["forward_type"], o["ssm_d_state"], o["ssm_act"],
                                       o["ssm_conv"], o["mlp_ratio"], ssm_ratio=o["ssm_ratio"],
                                       gmlp=o["gmlp"], mlp_act=o["mlp_act"],
                                       post_norm=o["post_norm"])
        want = _jax_conditions(o)
        assert got == want[0], o
        if o["ssm_ratio"] > 0 and o["forward_type"] == "v05_noz" and o["ssm_d_state"] == 1:
            m = vssm.VSSM(depths=(2, 1, 1, 1), dims=16, **{k: v for k, v in o.items()
                                                            if k not in ("ssm_conv",)},
                          ssm_conv=o["ssm_conv"])
            assert (m.stage_kernels, m.train_kernels,
                    m.train_kernels and m.stage_train_mlp) == want, o


def _block(d, mlp_ratio, conv_bias, seed):
    jblock = jvssm.VSSBlock(hidden_dim=d, ssm_d_state=1, ssm_ratio=2.0,
                            ssm_conv_bias=conv_bias, forward_type="v05_noz",
                            mlp_ratio=mlp_ratio)
    params = jax_variables(jblock, seed, jnp.zeros((1, 6, 6, d)))["params"]
    port = vssm.VSSBlock(d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias,
                         mlp_ratio=mlp_ratio).eval()
    load_jax_variables(port, {"params": params})
    return params, port


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_no_mlp_kernel_twins_match_jax_block_ref(dtype, tol):
    """Kernels 1 and 8's plain versions of a block without its MLP half
    (the operands' MLP fields None) against JAX's ``vss_block_ref(...,
    fuse_mlp=False)``, 2 images of 7 x 6."""
    params, port = _block(16, 0.0, True, seed=9)
    H, W = 7, 6
    x = np.random.default_rng(1).standard_normal((2, H * W, 16)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(jax_vbp.vss_block_ref, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x, jdtype), params, H, W, True, False)
    xt = T(x).to(dtype)
    p = vss_block.pack_vss_block_params(port, dtype)
    assert all(getattr(p, n) is None for n in vss_block.MLP_FIELDS)
    got1 = vss_stage.vss_stage(xt, [p], H, W)
    p8 = vss_block_v1.pack_vss_block_v1_params(port, dtype)
    got8 = vss_block_v1.vss_block_v1(xt, p8, H, W)
    assert got1.dtype == got8.dtype == dtype
    assert _rel(got1, want) <= tol and _rel(got8, want) <= tol
    assert _rel(vss_block_v1.vss_block_v1_plain(xt, p8, H, W), want) <= tol
    with torch.no_grad():
        composable = port(T(x).view(2, H, W, 16)).view(2, H * W, 16)
    assert _rel(composable, want if dtype == torch.float32 else
                jax.jit(jax_vbp.vss_block_ref, static_argnums=(2, 3, 4, 5))(
                    jnp.asarray(x), params, H, W, True, False)) <= 1e-4


def test_no_mlp_bfloat16_backbone_takes_the_stage_routes(monkeypatch):
    """A bfloat16 v05_noz backbone with ``mlp_ratio`` 0: eval stages on
    kernel 1 (an aligned batch) and kernel 8 (one image, stage 2), the
    logits within 5e-2 of JAX's float32 ones; a training step runs kernels
    4 -> 6 per block (``vss_block_train_op``) and no stage-training kernel
    (kernel 5 needs the MLP half)."""
    jmodel, variables, port = _pair(7, mlp_ratio=0.0, depths=(2, 2, 2, 2))
    calls = {"stage": 0, "v1": 0, "block_train": 0, "stage_train": 0}

    def counting(mod, name, key):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.__setitem__(key, calls[key] + 1)
                            or real(*a, **k))

    counting(vssm, "vss_stage", "stage")
    counting(vssm, "vss_block_v1", "v1")
    counting(vssm, "vss_block_train_op", "block_train")
    counting(vssm, "vss_stage_train", "stage_train")
    assert port.stage_kernels and port.train_kernels and not port.stage_train_mlp
    apply = jax.jit(jmodel.apply)
    for n in (8, 1):
        x = _images(8, n)
        want = apply(variables, jnp.asarray(x))
        port.eval()
        with torch.no_grad():
            got = port(T(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16 and _rel(got, want) <= 5e-2
    assert calls["stage"] >= 4 and calls["v1"] >= 1
    port.train()
    out = port(T(_images(9, 2)).to(torch.bfloat16))
    out.float().sum().backward()
    assert calls["block_train"] == 8 and calls["stage_train"] == 0
    assert all(p.grad is not None for p in port.parameters())


def test_backbone_vssm_takes_every_jax_option():
    """``backbone_vssm`` with the JAX factory's every option (its defaults
    changed where an option has two values): the same tree as JAX's and the
    same features."""
    options = dict(ssm_d_state=1, ssm_dt_rank="auto", ssm_act="silu", ssm_conv=3,
                   ssm_conv_bias=True, ssm_drop_rate=0.1, ssm_init="v0",
                   forward_type="v05_noz", mlp_ratio=2.0, mlp_act="silu", mlp_drop_rate=0.1,
                   gmlp=True, patch_norm=False, downsample_version="v2",
                   patchembed_version="v1", posembed=True, imgsize=IMAGE)
    geometry = dict(depths=(1, 1, 1, 1), dims=8, drop_path_rate=0.0, ssm_ratio=2.0,
                    out_indices=(1, 3))
    jmodel = jvssm.backbone_vssm(**geometry, **options)
    variables = jax_variables(jmodel, 2, jnp.zeros((1, IMAGE, IMAGE, 3)))
    port = vssm.backbone_vssm(**geometry, device="cpu", **options)
    load_jax_variables(port, variables)
    x = _images(3)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(T(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def _round_trip(port, variables):
    load_jax_variables(port, variables)
    back = export_jax_variables(port)
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[path]), np.asarray(leaf),
                                      err_msg=str(path))


def test_weight_bridge_round_trip_with_every_new_option():
    """JAX variables -> port -> JAX, bit for bit: a VSSM with the gated MLP
    (fc1 of twice the hidden width), ``pos_embed``, no patch norm and m0
    blocks with their z-gate (in_proj of 2 d_inner); CrossSS2Dv2
    (``in_proj_sec``) and CrossSS2Dv3; an m0 SS2D with its ``ssm_state``."""
    cfg = TINY | dict(gmlp=True, posembed=True, imgsize=IMAGE, patch_norm=False,
                      forward_type="m0", ssm_d_state=8, ssm_ratio=1.0, ssm_init="v2")
    jmodel = jvssm.VSSM(**cfg)
    _round_trip(vssm.VSSM(out_indices=None, **cfg),
                jax_variables(jmodel, 1, jnp.zeros((1, IMAGE, IMAGE, 3))))
    blk = vssm.VSSM(out_indices=None, **cfg).layers[0].blocks[0]
    assert blk.mlp.fc1.weight.shape[0] == 2 * blk.mlp.fc2.weight.shape[1]
    assert blk.op.in_proj.weight.shape[0] == 2 * blk.op.d_inner
    z = jnp.zeros((1, 5, 5, 16))
    for name in ("CrossSS2Dv2", "CrossSS2Dv3"):
        _round_trip(getattr(pfusion, name)(16, d_state=4),
                    jax_variables(getattr(jfusion, name)(d_model=16, d_state=4), 2, z, z))
    jss = JaxSS2D(d_model=16, d_state=8, ssm_ratio=1.0, forward_type="m0_noz",
                  initialize="v2", with_initial_state=True)
    shapes = jax.eval_shape(jss.init, jax.random.PRNGKey(0), z)
    variables = jax_variables(jss, 3, z)
    variables["ssm_state"] = {"initial_state": np.random.default_rng(0).standard_normal(
        shapes["ssm_state"]["initial_state"].shape).astype(np.float32)}
    holder = torch.nn.Module()
    holder.op = SS2D(16, d_state=8, ssm_ratio=1.0, forward_type="m0_noz", initialize="v2",
                     with_initial_state=True)
    _round_trip(holder, {k: {"op": v} for k, v in variables.items()})
