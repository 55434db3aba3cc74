"""Checkpoints written by the PyTorch reference, through the port's
`cli.load_variables` and `checkpoint.convert` against the JAX package's
``cli.load_variables`` / ``convert_*_state_dict``, on the CPU in float32.

The weights of a tiny JAX model are drawn from a seed, brought into the
port with ``load_jax_variables`` and written in the reference's form: the
fusion blocks' dead ``self_attention.in_proj``, thop's ``total_ops`` /
``total_params``, VMamba's legacy backbone names (``ln_1``,
``self_attention``, ``patch_embed.proj`` / ``.norm``, a top-level ``norm.``
/ ``head.``), ``Linear2d`` weights stored as (out, in, 1, 1), no
``num_batches_tracked``, and an ``argparse.Namespace`` beside ``"model"``.
Both packages load the file: logits within 1e-4, every port tensor equal
to its leaf of JAX's converted tree, and a key that JAX refuses refused by
both."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from torch_reference_form import reference_form
from xfmamba_tpu.checkpoint import convert as jax_convert
from xfmamba_tpu.cli import load_variables as jax_load_variables
from xfmamba_tpu.models import vssm as jax_vssm
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu_torch.checkpoint import convert
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.cli import load_variables
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
TINY = dict(model_type="tiny", hidden_dim=128, d_state=4,
            backbone_overrides=dict(depths=(1, 1, 1, 1), dims=16))
VANILLA = dict(depths=(1, 1, 1, 1), dims=16, num_classes=5, ssm_d_state=4, ssm_ratio=2.0,
               ssm_act="silu", ssm_conv_bias=True, ssm_init="v0", forward_type="v0",
               mlp_ratio=0.0, drop_path_rate=0.0, patchembed_version="v1",
               downsample_version="v1")
def save_reference(path, sd) -> str:
    torch.save({"model": sd, "args": argparse.Namespace(model_name="twoviewxfmamba", epochs=3)},
               path)
    return str(path)


def assert_tensors_match_tree(model, tree):
    """Every port tensor equals its leaf of a JAX variables tree."""
    state = model.state_dict()
    for key, (jpath, to_port, _) in jax_paths(model).items():
        leaf = tree
        for name in jpath:
            leaf = leaf[name]
        np.testing.assert_array_equal(state[key].numpy(), to_port(np.asarray(leaf)), err_msg=key)


@pytest.fixture(scope="module")
def tiny_xfmamba():
    """(JAX model, its variables, the port model loaded from them)."""
    jmodel = JaxTwoView(**TINY)
    x = jnp.zeros((2, 32, 32, 1))
    variables = jax_variables(jmodel, 3, x, x)
    port = TwoViewXFMamba(**TINY).eval()
    load_jax_variables(port, variables)
    return jmodel, variables, port


def test_reference_xfmamba_checkpoint_loads_as_in_jax(tiny_xfmamba, tmp_path):
    """The same reference-form file through both CLIs' ``load_variables``:
    the converted tensors equal, the logits within 1e-4, the port's
    BatchNorm count its own."""
    jmodel, _, port = tiny_xfmamba
    sd = reference_form(port.state_dict(), np.random.default_rng(4))
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    path = save_reference(tmp_path / "xfmamba.pth", sd)
    jvars = jax_load_variables(path)
    fresh = TwoViewXFMamba(**TINY).eval()
    fresh.shallow_mamba_fusion.norm.num_batches_tracked.fill_(7)
    load_variables(path, fresh)
    assert int(fresh.shallow_mamba_fusion.norm.num_batches_tracked) == 7
    assert_tensors_match_tree(fresh, jvars)
    rng = np.random.default_rng(5)
    xa, xb = (rng.standard_normal((2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    want = jax.jit(jmodel.apply)(jvars, jnp.asarray(xa), jnp.asarray(xb))
    with torch.no_grad():
        got = fresh(T(xa), T(xb))
        direct = port(T(xa), T(xb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


def test_port_checkpoint_keeps_its_counts(tiny_xfmamba, tmp_path):
    """The port's own state dict (its ``last.pt`` form) loads through the
    converter with its ``num_batches_tracked``."""
    _, _, port = tiny_xfmamba
    state = {k: v.clone() for k, v in port.state_dict().items()}
    state["shallow_mamba_fusion.norm.num_batches_tracked"].fill_(11)
    path = tmp_path / "last.pt"
    torch.save({"model": state, "epoch": 2}, path)
    fresh = TwoViewXFMamba(**TINY).eval()
    load_variables(str(path), fresh)
    for k, v in state.items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("key, shape", [
    ("mamba_feature_extrac.layers.0.blocks.0.self_attention.bogus.weight", (4,)),
    ("mamba_feature_extrac.patch_embed.3.weight", (4,)),
    ("mamba_feature_extrac.layers.0.downsample.2.weight", (4,)),
    ("fusemamba.blocks.0.self_attention.gate.weight", (4, 4)),
    ("shallow_mamba_fusion.extra.bias", (4,)),
    ("unknown_head.weight", (2, 4)),
])
def test_refused_keys_raise_in_both(tiny_xfmamba, tmp_path, key, shape):
    """A key the JAX converter has no rule for: both packages raise, the
    port naming the key."""
    _, _, port = tiny_xfmamba
    sd = reference_form(port.state_dict(), np.random.default_rng(6))
    sd[key] = torch.zeros(shape)
    path = save_reference(tmp_path / "bad.pth", sd)
    with pytest.raises(KeyError):
        jax_load_variables(path)
    with pytest.raises(KeyError) as e:
        load_variables(path, TwoViewXFMamba(**TINY).eval())
    assert ".".join(key.split(".")[-2:]) in str(e.value)


def test_misshapen_or_missing_tensor_raises(tiny_xfmamba, tmp_path):
    """A converted checkpoint that lacks a tensor, or holds one of another
    shape, does not load."""
    _, _, port = tiny_xfmamba
    sd = reference_form(port.state_dict(), np.random.default_rng(7))
    del sd["final_conv.bias"]
    with pytest.raises(ValueError, match="final_conv.bias"):
        load_variables(save_reference(tmp_path / "a.pth", sd), TwoViewXFMamba(**TINY).eval())
    sd = reference_form(port.state_dict(), np.random.default_rng(7))
    sd["classifier.head.weight"] = sd["classifier.head.weight"][:, :3]
    with pytest.raises(ValueError, match="misshapen"):
        load_variables(save_reference(tmp_path / "b.pth", sd), TwoViewXFMamba(**TINY).eval())


@pytest.fixture(scope="module")
def tiny_vanilla():
    jmodel = jax_vssm.VSSM(**VANILLA)
    variables = jax_variables(jmodel, 9, jnp.zeros((1, 32, 32, 3)))
    port = vssm.VSSM(out_indices=None, **VANILLA).eval()
    load_jax_variables(port, variables)
    return jmodel, port


def test_convert_vssm_state_dict_matches_jax(tiny_vanilla, tmp_path):
    """A tiny vanilla VMamba classifier in the reference's legacy form
    (``patch_embed.proj``, ``ln_1``, ``self_attention``, top-level
    ``norm.`` / ``head.``, 4-D linear weights, thop counters): the same
    tensors and logits within 1e-4 through both converters."""
    jmodel, port = tiny_vanilla
    sd = reference_form(port.state_dict(), np.random.default_rng(10), prefix="")
    assert "norm.weight" in sd and "head.weight" in sd and "patch_embed.proj.weight" in sd
    path = save_reference(tmp_path / "vmamba.pth", sd)
    params = jax_convert.convert_vssm_state_dict(jax_convert.load_pth_state_dict(path))
    fresh = vssm.VSSM(out_indices=None, **VANILLA).eval()
    convert.load_reference_state_dict(
        fresh, convert.convert_vssm_state_dict(convert.load_pth_state_dict(path)))
    assert_tensors_match_tree(fresh, {"params": params})
    x = np.random.default_rng(11).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = fresh(T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    sd["layers.0.blocks.0.self_attention.nothing"] = torch.zeros(1)
    with pytest.raises(KeyError):
        jax_convert.convert_vssm_state_dict({k: v.numpy() for k, v in sd.items()})
    with pytest.raises(KeyError, match="nothing"):
        convert.convert_vssm_state_dict(sd)


def test_position_embedding_and_renamed_twins():
    """``pos_embed`` moves from the reference's (1, C, H, W) to the port's
    (1, H, W, C), as JAX's converter moves it; where a legacy name and its
    new name are both there, the later one wins in both."""
    pos = np.arange(2 * 3 * 4, dtype=np.float32).reshape(1, 2, 3, 4)
    got = convert.convert_vssm_state_dict({"pos_embed": T(pos)})["pos_embed"]
    want = jax_convert.convert_vssm_state_dict({"pos_embed": pos})["pos_embed"]
    np.testing.assert_array_equal(got.numpy(), want)
    twins = {"layers.0.blocks.0.norm.weight": np.zeros(4, np.float32),
             "layers.0.blocks.0.ln_1.weight": np.ones(4, np.float32)}
    want = jax_convert.convert_vssm_state_dict(twins)["stage0_block0"]["norm"]["scale"]
    got = convert.convert_vssm_state_dict({k: T(v) for k, v in twins.items()})
    assert list(got) == ["layers.0.blocks.0.norm.weight"]
    np.testing.assert_array_equal(got["layers.0.blocks.0.norm.weight"].numpy(), want)
