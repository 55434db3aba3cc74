"""Kernel 8's plain twin (``ops/vss_block_v1.py::vss_block_v1_phases_plain``:
the phases of the cooperative kernel ``csrc/vss_block_v1.cu``, its scans
through the kernel's two levels) against the block as a sequence of the
smaller kernels' plain versions (``vss_block_v1_plain``), against JAX's
``vss_block_ref`` and (``slow``) against the v1 Pallas kernel in interpret
mode.

Inputs and weights are numpy arrays from fixed seeds handed to both sides.
Errors are relative to the largest output magnitude: float32 against the
sequence to 1e-6 (the two levels reassociate the scan's products), against
JAX to 1e-4 (GEMM and LayerNorm sums in other orders); bfloat16 against JAX
to 5e-2 (rounding flips of the matmul operands chained through the block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.models.vssm import VSSBlock as JaxVSSBlock
from xfmamba_tpu.ops import vss_block_pallas as jax_v1
from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables
from xfmamba_tpu_torch.kernels.build import CSRC_DIR
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import vss_block_v1
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _block(d, conv_bias, seed):
    jblock = JaxVSSBlock(hidden_dim=d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias,
                         forward_type="v05_noz", mlp_ratio=4.0)
    params = jax_variables(jblock, seed, jnp.zeros((1, 6, 6, d)))["params"]
    port = VSSBlock(d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias).eval()
    load_jax_variables(port, {"params": params})
    return params, port


def _x(seed, n, H, W, d):
    return np.random.default_rng(seed).standard_normal((n, H * W, d)).astype(np.float32)


@pytest.mark.parametrize("n,H,W,d,conv_bias", [
    (2, 6, 5, 16, False), (2, 7, 9, 16, True), (2, 14, 14, 32, False),
    (1, 20, 3, 16, True), (3, 5, 6, 16, False), (1, 33, 17, 16, True)])
def test_kernel8_twin_matches_the_sequence(n, H, W, d, conv_bias):
    """The twin against `vss_block_v1_plain` in float32, 1e-6: square and
    non-square maps, one chunk of image rows per kind and several (20 x 3
    and 33 x 17: two rows or columns a chunk, a ragged last chunk)."""
    _, port = _block(d, conv_bias, seed=n + H)
    p = vss_block_v1.pack_vss_block_v1_params(port, torch.float32)
    x = T(_x(H * W, n, H, W, d))
    got = vss_block_v1.vss_block_v1_phases_plain(x, p, H, W)
    assert _rel(got, vss_block_v1.vss_block_v1_plain(x, p, H, W).numpy()) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("H,W", [(6, 5), (7, 7)])
def test_kernel8_twin_matches_jax_block_ref(H, W, dtype, tol):
    """The twin against JAX's ``vss_block_ref`` (the v1 kernel's op order
    and casts) at d 16, 2 images, on a non-square and a square map."""
    params, port = _block(16, True, seed=7)
    x = _x(11, 2, H, W, 16)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(jax_v1.vss_block_ref, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x, jdtype), params, H, W, True, True)
    p = vss_block_v1.pack_vss_block_v1_params(port, dtype)
    got = vss_block_v1.vss_block_v1_phases_plain(T(x).to(dtype), p, H, W)
    assert got.dtype == dtype
    assert _rel(got, want) <= tol


def test_kernel8_wrapper_takes_the_twin_on_the_cpu():
    _, port = _block(16, False, seed=2)
    p = vss_block_v1.pack_vss_block_v1_params(port, torch.bfloat16)
    x = T(_x(4, 2, 6, 5, 16)).to(torch.bfloat16)
    before = vss_block_v1.vss_block_v1.launches
    assert torch.equal(vss_block_v1.vss_block_v1(x, p, 6, 5),
                       vss_block_v1.vss_block_v1_phases_plain(x, p, 6, 5))
    assert vss_block_v1.vss_block_v1.launches == before


def test_kernel8_phase_names_match_the_kernel():
    """`PHASES` names the kernel's phases, one per stamp interval."""
    src = (CSRC_DIR / "vss_block_v1.cu").read_text()
    count = int(src.split("constexpr int kV1Phases = ")[1].split(";")[0])
    assert len(vss_block_v1.PHASES) == count


@pytest.mark.slow
def test_kernel8_twin_matches_the_pallas_kernel():
    """Against ``_vss_block_call(..., interpret=True)`` (the v1 Pallas
    kernel, its Hillis-Steele scans and erf GELU) on an 8 x 6 map, two
    images in one group, float32: 1e-4 of the largest output."""
    params, port = _block(16, True, seed=5)
    H, W = 8, 6
    x = _x(6, 2, H, W, 16)
    packed = jax_v1.pack_vss_block_params(params, jnp.float32, True)
    want = jax_v1._vss_block_call(jnp.asarray(x), *packed, H=H, W=W, conv_bias=True,
                                  fuse_mlp=True, interpret=True, group=2)
    got = vss_block_v1.vss_block_v1_phases_plain(
        T(x), vss_block_v1.pack_vss_block_v1_params(port, torch.float32), H, W)
    assert _rel(got, want) <= 1e-4


def test_inference_operands_are_packed_once(monkeypatch):
    """After `pack_for_inference` the model keeps each block's kernel-8
    operands while its parameters stay as they are: a second forward packs
    nothing, an in-place change of a weight (an optimizer step, a loaded
    checkpoint) packs again, and the output follows the new weights."""
    packs = [0]
    pack = vssm.pack_vss_block_v1_params

    def counting(*args):
        packs[0] += 1
        return pack(*args)

    monkeypatch.setattr(vssm, "pack_vss_block_v1_params", counting)
    small = dict(model_type="tiny", hidden_dim=128, d_state=4,
                 backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16))
    model = TwoViewXFMamba(generator=torch.Generator().manual_seed(0), **small).eval()
    model.pack_for_inference()
    xa, xb = (torch.randn(1, 56, 56, 1, generator=torch.Generator().manual_seed(s)).to(
        torch.bfloat16) for s in (1, 2))
    with torch.no_grad():
        first = model(xa, xb)
        n = packs[0]
        assert n == 4                       # stages 0 and 1: two blocks each
        assert torch.equal(model(xa, xb), first) and packs[0] == n
        block = model.mamba_feature_extrac.layers[0].blocks[0]
        block.op.out_proj.weight.mul_(2.0)
        changed = model(xa, xb)
    assert packs[0] == n + 1 and not torch.equal(changed, first)
    fresh = TwoViewXFMamba(generator=torch.Generator().manual_seed(0), **small).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(fresh(xa, xb), changed)


def test_data_writes_reach_the_eval_forward(monkeypatch):
    """Writes through ``.data`` (``mul_``, ``copy_``, ``normal_``) change no
    storage or version counter, so a kept operand would go stale: by
    default each eval forward packs anew and returns the logits of a fresh
    model loaded with the same ``state_dict()``; `pack_for_inference`
    keeps the operands (no packing at the next forward), and
    ``load_state_dict`` and ``train`` drop them."""
    packs = [0]
    pack = vssm.pack_vss_block_v1_params

    def counting(*args):
        packs[0] += 1
        return pack(*args)

    monkeypatch.setattr(vssm, "pack_vss_block_v1_params", counting)
    small = dict(model_type="tiny", hidden_dim=128, d_state=4,
                 backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16))
    model = TwoViewXFMamba(generator=torch.Generator().manual_seed(0), **small).eval()
    xa, xb = (torch.randn(1, 56, 56, 1, generator=torch.Generator().manual_seed(s)).to(
        torch.bfloat16) for s in (3, 4))

    def fresh_logits(state):
        fresh = TwoViewXFMamba(generator=torch.Generator().manual_seed(9), **small).eval()
        fresh.load_state_dict(state)
        with torch.no_grad():
            return fresh(xa, xb)

    blocks = model.mamba_feature_extrac.layers[0].blocks
    with torch.no_grad():
        before = model(xa, xb)
        blocks[0].op.out_proj.weight.data.mul_(2.0)
        blocks[1].mlp.fc1.weight.data.copy_(torch.randn(
            blocks[1].mlp.fc1.weight.shape, generator=torch.Generator().manual_seed(5)))
        blocks[1].op.x_proj_weight.data.normal_(generator=torch.Generator().manual_seed(6))
        after = model(xa, xb)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh_logits(model.state_dict()))
    # kept after the explicit call; load_state_dict and train drop them
    model.pack_for_inference()
    with torch.no_grad():
        assert torch.equal(model(xa, xb), after)
        n = packs[0]
        assert torch.equal(model(xa, xb), after) and packs[0] == n
        state = fresh_logits(model.state_dict()), {
            k: v.clone() for k, v in model.state_dict().items()}
        blocks[0].op.out_proj.weight.data.mul_(0.5)
        model.load_state_dict(state[1])
        assert torch.equal(model(xa, xb), state[0]) and packs[0] > n
    model.pack_for_inference()
    with torch.no_grad():
        model(xa, xb)
        blocks[0].op.out_proj.weight.data.mul_(0.5)
        model.train().eval()
        assert torch.equal(model(xa, xb), fresh_logits(model.state_dict()))


def test_eval_keeps_the_operands(monkeypatch):
    """``eval()`` changes no weight, so it keeps what `pack_for_inference`
    packed: ``model.pack_for_inference().eval()`` packs once, at its first
    forward, and not again; ``train()`` drops the operands."""
    packs = [0]
    pack = vssm.pack_vss_block_v1_params

    def counting(*args):
        packs[0] += 1
        return pack(*args)

    monkeypatch.setattr(vssm, "pack_vss_block_v1_params", counting)
    small = dict(model_type="tiny", hidden_dim=128, d_state=4,
                 backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16))
    model = TwoViewXFMamba(generator=torch.Generator().manual_seed(0), **small)
    model.pack_for_inference().eval()
    xa, xb = (torch.randn(1, 56, 56, 1, generator=torch.Generator().manual_seed(s)).to(
        torch.bfloat16) for s in (7, 8))
    with torch.no_grad():
        first = model(xa, xb)
        assert packs[0] == 4                # stages 0 and 1: two blocks each
        model.eval()
        assert torch.equal(model(xa, xb), first) and packs[0] == 4
        model.train()
        model.eval()
        assert torch.equal(model(xa, xb), first) and packs[0] == 8
