"""Single-study and unaligned-batch inference (kernels 8 and 9) on the CPU
against the JAX package: the routing rules the port copies, the route a
model takes, the plain twins of kernels 8 and 9 against JAX's
``vss_block_ref`` and composable core (and, under ``slow``, against the
Pallas kernels in interpret mode), and a small XFMamba's logits at one and
three studies per batch in both dtypes.

Which kernel the JAX accelerator path picks is read from JAX's own code:
the model is traced with ``jax.eval_shape`` with the backend reported as a
TPU and the kernel entry points replaced by recorders.  Inputs are numpy
arrays from a seed handed to both sides; tolerances are stated per test.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import assert_close, jax_variables
from xfmamba_tpu.models.fusion import CrossSS2Dv5 as JaxCross
from xfmamba_tpu.models.fusion import ShallowFuseSS2Dv4 as JaxShallow
from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.models.vssm import VSSM as JaxVSSM
from xfmamba_tpu.models.vssm import VSSBlock as JaxVSSBlock
from xfmamba_tpu.ops import vss_block_pallas as jax_v1
from xfmamba_tpu.ops import vss_block_pallas_v2 as jax_v2
from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables
from xfmamba_tpu_torch.models import fusion, vssm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import nk_scan, nk_scan_v1, ss2d_core_n1, vss_block_v1, vss_stage

T = torch.from_numpy
# a small XFMamba whose 56 x 56 views give maps 14, 7, 4, 2: at one or
# three studies stages 0 and 1 take kernel 8, stage 2 kernel 1 and the 2 x 2
# stage 3 the composable blocks; both fusion scans take kernel 9
SMALL = dict(model_type="tiny", hidden_dim=128, d_state=4,
             backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16))
IMAGE = 56
# (model, stage maps (H, d, depth), d_inner ratio): XFMamba-S, -B and -T
MODELS = {"small": ([(56, 96, 2), (28, 192, 2), (14, 384, 15), (7, 768, 2)], 2),
          "base": ([(56, 128, 2), (28, 256, 2), (14, 512, 15), (7, 1024, 2)], 2),
          "tiny": ([(56, 96, 2), (28, 192, 2), (14, 384, 8), (7, 768, 2)], 1)}


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


# ---------------------------------------------------------------------------
# the copied rules against JAX's functions
# ---------------------------------------------------------------------------

MAPS = ((56, 56), (28, 28), (14, 14), (7, 7), (4, 4), (2, 2), (1, 1), (8, 8), (2, 5), (3, 16))
WIDTHS = (16, 96, 128, 192, 256, 384, 512, 768, 1024)
BATCHES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64)


@pytest.mark.parametrize("ratio", [1, 2])
def test_backbone_rules_match_jax(ratio):
    """``pick_group_v2`` (with the full and the stage path's budget),
    ``_vmem_estimate_v2``, ``fused_vss_block_supported``, ``pick_group`` and
    ``_vmem_estimate`` equal JAX's on a grid of (B, H, W, d), d_inner =
    ratio x d, MLP 4d."""
    for B, (H, W), d in itertools.product(BATCHES, MAPS, WIDTHS):
        di, hd = ratio * d, 4 * d
        budget = jax_v2._VMEM_BUDGET_V2 - vss_stage.stage_weight_bytes(d, di, hd)
        assert vss_stage._VMEM_BUDGET_V2 == jax_v2._VMEM_BUDGET_V2
        assert vss_stage.pick_group_v2(B, H, W, d, di, hd) == \
            jax_v2.pick_group_v2(B, H, W, d, di, hd), (B, H, W, d)
        assert vss_stage.pick_group_v2(B, H, W, d, di, hd, budget_bytes=budget) == \
            jax_v2.pick_group_v2(B, H, W, d, di, hd, budget_bytes=budget), (B, H, W, d)
        assert vss_block_v1.fused_vss_block_supported(H, W, d, di, hd) == \
            jax_v1.fused_vss_block_supported(H, W, d, di, hd), (H, W, d)
        assert vss_block_v1.pick_group(B, H, W, d, di, hd) == \
            jax_v1.pick_group(B, H, W, d, di, hd), (B, H, W, d)
        for G in (1, 2, 4, 8):
            assert vss_stage._vmem_estimate_v2(H * W, d, di, hd, G, True) == \
                jax_v2._vmem_estimate_v2(H * W, d, di, hd, G, True)
            assert vss_block_v1._vmem_estimate(H, W, d, di, hd, G, True) == \
                jax_v1._vmem_estimate(H, W, d, di, hd, G, True)


def _jax_stage_outcome(B, H, W, d, di, hd, depth):
    """JAX's accelerator-path choice for a bfloat16 inference stage, from
    JAX's own functions in the order of ``VSSM._fused_stage_path`` and
    ``VSSBlock._fused_path`` (``models/vssm.py:142-180, :315-343``)."""
    wbytes = 2 * (2 * d * di + 2 * d * hd + 3 * di * di // 4) * 2
    if depth >= 2 and jax_v2.pick_group_v2(
            B, H, W, d, di, hd, budget_bytes=jax_v2._VMEM_BUDGET_V2 - wbytes) is not None:
        return "stage"
    if not jax_v1.fused_vss_block_supported(H, W, d, di, hd):
        return "composable"
    if jax_v2.pick_group_v2(B, H, W, d, di, hd) is not None:
        return "block_v2"
    return "v1"


# the port's route for each of JAX's outcomes: JAX's per-block v2 kernel
# computes what kernel 1 computes, so the port keeps kernel 1 there
PORT_ROUTE = {"stage": "stage", "block_v2": "stage", "v1": "v1", "composable": "composable"}


@pytest.mark.parametrize("size", ["small", "base", "tiny"])
def test_model_routes_match_jax(size):
    """`stage_route` against JAX's outcome at every stage of XFMamba-S, -B
    and -T for 1 to 32 studies (the backbone sees 2B images), and the
    fusion scans' rules, which have no dtype term; XFMamba-S's table:
    kernel 8 at stages 2-3 for 1 and 3 studies, at stage 3 for 2 and 6,
    kernel 9 in both fusion ops up to 12 studies."""
    stages, ratio = MODELS[size]
    for B in range(1, 33):
        got, want = [], []
        for H, d, depth in stages:
            args = (2 * B, H, H, d, ratio * d, 4 * d, depth)
            got.append(vss_stage.stage_route(*args))
            want.append(PORT_ROUTE[_jax_stage_outcome(*args)])
        assert got == want, (size, B)
        v1_fusion = not nk_scan_v1.shallow_takes_v2(B, 49, 7)
        assert v1_fusion == (nk_scan_v1.cross_v2_group(3 * B, 7, 7) is None) == (B % 8 != 0)
        table = {1: 2, 3: 2, 2: 1, 6: 1, 4: 0, 12: 0, 8: 0, 16: 0, 32: 0}
        if size == "small" and B in table:
            assert got.count("v1") == table[B] and got[4 - table[B]:] == ["v1"] * table[B]
    if size == "base":     # stage 3 at four or more studies: JAX's per-block v2 kernel
        assert _jax_stage_outcome(8, 7, 7, 1024, 2048, 4096, 2) == "block_v2"


class _Recorder:
    """Replaces JAX kernel entry points during a trace and records which
    one ran, with its ``group``."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.mp = monkeypatch
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def replace(self, module, name, out):
        def fn(*args, **kw):
            self.calls.append((name, kw.get("group")))
            return out(*args)
        self.mp.setattr(module, name, fn)


@pytest.mark.parametrize("B", [2, 4, 6, 8])
def test_backbone_route_matches_the_traced_jax_model(monkeypatch, B):
    """A JAX bfloat16 VSSM (maps 14, 7, 4, 2) traced on the accelerator
    path: the kernels it calls, stage by stage, are the outcomes of
    `_jax_stage_outcome`, which the port's `stage_route` follows."""
    rec = _Recorder(monkeypatch)
    rec.replace(jax_v2, "vss_stage_fused_v2", lambda x, *a: x)
    rec.replace(jax_v2, "vss_block_fused_v2", lambda x, *a: x)
    rec.replace(jax_v1, "vss_block_fused", lambda x, *a: x)
    model = JaxVSSM(depths=(2, 2, 2, 2), dims=16, ssm_ratio=1.0, forward_type="v05_noz",
                    ssm_d_state=1, ssm_conv_bias=False, out_indices=(3,), dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((B, IMAGE, IMAGE, 3), jnp.bfloat16)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    jax.eval_shape(model.apply, variables, x)
    calls = {"stage": ["vss_stage_fused_v2"], "block_v2": ["vss_block_fused_v2"] * 2,
             "v1": ["vss_block_fused"] * 2, "composable": []}
    want = []
    for i, H in enumerate((14, 7, 4, 2)):
        d = 16 * 2 ** i
        outcome = _jax_stage_outcome(B, H, H, d, d, 4 * d, 2)
        assert vss_stage.stage_route(B, H, H, d, d, 4 * d, 2) == PORT_ROUTE[outcome]
        want += calls[outcome]
    assert [name for name, _ in rec.calls] == want


@pytest.mark.parametrize("B,H,W", [(1, 7, 7), (2, 7, 7), (3, 7, 7), (4, 7, 7), (8, 7, 7),
                                   (16, 7, 7), (2, 4, 4), (1, 8, 8), (3, 2, 2)])
def test_fusion_routes_match_the_traced_jax_ops(monkeypatch, B, H, W):
    """JAX's ShallowFuse_SS2Dv4 and Cross_SS2Dv5 traced on the accelerator
    path: v2 or v1 (and v1's image group), against the port's rules."""
    rec = _Recorder(monkeypatch)
    rec.replace(jax_v2, "nk_scan_call_v2", lambda u, *a: jnp.zeros(u.shape, u.dtype))
    rec.replace(jax_v2, "nk_scan_call_v2r", lambda u, *a: jnp.zeros(u.shape, u.dtype))
    rec.replace(jax_v1, "nk_scan_call", lambda u, *a: jnp.zeros(u.shape, u.dtype))
    x = jax.ShapeDtypeStruct((B, H, W, 16), jnp.float32)
    ops = [JaxShallow(d_model=16, d_state=4), JaxCross(d_model=16, d_state=4)]
    variables = [jax.eval_shape(op.init, jax.random.PRNGKey(0), x, x) for op in ops]
    rec.calls.clear()                                  # init traces the forward too
    for op, v in zip(ops, variables):
        jax.eval_shape(op.apply, v, x, x)
    L = H * W
    shallow = ("nk_scan_call_v2" if nk_scan_v1.shallow_takes_v2(B, L, W) else "nk_scan_call",
               nk_scan_v1.shallow_group(B, L))
    cross = ("nk_scan_call_v2r", nk_scan_v1.cross_v2_group(3 * B, H, W)) \
        if nk_scan_v1.cross_v2_group(3 * B, H, W) is not None \
        else ("nk_scan_call", nk_scan_v1.nk_from_projs_group(3 * B, L))
    assert rec.calls == [shallow, shallow, cross]


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (the wrappers take their plain
    twins here and launch nothing)."""
    fn = getattr(module, name)
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_study_reaches_kernels_8_and_9(monkeypatch, dtype):
    """The small model at one study: in bfloat16 four blocks through
    kernel 8, stage 2 through kernel 1 and stage 3's two blocks through
    kernel 11; in float32 the composable blocks; both fusion scans through
    kernel 9 (three calls) in both dtypes, kernels 2 and 3 never."""
    counts = {name: _counting(monkeypatch, mod, name) for mod, name in (
        (vssm, "vss_block_v1"), (vssm, "vss_stage"), (fusion, "nk_scan_v1"),
        (fusion, "nk_scan_train"), (fusion, "nk_scan_x"))}
    counts["n1"] = _counting(monkeypatch, ss2d_core_n1, "ss2d_core_n1_fwd")
    model = TwoViewXFMamba(generator=torch.Generator().manual_seed(0), **SMALL).eval()
    xa, xb = (torch.randn(1, IMAGE, IMAGE, 1).to(dtype) for _ in range(2))
    with torch.no_grad():
        assert torch.isfinite(model(xa, xb).float()).all()
    got = {k: v[0] for k, v in counts.items()}
    bf16 = dtype == torch.bfloat16
    assert got == dict(vss_block_v1=4 if bf16 else 0, vss_stage=1 if bf16 else 0,
                       nk_scan_v1=3, nk_scan_train=0, nk_scan_x=0, n1=2 if bf16 else 8)


# ---------------------------------------------------------------------------
# the plain twins of kernels 8 and 9 against JAX
# ---------------------------------------------------------------------------

def _block(conv_bias, d=16, seed=0):
    jblock = JaxVSSBlock(hidden_dim=d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias,
                         forward_type="v05_noz", mlp_ratio=4.0)
    params = jax_variables(jblock, seed, jnp.zeros((1, 6, 6, d)))["params"]
    port = VSSBlock(d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias).eval()
    load_jax_variables(port, {"params": params})
    return params, port


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("conv_bias", [False, True])
def test_kernel8_plain_matches_jax_block_ref(dtype, tol, conv_bias):
    """`vss_block_v1_plain` against JAX's ``vss_block_ref`` (the v1 kernel's
    op order and casts) on a 7 x 9 map: float32 to summation order (5e-5
    absolute and relative), bfloat16 to the rounding flips of the matmul
    operands (3e-2 of the largest output)."""
    params, port = _block(conv_bias, seed=int(conv_bias))
    H, W = 7, 9
    x = np.random.default_rng(3).standard_normal((2, H * W, 16)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(jax_v1.vss_block_ref, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x, jdtype), params, H, W, conv_bias, True)
    p = vss_block_v1.pack_vss_block_v1_params(port, dtype)
    got = vss_block_v1.vss_block_v1(T(x).to(dtype), p, H, W)
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert_close(got, want, tol)
    else:
        assert _rel(got, want) <= tol


def _projs(seed, B=3, H=5, W=6, D=12, K=4, N=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, D), np.float32),
            0.3 * rng.standard_normal((B, H, W, K, D), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            -np.exp(0.5 * rng.standard_normal((K, D, N), np.float32)),
            rng.standard_normal((K, D), np.float32),
            0.1 * rng.standard_normal((K, D), np.float32))


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_kernel9_plain_matches_jax_composable(scan_mode):
    """`nk_scan_v1` (plain) against JAX's composable ``ss2d_core_from_projs``
    at N 16 (2e-4: float32, N x L products in other orders)."""
    x, dts, Bs, Cs, A, Dmat, bias = args = _projs(4)
    B, H, W, D, K, N = *x.shape, 4, 16
    L = H * W
    want = jax.jit(jax_core, static_argnames="scan_mode")(*map(jnp.asarray, args),
                                                          scan_mode=scan_mode)
    got = nk_scan_v1.nk_scan_v1(
        T(x.reshape(B, L, D)), T(dts.reshape(B, L, K * D)), T(Bs.reshape(B, L, K * N)),
        T(Cs.reshape(B, L, K * N)), T(A.transpose(0, 2, 1).reshape(K * N, D)), T(Dmat),
        T(bias), H, W, nk_scan.scan_mode_kinds(scan_mode))
    assert_close(got.reshape(B, H, W, D), want, 2e-4)


@pytest.mark.slow
def test_kernel8_plain_matches_the_pallas_kernel():
    """Against ``_vss_block_call(..., interpret=True)`` (the v1 Pallas
    kernel, its Hillis-Steele scans and erf GELU) on an 8 x 6 map, two
    images in one group, float32: 1e-4 of the largest output."""
    params, port = _block(True, seed=5)
    H, W = 8, 6
    x = np.random.default_rng(6).standard_normal((2, H * W, 16)).astype(np.float32)
    packed = jax_v1.pack_vss_block_params(params, jnp.float32, True)
    want = jax_v1._vss_block_call(jnp.asarray(x), *packed, H=H, W=W, conv_bias=True,
                                  fuse_mlp=True, interpret=True, group=2)
    got = vss_block_v1.vss_block_v1(T(x), vss_block_v1.pack_vss_block_v1_params(
        port, torch.float32), H, W)
    assert _rel(got, want) <= 1e-4


@pytest.mark.slow
def test_kernel9_plain_matches_the_pallas_kernel():
    """Against ``nk_scan_call(..., interpret=True)`` (the v1 Pallas nk scan)
    at cross2d K 4, N 4, two images in one group, float32: 1e-4."""
    x, dts, Bs, Cs, A, Dmat, bias = _projs(7, B=2, H=4, W=6, D=8, N=4)
    B, H, W, D, K, N = *x.shape, 4, 4
    L = H * W
    ops = (x.reshape(B, L, D), dts.reshape(B, L, K * D), Bs.reshape(B, L, K * N),
           Cs.reshape(B, L, K * N), A.transpose(0, 2, 1).reshape(K * N, D), Dmat, bias)
    kinds = nk_scan.scan_mode_kinds("cross2d")
    want = jax_v1.nk_scan_call(*map(jnp.asarray, ops), H, W, kinds, group=2, interpret=True)
    got = nk_scan_v1.nk_scan_v1(*map(T, ops), H, W, kinds)
    assert _rel(got, want) <= 1e-4


# ---------------------------------------------------------------------------
# the small model at one and three studies against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_models():
    """The port's small model on the JAX model's weights, three studies'
    views, and JAX's float32 and bfloat16 logits for them (each study's
    logits depend on its own views alone, so one study's are the first
    row)."""
    jmodels = {dt: JaxTwoView(**SMALL, dtype=dt) for dt in (jnp.float32, jnp.bfloat16)}
    x = jnp.zeros((1, IMAGE, IMAGE, 1))
    variables = jax_variables(jmodels[jnp.float32], 21, x, x)
    port = TwoViewXFMamba(**SMALL).eval()
    load_jax_variables(port, variables)
    rng = np.random.default_rng(3)
    views = [rng.standard_normal((3, IMAGE, IMAGE, 1)).astype(np.float32) for _ in range(2)]
    logits = {dt: np.asarray(jax.jit(jmodels[dt].apply)(
        variables, *(jnp.asarray(v, dt) for v in views)), np.float32)
        for dt in (jnp.float32, jnp.bfloat16)}
    return port, views, logits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3])
def test_logits_match_jax_at_one_and_three_studies(small_models, B, dtype):
    """Logits of the small model (the bfloat16 route: kernels 8, 1 and 11;
    both fusion scans kernel 9) against the JAX model (its CPU path, the
    composable blocks) on the same weights.  float32: within 1e-4 of the
    largest logit.  bfloat16: the two round at other points through eight
    blocks and the fusion layers, and this random model's bfloat16 logits
    stray by several percent from its float32 ones in JAX too, so the
    port's bfloat16 logits must be as close to JAX's float32 logits as
    JAX's own bfloat16 model is: within twice its error (or 2e-2)."""
    port, views, logits = small_models
    want = logits[jnp.float32][:B]
    with torch.no_grad():
        got = port(*(T(v[:B]).to(dtype) for v in views))
    assert got.shape == (B, 2) and got.dtype == dtype
    if dtype == torch.float32:
        assert _rel(got, want) <= 1e-4
        return
    assert _rel(got, want) <= max(2 * _rel(logits[jnp.bfloat16][:B], want), 2e-2)
