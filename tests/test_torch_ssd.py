"""The SSD (Mamba-2) path of the port on the CPU against the JAX package:
cross-scan / cross-merge, the einsum SSD (``ops/ssd.py``), the plain twins
of kernels 15 and 16 (``ops/ssd_chunk.py``: forward, checkpoints and the
step-by-step adjoint) against the XLA form, ``jax.vjp`` and the Pallas
kernels in interpret mode, the m0 SS2D layer, a tiny m2 classifier's logits
and one train step, the m2 factories' parameter trees, and the bfloat16
route guard.

Inputs are numpy arrays from a seed handed to both sides; JAX runs under
``jax.jit`` on the CPU.  float32 throughout unless a test says otherwise,
so tolerances cover summation order: the port pads a ragged sequence to
whole chunks where the XLA form halves its chunk, and the two compute the
same function in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity import jax_variables
from xfmamba_tpu.checkpoint.convert import convert_vssm_state_dict, verify_tree_matches
from xfmamba_tpu.models.layers import gelu as jax_gelu
from xfmamba_tpu.models.ss2d import SS2D as JaxSS2D
from xfmamba_tpu.models.vssm import VSSM as JaxVSSM
from xfmamba_tpu.models.vssm import vmamba_base_m2 as jax_vmamba_base_m2
from xfmamba_tpu.models.vssm import vmamba_small_m2 as jax_vmamba_small_m2
from xfmamba_tpu.ops.cross_scan import cross_merge as jax_cross_merge
from xfmamba_tpu.ops.cross_scan import cross_scan as jax_cross_scan
from xfmamba_tpu.ops import ssd as jax_ssd
from xfmamba_tpu.ops import ssd_pallas as jax_sp
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables, jax_paths, load_jax_variables
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops import cross_scan, ssd, ssd_chunk
from xfmamba_tpu_torch.train import loop
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _ssd_operands(seed, b, s, h, p, g, n):
    """x, dt, A, B, C, D (h, p), bias, initial state in the public layout."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    return dict(x=f(b, s, h, p), dt=f(b, s, h, scale=0.5),
                A=-np.exp(f(h, scale=0.3)), B=f(b, s, g, n), C=f(b, s, g, n),
                D=f(h, p), bias=f(h, scale=0.1), init=f(b, h, p, n))


def _jax_ssd(chunk, with_init=True):
    """JAX's XLA form as f(x, dt, A, B, C, D, bias[, init]) -> (y, final)."""
    def f(x, dt, A, B, C, D, bias, init=None):
        return jax_ssd.ssd_chunk_scan(x, dt, A, B, C, chunk, D=D, dt_bias=bias,
                                      initial_states=init if with_init else None,
                                      dt_softplus=True, return_final_states=True)
    return jax.jit(f)


def _kernel_layout(ops):
    """The public-layout numpy operands in the port's kernel layout, as
    tensors: x, dt, A, B, C, D, bias, init."""
    return [t.contiguous() for t in ssd_chunk.pack_args(*(T(v) for v in ops.values()))]


def _fused(*args):
    """`ssd_chunk_scan_heads` on public-layout tensors (x, dt, A, B, C[, D,
    bias, init]); returns y (b, s, h, p) and the final state (b, h, p, n)."""
    y, fin = ssd_chunk.ssd_chunk_scan_heads(*ssd_chunk.pack_args(*args))
    return y.transpose(1, 2).reshape(args[0].shape), fin.transpose(2, 3)


# ---------------------------------------------------------------------------
# cross-scan and the einsum SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scans", [0, 1, 2])
def test_cross_scan_and_merge_match_jax(scans):
    """Both directions exactly, on a non-square map."""
    rng = np.random.default_rng(scans)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    ys = rng.standard_normal((2, 4, 15, 4)).astype(np.float32)
    np.testing.assert_array_equal(cross_scan.cross_scan(T(x), scans).numpy(),
                                  np.asarray(jax_cross_scan(jnp.asarray(x), scans)))
    np.testing.assert_array_equal(cross_scan.cross_merge(T(ys), 3, 5, scans).numpy(),
                                  np.asarray(jax_cross_merge(jnp.asarray(ys), 3, 5, scans)))


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(ssd.segsum(T(x)).numpy(), np.asarray(jax_ssd.segsum(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,h,g,chunk,D,init,z", [
    (64, 4, 4, 16, "vector", False, False),    # whole chunks, one group per head
    (49, 4, 2, 16, "matrix", True, False),     # ragged: the chunk halves to 1
    (48, 6, 2, 32, "matrix", True, True),      # g < h, the chunk halves to 16, a z-gate
])
def test_ssd_chunk_scan_matches_jax(s, h, g, chunk, D, init, z):
    """y and the final state within 1e-5 of their largest magnitude."""
    ops = _ssd_operands(s + h, 2, s, h, 8, g, 8)
    Dv = ops["D"][:, 0] if D == "vector" else ops["D"]
    zv = np.random.default_rng(1).standard_normal(ops["x"].shape).astype(np.float32) if z else None
    kw = dict(D=Dv, dt_bias=ops["bias"], initial_states=ops["init"] if init else None, z=zv)
    want = jax.jit(lambda x, dt, A, B, C, kw: jax_ssd.ssd_chunk_scan(
        x, dt, A, B, C, chunk, dt_softplus=True, return_final_states=True, **kw))(
        *(jnp.asarray(ops[k]) for k in "x dt A B C".split()),
        {k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    calls = ssd.ssd_chunk_scan.calls
    got = ssd.ssd_chunk_scan(*(T(ops[k]) for k in "x dt A B C".split()), chunk,
                             dt_softplus=True, return_final_states=True,
                             **{k: None if v is None else T(v) for k, v in kw.items()})
    assert ssd.ssd_chunk_scan.calls == calls + 1
    assert _rel(got[0], want[0]) <= 1e-5 and _rel(got[1], want[1]) <= 1e-5


# ---------------------------------------------------------------------------
# the plain twins of kernels 15 and 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(80, 16), (64, 16), (150, 64)])
def test_ssd_fwd_plain_matches_the_xla_form(s, chunk):
    """Kernel 15's plain twin at a ragged and an exact length, and at the
    kernels' chunk of 64 over three chunks, the last ragged: y and the
    final state within 1e-5 of the XLA form."""
    ops = _ssd_operands(s, 2, s, 4, 8, 2, 8)
    want = _jax_ssd(chunk)(*(jnp.asarray(v) for v in ops.values()))
    got = _fused(*(T(v) for v in ops.values())) if chunk == 64 else None
    x, dt, A, B, C, D, bias, init = _kernel_layout(ops)
    y, fin = ssd_chunk.ssd_fwd_plain(x, dt, A, B, C, D, bias, init, chunk=chunk)
    assert _rel(y.transpose(1, 2).reshape(want[0].shape), want[0]) <= 1e-5
    assert _rel(fin.transpose(2, 3), want[1]) <= 1e-5
    if got is not None:
        assert _rel(got[0], want[0]) <= 1e-5 and _rel(got[1], want[1]) <= 1e-5


def _pallas_states(cs, b, g, R, R_t, n, p):
    """The Pallas checkpoints (b * g * nt, nc, R_t * n, p) as the port's
    (b, g * R, nc, n, p)."""
    nt, nc = R // R_t, cs.shape[1]
    return np.asarray(cs).reshape(b, g, nt, nc, R_t, n, p).transpose(
        0, 1, 2, 4, 3, 5, 6).reshape(b, g * R, nc, n, p)


def test_ssd_fwd_plain_matches_the_pallas_kernel():
    """Against ``ssd_chunk_scan_pallas`` and ``_ssd_call_train`` in
    interpret mode at b 1, L 80, 4 heads in 2 groups, P 8, N 8, chunk 16:
    y, the final state and every checkpoint within 1e-5."""
    b, s, h, p, g, n, chunk = 1, 80, 4, 8, 2, 8, 16
    ops = _ssd_operands(7, b, s, h, p, g, n)
    jops = {k: jnp.asarray(v) for k, v in ops.items()}
    y_ref, fin_ref = jax_sp.ssd_chunk_scan_pallas(
        jops["x"], jops["dt"], jops["A"], jops["B"], jops["C"], chunk, D=jops["D"],
        dt_bias=jops["bias"], initial_states=jops["init"], interpret=True)
    packed = jax_sp._pack_args(jops["x"], jops["dt"], jops["A"], jops["B"], jops["C"], chunk,
                               jops["D"], jops["bias"], jops["init"])
    K, R_t = packed[8], packed[9]
    _, _, cs = jax_sp._ssd_call_train(*packed[:8], K=K, R_t=R_t, chunk=chunk, interpret=True)
    x, dt, A, B, C, D, bias, init = _kernel_layout(ops)
    y, fin, states = ssd_chunk.ssd_fwd_plain(x, dt, A, B, C, D, bias, init, chunk=chunk,
                                             save_states=True)
    assert _rel(y.transpose(1, 2).reshape(b, s, h, p), y_ref) <= 1e-5
    assert _rel(fin.transpose(2, 3), fin_ref) <= 1e-5
    assert _rel(states, _pallas_states(cs, b, g, h // g, R_t, n, p)) <= 1e-5


def _port_grads(ops, g, chunk, gy, gfin):
    """ssd_bwd_plain from the plain forward's checkpoints, in the public
    layout: dx, ddt, dA, dB, dC, dD (h, p), dbias, dinit (b, h, p, n)."""
    x, dt, A, B, C, D, bias, init = _kernel_layout(ops)
    _, _, states = ssd_chunk.ssd_fwd_plain(x, dt, A, B, C, D, bias, init, chunk=chunk,
                                           save_states=True)
    b, s, h, p = ops["x"].shape
    dy = T(gy).view(b, s, g, h // g, p).transpose(1, 2).contiguous()
    got = ssd_chunk.ssd_bwd_plain(x, dt, A, B, C, D, bias, states, dy,
                                  T(gfin).transpose(2, 3).contiguous(), chunk=chunk)
    return [got["dx"].transpose(1, 2).reshape(b, s, h, p),
            got["ddt"].transpose(1, 2).reshape(b, s, h), got["dA"],
            got["dB"].transpose(1, 2), got["dC"].transpose(1, 2), got["dD"], got["dbias"],
            got["dinit"].transpose(2, 3)]


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dbias", "dinit")


@pytest.mark.parametrize("s,g,chunk", [(80, 2, 16), (64, 4, 16), (150, 2, 64)])
def test_ssd_bwd_plain_matches_jax_vjp(s, g, chunk):
    """Kernel 16's plain twin, replayed from the checkpoints, against
    ``jax.vjp`` of the XLA form with cotangents on y and the final state:
    every gradient within 1e-4 of its largest magnitude."""
    ops = _ssd_operands(s + g, 2, s, 4, 8, g, 8)
    rng = np.random.default_rng(9)
    gy = rng.standard_normal(ops["x"].shape).astype(np.float32)
    gfin = rng.standard_normal(ops["init"].shape).astype(np.float32)
    _, vjp = jax.vjp(_jax_ssd(chunk), *(jnp.asarray(v) for v in ops.values()))
    want = vjp((jnp.asarray(gy), jnp.asarray(gfin)))
    for name, got, w in zip(NAMES, _port_grads(ops, g, chunk, gy, gfin), want):
        assert tuple(got.shape) == w.shape, name
        assert _rel(got, w) <= 1e-4, name


@pytest.fixture
def _interpret_train():
    old = jax_sp.INTERPRET_TRAIN
    jax_sp.INTERPRET_TRAIN = True
    yield
    jax_sp.INTERPRET_TRAIN = old


def test_ssd_bwd_plain_matches_the_pallas_adjoint(_interpret_train):
    """Against ``jax.vjp`` of ``ssd_chunk_scan_pallas_train`` (the Pallas
    forward with checkpoints and the Pallas adjoint, in interpret mode) at
    b 1, L 80, 4 heads in 2 groups, chunk 16: output by output, 1e-4."""
    b, s, h, p, g, n, chunk = 1, 80, 4, 8, 2, 8, 16
    ops = _ssd_operands(8, b, s, h, p, g, n)
    rng = np.random.default_rng(10)
    gy = rng.standard_normal(ops["x"].shape).astype(np.float32)
    gfin = rng.standard_normal(ops["init"].shape).astype(np.float32)
    f = lambda x, dt, A, B, C, D, bias, init: jax_sp.ssd_chunk_scan_pallas_train(
        x, dt, A, B, C, chunk, D, bias, init)
    _, vjp = jax.vjp(f, *(jnp.asarray(v) for v in ops.values()))
    want = vjp((jnp.asarray(gy), jnp.asarray(gfin)))
    for name, got, w in zip(NAMES, _port_grads(ops, g, chunk, gy, gfin), want):
        assert _rel(got, w) <= 1e-4, name


@pytest.mark.parametrize("optional", [True, False])
def test_autograd_op_matches_jax_vjp(optional):
    """`ssd_chunk_scan_heads` through torch autograd (`SSDChunkScanTrain`:
    kernel 15 with checkpoints, then kernel 16; plain here), with a vector
    D, bias and an initial state or none of them; only y is used, so the
    final state's cotangent is undefined (zeros)."""
    ops = _ssd_operands(11, 2, 100, 4, 8, 2, 8)
    ops["D"] = ops["D"][:, 0].copy()
    keys = list(ops) if optional else ["x", "dt", "A", "B", "C"]
    gy = np.random.default_rng(12).standard_normal(ops["x"].shape).astype(np.float32)

    def f(*a):
        kw = dict(zip(("D", "bias", "init"), a[5:])) if optional else {}
        return jax_ssd.ssd_chunk_scan(*a[:5], 64, D=kw.get("D"), dt_bias=kw.get("bias"),
                                      initial_states=kw.get("init"), dt_softplus=True)

    y_ref, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(ops[k]) for k in keys))
    want = vjp(jnp.asarray(gy))
    leaves = [T(ops[k]).requires_grad_() for k in keys]
    y, _ = _fused(*leaves)
    y.backward(T(gy))
    assert _rel(y, y_ref) <= 1e-5
    for k, leaf, w in zip(keys, leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4, k


def _serial_fwd(x, dt, A, B, C, D, bias, init, chunk):
    """The chunk-by-chunk recurrence of kernel 15 in float64, in the kernel
    layout: y (b, g, L, R, P), the final state and the state entering each
    chunk, (b, g * R, [nc,] N, P)."""
    f = lambda t: None if t is None else t.double()
    x, dt, A, B, C, D, bias = map(f, (x, dt, A, B, C, D, bias))
    b, g, L, R, P = x.shape
    N, nc = B.shape[-1], -(-L // chunk)
    state = torch.zeros(b, g, R, N, P, dtype=torch.float64) if init is None \
        else f(init).view(b, g, R, N, P).clone()
    z = dt.permute(0, 1, 3, 2) + bias.view(1, g, R, 1)
    dts = torch.nn.functional.softplus(z, threshold=20)
    ys, states = [], []
    for j in range(nc):
        rows = slice(j * chunk, min(L, (j + 1) * chunk))
        states.append(state)
        d = dts[..., rows]                                       # (b, g, R, c)
        cum = torch.cumsum(d * A.view(1, g, R, 1), -1)
        xc = x[:, :, rows].permute(0, 1, 3, 2, 4)                # (b, g, R, c, P)
        Bc, Cc = B[:, :, None, rows], C[:, :, None, rows]
        E = torch.exp(cum[..., :, None] - cum[..., None, :]).tril()
        dtx = xc * d[..., None]
        y = ((Cc @ Bc.transpose(-1, -2)) * E) @ dtx + (Cc @ state) * torch.exp(cum)[..., None]
        ys.append(y + xc * D.view(1, g, R, 1, P))
        w = cum[..., -1:]
        state = state * torch.exp(w)[..., None] + \
            Bc.transpose(-1, -2) @ (dtx * torch.exp(w - cum)[..., None])
    y = torch.cat(ys, 3).permute(0, 1, 3, 2, 4)
    return y, state.reshape(b, g * R, N, P), torch.stack(states, 3).reshape(b, g * R, nc, N, P)


def _bf16_round(ops):
    """The operands that the bfloat16 path takes in bfloat16 (x, dt, B, C),
    rounded to it, so both sides see the same values."""
    return {k: (torch.from_numpy(v).bfloat16().float().numpy() if k in ("x", "dt", "B", "C")
                else v) for k, v in ops.items()}


def _kernel_args(ops, dtype):
    x, dt, A, B, C, D, bias, init = _kernel_layout(ops)
    return [x.to(dtype), dt.to(dtype), A, B.to(dtype), C.to(dtype), D, bias, init]


@pytest.mark.parametrize("L,with_init,dtype", [
    (150, True, torch.float32),    # three chunks, the last ragged
    (150, False, torch.bfloat16),  # no initial state, bfloat16 operands
    (128, False, torch.float32),   # whole chunks only
    (49, True, torch.bfloat16),    # one ragged chunk
])
def test_plain_passes_compose_to_the_serial_form(L, with_init, dtype):
    """Kernel 15's plain passes one by one -- the chunk states and decays,
    the state pass, the chunk scan -- against the chunk-by-chunk
    recurrence in float64 on the same values: y (1e-5 of its largest
    magnitude in float32; bfloat16 y rounds once, 8e-3), the final state
    and every checkpoint (1e-5); and `ssd_fwd_plain` is their composition."""
    ops = _ssd_operands(L, 2, L, 6, 16, 2, 16)
    if dtype == torch.bfloat16:
        ops = _bf16_round(ops)
    x, dt, A, B, C, D, bias, init = _kernel_args(ops, dtype)
    init = init if with_init else None
    local, decay = ssd_chunk.ssd_chunk_states_plain(x, dt, A, B, bias)
    assert local.shape == (2, 6, -(-L // 64), 16, 16) and decay.shape == local.shape[:3]
    assert bool((decay > 0).all() and (decay <= 1).all())
    states, fin = ssd_chunk.ssd_state_pass_plain(local, decay, init)
    y = ssd_chunk.ssd_chunk_scan_plain(x, dt, A, B, C, D, bias, states)
    assert y.dtype == dtype
    y_s, fin_s, states_s = _serial_fwd(x, dt, A, B, C, D, bias, init, 64)
    assert _rel(y.float(), y_s) <= (1e-5 if dtype == torch.float32 else 8e-3)
    assert _rel(fin, fin_s) <= 1e-5 and _rel(states, states_s) <= 1e-5
    for got, want in zip(ssd_chunk.ssd_fwd_plain(x, dt, A, B, C, D, bias, init,
                                                 save_states=True), (y, fin, states)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("L,with_dfin,dtype", [
    (150, True, torch.float32),
    (150, False, torch.bfloat16),
    (128, False, torch.float32),
    (49, True, torch.bfloat16),
])
def test_plain_adjoint_passes_match_jax_vjp(L, with_dfin, dtype):
    """Kernel 16's plain passes one by one -- Q = C^T (exp(cum) dy) and the
    decays, the reverse state pass, the chunk gradients -- from the
    forward passes' checkpoints, against ``jax.vjp`` of the XLA form on the
    same values (bfloat16 operands rounded first; the port computes in
    float32): every gradient within 1e-4 of its largest magnitude, and
    `ssd_bwd_plain` is their composition."""
    ops = _ssd_operands(L + 1, 2, L, 6, 16, 2, 16)
    if dtype == torch.bfloat16:
        ops = _bf16_round(ops)
    rng = np.random.default_rng(L)
    gy = rng.standard_normal(ops["x"].shape).astype(np.float32)
    gfin = rng.standard_normal(ops["init"].shape).astype(np.float32) if with_dfin \
        else np.zeros(ops["init"].shape, np.float32)
    _, vjp = jax.vjp(_jax_ssd(64), *(jnp.asarray(v) for v in ops.values()))
    want = vjp((jnp.asarray(gy), jnp.asarray(gfin)))
    x, dt, A, B, C, D, bias, init = args = _kernel_args(ops, dtype)
    states = ssd_chunk.ssd_fwd_plain(*args, save_states=True)[2]
    b, s, h, p = ops["x"].shape
    dy = T(gy).view(b, s, 2, 3, p).transpose(1, 2).contiguous()
    dfin = T(gfin).transpose(2, 3).contiguous() if with_dfin else None
    q, decay = ssd_chunk.ssd_chunk_states_plain(dy, dt, A, C, bias, adjoint=True)
    ds_out, dinit = ssd_chunk.ssd_state_pass_plain(q, decay, dfin, reverse=True)
    got = ssd_chunk.ssd_chunk_grads_plain(x, dt, A, B, C, D, bias, states, ds_out, dy)
    got["dinit"] = dinit
    for name, w in ssd_chunk.ssd_bwd_plain(x, dt, A, B, C, D, bias, states, dy, dfin).items():
        assert torch.equal(got[name], w), name
    port = [got["dx"].transpose(1, 2).reshape(b, s, h, p),
            got["ddt"].transpose(1, 2).reshape(b, s, h), got["dA"], got["dB"].transpose(1, 2),
            got["dC"].transpose(1, 2), got["dD"], got["dbias"], got["dinit"].transpose(2, 3)]
    for name, g, w in zip(NAMES, port, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= 1e-4, name


@pytest.mark.parametrize("with_start,reverse", [(True, False), (False, False), (True, True),
                                                (False, True)])
def test_state_pass_plain(with_start, reverse):
    """Pass (b) against the recurrence written out: out[j] is the carry
    entering chunk j (in the walk's order), the carry ends as the result."""
    g = torch.Generator().manual_seed(5)
    local = torch.randn(2, 3, 5, 4, 2, generator=g)
    decay = torch.rand(2, 3, 5, generator=g)
    start = torch.randn(2, 3, 4, 2, generator=g) if with_start else None
    out, last = ssd_chunk.ssd_state_pass_plain(local, decay, start, reverse)
    s = start if with_start else torch.zeros(2, 3, 4, 2)
    for j in (range(4, -1, -1) if reverse else range(5)):
        torch.testing.assert_close(out[:, :, j], s, rtol=0, atol=0)
        s = decay[:, :, j, None, None] * s + local[:, :, j]
    torch.testing.assert_close(last, s, rtol=0, atol=0)


def test_ssd_supported_matches_jax():
    for L in (1, 49, 196, 784, 3136, 100000):
        for h, g in ((24, 4), (192, 4), (5, 4), (8, 8)):
            for p in (4, 8, 16, 136):
                for n in (8, 12, 64, 520):
                    assert ssd_chunk.ssd_supported(L, h, p, n, g) == \
                        jax_sp.ssd_supported(L, h, p, n, g), (L, h, p, n, g)


@pytest.mark.parametrize("P,N", [(64, 128), (40, 72)])
def test_tiled_plain_twins_match_untiled_and_jax_vjp(P, N):
    """`ssd_fwd_tiled` / `ssd_bwd_tiled` past the kernels' limits (width
    slices of 32, d_state tiles of 64, composed from the plain twins)
    against the untiled plain twins and the XLA form: y, the final state
    and the checkpoints within 1e-5, the gradients within 1e-4; through
    `ssd_chunk_scan_heads` under autograd every gradient within 1e-4 of
    ``jax.vjp``."""
    b, s, h, g, chunk = 1, 100, 4, 2, 64
    ops = _ssd_operands(P + N, b, s, h, P, g, N)
    x, dt, A, B, C, D, bias, init = args = _kernel_layout(ops)
    y, fin, states = ssd_chunk.ssd_fwd_tiled(*args, save_states=True)
    want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
    for got, w in zip((y, fin, states), want):
        assert _rel(got, w) <= 1e-5
    rng = np.random.default_rng(13)
    dy, dfin = (T(rng.standard_normal(t.shape).astype(np.float32)) for t in (x, fin))
    got = ssd_chunk.ssd_bwd_tiled(x, dt, A, B, C, D, bias, states, dy, dfin)
    want = ssd_chunk.ssd_bwd_plain(x, dt, A, B, C, D, bias, want[2], dy, dfin)
    for name in NAMES:     # sums over the tiles' calls, reassociated
        assert _rel(got[name], want[name]) <= 1e-4, name
    gy = rng.standard_normal(ops["x"].shape).astype(np.float32)
    gfin = rng.standard_normal(ops["init"].shape).astype(np.float32)
    out_ref, vjp = jax.vjp(_jax_ssd(chunk), *(jnp.asarray(v) for v in ops.values()))
    want = vjp((jnp.asarray(gy), jnp.asarray(gfin)))
    leaves = [T(v).requires_grad_() for v in ops.values()]
    y, fin = _fused(*leaves)
    assert _rel(y, out_ref[0]) <= 1e-5 and _rel(fin, out_ref[1]) <= 1e-5
    torch.autograd.backward((y, fin), (T(gy), T(gfin)))
    for name, leaf, w in zip(NAMES, leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4, name


def test_kernel_limits():
    """What the CUDA kernels refuse, checked before a launch: another chunk
    than 64, or a state or head width beyond their shared memory."""
    def args(L, R, P, N):
        return (torch.zeros(1, 1, L, R, P), torch.zeros(1, 1, L, R), torch.zeros(R),
                torch.zeros(1, 1, L, N), torch.zeros(1, 1, L, N), None, None)

    ssd_chunk._check(*args(70, 2, 16, 64), 64)
    with pytest.raises(ValueError, match="chunk 64"):
        ssd_chunk._check(*args(70, 2, 16, 64), 32)
    with pytest.raises(ValueError, match="d_state 128"):
        ssd_chunk._check(*args(70, 2, 16, 128), 64)
    with pytest.raises(ValueError, match="head width 64"):
        ssd_chunk._check(*args(70, 2, 64, 64), 64)


# ---------------------------------------------------------------------------
# the m0 SS2D layer and the m2 classifiers
# ---------------------------------------------------------------------------

def _load_ss2d(port, variables):
    """A bare SS2D loads as the ``op`` of a block (the JAX out-norm sits in
    ``out_norm/norm``)."""
    holder = torch.nn.Module()
    holder.op = port
    load_jax_variables(holder, {"params": {"op": variables["params"]}})
    return holder


@pytest.mark.parametrize("d_state,route", [(8, "kernels"), (4, "einsum")])
def test_ss2d_m0_matches_jax(d_state, route):
    """``SS2D(forward_type="m0_noz", act=gelu)`` on a 6 x 9 map, 2 heads per
    direction of width 16: output and every parameter and input gradient
    against ``jax.vjp`` of the JAX layer (1e-5 / 1e-4).  d_state 8 passes
    ``ssd_supported`` (the kernels' plain twins); d_state 4 does not, and
    runs ``ops/ssd.py``, as JAX does there."""
    _check_ss2d_m0(d_state, 1.0, route)


def test_ss2d_m0_past_the_kernel_limits_matches_jax():
    """The same at d_state 128 and ssm_ratio 4 (heads of width 64), which
    the gate admits past the kernels' d_state 64 and width 32: the tiled
    route (two width slices x two d_state tiles of the plain twins)."""
    _check_ss2d_m0(128, 4.0, "kernels")


def _check_ss2d_m0(d_state, ssm_ratio, route):
    jmodel = JaxSS2D(d_model=32, d_state=d_state, ssm_ratio=ssm_ratio, act=jax_gelu,
                     forward_type="m0_noz", initialize="v2", conv_bias=False)
    rng = np.random.default_rng(d_state)
    x = rng.standard_normal((2, 6, 9, 32)).astype(np.float32)
    gy = rng.standard_normal((2, 6, 9, 32)).astype(np.float32)
    variables = jax_variables(jmodel, d_state, jnp.zeros((1, 6, 9, 32)))
    y_ref, vjp = jax.vjp(jax.jit(lambda v, x: jmodel.apply({"params": v}, x)),
                         variables["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(gy))
    port = SS2D(32, d_state=d_state, ssm_ratio=ssm_ratio, forward_type="m0_noz", act="gelu",
                initialize="v2", conv_bias=False)
    holder = _load_ss2d(port, variables)
    P = int(32 * ssm_ratio) // 2
    assert ssd_chunk.ssd_supported(54, 8, P, d_state, 4) == (route == "kernels")
    calls = ssd.ssd_chunk_scan.calls
    xt = T(x).requires_grad_()
    y = port(xt)
    y.backward(T(gy))
    assert ssd.ssd_chunk_scan.calls == calls + (route == "einsum")
    assert _rel(y, y_ref) <= 1e-5 and _rel(xt.grad, dx) <= 1e-4
    params = dict(holder.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(holder).items():
        want = to_port(np.asarray(_leaf({"params": {"op": dparams}}, jpath)))
        assert _rel(params[key].grad, want) <= 1e-4, key


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def test_m0_refuses_what_is_not_ported():
    for kw in (dict(forward_type="m0"), dict(forward_type="m0_noz", with_initial_state=True)):
        with pytest.raises(ValueError):
            SS2D(16, d_state=8, ssm_ratio=1.0, **kw)


TINY_M2 = dict(depths=(1, 1, 1, 1), dims=16, num_classes=10, ssm_d_state=8, ssm_ratio=1.0,
               ssm_act="gelu", ssm_conv_bias=False, ssm_init="v2", forward_type="m0_noz",
               mlp_ratio=4.0, drop_path_rate=0.0)
BATCH, IMAGE, LR = 3, 64, 1e-3


@pytest.fixture(scope="module")
def tiny_m2_step():
    """A tiny m2 classifier (maps 16, 8, 4 and 2: whole and ragged chunks),
    its variables, a batch, the JAX eval logits, and JAX's loss, gradients
    and parameters after one Adam step of ``make_train_step(two_view=False)``."""
    jmodel = JaxVSSM(**TINY_M2)
    variables = jax_variables(jmodel, 2, jnp.zeros((1, IMAGE, IMAGE, 3)))
    rng = np.random.default_rng(3)
    batch = {"image1": rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             "label": np.array([0, 3, 9], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, jbatch["image1"])
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
    train_step, _ = jax_make_train_step(jmodel, opt, multilabel=False, two_view=False,
                                        jit_compile=False)
    state = TrainState(step=0, params=variables["params"], batch_stats={},
                       opt_state=opt.init(variables["params"]))
    new_state, metrics = jax.jit(train_step)(state, jbatch, jax.random.PRNGKey(0), LR)
    return (variables, batch, np.asarray(logits), float(metrics["loss"]), new_state.opt_state[0],
            new_state.params)


def test_m2_classifier_logits_match_jax(tiny_m2_step):
    """Eval logits (kernel 15 alone, plain here) within 1e-5; the port's
    variables export back to the JAX tree unchanged, and its state dict,
    in the reference's names, converts to that tree with the JAX package's
    ``convert_vssm_state_dict``."""
    variables, batch, logits, *_ = tiny_m2_step
    model = vssm.VSSM(out_indices=None, **TINY_M2).eval()
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model(T(batch["image1"]))
    assert got.shape == (BATCH, 10) and _rel(got, logits) <= 1e-5
    exported = export_jax_variables(model)
    converted = convert_vssm_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    verify_tree_matches(converted, variables["params"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [k.key for k in path]
        np.testing.assert_array_equal(_leaf(exported, keys), leaf)
        np.testing.assert_array_equal(_leaf(converted, keys[1:]), leaf)


def test_m2_classifier_train_step_matches_jax(tiny_m2_step):
    """One ``make_train_step(..., two_view=False)`` step (kernels 15 and 16,
    plain here) against JAX: the loss (1e-5), every gradient (2e-4 of its
    tensor's largest gradient) and the parameters after Adam (2 lr where a
    gradient near zero may flip the first update's sign)."""
    variables, batch, _, loss_ref, grads_ref, params_ref = tiny_m2_step
    model = vssm.VSSM(out_indices=None, **TINY_M2)
    load_jax_variables(model, variables)
    optimizer = loop.make_optimizer(TrainConfig(lr=LR), model.parameters())
    train_step, _ = loop.make_train_step(model, optimizer, multilabel=False, two_view=False)
    launches = ssd_chunk.ssd_fwd.launches
    out = train_step({"image1": T(batch["image1"]), "label": T(batch["label"]).long()})
    assert ssd_chunk.ssd_fwd.launches == launches     # CPU tensors: the plain twins
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


@pytest.mark.parametrize("size", ["small", "base"])
def test_m2_parameter_trees_match_jax(size):
    """``vmamba_{small,base}_m2`` have JAX's parameters, name for name and
    shape for shape (``jax.eval_shape``, nothing materialised on the JAX
    side), the m0 leaves (x_proj_weight, A_logs, Ds, dt_projs_bias) raw."""
    jfactory = dict(small=jax_vmamba_small_m2, base=jax_vmamba_base_m2)[size]
    shapes = jax.eval_shape(jfactory().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path({"params": shapes["params"]})}
    factory = dict(small=vssm.vmamba_small_m2, base=vssm.vmamba_base_m2)[size]
    model = factory(device="cpu")
    assert not model.training and not model.stage_kernels
    state = model.state_dict()
    seen = set()
    for key, (jpath, to_port, _) in jax_paths(model).items():
        assert jpath in want, key
        assert tuple(state[key].shape) == to_port(np.zeros(want[jpath], np.float32)).shape, key
        seen.add(jpath)
    assert seen == set(want)
    d = 96 if size == "small" else 128
    op = model.layers[0].blocks[0].op
    assert op.x_proj_weight.shape == (4, d // 16 + 128, d) and op.Ds.shape == (4, d // 16, 16)


def test_bfloat16_m2_takes_the_composable_route(monkeypatch):
    """A bfloat16 m2 model never reaches the stage kernels (1, 4-6), in
    eval or training mode; XFMamba's backbone configuration still does."""
    def refuse(*args, **kw):
        raise AssertionError("a stage kernel ran")

    for name in ("vss_stage", "vss_stage_train", "vss_block_train_op"):
        monkeypatch.setattr(vssm, name, refuse)
    assert vssm.stage_kernels_apply("v05_noz", 1, "silu")
    assert not vssm.stage_kernels_apply("m0_noz", 64, "gelu")
    model = vssm.vmamba_tiny_m2(device="cpu", depths=(1, 1, 1, 1), dims=16, num_classes=4,
                                drop_path_rate=0.0)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    with torch.no_grad():
        logits = model(x)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    model.train()
    model(x).float().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
