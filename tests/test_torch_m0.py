"""m0, the Mamba-2 / SSD forward type of SS2D, in full: the port against
the JAX package on the CPU.

- The SS2D layer (``models/ss2d.py``) with its z-gate (activated, and
  ``_nozact``), chunks of 16, 32 and 64 positions, d_state 128, head width
  64, and a carried initial state over two forwards against JAX's
  ``apply(..., mutable=["ssm_state"])``; its gradients against
  ``jax.grad``.
- Kernels 15 and 16's plain twins (``ops/ssd_chunk.py``) at the geometries
  the widened gate sends to the kernels (chunks of 24 to 128, d_state past
  64, head width past 32) against JAX's ``ssd_chunk_scan`` and
  ``jax.vjp``.
- The kernels' CUDA source (``csrc/ssd_chunk.cu``) on the CPU through
  ``tests/cuda_emulator`` (the wrappers call it through ctypes on CPU
  tensors) against the plain twins at chunks of 24 and 72 with d_state 80
  and head width 40: pieces padded inside the 64-row tile, and the slab
  plan (a block per slab of 64 states by 32 columns, the slabs' parts
  summed in slab order).

Tolerances: float32 1e-4 of each output's largest magnitude against JAX
(the chunked sums run in another order), 2e-4 for the emulated kernels,
whose products are three-pass TF32 (about 21 bits of each operand).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.models.ss2d import SS2D as JaxSS2D
from xfmamba_tpu.ops.ssd import ssd_chunk_scan as jax_ssd_chunk_scan
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables, load_jax_variables
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops import ssd_chunk
from test_torch_grouped_emulated import STUBS, _check, _rewrite
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
SOURCES = ("common.cuh", "mma.cuh", "ssd_chunk.cu")
GRADS = ("dx", "ddt", "dB", "dC", "dA", "dbias", "dD", "dinit")


def _rel(got, want):
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(
        np.asarray(want)).double()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


# ---------------------------------------------------------------------------
# kernels 15 and 16's plain twins at the widened gate against JAX
# ---------------------------------------------------------------------------

def _ssd_case(seed, b, L, h, p, g, n):
    """The public layout of ``ops/ssd.py``: x (b, L, h, p), dt (b, L, h), A,
    B/C (b, L, g, n), D (h, p), dt_bias, initial states (b, h, p, n)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, L, h, p)).astype(f),
            (0.5 * rng.standard_normal((b, L, h)) - 1.0).astype(f),
            -np.exp(0.5 * rng.standard_normal(h)).astype(f),
            (0.3 * rng.standard_normal((b, L, g, n))).astype(f),
            (0.3 * rng.standard_normal((b, L, g, n))).astype(f),
            rng.standard_normal((h, p)).astype(f), (0.1 * rng.standard_normal(h)).astype(f),
            (0.5 * rng.standard_normal((b, h, p, n))).astype(f))


# (b, L, h, p, g, n, chunk): chunk 24 (a multiple of 8 below the tile),
# 72 (a 64-row piece and an 8-row piece a chunk), 128 (two whole pieces),
# d_state 128 and 80, head width 64 and 40
SSD_CASES = [(1, 50, 4, 16, 2, 128, 24),
             pytest.param(2, 150, 2, 40, 1, 16, 72, marks=pytest.mark.slow),
             pytest.param(1, 130, 2, 64, 2, 80, 128, marks=pytest.mark.slow),
             (1, 49, 2, 8, 1, 8, 16)]


@pytest.mark.parametrize("b,L,h,p,g,n,chunk", SSD_CASES)
def test_plain_twins_match_jax_at_widened_gate(b, L, h, p, g, n, chunk):
    """`ssd_chunk_scan_heads` on the CPU (the plain twins of kernels 15/16)
    against JAX's ``ssd_chunk_scan``
    with a carried state: y, the final state and every gradient."""
    assert ssd_chunk.ssd_supported(L, h, p, n, g, chunk)
    args = _ssd_case(b * L + n + chunk, b, L, h, p, g, n)
    x, dt, A, B, C, D, bias, init = args
    rng = np.random.default_rng(chunk)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gfin = rng.standard_normal(init.shape).astype(np.float32)

    def jfn(x, dt, B, C, D, bias, init):
        y, fin = jax_ssd_chunk_scan(x, dt, jnp.asarray(A), B, C, chunk, D=D, dt_bias=bias,
                                    initial_states=init, dt_softplus=True,
                                    return_final_states=True)
        return y, fin

    jargs = [jnp.asarray(a) for a in (x, dt, B, C, D, bias, init)]
    (y_j, fin_j), vjp = jax.vjp(jfn, *jargs)
    grads_j = vjp((jnp.asarray(gy), jnp.asarray(gfin)))

    t = [T(a).requires_grad_() for a in (x, dt, B, C, D, bias, init)]
    packed = ssd_chunk.pack_args(t[0], t[1], T(A), t[2], t[3], t[4], t[5], t[6])
    y, fin = ssd_chunk.ssd_chunk_scan_heads(*packed, chunk=chunk)
    bb, gg, LL, R, P = packed[0].shape
    y = y.transpose(1, 2).reshape(b, L, h, p)
    fin = fin.transpose(2, 3)
    assert _rel(y.detach(), y_j) < 1e-4 and _rel(fin.detach(), fin_j) < 1e-4
    torch.autograd.backward([y, fin], [T(gy), T(gfin)])
    for name, ten, want in zip(("x", "dt", "B", "C", "D", "bias", "init"), t, grads_j):
        assert _rel(ten.grad, want) < 1e-4, name


# ---------------------------------------------------------------------------
# the CUDA source on the emulator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated_library():
    """``csrc/ssd_chunk.cu`` built against the stub headers once into the
    port's build directory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    texts = {n: (build.CSRC_DIR / n).read_text() for n in SOURCES}
    key = hashlib.sha256("".join(texts.values()).encode() + b"".join(
        p.read_bytes() for p in sorted(STUBS.glob("*.h")))).hexdigest()[:16]
    out = build.BUILD_DIR / f"emulated_{key}"
    so = out / "libssd_chunk_emulated.so"
    if not so.exists():
        src = out / f"src.{os.getpid()}"
        src.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():
            (src / name).write_text(_rewrite(name, text))
        tmp = out / f"lib.{os.getpid()}.tmp"
        subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                        "-include", "cstring", "-I", str(STUBS), "-I", str(src), "-x", "c++",
                        str(src / "ssd_chunk.cu"), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name in ("xfm_ssd_chunk_state", "xfm_ssd_state_pass", "xfm_ssd_chunk_scan",
                 "xfm_ssd_chunk_grads", "xfm_ssd_sum"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def emulated(emulated_library, monkeypatch):
    """The emulated library bound as `build.library`, with the wrappers'
    CPU dispatch switched to the launch path, for one test."""
    monkeypatch.setattr(build, "library", lambda: emulated_library)
    monkeypatch.setattr(build, "check", _check)
    for name in ("on_cpu", "needs_grad"):
        monkeypatch.setattr(ssd_chunk, name, lambda *t: False)
    for name in ("require_cuda", "forward_only"):
        monkeypatch.setattr(ssd_chunk, name, lambda *t: None)
    monkeypatch.setattr(ssd_chunk, "stream", lambda t: None)
    return emulated_library


# (b, g, L, R, P, N, chunk): chunk 24 at d_state 80 (two slabs of N, pieces
# of 24, 24 and 2 rows); chunk 72 at head width 40 (two slabs of P; pieces
# of 64 and 8 rows, the last chunk one piece of 6); chunk 16 with two slabs
# of each (four parts of ddt) and four heads a group
EMU_CASES = [(1, 2, 50, 2, 16, 80, 24), (1, 1, 150, 2, 40, 16, 72),
             pytest.param(1, 1, 40, 4, 40, 72, 16, marks=pytest.mark.slow)]


@pytest.mark.parametrize("b,g,L,R,P,N,chunk", EMU_CASES)
def test_emulated_ssd_kernels_match_plain(emulated, b, g, L, R, P, N, chunk):
    """Kernel 15 (y, final state, every piece's state) and kernel 16 (every
    gradient, from the plain checkpoints) on the slab plan against the
    plain twins, float32, with an initial state and a final-state
    gradient."""
    rng = np.random.default_rng(L + N)
    f = np.float32
    h = g * R
    x = T(rng.standard_normal((b, g, L, R, P)).astype(f))
    dt = T((0.5 * rng.standard_normal((b, g, L, R)) - 1.0).astype(f))
    A = T(-np.exp(0.5 * rng.standard_normal(h)).astype(f))
    Bm = T((0.3 * rng.standard_normal((b, g, L, N))).astype(f))
    Cm = T((0.3 * rng.standard_normal((b, g, L, N))).astype(f))
    D = T(rng.standard_normal((h, P)).astype(f))
    bias = T((0.1 * rng.standard_normal(h)).astype(f))
    init = T((0.5 * rng.standard_normal((b, h, N, P))).astype(f))
    dy = T(rng.standard_normal((b, g, L, R, P)).astype(f))
    dfin = T(rng.standard_normal((b, h, N, P)).astype(f))
    args = (x, dt, A, Bm, Cm, D, bias, init)
    before = ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_slab_sum.launches
    y, fin, states = ssd_chunk.ssd_fwd(*args, chunk, save_states=True)
    ns, ps = ssd_chunk.slabs(N, P)
    assert (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_slab_sum.launches) == \
        (before[0] + 1, before[1] + (ns > 1))
    y_p, fin_p, states_p = ssd_chunk.ssd_fwd_plain(*args, chunk=chunk, save_states=True)
    assert states.shape == (b, h, ssd_chunk.pieces(L, chunk), N, P)
    assert _rel(y, y_p) < 2e-4 and _rel(fin, fin_p) < 2e-4 and _rel(states, states_p) < 2e-4
    got = ssd_chunk.ssd_bwd(*args[:7], states_p, dy, dfin, chunk)
    want = ssd_chunk.ssd_bwd_plain(*args[:7], states_p, dy, dfin, chunk)
    for name in GRADS:
        assert _rel(got[name], want[name]) < 2e-4, name


# ---------------------------------------------------------------------------
# the m0 SS2D layer against JAX
# ---------------------------------------------------------------------------

def _load_ss2d(port, variables):
    """A bare SS2D loads as the ``op`` of a block (the JAX out-norm sits in
    ``out_norm/norm``); the ``ssm_state`` collection goes with it."""
    holder = torch.nn.Module()
    holder.op = port
    load_jax_variables(holder, {k: {"op": v} for k, v in variables.items()})
    return holder


def _jax_vars(jmodel, seed, x):
    """The JAX layer's variables: parameters from a numpy seed (the
    parity tests' fill), a random carried state where the layer has one."""
    from test_torch_parity import jax_variables
    variables = jax_variables(jmodel, seed, jnp.asarray(x))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    if "ssm_state" in shapes:
        shape = shapes["ssm_state"]["initial_state"].shape
        variables["ssm_state"] = {"initial_state": jnp.asarray(
            (0.3 * np.random.default_rng(seed + 1).standard_normal(shape)).astype(np.float32))}
    return variables


# (forward type, d_state, ssm_ratio, chunk): the z-gate activated and
# ``_nozact``; chunks of 16, 32 and 64 (padded past the 54-position map);
# d_state 128; ssm_ratio 4 (heads of width 64)
M0_CASES = [("m0", 16, 1.0, 64), ("m0_nozact", 8, 2.0, 32), ("m0", 8, 1.0, 16),
            ("m0_noz", 128, 1.0, 32), pytest.param("m0", 16, 4.0, 64, marks=pytest.mark.slow)]


@pytest.mark.parametrize("forward_type,d_state,ssm_ratio,chunk", M0_CASES)
def test_ss2d_m0_options_match_jax(forward_type, d_state, ssm_ratio, chunk):
    """The layer's output, input gradient and every parameter gradient
    against ``jax.vjp`` of the JAX layer (1e-4), on the kernels' route
    (their plain twins)."""
    kw = dict(d_model=32, d_state=d_state, ssm_ratio=ssm_ratio, forward_type=forward_type,
              initialize="v2")
    jmodel = JaxSS2D(chunk_size=chunk, **kw)
    rng = np.random.default_rng(d_state + chunk)
    x = rng.standard_normal((2, 6, 9, 32)).astype(np.float32)
    gy = rng.standard_normal((2, 6, 9, 32)).astype(np.float32)
    variables = _jax_vars(jmodel, d_state, x)
    y_ref, vjp = jax.vjp(lambda v, x: jmodel.apply({"params": v}, x), variables["params"],
                         jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(gy))
    port = SS2D(chunk_size=chunk, **kw)
    holder = _load_ss2d(port, variables)
    P = int(32 * ssm_ratio) // 2
    assert ssd_chunk.ssd_supported(54, 8, P, d_state, 4, chunk)
    xt = T(x).requires_grad_()
    y = port(xt)
    y.backward(T(gy))
    assert _rel(y.detach(), y_ref) <= 1e-4 and _rel(xt.grad, dx) <= 1e-4
    params = dict(holder.named_parameters())
    from xfmamba_tpu_torch.checkpoint.convert import jax_paths
    for key, (jpath, to_port, _) in jax_paths(holder).items():
        tree = {"params": {"op": dparams}}
        for name in jpath:
            tree = tree[name]
        assert _rel(params[key].grad, to_port(np.asarray(tree))) <= 1e-4, key


@pytest.mark.parametrize("chunk,einsum", [(32, False), (64, True)])
def test_ss2d_m0_carried_state_matches_jax(chunk, einsum):
    """``with_initial_state``: two forwards inside `carry_ssm_state` against
    JAX's ``apply(..., mutable=["ssm_state"])`` (each output, and the state
    after each: the sum over the batch of the final state), a plain
    forward that leaves the state as it is, and the state through the
    weight bridge both ways.  d_state 128 with heads of width 64 on the
    kernels' route; d_state 4, outside ``ssd_supported``, on the einsum
    form."""
    from xfmamba_tpu_torch.models.ss2d import carry_ssm_state
    d_state = 4 if einsum else 128
    kw = dict(d_model=32, d_state=d_state, ssm_ratio=4.0 if not einsum else 1.0,
              forward_type="m0_noz", initialize="v2", with_initial_state=True)
    jmodel = JaxSS2D(chunk_size=chunk, **kw)
    rng = np.random.default_rng(chunk)
    xs = [rng.standard_normal((2, 7, 8, 32)).astype(np.float32) for _ in range(2)]
    variables = _jax_vars(jmodel, 5, xs[0])
    port = SS2D(chunk_size=chunk, **kw)
    holder = _load_ss2d(port, variables)
    assert port.initial_state.shape == variables["ssm_state"]["initial_state"].shape
    calls = __import__("xfmamba_tpu_torch.ops.ssd", fromlist=["x"]).ssd_chunk_scan.calls
    state0 = port.initial_state.clone()
    with torch.no_grad():
        port(T(xs[0]))
    assert torch.equal(port.initial_state, state0)
    jv = dict(variables)
    for x in xs:
        y_ref, upd = jmodel.apply(jv, jnp.asarray(x), mutable=["ssm_state"])
        jv = {**jv, "ssm_state": upd["ssm_state"]}
        with torch.no_grad(), carry_ssm_state(holder):
            y = port(T(x))
        assert _rel(y, y_ref) <= 1e-4
        assert _rel(port.initial_state, upd["ssm_state"]["initial_state"]) <= 1e-4
    assert not port.carry
    from xfmamba_tpu_torch.ops import ssd as port_ssd
    assert (port_ssd.ssd_chunk_scan.calls - calls > 0) == einsum
    back = export_jax_variables(holder)
    np.testing.assert_array_equal(back["ssm_state"]["op"]["initial_state"],
                                  port.initial_state.numpy())



def test_carried_state_sums_over_the_global_batch(monkeypatch):
    """Inside a data-parallel step (`layers.batch_shard`) the carried state
    becomes the sum of the final state over the global batch, as JAX's
    GSPMD step computes it: this rank's sum all-reduced over the step's
    group (the stub all-reduce adds a second rank's equal sum)."""
    from xfmamba_tpu_torch.models import layers, ss2d
    from xfmamba_tpu_torch.models.ss2d import carry_ssm_state
    op = SS2D(16, d_state=8, ssm_ratio=1.0, forward_type="m0_noz", initialize="v2",
              with_initial_state=True, generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), carry_ssm_state(op):
        op(x)
    local = op.initial_state.clone()
    op.initial_state.zero_()
    groups = []
    monkeypatch.setattr(ss2d.dist, "all_reduce",
                        lambda t, group=None: groups.append(group) or t.mul_(2))
    with torch.no_grad(), layers.batch_shard(layers.BatchShard(rank=0, world=2, rows=2)), \
            carry_ssm_state(op):
        op(x)
    assert groups == [None] and torch.allclose(op.initial_state, 2 * local)
