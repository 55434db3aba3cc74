"""The port's device preprocessing stage (``data/device_pipeline.py``, the
kernel's plain version on the CPU) against the JAX package's
(``xfmamba_tpu/data/device_pipeline.py``).

``jax.random`` draws cannot be replayed in torch, so the augmentation
parameters are drawn from the JAX key exactly as JAX's stage draws them
(``_random_crop``'s split into top and left keys, ``_random_hflip``,
``_random_rotate_nearest``, ``train_batch``'s three-way split, and
``make_train_step``'s ``fold_in(rngs["dropout"], 0x5eed)`` and split per
view) and handed to the port as rows.  Held: `StagingTransform` bit for
bit; ``eval_batch`` within 1e-6 (at 224 and on a real downscale 64 -> 32);
crops and flips exact, the rotation's source indices exact (a pixel whose
source lies within 1e-4 of a rounding tie may round the other way in
XLA's float32 arithmetic: the test counts them and allows only those), the
whole train batch within 1e-5; the three stages' settings; the hip loader
staging uint8 where JAX's does not (a JAX fault); ``make_train_step(...,
preprocess=...)`` on the smoke geometry against JAX's step (loss 1e-5,
gradients 2e-4 of each tensor's largest, as ``tests/test_torch_train.py``);
``fit`` with the stage resuming bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_driver import BATCH, IMAGE, _in_memory, _loaders, _quiet
from test_torch_parity import jax_variables
from torch_datasets_tree import write_hip_tree
from xfmamba_tpu.data import device_pipeline as jdp
from xfmamba_tpu.data import hipxray as jax_hip
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
from xfmamba_tpu_torch.checkpoint import io as ckpt
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.cli import build_model_by_name
from xfmamba_tpu_torch.data import device_pipeline as dp
from xfmamba_tpu_torch.data import hipxray
from xfmamba_tpu_torch.data.loader import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data.transforms import TwoViewTransform
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.ops import device_preprocess as op
from xfmamba_tpu_torch.train import driver, loop
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def jax_draws(stage, batch, key):
    """The parameters JAX's ``train_batch(u8, key)`` draws for ``batch``
    images, as `DevicePreprocess.draw_params` returns them."""
    kc, kf, kr = jax.random.split(key, 3)
    h, w = stage.image_size
    zeros = np.zeros(batch, np.int64)
    top = left = zeros
    if stage.crop:
        c = min(stage.crop, *stage.image_size)
        if (h, w) != (c, c):
            kt, kl = jax.random.split(kc)
            top = np.asarray(jax.random.randint(kt, (batch,), 0, h - c + 1), np.int64)
            left = np.asarray(jax.random.randint(kl, (batch,), 0, w - c + 1), np.int64)
    flip = (np.asarray(jax.random.bernoulli(kf, 0.5, (batch,))) if stage.hflip
            else zeros.astype(bool))
    angle = (np.asarray(jax.random.uniform(kr, (batch,), minval=-stage.rotation,
                                           maxval=stage.rotation))
             if stage.rotation else np.zeros(batch, np.float32))
    return {"top": T(top.copy()), "left": T(left.copy()), "flip": T(flip.copy()),
            "angle": T(np.array(angle, np.float32))}


# ---------------------------------------------------------------------------
# the host half and the eval transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [((300, 251), (224, 224)), ((48, 40), (32, 32)),
                                        ((224, 224), (224, 224)), ((17, 29), (37, 41))])
def test_staging_transform_is_jax_bitwise(shape, size):
    """The uint8 staging resize equals JAX's (cv2's) bit for bit."""
    img = _u8(shape, sum(shape))
    got = dp.StagingTransform(size)(img)
    want = jdp.StagingTransform(size)(img)
    assert got.dtype == np.uint8 and got.shape == size + (1,)
    np.testing.assert_array_equal(got, want)


def test_eval_batch_matches_jax_and_the_host_transform():
    """At 224 (the resize the identity): JAX's ``eval_batch`` and the
    port's host eval transform within 1e-6."""
    imgs = _u8((4, 224, 224), 0)
    staged = np.stack([dp.StagingTransform()(im) for im in imgs])
    got = dp.mura_device_preprocess().eval_batch(T(staged)).numpy()
    want = np.asarray(jdp.mura_device_preprocess().eval_batch(jnp.asarray(staged)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    host = np.stack([TwoViewTransform(train=False)(im) for im in imgs])
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,size", [((64, 64), (32, 32)), ((64, 48), (32, 40)),
                                        ((20, 17), (37, 41))])
def test_eval_resize_matches_jax(shape, size):
    """A real downscale (64 -> 32), a mixed one and an upscale: JAX's
    ``jax.image.resize(..., antialias=False)`` within 1e-6."""
    u8 = _u8((3,) + shape + (1,), 1)
    kw = dict(image_size=size, crop=None, hflip=False, rotation=0.0, normalize_mean=None,
              normalize_std=None)
    got = dp.DevicePreprocess(**kw).eval_batch(T(u8)).numpy()
    want = np.asarray(jdp.DevicePreprocess(**kw).eval_batch(jnp.asarray(u8)))
    assert got.shape == want.shape == (3,) + size + (1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the train transform with JAX's draws
# ---------------------------------------------------------------------------

# (stage factory, staged size, image size): MURA at 224 (no crop draw),
# MURA staged at 288 with image size 256 and crop 224 (resize and crop both
# act), CheXpert (no normalize), CBIS-DDSM (no crop, no normalize)
TRAIN_CASES = [("mura", 224, 224), ("mura", 288, 256), ("chexpert", 72, 64),
               ("ddsm", 64, 48)]
FACTORIES = {"mura": (dp.mura_device_preprocess, jdp.mura_device_preprocess),
             "chexpert": (dp.chexpert_device_preprocess, jdp.chexpert_device_preprocess),
             "ddsm": (dp.ddsm_device_preprocess, jdp.ddsm_device_preprocess)}


def _ties(stage, rows, jax_index, port_index):
    """The mask of pixels whose source differs between JAX and the port
    (-1: the zero fill); each must lie within 1e-4 of a rounding tie of
    the port's float32 map."""
    c = stage.crop_size
    h, w = (c, c) if c else stage.image_size
    cy, cx = np.float32((h - 1) / 2.0), np.float32((w - 1) / 2.0)
    yy = np.arange(h, dtype=np.float32)[None, :, None] - cy
    xx = np.arange(w, dtype=np.float32)[None, None, :] - cx
    cs, sn = rows[:, 3].numpy()[:, None, None], rows[:, 4].numpy()[:, None, None]
    fx = (cs * xx - sn * yy) + cx
    fy = (sn * xx + cs * yy) + cy
    near = (np.abs(np.abs(fx - np.floor(fx)) - 0.5) < 1e-4) | \
        (np.abs(np.abs(fy - np.floor(fy)) - 0.5) < 1e-4)
    differ = jax_index != port_index
    assert not (differ & ~near).any()
    return differ


@pytest.mark.parametrize("name,staged,size", TRAIN_CASES)
def test_train_batch_matches_jax_draws(name, staged, size):
    """Parameters from JAX's key: crops and flips exact (rotation off);
    the rotation's source of every pixel exact but at ties, whose pixels
    are counted and allowed; the whole batch within 1e-5 elsewhere."""
    ours, theirs = (f((size, size)) for f in FACTORIES[name])
    B = 8
    u8 = _u8((B, staged, staged, 1), staged)
    key = jax.random.PRNGKey(size)
    params = jax_draws(theirs, B, key)
    rows = ours.rows(params)
    # crop and flip alone: exact
    flat = [dataclasses.replace(s, rotation=0.0) for s in (ours, theirs)]
    np.testing.assert_allclose(flat[0].train_batch(T(u8), rows).numpy(),
                               np.asarray(flat[1].train_batch(jnp.asarray(u8), key)),
                               rtol=0, atol=1e-6)
    # the rotation's source indices, read from a ramp through JAX's rotation
    c = ours.crop_size
    h, w = (c, c) if c else ours.image_size
    ramp = np.broadcast_to(np.arange(h * w, dtype=np.float32).reshape(1, h, w, 1) + 1,
                           (B, h, w, 1))
    _, _, kr = jax.random.split(key, 3)
    jax_src = np.asarray(jdp._random_rotate_nearest(jnp.asarray(ramp), kr, theirs.rotation))
    jax_index = jax_src[..., 0].astype(np.int64) - 1
    sy, sx, valid = op.rotation_source(h, w, rows[:, 3], rows[:, 4])
    port_index = np.where(valid.numpy(), (sy * w + sx).numpy(), -1)
    ties = _ties(ours, rows, jax_index, port_index)
    print(f"{name} {staged}->{size}: {int(ties.sum())} of {ties.size} pixels at a tie")
    got = ours.train_batch(T(u8), rows).numpy()[..., 0]
    want = np.asarray(theirs.train_batch(jnp.asarray(u8), key))[..., 0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[~ties], want[~ties], rtol=0, atol=1e-5)


def test_stage_settings_match_jax():
    """The three stages' fields, train and eval, at two image sizes."""
    for ours, theirs in FACTORIES.values():
        for size in ((224, 224), (256, 256)):
            for train in (True, False):
                a, b = ours(size, train), theirs(size, train)
                assert {f.name: getattr(a, f.name) for f in dataclasses.fields(b)} == \
                    dataclasses.asdict(b)


def test_draw_params_follow_jax_distributions():
    """Offsets in [0, h - crop], flips about half, angles in ±30 and about
    uniform; the stage's generator is its own and seeded."""
    stage = dp.mura_device_preprocess((256, 256), seed=4)
    p = stage.draw_params(4000)
    assert int(p["top"].min()) == 0 and int(p["top"].max()) == 32
    assert int(p["left"].min()) == 0 and int(p["left"].max()) == 32
    assert 0.45 < float(p["flip"].float().mean()) < 0.55
    assert float(p["angle"].abs().max()) <= 30.0 and abs(float(p["angle"].mean())) < 1.0
    again = dp.mura_device_preprocess((256, 256), seed=4).draw_params(4000)
    assert all(torch.equal(p[k], again[k]) for k in p)
    none = dp.ddsm_device_preprocess((64, 64)).draw_params(5)
    assert not none["top"].any() and not none["left"].any()


def test_hip_loader_stages_u8_where_jax_does_not(tmp_path):
    """JAX fault: its hip loader never reads ``device_preprocess``
    (``xfmamba_tpu/data/hipxray.py:58-80``), so its batches stay host-
    transformed, normalized floats, which JAX's CLI then feeds to MURA's
    device stage as if they were bytes.  The port's hip loader stages uint8,
    and its device eval batch equals the host eval transform's."""
    images, csv_path = write_hip_tree(str(tmp_path), n=12, size=(80, 64), distinct=4, seed=2)
    cfg = dict(seed=0, image_size=(32, 32), batch_size=4, num_workers=2, device_preprocess=True)
    ours = hipxray.create_data_loaders(images, csv_path, cfg)[1]
    theirs = jax_hip.create_data_loaders(images, csv_path, cfg)[1]
    staged, host = next(iter(ours)), next(iter(theirs))
    assert staged["image1"].dtype == np.uint8 and staged["image1"].shape == (4, 32, 32, 1)
    assert host["image1"].dtype == np.float32 and host["image1"].min() < 0
    plain = hipxray.create_data_loaders(images, csv_path, dict(cfg, device_preprocess=False))[1]
    want = next(iter(plain))
    stage = dp.mura_device_preprocess((32, 32))
    nv = staged["n_valid"]
    for k in ("image1", "image2"):
        np.testing.assert_allclose(stage.eval_batch(T(staged[k][:nv])).numpy(), want[k][:nv],
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step and fit with the stage
# ---------------------------------------------------------------------------

SMOKE = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
             backbone_overrides=dict(depths=(1, 1, 1, 1), dims=16, drop_path_rate=0.0))
STEP_B, LR = 4, 1e-3


@pytest.fixture(scope="module")
def jax_step():
    """JAX's loss, gradients and logits after one step of the smoke model
    with MURA's stage at 32² on staged uint8 views (``tests/
    test_device_pipeline.py``'s geometry, drop paths off), and the
    augmentation parameters it drew for each view."""
    jmodel = JaxTwoView(**SMOKE)
    stage = jdp.mura_device_preprocess((IMAGE, IMAGE))
    zeros = jnp.zeros((STEP_B, IMAGE, IMAGE, 1))
    variables = jax_variables(jmodel, 3, zeros, zeros)
    batch = {"image1": _u8((STEP_B, IMAGE, IMAGE, 1), 6), "image2": _u8((STEP_B, IMAGE, IMAGE, 1), 7),
             "label": np.array([0, 1, 0, 1], np.int32)}
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
    train_step, _ = jax_make_train_step(jmodel, opt, multilabel=False, jit_compile=False,
                                        preprocess=stage)
    state = TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))
    rng = jax.random.PRNGKey(0)
    new_state, metrics = jax.jit(train_step)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                             rng, LR)
    pkey = jax.random.fold_in(jax.random.fold_in(rng, 0), 0x5eed)
    ours = dp.mura_device_preprocess((IMAGE, IMAGE))
    draws = [jax_draws(stage, STEP_B, k) for k in jax.random.split(pkey, 2)]
    return (variables, batch, float(metrics["loss"]), np.asarray(metrics["logits"]),
            new_state.opt_state[0], draws)


def test_train_step_with_preprocess_matches_jax(jax_step, monkeypatch):
    """The port's step with the stage, its ``draw_params`` giving JAX's
    draws view by view: loss within 1e-5, logits 1e-5 of the largest,
    every gradient 2e-4 of its tensor's largest; the eval step takes
    ``eval_batch``."""
    variables, batch, loss_ref, logits_ref, grads_ref, draws = jax_step
    model = TwoViewXFMamba(**SMOKE)
    load_jax_variables(model, variables)
    optimizer = loop.make_optimizer(TrainConfig(lr=LR), model.parameters())
    stage = dp.mura_device_preprocess((IMAGE, IMAGE))
    train_step, eval_step = loop.make_train_step(model, optimizer, multilabel=False,
                                                 preprocess=stage)
    tb = {"image1": T(batch["image1"]), "image2": T(batch["image2"]),
          "label": T(batch["label"]).long()}
    drawn = stage.generator.get_state()
    with monkeypatch.context() as m:
        given = iter(draws)
        m.setattr(stage, "draw_params", lambda B, generator=None: next(given))
        out = train_step(tb)
        assert next(given, None) is None
    assert torch.equal(stage.generator.get_state(), drawn)
    assert abs(float(out["loss"]) - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))
    np.testing.assert_allclose(out["logits"].numpy(), logits_ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(logits_ref).max()))
    params = dict(model.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(model).items():
        if jpath[0] != "params":
            continue
        want = grads_ref
        for name in jpath[1:]:
            want = want[name]
        want = to_port(np.asarray(want))
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(params[key].grad.numpy(), want, rtol=0, atol=2e-4 * scale,
                                   err_msg=key)
    # unpatched, the step draws from the stage's generator, two views' worth
    train_step(tb)
    assert not torch.equal(stage.generator.get_state(), drawn)
    ev = eval_step(tb)
    views = [stage.eval_batch(tb[k]) for k in ("image1", "image2")]
    model.eval()
    with torch.no_grad():
        assert torch.equal(ev["logits"], model(*views))


def _resume_run(tmp, epochs, init_state=None):
    model, _ = build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=3)
    train, val = _in_memory(4, 12, float_views=False), _in_memory(5, 5, float_views=False)
    staged = dp.StagingTransform((IMAGE, IMAGE))
    loaders = _loaders(types.SimpleNamespace(TwoViewLoader=TwoViewLoader,
                                             TwoViewSamples=TwoViewSamples),
                       train, val, (staged, staged))
    cfg = TrainConfig(epochs=epochs, lr=1e-3, scheduler="reduce", batch_size=BATCH,
                      data_parallel=False, log_every=0, seed=0)
    stage = dp.mura_device_preprocess((IMAGE, IMAGE), seed=9)
    state, hist = driver.fit(model, cfg, *loaders, init_state=init_state, log_fn=_quiet,
                             out_dir=str(tmp), preprocess=stage)
    return model, state, hist, stage


def test_fit_with_the_stage_resumes_bitwise(tmp_path):
    """One epoch, then a second from its ``last.pt`` with new objects,
    equals two uninterrupted epochs bit for bit: parameters, optimizer
    moments, the drop-path and the stage's generators, history."""
    model_a, state_a, hist_a, stage_a = _resume_run(tmp_path / "a", 2)
    _resume_run(tmp_path / "b", 1)
    saved = ckpt.load_state(str(tmp_path / "b" / "last.pt"))
    assert saved["preprocess_generator"] is not None
    model_b, state_b, hist_b, stage_b = _resume_run(tmp_path / "b", 2, init_state=saved)
    assert not torch.equal(stage_a.generator.get_state(),
                           dp.mura_device_preprocess((IMAGE, IMAGE), seed=9).generator.get_state())
    assert torch.equal(stage_a.generator.get_state(), stage_b.generator.get_state())
    sa, sb = model_a.state_dict(), model_b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for (ka, ma), (kb, mb) in zip(state_a["optimizer"]["state"].items(),
                                  state_b["optimizer"]["state"].items()):
        assert ka == kb and all(torch.equal(ma[n], mb[n]) for n in ma)
    timings = ("time_s", "loader_wait_s", "first_batch_wait_s")
    strip = [{k: v for k, v in h[part].items() if k not in timings}
             for h in hist_a for part in ("train", "val")]
    strip_b = [{k: v for k, v in h[part].items() if k not in timings}
               for h in hist_b for part in ("train", "val")]
    assert strip == strip_b and len(hist_b) == 2
