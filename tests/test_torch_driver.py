"""The port's epoch driver on the CPU against the JAX package: metrics,
``compute_epoch_metrics``, ``EarlyStopping``, ``fit`` over two epochs of
the tiny two-view model, the checkpoint files both ways, and the three
faults of the JAX driver that the port does not copy (each in a test of
its own: the "reduce" schedule, the eval loss of a padded batch, and
checkpoints that resume)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_parity import jax_variables
from torch_mura_tree import ArrayPairs
from xfmamba_tpu.cli import load_variables as jax_load_variables
from xfmamba_tpu.data import loader as jax_loader
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.train import driver as jax_driver
from xfmamba_tpu.train import loop as jax_loop
from xfmamba_tpu.train import metrics as jax_metrics
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu_torch.checkpoint import io as ckpt
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables, load_jax_variables
from xfmamba_tpu_torch.cli import build_model_by_name, load_variables
from xfmamba_tpu_torch.data import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data.transforms import mura_eval_transform, mura_train_transform
from xfmamba_tpu_torch.models.layers import BatchNorm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.train import driver, loop
from xfmamba_tpu_torch.train import metrics as M
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
            backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16, drop_path_rate=0.0))
IMAGE, BATCH = 32, 4


def _quiet(*args, **kw):
    pass


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _same(a, b, tol):
    if isinstance(a, (list, tuple, np.ndarray)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_jax(seed):
    """roc_auc (with tied scores), the multi-label mean AUC (with a constant
    column), the confusion statistics and the ROC points: within 1e-12 of
    JAX's; a single-class column gives NaN in both."""
    rng = np.random.default_rng(seed)
    n = 50 + 7 * seed
    labels = rng.integers(0, 2, n)
    scores = np.round(rng.random(n), 1)                     # many ties
    _same(M.roc_auc(labels, scores), jax_metrics.roc_auc(labels, scores), 1e-12)
    assert np.isnan(M.roc_auc(np.ones(5), rng.random(5)))
    multi = rng.integers(0, 2, (n, 4))
    multi[:, 2] = 1
    mscores = rng.random((n, 4))
    got = M.multilabel_mean_auc(multi, mscores, return_per_label=True)
    want = jax_metrics.multilabel_mean_auc(multi, mscores, return_per_label=True)
    _same(got[0], want[0], 1e-12)
    _same(got[1], want[1], 1e-12)
    assert np.isnan(got[1][2])
    preds = rng.integers(0, 2, n)
    got, want = M.binary_confusion_stats(labels, preds), jax_metrics.binary_confusion_stats(
        labels, preds)
    assert got.keys() == want.keys()
    for k in got:
        _same(got[k], want[k], 1e-12)
    for a, b in zip(M.roc_curve_points(labels, scores),
                    jax_metrics.roc_curve_points(labels, scores)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["binary", "three_classes", "multilabel"])
def test_compute_epoch_metrics_matches_jax(kind):
    rng = np.random.default_rng(9)
    n = 40
    if kind == "multilabel":
        logits = rng.standard_normal((n, 5)).astype(np.float32)
        labels = rng.integers(0, 2, (n, 5)).astype(np.float32)
        labels[:, 1] = 0
    else:
        c = 2 if kind == "binary" else 3
        logits = (3 * rng.standard_normal((n, c))).astype(np.float32)
        labels = rng.integers(0, c, n)
    got = driver.compute_epoch_metrics(logits, labels, kind == "multilabel")
    want = jax_driver.compute_epoch_metrics(logits, labels, kind == "multilabel")
    assert got.keys() == want.keys()
    for k in got:
        _same(got[k], want[k], 1e-6)


def test_set_random_seeds_matches_jax():
    """Python's and numpy's generators seeded as JAX's ``set_random_seeds``
    seeds them; the port returns a ``torch.Generator`` seeded with the
    seed, where JAX returns a key."""
    import random
    from xfmamba_tpu.utils.misc import set_random_seeds as jax_seeds
    from xfmamba_tpu_torch.utils.misc import set_random_seeds
    jax_seeds(7)
    want = (random.random(), np.random.random())
    g = set_random_seeds(7)
    assert (random.random(), np.random.random()) == want
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(7).get_state())


# ---------------------------------------------------------------------------
# EarlyStopping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patience,delta,every", [(3, 0.0, True), (2, 0.02, False),
                                                  (10, 0.0, False)])
def test_early_stopping_matches_jax(patience, delta, every):
    """Counters, best epoch, stop flag and save calls on a scripted loss
    sequence; the port's counters survive a state_dict round trip."""
    losses = [1.0, 0.9, 0.95, 0.9, 0.89, 0.91, 0.92, 0.93, 0.5, 0.51, 0.6, 0.7]
    calls = {"port": [], "jax": []}
    ours = loop.EarlyStopping(patience, delta, lambda s, e, i: calls["port"].append((s, e, i)),
                              every)
    ref = jax_loop.EarlyStopping(patience, delta, lambda s, e, i: calls["jax"].append((s, e, i)),
                                 every)
    for epoch, v in enumerate(losses):
        assert ours(v, "state", epoch) == ref(v, "state", epoch)
        for name in ("counter", "best_score", "early_stop", "best_epoch"):
            assert getattr(ours, name) == getattr(ref, name), name
        copy = loop.EarlyStopping()
        copy.load_state_dict(ours.state_dict())
        assert copy.state_dict() == ours.state_dict()
    assert calls["port"] == calls["jax"] and calls["port"]


# ---------------------------------------------------------------------------
# the three faults of the JAX driver that the port does not copy
# ---------------------------------------------------------------------------

def _scripted_fit(module, fit, losses, cfg, model, state, tmp_path, monkeypatch, lrs):
    """Run ``module.fit`` with its epoch functions replaced: train epochs
    record their learning rate, eval epochs return ``losses`` in turn."""
    val = iter(losses)

    def train_epoch(*args, **kw):
        lrs.append(float(args[4] if module is jax_driver else args[2]))
        stats = {"loss": 1.0, "time_s": 0.0, "loader_wait_s": 0.0, "first_batch_wait_s": 0.0,
                 "steps": 1}
        return (args[1], stats) if module is jax_driver else stats

    def eval_epoch(*args, **kw):
        return {"loss": next(val), "auc": 0.5}, None, None

    monkeypatch.setattr(module, "run_train_epoch", train_epoch)
    monkeypatch.setattr(module, "run_eval_epoch", eval_epoch)
    if module is jax_driver:
        monkeypatch.setattr(module, "make_train_step", lambda *a, **kw: (None, None))
    return fit(model, cfg, types.SimpleNamespace(_epoch=0), None, init_state=state,
               log_fn=_quiet, out_dir=str(tmp_path), save_checkpoints=False)


def test_reduce_schedule_is_reduce_lr_on_plateau(tmp_path, monkeypatch):
    """Divergence 1, the "reduce" schedule: the port's learning rates are
    ``ReduceLROnPlateau(mode="min", factor=0.1, patience=10)``'s on the same
    val losses.  JAX's check compares the epoch's loss with a minimum that
    includes it, so it decays at epoch 11 of a loss that falls every
    epoch."""
    falling = [1.0 - 0.01 * e for e in range(14)]
    plateau = falling + [falling[-1] + 0.1] * 12 + [0.5] * 3
    for losses in (falling, plateau):
        cfg = dict(scheduler="reduce", lr=1e-3, epochs=len(losses), data_parallel=False,
                   log_every=0)
        ours = []
        _scripted_fit(driver, driver.fit, losses, TrainConfig(**cfg), torch.nn.Linear(2, 2),
                      None, tmp_path / "port", monkeypatch, ours)
        opt = torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=1e-3)
        sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, mode="min", factor=0.1,
                                                           patience=10)
        want = []
        for v in losses:
            want.append(opt.param_groups[0]["lr"])
            sched.step(v)
        np.testing.assert_allclose(ours, want, rtol=1e-12)
        jax_lrs = []
        _scripted_fit(jax_driver, jax_driver.fit, losses, JaxTrainConfig(**cfg), None,
                      jax_loop.TrainState(0, {}, {}, None), tmp_path / "jax", monkeypatch,
                      jax_lrs)
        if losses is falling:
            assert ours == [1e-3] * len(losses)
            assert jax_lrs[11] == pytest.approx(1e-4) and jax_lrs[10] == 1e-3
        else:
            assert min(ours) < 1e-3


def test_eval_loss_is_the_mean_over_valid_rows():
    """Divergence 2, the padded eval batch: the port's eval loss is the
    mean over the valid rows.  JAX's eval step averages the zero pad rows'
    loss into each batch's, then weights the batches by ``n_valid``."""
    rng = np.random.default_rng(10)
    batches, logits = [], []
    for nv in (4, 1):
        label = np.zeros(4, np.int32)
        label[:nv] = rng.integers(0, 2, nv)
        batches.append({"image1": np.zeros((4, 2, 2, 1), np.float32),
                        "image2": np.zeros((4, 2, 2, 1), np.float32), "label": label,
                        "n_valid": nv})
        logits.append((3 * rng.standard_normal((4, 2))).astype(np.float32))
    it = iter(logits)
    stats, got_logits, labels = driver.run_eval_epoch(
        lambda b: {"logits": torch.from_numpy(next(it))}, batches, False, "cpu")
    valid = np.concatenate([lg[:b["n_valid"]] for lg, b in zip(logits, batches)])
    want = float(F.cross_entropy(torch.from_numpy(valid), torch.from_numpy(labels).long()))
    assert stats["loss"] == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(got_logits, valid)

    jit = iter(logits)

    def jax_eval_step(state, batch):           # xfmamba_tpu/train/loop.py:150-154
        lg = jnp.asarray(next(jit))
        return {"loss": jax_loop.cross_entropy_loss(lg, batch["label"]), "logits": lg}
    jstats, jlogits, jlabels = jax_driver.run_eval_epoch(jax_eval_step, None, batches, False)
    np.testing.assert_array_equal(jlogits, valid)
    assert jstats["auc"] == pytest.approx(stats["auc"], rel=1e-12)
    assert abs(jstats["loss"] - want) > 1e-3


# ---------------------------------------------------------------------------
# fit, resume and the checkpoint files
# ---------------------------------------------------------------------------

def _flax_batch_norm(self, x):
    """Flax's update: the *biased* batch variance into the running one."""
    if not self.training:
        return _torch_batch_norm(self, x)
    self.num_batches_tracked.add_(1)
    xf = x.float()
    mean = xf.mean((0, 1, 2))
    var = xf.var((0, 1, 2), unbiased=False)
    with torch.no_grad():
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)
    y = (xf - mean) / torch.sqrt(var + self.eps) * self.weight.float() + self.bias.float()
    return y.to(x.dtype)


_torch_batch_norm = BatchNorm.forward


def _in_memory(seed, n, float_views=True):
    rng = np.random.default_rng(seed)
    if float_views:
        images = [rng.standard_normal((IMAGE, IMAGE, 1)).astype(np.float32) for _ in range(n)]
    else:
        images = [rng.integers(0, 256, (48, 40), dtype=np.uint8) for _ in range(n)]
    return images, [(i, (i + 1) % n, i % 2) for i in range(n)]


def _loaders(module, train, val, transforms=(None, None)):
    (ti, ts), (vi, vs) = train, val
    return (module.TwoViewLoader(module.TwoViewSamples(ts, ArrayPairs(ti), transforms[0]), BATCH,
                                 shuffle=True, drop_last=True, num_workers=2, seed=0),
            module.TwoViewLoader(module.TwoViewSamples(vs, ArrayPairs(vi), transforms[1]), BATCH,
                                 shuffle=False, num_workers=2, seed=0))


FIT_CFG = dict(epochs=2, lr=1e-4, scheduler="step", step_size=1, gamma=0.5, batch_size=BATCH,
               eval_batch_size=BATCH, data_parallel=False, log_every=0, seed=0, patience=100)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """JAX's ``fit`` and the port's, two epochs of the tiny model from the
    same variables on the same in-memory batches (8 train, 2 steps an
    epoch; 4 val), "step" schedule (lr 1e-4, then 5e-5), drop paths 0.  The
    port's BatchNorm takes flax's running-variance update here (see
    `_flax_batch_norm`), so that the val metrics measure the driver."""
    base = tmp_path_factory.mktemp("fit")
    jmodel = JaxTwoView(**TINY)
    zeros = jnp.zeros((BATCH, IMAGE, IMAGE, 1))
    variables = jax_variables(jmodel, 11, zeros, zeros)
    train, val = _in_memory(1, 8), _in_memory(2, 4)
    cfg = JaxTrainConfig(**FIT_CFG)
    init = jax_loop.TrainState(0, variables["params"], variables["batch_stats"],
                               jax_loop.make_optimizer(cfg).init(variables["params"]))
    jstate, jhist = jax_driver.fit(jmodel, cfg, *_loaders(jax_loader, train, val),
                                   init_state=init, log_fn=_quiet, out_dir=str(base / "jax"))
    model = TwoViewXFMamba(**TINY)
    load_jax_variables(model, variables)
    BatchNorm.forward = _flax_batch_norm
    try:
        state, hist = driver.fit(model, TrainConfig(**FIT_CFG),
                                 *_loaders(types.SimpleNamespace(
                                     TwoViewLoader=TwoViewLoader, TwoViewSamples=TwoViewSamples),
                                     train, val),
                                 log_fn=_quiet, out_dir=str(base / "port"))
    finally:
        BatchNorm.forward = _torch_batch_norm
    apply = jax.jit(lambda v, a, b: jmodel.apply(v, a, b))
    return dict(base=base, variables=variables, jstate=jstate, jhist=jhist, model=model,
                state=state, hist=hist, apply=apply, val=val)


def test_fit_matches_jax(fits):
    """Per epoch the train and val losses and AUCs within 1e-4 relative of
    JAX's, the learning rates equal; the final parameters within 1e-3 and
    the batch statistics within 1e-4."""
    jhist, hist = fits["jhist"], fits["hist"]
    assert len(hist) == len(jhist) == 2
    for h, j in zip(hist, jhist):
        assert h["epoch"] == j["epoch"]
        for part in ("train", "val"):
            for key in ("loss", "auc", "accuracy"):
                _same(h[part][key], j[part][key], 1e-4)
    assert [h["lr"] for h in hist] == pytest.approx([1e-4, 5e-5], rel=1e-12)
    got = export_jax_variables(fits["model"])
    for coll, tol in (("params", 1e-3), ("batch_stats", 1e-4)):
        want = dict(jax.tree_util.tree_leaves_with_path(fits["jstate"].__dict__[coll]))
        leaves = jax.tree_util.tree_leaves_with_path(got[coll])
        assert len(leaves) == len(want)
        for path, value in leaves:
            np.testing.assert_allclose(value, np.asarray(want[path]), rtol=0, atol=tol,
                                       err_msg=str(path))


def test_fit_writes_the_checkpoint_files(fits):
    """Both packages write model_epoch_{0,1}.npz, best.npz and
    epoch_{n}/metrics.txt; the port's npz files have JAX's keys and shapes,
    and its ``last.pt`` holds what JAX's files do not (divergence 3): the
    optimizer's moments for every parameter, the epoch, the history, the
    early-stopping counters and the loader's epoch."""
    base = fits["base"]
    names = ["model_epoch_0.npz", "model_epoch_1.npz", "best.npz", "epoch_0/metrics.txt",
             "epoch_1/metrics.txt"]
    for name in names:
        assert (base / "jax" / name).is_file() and (base / "port" / name).is_file(), name
    assert not (base / "jax" / "last.pt").exists()
    with np.load(base / "jax" / "best.npz") as j, np.load(base / "port" / "best.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        assert all(j[k].shape == p[k].shape for k in j.files)
        assert all(k.startswith(("params/", "batch_stats/")) for k in j.files)
    state = ckpt.load_state(str(base / "port" / "last.pt"))
    assert state["epoch"] == 1 and len(state["history"]) == 2
    assert state["train_loader_epoch"] == 2
    assert state["early_stopping"]["best_epoch"] in (0, 1)
    n_params = len(list(fits["model"].parameters()))
    moments = state["optimizer"]["state"]
    assert len(moments) == n_params and all("exp_avg_sq" in m for m in moments.values())


def _logits_port(path):
    model = TwoViewXFMamba(**TINY)
    load_variables(str(path), model)
    images, _ = _in_memory(2, 4)
    x = torch.from_numpy(np.stack(images))
    with torch.no_grad():
        return model.eval()(x, x.flip(0)).numpy(), x.numpy()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_bridge(fits, writer):
    """A ``best.npz`` written by either package loads into the other: JAX's
    ``cli.load_variables`` + ``model.apply`` and the port's
    ``cli.load_variables`` give logits within 1e-4 of each other."""
    path = fits["base"] / writer / "best.npz"
    got, x = _logits_port(path)
    want = fits["apply"](jax_load_variables(str(path)), jnp.asarray(x), jnp.asarray(x[::-1]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def _resume_run(tmp, epochs, init_state=None):
    model, _ = build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=3)
    train, val = _in_memory(4, 12, float_views=False), _in_memory(5, 5, float_views=False)
    loaders = _loaders(types.SimpleNamespace(TwoViewLoader=TwoViewLoader,
                                             TwoViewSamples=TwoViewSamples),
                       train, val, (mura_train_transform((IMAGE, IMAGE)),
                                    mura_eval_transform((IMAGE, IMAGE))))
    cfg = TrainConfig(epochs=epochs, lr=1e-3, scheduler="reduce", batch_size=BATCH,
                      data_parallel=False, log_every=0, seed=0)
    state, hist = driver.fit(model, cfg, *loaders, init_state=init_state, log_fn=_quiet,
                             out_dir=str(tmp))
    return model, state, hist


def test_resume_is_bitwise(tmp_path):
    """Divergence 3, checkpoints that resume: one epoch, then a second from
    its ``last.pt`` in a new process's worth of objects (model, loaders,
    optimizer), equals two uninterrupted epochs bit for bit on the CPU:
    parameters, batch statistics, optimizer moments, drop-path generator,
    history.  Drop paths are on (the smoke model's 0.2 / 0.1)."""
    model_a, state_a, hist_a = _resume_run(tmp_path / "a", 2)
    _resume_run(tmp_path / "b", 1)
    saved = ckpt.load_state(str(tmp_path / "b" / "last.pt"))
    assert saved["epoch"] == 0 and saved["train_loader_epoch"] == 1
    model_b, state_b, hist_b = _resume_run(tmp_path / "b", 2, init_state=saved)
    fresh = build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=3)[0]
    assert not torch.equal(fresh.dropout_generator.get_state(), model_a.dropout_generator.get_state())
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for (ka, ma), (kb, mb) in zip(state_a["optimizer"]["state"].items(),
                                  state_b["optimizer"]["state"].items()):
        assert ka == kb and all(torch.equal(ma[n], mb[n]) for n in ma)
    for name, g in state_a["generators"].items():
        assert torch.equal(g, state_b["generators"][name]), name
    timings = ("time_s", "loader_wait_s", "first_batch_wait_s")
    strip = [{k: v for k, v in h[part].items() if k not in timings}
             for h in hist_a for part in ("train", "val")]
    strip_b = [{k: v for k, v in h[part].items() if k not in timings}
               for h in hist_b for part in ("train", "val")]
    assert strip == strip_b and len(hist_b) == 2
