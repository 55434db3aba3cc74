"""Multilabel training in the port against the JAX package on the CPU,
float32: CheXpert's BCE on label vectors that hold 1, 0 and -1 (uncertain,
which reaches the loss unchanged in both packages), the rule of ``fit``
(``num_tasks > 1`` or ``dataset == "chexpert"``).

One ``make_train_step(multilabel=True)`` step of a tiny two-view model
(loss, logits, gradients, BatchNorm statistics and parameters after Adam,
as tests/test_torch_train.py holds the cross-entropy step), one
``make_mutual_train_step(multilabel=True)`` step (as
tests/test_torch_mutual.py holds the cross-entropy one), the eval loss of
multilabel batches with and without padding, the mean AUC's rule for -1
(a negative, where JAX's epoch metrics rank the raw value), and ``fit``
over two epochs on a synthetic CheXpert tree (tests/torch_datasets_tree.py)
through each package's own loaders.  Tolerances are stated in each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_driver import FIT_CFG, _flax_batch_norm, _quiet, _same, _torch_batch_norm
from test_torch_mutual import check_mutual_step, jax_mutual_step, port_mutual_step
from test_torch_parity import jax_variables, route  # noqa: F401 (fixture)
from test_torch_train import TINY, _check_train_step, jax_train_step
from torch_datasets_tree import write_chexpert_tree
from xfmamba_tpu.data import chexpert as jax_chexpert
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.train import driver as jax_driver
from xfmamba_tpu.train import loop as jax_loop
from xfmamba_tpu.train import metrics as jax_metrics
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables, load_jax_variables
from xfmamba_tpu_torch.data import chexpert
from xfmamba_tpu_torch.models.layers import BatchNorm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.train import driver
from xfmamba_tpu_torch.train import metrics as M
from xfmamba_tpu_torch.train.config import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHALLOW = dict(depths=(1, 1, 1, 1), dims=16, drop_path_rate=0.0)


def _labels(shape, seed):
    """A float32 label matrix of 1, 0 and -1, each present."""
    rng = np.random.default_rng(seed)
    label = rng.choice(np.float32([1, 0, -1]), size=shape)
    label.flat[:3] = (1, 0, -1)
    return label


# ---------------------------------------------------------------------------
# one train step and one mutual step
# ---------------------------------------------------------------------------

FIVE = dict(TINY, outputs=5, backbone_overrides=SHALLOW)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's multilabel step of the five-output tiny model (`jax_train_step`)."""
    return jax_train_step(FIVE, _labels((3, 5), 0))


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_multilabel_train_step_matches_jax(jax_step, use_checkpoint, route):
    """The BCE step against JAX's: loss, logits, gradients, the BatchNorm
    statistics and the parameters after Adam, each to the tolerance of
    `test_torch_train._check_train_step`."""
    _check_train_step(jax_step, use_checkpoint, FIVE)


@pytest.fixture(scope="module")
def jax_mutual():
    """JAX's multilabel mutual step (`jax_mutual_step`) on label vectors."""
    return jax_mutual_step(_labels((3, 2), 1))


def test_multilabel_mutual_step_matches_jax(jax_mutual, monkeypatch):
    """The BCE mutual step against JAX's: the total, each model's BCE and
    KL, logits, gradients, parameters and statistics, each to the tolerance
    of `test_torch_mutual.check_mutual_step`."""
    check_mutual_step(jax_mutual, port_mutual_step(jax_mutual, monkeypatch))


# ---------------------------------------------------------------------------
# the eval loss
# ---------------------------------------------------------------------------

def _eval_batches(rng, valid, classes=5):
    batches, logits = [], []
    for nv in valid:
        label = np.zeros((4, classes), np.float32)
        label[:nv] = _labels((nv, classes), int(rng.integers(1 << 30)))
        batches.append({"image1": np.zeros((4, 2, 2, 1), np.float32),
                        "image2": np.zeros((4, 2, 2, 1), np.float32), "label": label,
                        "n_valid": nv})
        logits.append((3 * rng.standard_normal((4, classes))).astype(np.float32))
    return batches, logits


def _jax_eval_step(logits):
    it = iter(logits)

    def step(state, batch):                    # xfmamba_tpu/train/loop.py:150-154
        lg = jnp.asarray(next(it))
        return {"loss": jax_loop.bce_with_logits_loss(lg, batch["label"]), "logits": lg}
    return step


def _binarized(compute_epoch_metrics):
    """JAX's ``compute_epoch_metrics`` given multilabel labels above 0.5:
    the port's rule for the mean AUC (see
    `test_mean_auc_counts_uncertain_labels_as_negatives`); its accuracy
    already thresholds so."""
    def metrics(logits, labels, multilabel):
        if multilabel:
            labels = (np.asarray(labels) > 0.5).astype(np.float32)
        return compute_epoch_metrics(logits, labels, multilabel)
    return metrics


@pytest.mark.parametrize("valid", [(4, 4), (4, 1)])
def test_multilabel_eval_loss_matches_jax(valid, monkeypatch):
    """``run_eval_epoch`` on multilabel batches: the BCE over the valid
    rows' labels.  With no padding it equals JAX's ``run_eval_epoch``
    (1e-6 relative); with a padded batch it equals JAX's BCE of the valid
    rows (JAX's own epoch loss then takes in the pad rows, the port's
    divergence that `test_torch_driver.test_eval_loss_is_the_mean_over_valid_rows`
    pins for the cross-entropy).  Logits and labels equal JAX's; the mean
    and per-label AUCs and the accuracy equal JAX's metrics on the labels
    above 0.5."""
    batches, logits = _eval_batches(np.random.default_rng(sum(valid)), valid)
    it = iter(logits)
    stats, got_logits, labels = driver.run_eval_epoch(
        lambda b: {"logits": torch.from_numpy(next(it))}, batches, True, "cpu")
    monkeypatch.setattr(jax_driver, "compute_epoch_metrics",
                        _binarized(jax_driver.compute_epoch_metrics))
    jstats, jlogits, jlabels = jax_driver.run_eval_epoch(_jax_eval_step(logits), None,
                                                         batches, True)
    np.testing.assert_array_equal(got_logits, jlogits)
    np.testing.assert_array_equal(labels, jlabels)
    assert (labels == -1).any()
    _same(stats["auc"], jstats["auc"], 1e-12)
    _same(stats["per_label_auc"], jstats["per_label_auc"], 1e-12)
    assert stats["accuracy"] == jstats["accuracy"]
    want = float(jax_loop.bce_with_logits_loss(jnp.asarray(jlogits), jnp.asarray(jlabels)))
    assert stats["loss"] == pytest.approx(want, rel=1e-6)
    if min(valid) == 4:
        assert stats["loss"] == pytest.approx(jstats["loss"], rel=1e-6)


def test_mean_auc_counts_uncertain_labels_as_negatives():
    """A fault of the JAX package not copied: its ``multilabel_mean_auc``
    ranks the raw labels, so a column holding CheXpert's -1 counts the -1
    rows against the positives (here no AUC for one column, 2.0 for the
    other).  The port's counts a label above 0.5 as positive, as its
    accuracy and ``cli.infer_chexpert`` (JAX's too) do: equal to JAX's
    function on the binarized labels, and within [0, 1]."""
    labels = np.float32([[1, 1], [1, 0], [-1, 0], [-1, 1], [0, -1]])
    scores = np.float64([[0.9, 0.8], [0.8, 0.1], [0.2, 0.3], [0.1, 0.7], [0.5, 0.2]])
    got, per = M.multilabel_mean_auc(labels, scores, return_per_label=True)
    want, want_per = jax_metrics.multilabel_mean_auc(labels > 0.5, scores,
                                                     return_per_label=True)
    assert got == want and per == want_per
    assert all(0.0 <= a <= 1.0 for a in per)
    raw = jax_metrics.multilabel_mean_auc(labels, scores, return_per_label=True)[1]
    assert np.isnan(raw[0]) and raw[1] == 2.0


# ---------------------------------------------------------------------------
# fit on a CheXpert tree
# ---------------------------------------------------------------------------

CHEX = dict(TINY, outputs=14, backbone_overrides=SHALLOW)
# 25 patients: 33 two-view samples, 24 train (6 steps of 4), 4 val (one full batch)
LOADER_CFG = dict(seed=0, image_size=(32, 32), batch_size=4, eval_batch_size=4, num_workers=2)


@pytest.fixture(scope="module")
def chexpert_fits(tmp_path_factory):
    """JAX's ``fit`` and the port's, two epochs of the tiny 14-output model
    from the same variables on a CheXpert tree, each through its own
    package's ``create_train_val_test_data_loaders`` (the train transform's
    crops, flips and rotations drawn alike), ``dataset="chexpert"`` (so
    multilabel), the "step" schedule of `test_torch_driver.fits`, drop
    paths 0, the port's BatchNorm on flax's running-variance update, and
    JAX's epoch metrics on the labels above 0.5 (`_binarized`)."""
    base = tmp_path_factory.mktemp("chexpert_fit")
    root = str(base / "tree")
    csv_path, _ = write_chexpert_tree(root, n_patients=25, size=(44, 36), seed=6)
    cfg = dict(FIT_CFG, dataset="chexpert", num_classes=14)
    jmodel = JaxTwoView(**CHEX)
    zeros = jnp.zeros((4, 32, 32, 1))
    variables = jax_variables(jmodel, 12, zeros, zeros)
    jcfg = JaxTrainConfig(**cfg)
    init = jax_loop.TrainState(0, variables["params"], variables["batch_stats"],
                               jax_loop.make_optimizer(jcfg).init(variables["params"]))
    jtrain, jval, _ = jax_chexpert.create_train_val_test_data_loaders([root], [csv_path],
                                                                     LOADER_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "compute_epoch_metrics",
                   _binarized(jax_driver.compute_epoch_metrics))
        jstate, jhist = jax_driver.fit(jmodel, jcfg, jtrain, jval, init_state=init,
                                       log_fn=_quiet, out_dir=str(base / "jax"))
    model = TwoViewXFMamba(**CHEX)
    load_jax_variables(model, variables)
    train, val, _ = chexpert.create_train_val_test_data_loaders([root], [csv_path], LOADER_CFG)
    BatchNorm.forward = _flax_batch_norm
    try:
        _, hist = driver.fit(model, TrainConfig(**cfg), train, val, log_fn=_quiet,
                             out_dir=str(base / "port"))
    finally:
        BatchNorm.forward = _torch_batch_norm
    return dict(jstate=jstate, jhist=jhist, model=model, hist=hist, train=train, val=val)


def test_chexpert_fit_matches_jax(chexpert_fits):
    """Per epoch the train and val BCE, mean AUC, per-label AUCs and
    accuracy within 1e-4 relative of JAX's, the learning rates equal; the
    final parameters within 1e-3 (the tolerance of
    `test_torch_driver.test_fit_matches_jax`) and the batch statistics
    within 1e-4 of each tensor's largest value (the fusion norm's running
    mean reaches about 3 here after 12 steps)."""
    jhist, hist = chexpert_fits["jhist"], chexpert_fits["hist"]
    assert (len(chexpert_fits["train"]), len(chexpert_fits["val"].dataset)) == (6, 4)
    assert len(hist) == len(jhist) == 2
    for h, j in zip(hist, jhist):
        assert h["epoch"] == j["epoch"]
        for part in ("train", "val"):
            for key in ("loss", "auc", "per_label_auc", "accuracy"):
                _same(h[part][key], j[part][key], 1e-4)
            assert np.isfinite(h[part]["auc"])
    assert [h["lr"] for h in hist] == pytest.approx([1e-4, 5e-5], rel=1e-12)
    got = export_jax_variables(chexpert_fits["model"])
    for coll in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_leaves_with_path(chexpert_fits["jstate"].__dict__[coll]))
        leaves = jax.tree_util.tree_leaves_with_path(got[coll])
        assert len(leaves) == len(want)
        for path, value in leaves:
            ref = np.asarray(want[path])
            tol = 1e-3 if coll == "params" else 1e-4 * max(1.0, np.abs(ref).max())
            np.testing.assert_allclose(value, ref, rtol=0, atol=tol, err_msg=str(path))
