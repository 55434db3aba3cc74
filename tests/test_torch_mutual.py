"""Deep mutual learning in the port (``train/mutual.py``,
``cli/train_mutual.py``) against the JAX package on the CPU, float32.

One mutual step of a two-view model (XFMamba at the smoke geometry) and a
single-view one (``SingleViewMamba`` on a tiny VMamba, its ``build_model``
shrunk with ``monkeypatch`` in both packages), drop path 0, from the same
numpy-drawn variables: the total, each model's CE and KL, the gradients
leaf by leaf, the parameters and batch statistics after Adam, and the
best-ROC file read by JAX's ``load_npz`` against JAX's file for its state.
The gradients also equal each model's own backward with detached peers
(the reference's K backwards, ``tests/test_mutual.py``'s oracle).  Then
``kl_div_loss`` and ``MutualMeter`` against JAX's, and the CLI on a
synthetic MURA tree.  Tolerances are stated in each test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from test_torch_parity import assert_close, jax_variables
from test_torch_tops import _jax_tiny_build_model, _leaf, _port_tiny_build_model
from torch_mura_tree import write_mura_tree
from xfmamba_tpu.checkpoint.io import _flatten as jax_flatten
from xfmamba_tpu.checkpoint.io import load_npz as jax_load_npz
from xfmamba_tpu.cli import train_mutual as jax_cli
from xfmamba_tpu.models import tops as jtops
from xfmamba_tpu.train import mutual as jax_mutual
from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
from xfmamba_tpu.train.loop import TrainState
from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables
from xfmamba_tpu_torch.cli import train_mutual
from xfmamba_tpu_torch.models import tops
from xfmamba_tpu_torch.train import mutual
from xfmamba_tpu_torch.train.config import TrainConfig
from xfmamba_tpu_torch.train.loop import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
BATCH, IMAGE, LR = 3, 32, 1e-3
TWO_VIEW = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
                backbone_overrides=dict(depths=(1, 1, 1, 1), dims=16, drop_path_rate=0.0))


def _shrink(mp):
    mp.setattr(jtops, "build_model", _jax_tiny_build_model)
    mp.setattr(tops, "build_model", _port_tiny_build_model)


def jax_mutual_step(label=np.array([1, 0, 1], np.int32)):
    """Both models' variables, a batch, and JAX's mutual step from them
    (Adam, lr 1e-3, weight decay 1e-5): the metrics, each model's
    gradients, and the new states with the optimizer state of the plain
    ``make_optimizer`` (an identity transformation ahead of it keeps the
    gradients).  Integer ``label`` classes train with the cross-entropy,
    float label vectors (multilabel) with the BCE."""
    rng = np.random.default_rng(8)
    batch = {"image1": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "image2": rng.standard_normal((BATCH, IMAGE, IMAGE, 1)).astype(np.float32),
             "label": label}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        jmodels = [jtops.TwoViewXFMamba(**TWO_VIEW), jtops.SingleViewMamba()]
        variables = [jax_variables(jmodels[0], 20, jb["image1"], jb["image2"]),
                     jax_variables(jmodels[1], 21, jb["image1"])]
        opts = [optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=LR)))
                for _ in jmodels]
        states = [TrainState(step=0, params=v["params"], batch_stats=v.get("batch_stats", {}),
                             opt_state=o.init(v["params"])) for v, o in zip(variables, opts)]
        step = jax_mutual.make_mutual_train_step(jmodels, opts, multilabel=label.ndim == 2,
                                                 two_view=[True, False])
        new, metrics = jax.device_get(step(states, jb, jax.random.PRNGKey(0), jnp.asarray(LR)))
    grads = [s.opt_state[0] for s in new]
    new = [TrainState(step=s.step, params=s.params, batch_stats=s.batch_stats,
                      opt_state=s.opt_state[1]) for s in new]
    return dict(variables=variables, batch=batch, new=new, grads=grads, metrics=metrics)


@pytest.fixture(scope="module")
def jax_step():
    """`jax_mutual_step` on three integer labels."""
    return jax_mutual_step()


def _port_models(variables, mp):
    _shrink(mp)
    models = [tops.TwoViewXFMamba(**TWO_VIEW), tops.SingleViewMamba()]
    for m, v in zip(models, variables):
        load_jax_variables(m, v)
    return models


def _batch(batch):
    label = T(batch["label"])
    return {"image1": T(batch["image1"]), "image2": T(batch["image2"]),
            "label": label if label.ndim == 2 else label.long()}


def port_mutual_step(jax_step, mp):
    """The port's models after one mutual step from JAX's variables, their
    optimizers, the step's output, and copies of the models from before it
    (multilabel when the batch's labels are vectors)."""
    models = _port_models(jax_step["variables"], mp)
    before = copy.deepcopy(models)
    optimizers = [make_optimizer(TrainConfig(lr=LR), m.parameters()) for m in models]
    step = mutual.make_mutual_train_step(models, optimizers,
                                         multilabel=jax_step["batch"]["label"].ndim == 2,
                                         two_view=[True, False])
    return models, optimizers, step(_batch(jax_step["batch"])), before


@pytest.fixture
def port_step(jax_step, monkeypatch):
    return port_mutual_step(jax_step, monkeypatch)


def test_mutual_step_matches_jax(jax_step, port_step):
    """`check_mutual_step` on the cross-entropy step."""
    check_mutual_step(jax_step, port_step)


def check_mutual_step(jax_step, port_step):
    """The total and each model's CE and KL (1e-5 relative), each model's
    logits (1e-5 of the largest), every gradient (2e-4 of its tensor's
    largest gradient), the parameters after
    Adam (2 lr where a gradient near zero may flip the first update's sign,
    1e-6 where Adam's input is well above the gradient tolerance), and the
    two-view model's ShallowFusion BatchNorm statistics (updated once a
    view; the variance up to n / (n - 1), torch's unbiased one)."""
    models, _, out, _ = port_step
    ref = jax_step["metrics"]
    assert abs(float(out["loss"]) - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))
    for key in ("ce_loss", "kl_loss"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-7)
    for got, want in zip(out["logits"], ref["logits"], strict=True):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert_close(got, want, 1e-5 * max(1.0, np.abs(want).max()))
    for i, model in enumerate(models):
        params = dict(model.named_parameters())
        variables = jax_step["variables"][i]
        n = 0
        for key, (jpath, to_port, _) in jax_paths(model).items():
            if jpath[0] != "params":
                continue
            want = to_port(_leaf(jax_step["grads"][i], jpath[1:]))
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(params[key].grad.numpy(), want, rtol=0,
                                       atol=2e-4 * scale, err_msg=key)
            diff = np.abs(params[key].detach().numpy()
                          - to_port(_leaf(jax_step["new"][i].params, jpath[1:])))
            assert diff.max() <= 2 * LR, key
            step_in = want + 1e-5 * to_port(_leaf(variables["params"], jpath[1:]))
            assert diff[np.abs(step_in) > 100 * 2e-4 * scale].max(initial=0) <= 1e-6, key
            n += 1
        assert n == len(params)
    bn = models[0].shallow_mamba_fusion.norm
    old = jax_step["variables"][0]["batch_stats"]["shallow_mamba_fusion"]["norm"]
    new = jax_step["new"][0].batch_stats["shallow_mamba_fusion"]["norm"]
    n = BATCH                   # one view's stage-3 map at 32 x 32 is 1 x 1
    assert_close(bn.running_mean, new["mean"], 1e-5)
    assert_close(bn.running_var.numpy() - 0.81 * old["var"],
                 (np.asarray(new["var"]) - 0.81 * old["var"]) * n / (n - 1), 1e-5)
    assert not jax_step["new"][1].batch_stats and not list(models[1].buffers())


def test_mutual_grads_equal_each_models_own_backward(jax_step, port_step):
    """The joint backward's gradients equal each model's own backward of
    CE + KL against its peer's detached softmax (1e-6 of each tensor's
    largest gradient)."""
    models, _, _, before = port_step
    b = _batch(jax_step["batch"])
    for m in before:
        m.train()
    logits = [before[0](b["image1"], b["image2"]), before[1](b["image1"])]
    for i, model in enumerate(before):
        j = 1 - i
        loss = F.cross_entropy(logits[i], b["label"]) + mutual.kl_div_loss(
            F.log_softmax(logits[i], 1), F.softmax(logits[j].detach(), 1))
        model.zero_grad()
        loss.backward(retain_graph=True)
        joint = dict(models[i].named_parameters())
        for key, p in model.named_parameters():
            want = p.grad if p.grad is not None else torch.zeros_like(p)
            scale = max(float(want.abs().max()), 1e-6)
            assert_close(joint[key].grad, want, 1e-6 * scale)


def test_best_roc_file_is_jax_s(jax_step, port_step, tmp_path):
    """The port's ``best_model_{epoch}.npz`` against JAX's
    ``save_best_roc_checkpoint`` of JAX's state after the same step, both
    read by JAX's ``load_npz``: the same keys, shapes and dtypes; epoch,
    val_roc, the step counts and the learning rate equal; the parameters
    within 2 lr, Adam's moments within 2e-4 (mu) and 4e-4 (nu) of their
    largest, the BatchNorm mean within 1e-5 (the variance is torch's
    unbiased one); the ``opt_state`` leaves are those of flax's
    ``to_state_dict`` of the optax state."""
    models, optimizers, _, _ = port_step
    for i, name in enumerate(("two", "single")):
        path = mutual.save_best_roc_checkpoint(str(tmp_path / "port"), name, models[i],
                                               optimizers[i], 3, 0.75)
        assert path == str(tmp_path / "port" / name / "best_model_3.npz")
        ref_path = jax_mutual.save_best_roc_checkpoint(str(tmp_path / "jax"), name,
                                                       jax_step["new"][i], 3, 0.75)
        got, want = jax_load_npz(path), jax_load_npz(ref_path)
        flat_got, flat_want = jax_flatten(got), jax_flatten(want)
        assert flat_got.keys() == flat_want.keys()
        for key, w in flat_want.items():
            g = flat_got[key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), key
            if key.startswith("params/"):
                assert np.abs(g - w).max() <= 2 * LR, key
            elif "/mu/" in key or "/nu/" in key:
                tol = 2e-4 if "/mu/" in key else 4e-4
                np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-12),
                                           err_msg=key)
            elif key.endswith("/mean"):
                assert_close(g, w, 1e-5)
            elif not key.endswith("/var"):
                np.testing.assert_array_equal(g, w, err_msg=key)
        opt_keys = jax_flatten(serialization.to_state_dict(jax_step["new"][i].opt_state))
        assert set(jax_flatten(got["opt_state"])) == set(opt_keys)
        assert int(got["opt_state"]["count"]) == 1 and \
            got["opt_state"]["hyperparams"]["learning_rate"] == np.float32(LR)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "sum", "none"])
def test_kl_div_loss_matches_jax(reduction):
    """Every reduction within 1e-6, a zero probability included (the
    1e-12 floor of the log)."""
    rng = np.random.default_rng(3)
    log_q = np.log(rng.dirichlet(np.ones(3), 5)).astype(np.float32)
    p = rng.dirichlet(np.ones(3), 5).astype(np.float32)
    p[0] = [0.0, 0.4, 0.6]
    got = mutual.kl_div_loss(T(log_q), T(p), reduction)
    want = jax_mutual.kl_div_loss(jnp.asarray(log_q), jnp.asarray(p), reduction)
    assert got.shape == want.shape
    assert_close(got, want, 1e-6)


def test_mutual_meter_matches_jax():
    ours, ref = mutual.MutualMeter(3, 10), jax_mutual.MutualMeter(3, 10)
    for m in (ours, ref):
        for i in range(3):
            m.update(0.5 + i, 0.1 * i, 1.25 * i, 3 + i, epoch=4)
        m.update_auc(0.625)
    assert ours.get_avg() == ref.get_avg()
    ours.reset()
    assert ours.get_avg()["loss"] == 0.0


def test_mutual_needs_two_models():
    with pytest.raises(ValueError, match="two models"):
        mutual.make_mutual_train_step([torch.nn.Linear(1, 2)], [None])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mura")
    csvs, _ = write_mura_tree(str(root), n_studies=12, n_valid=4, sizes=((40, 64), (40, 64)),
                              seed=5)
    return ["--data_root", str(root), "--train_image_csv", csvs[0], "--train_label_csv", csvs[1],
            "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3]]


def test_cli_trains_a_two_view_and_a_single_view_model(tree, tmp_path, monkeypatch, capsys):
    """Two epochs of the smoke XFMamba and a tiny SingleViewMamba on the CPU:
    per model and epoch finite CE and KL and the print line; the median ms
    per mutual step; each model's best-ROC files, which JAX's ``load_npz``
    reads with the JAX keys."""
    monkeypatch.setattr(tops, "build_model", _port_tiny_build_model)
    out = tmp_path / "dml"
    models, history = train_mutual.main(
        ["--model_names", "twoviewxfmamba_smoke", "singleviewmamba", "--image_size", "32",
         "--batch_size", "4", "--epochs", "2", "--num_workers", "1", "--device", "cpu",
         "--savemodel_path", str(out)] + tree)
    assert len(models) == 2 and len(history) == 2
    text = capsys.readouterr().out
    for epoch, h in enumerate(history):
        assert h["step_ms"] and all(np.isfinite(h["step_ms"]))
        for i, name in enumerate(("twoviewxfmamba_smoke", "singleviewmamba")):
            avg = h["models"][i]
            assert np.isfinite(avg["ce_loss"]) and np.isfinite(avg["kl_loss"]), avg
            assert avg["epoch"] == epoch and 0.0 <= avg["acc"] <= 1.0
            assert f"epoch {epoch} model[{i}] {name}: ce={avg['ce_loss']:.4f}" in text
        assert f"epoch {epoch}: {len(h['step_ms'])} mutual steps, median" in text
    written = [p for h in history for p in h["checkpoints"]]
    assert written and all(p.startswith(str(out)) for p in written)
    for path in written:
        tree_ = jax_load_npz(path)
        assert set(tree_) >= {"epoch", "val_roc", "params", "opt_state"}
        assert "inner_state" in tree_["opt_state"]


def test_cli_flags_match_jax():
    """Every flag of the JAX CLI, with its default; the port adds
    ``--device`` (default cuda)."""
    ours, ref = vars(train_mutual.parse_args([])), vars(jax_cli.parse_args([]))
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"] == "cuda" and set(ours) - set(ref) == {"device"}
