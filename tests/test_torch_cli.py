"""The port's CLIs on the CPU: ``cli.train`` then ``cli.infer_mura`` on a
synthetic MURA tree (tests/torch_mura_tree.py) with the smoke model at 32²
and ``--device cpu``, the files they write, the model-name dispatch, a
single-view model fed one view, the flags against the JAX CLI's, the device
stage (``--device_preprocess 1`` on the MURA and hip trees, the stage JAX's
CLI picks for each dataset), ``--cal_flops 1`` and ``--gradcam 1``, and the
helpers against JAX's ``collect_scores`` / ``write_roc_artifacts``."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_datasets_tree import write_hip_tree
from torch_mura_tree import write_mura_tree
from torch_reference_form import reference_form
from xfmamba_tpu import cli as jax_cli
from xfmamba_tpu.data import device_pipeline as jax_dp
from xfmamba_tpu.cli import infer_mura as jax_infer
from xfmamba_tpu.cli import train as jax_train
from xfmamba_tpu_torch import cli
from xfmamba_tpu_torch.checkpoint.convert import jax_paths
from xfmamba_tpu_torch.cli import infer_mura, train
from xfmamba_tpu_torch.models import tops, vssm
from xfmamba_tpu_torch.train import driver
from xfmamba_tpu_torch.utils.flops import model_flops
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMOKE = ["--model_name", "twoviewxfmamba_smoke", "--image_size", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mura")
    csvs, _ = write_mura_tree(str(root), n_studies=24, n_valid=10, sizes=((40, 64), (40, 64)),
                              seed=5)
    data = ["--data_root", str(root), "--train_image_csv", csvs[0], "--train_label_csv", csvs[1],
            "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3]]
    return root, data


def _train(data, out, *extra):
    return train.main(SMOKE + data + ["--batch_size", "4", "--num_workers", "2",
                                      "--savemodel_path", str(out), *extra])


def test_train_then_infer(tree, tmp_path, capsys):
    """Two epochs of ``cli.train`` write every file ``fit`` owes; then
    ``cli.infer_mura`` scores the valid split with ``best.npz``, per part
    and combined, and writes ``auc_*.txt``; the parts without studies are
    skipped."""
    root, data = tree
    state, history = _train(data, tmp_path / "run", "--epochs", "2")
    assert len(history) == 2 and state["epoch"] == 1
    assert all(np.isfinite(h[p]["loss"]) for h in history for p in ("train", "val"))
    for name in ("model_epoch_0.npz", "model_epoch_1.npz", "best.npz", "epoch_0/metrics.txt",
                 "epoch_1/metrics.txt", "last.pt"):
        assert (tmp_path / "run" / name).is_file(), name
    out = tmp_path / "infer"
    aucs = infer_mura.main(SMOKE + data + ["--pretrained_model_path",
                                           str(tmp_path / "run" / "best.npz"),
                                           "--batch_size", "4", "--out_dir", str(out)])
    assert set(aucs) == {"ELBOW", "WRIST", "combined"}
    assert all(0.0 <= v <= 1.0 for v in aucs.values())
    for tag in aucs:
        text = (out / f"auc_{tag}.txt").read_text()
        assert text.startswith(f"{tag} AUC: {aucs[tag]:.6f}")
    assert "FINGER: no studies" in capsys.readouterr().out


def test_model_name_dispatch(monkeypatch):
    """Each CLI name to its factory and size; the smoke model is JAX's
    smoke geometry (every parameter and batch statistic by name and shape);
    the single-view, late-join and early-fusion names to their tops with
    JAX's ``two_view`` (their trees: ``tests/test_torch_tops.py``); an
    unknown name ValueError (as in JAX)."""
    calls = []
    monkeypatch.setattr(tops, "two_view_xfmamba",
                        lambda size, **kw: calls.append((size, kw["outputs"])) or torch.nn.Linear(1, 1))
    for name, size in (("twoviewxfmamba", "small"), ("dualfusionmambav13", "small"),
                       ("twoviewxfmamba_tiny", "tiny"), ("twoviewxfmamba_base", "base")):
        assert cli.build_model_by_name(name, 3, device="cpu")[1] is True
        assert calls[-1] == (size, 3)
        assert jax_cli.build_model_by_name(name, 3)[1] is True
    model, two_view = cli.build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu")
    assert two_view and not model.training
    jmodel, _ = jax_cli.build_model_by_name("twoviewxfmamba_smoke", 2)
    zeros = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), zeros, zeros)
    want = {tuple(k.key for k in path): leaf.shape
            for coll in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_leaves_with_path({coll: shapes[coll]})}
    state = model.state_dict()
    got = {jpath: to_jax(state[key].numpy()).shape
           for key, (jpath, _, to_jax) in jax_paths(model).items()}
    assert got == want
    for name, cls in (("singleviewmamba", "SingleViewMamba"),
                      ("twoviewlatejoinmamba", "TwoViewLateJoinMamba"),
                      ("twoviewearlyfusionmamba", "TwoViewEarlyFusionMamba")):
        monkeypatch.setattr(tops, cls, lambda **kw: calls.append((cls, kw["outputs"], kw[
            "use_checkpoint"])) or torch.nn.Linear(1, 1))
        model, two_view = cli.build_model_by_name(name, 3, device="cpu", use_checkpoint=True)
        assert calls[-1] == (cls, 3, True) and not model.training
        assert two_view is jax_cli.build_model_by_name(name, 3)[1]
        assert two_view is (name != "singleviewmamba")
    with pytest.raises(ValueError):
        cli.build_model_by_name("nope", 2, device="cpu")


def test_train_feeds_a_single_view_model_one_view(tmp_path, monkeypatch):
    """``cli.train`` with ``singleviewmamba`` (its classifier shrunk) trains
    and evaluates on ``image1`` alone: ``fit`` takes the model's
    ``two_view``.  JAX's ``fit`` never passes it, so its single-view model
    binds the second view to ``deterministic`` (ROADMAP, faults in the JAX
    reference)."""
    monkeypatch.setattr(tops, "build_model", lambda num_classes, **kw: vssm.vmamba_small_s2l15(
        num_classes, depths=(1, 1, 1, 1), dims=16, **kw))
    arity = []

    def record(module, args):
        if isinstance(module, tops.SingleViewMamba):
            arity.append((module.training, len(args)))
    csvs, _ = write_mura_tree(str(tmp_path / "mura"), n_studies=12, n_valid=4,
                              sizes=((40, 64), (40, 64)), seed=6)
    data = ["--data_root", str(tmp_path / "mura"), "--train_image_csv", csvs[0],
            "--train_label_csv", csvs[1], "--valid_image_csv", csvs[2], "--valid_label_csv",
            csvs[3]]
    handle = torch.nn.modules.module.register_module_forward_pre_hook(record)
    try:
        state, history = train.main(
            ["--model_name", "singleviewmamba", "--image_size", "32", "--device", "cpu"] + data
            + ["--batch_size", "4", "--num_workers", "1", "--epochs", "1", "--savemodel_path",
               str(tmp_path / "run")])
    finally:
        handle.remove()
    assert np.isfinite(history[0]["train"]["loss"]) and np.isfinite(history[0]["val"]["loss"])
    assert {mode for mode, _ in arity} == {True, False}
    assert {n for _, n in arity} == {1}
    assert (tmp_path / "run" / "best.npz").is_file()


@pytest.mark.parametrize("parse,jax_parse,required", [
    (train.parse_args, jax_train.parse_args, []),
    (infer_mura.parse_args, jax_infer.parse_args, ["--valid_image_csv", "v", "--valid_label_csv",
                                                   "l"])])
def test_flags_match_jax(parse, jax_parse, required):
    """Every flag of the JAX CLI, with its default; the port adds
    ``--device`` (default cuda)."""
    ours, ref = vars(parse(required)), vars(jax_parse(required))
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"] == "cuda" and set(ours) - set(ref) == {"device"}


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "chexpert", "--device_preprocess", "1"], "chexpert"),
    (["--dataset", "ddsmxray", "--device_preprocess", "1"], "ddsm"),
    (["--device_preprocess", "1"], "mura"),
    (["--dataset", "hipxray", "--device_preprocess", "1"], "mura"),
])
def test_device_preprocess_picks_jax_stage(tree, tmp_path, argv, match):
    """``--device_preprocess 1`` picks the stage JAX's CLI picks for the
    dataset (CheXpert's, CBIS-DDSM's, else MURA's, hip X-rays included), at
    the image size, with the loaders' config flag set; without the flag
    there is none."""
    args = train.parse_args(SMOKE + argv)
    stage = train.device_stage(args, 5)
    want = getattr(jax_dp, f"{match}_device_preprocess")((32, 32))
    assert {f: getattr(stage, f) for f in ("image_size", "crop", "hflip", "rotation",
                                           "normalize_mean", "normalize_std")} == vars(want)
    assert train.make_config(args)[1]["device_preprocess"] is True
    assert train.device_stage(train.parse_args(SMOKE), 5) is None


@pytest.mark.parametrize("flag", ["--cal_flops", "--gradcam"])
def test_infer_utility_flags(tree, tmp_path, flag):
    """``--cal_flops 1`` returns `model_flops` of a batch-1 forward and
    prints it; ``--gradcam 1`` scores the parts, then writes gradcam.npz
    (class 1's CAMs of the first validation batch, in [0, 1], and its
    views) and, with matplotlib, the overlays."""
    _, data = tree
    out = infer_mura.main(SMOKE + data + [flag, "1", "--batch_size", "4", "--out_dir",
                                          str(tmp_path)])
    if flag == "--cal_flops":
        model, _ = cli.build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=42)
        x = torch.zeros(1, 32, 32, 1)
        assert out == model_flops(model, x, x) and out["flops"] > 0
        return
    assert set(out) == {"ELBOW", "WRIST", "combined"}
    saved = np.load(tmp_path / "gradcam.npz")
    assert set(saved.files) == {"cam_a", "cam_b", "image1", "image2"}
    assert saved["cam_a"].shape == saved["cam_b"].shape == (4, 32, 32)
    assert saved["image1"].shape == (4, 32, 32, 1)
    for k in ("cam_a", "cam_b"):
        assert np.isfinite(saved[k]).all() and 0 <= saved[k].min() <= saved[k].max() <= 1


@pytest.fixture(scope="module")
def hip_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hip")
    images, csv_path = write_hip_tree(str(root), n=30, size=(80, 64), distinct=6, seed=4)
    return ["--dataset", "hipxray", "--hip_images_dir", images, "--hip_csv", csv_path,
            "--num_classes", "3"]


@pytest.mark.parametrize("dataset", ["mura", "hipxray"])
def test_train_with_device_preprocess(tree, hip_tree, tmp_path, dataset, monkeypatch):
    """``cli.train --device_preprocess 1``: the loaders stage uint8 (hip
    X-rays too, where JAX's loader does not), the stage's plain version
    augments and normalizes, two epochs train with finite losses, and
    ``last.pt`` holds the stage's generator."""
    data = tree[1] if dataset == "mura" else hip_tree
    seen = []
    real = driver.fit

    def spy(model, cfg, train_loader, val_loader, **kw):
        seen.append((next(iter(train_loader))["image1"].dtype, kw["preprocess"]))
        return real(model, cfg, train_loader, val_loader, **kw)
    monkeypatch.setattr(driver, "fit", spy)
    state, history = _train(data, tmp_path / "run", "--epochs", "2", "--device_preprocess", "1")
    (dtype, stage), = seen
    assert dtype == np.uint8 and stage.normalize_mean == 0.456 and stage.rotation == 30.0
    assert all(np.isfinite(h[p]["loss"]) for h in history for p in ("train", "val"))
    assert torch.equal(state["preprocess_generator"], stage.generator.get_state())


def test_infer_without_checkpoint_warns(tree, tmp_path, capsys):
    _, data = tree
    aucs = infer_mura.main(SMOKE + data + ["--body_parts", "WRIST", "--out_dir", str(tmp_path)])
    assert "WARNING: no checkpoint given" in capsys.readouterr().out
    assert set(aucs) <= {"WRIST", "combined"}


def test_load_variables_formats(tmp_path):
    """A torch file holding the state dict bare, under "model" (the port's
    ``last.pt``) or under "state_dict", or in the reference's form (legacy
    names, 4-D linear weights, the dead fusion ``in_proj``, thop counters,
    an ``argparse.Namespace`` beside it); other suffixes raise."""
    src, _ = cli.build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=1)
    reference = {"model": reference_form(src.state_dict(), np.random.default_rng(0)),
                 "args": argparse.Namespace(epochs=3)}
    for i, wrap in enumerate((lambda sd: sd, lambda sd: {"model": sd, "epoch": 3},
                              lambda sd: {"state_dict": sd}, lambda sd: reference)):
        path = str(tmp_path / f"w{i}.pth")
        torch.save(wrap(src.state_dict()), path)
        dst, _ = cli.build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=2)
        cli.load_variables(path, dst)
        for k, v in src.state_dict().items():
            assert torch.equal(v, dst.state_dict()[k]), k
    with pytest.raises(ValueError, match="unsupported"):
        cli.load_variables(str(tmp_path / "w.ckpt"), dst)


def test_scores_and_roc_files_match_jax(tmp_path):
    """``collect_scores`` (softmax[:, 1] and sigmoid, each batch's valid
    rows) and ``write_roc_artifacts`` against JAX's, on the same logits."""
    rng = np.random.default_rng(12)
    logits = [rng.standard_normal((4, 2)).astype(np.float32) for _ in range(3)]
    batches = [{"image1": np.zeros((4, 1)), "image2": np.zeros((4, 1)),
                "label": rng.integers(0, 2, 4), "n_valid": nv} for nv in (4, 4, 2)]
    for binary in (False, True):
        it, jit = iter(logits), iter(logits)
        got = cli.collect_scores(lambda a, b: next(it), batches, binary)
        want = jax_cli.collect_scores(lambda a, b: jnp.asarray(next(jit)), batches, binary)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    labels, probs, _ = got                     # the binary scores
    auc = cli.write_roc_artifacts(str(tmp_path / "p"), "X", labels, probs)
    assert auc == jax_cli.write_roc_artifacts(str(tmp_path / "j"), "X", labels, probs)
    assert (tmp_path / "p" / "auc_X.txt").read_text() == (tmp_path / "j" / "auc_X.txt").read_text()
    assert os.path.isfile(tmp_path / "p" / "roc_X.png")
