"""The port's CLIs on CheXpert, hip X-ray and CBIS-DDSM trees
(tests/torch_datasets_tree.py) on the CPU with the smoke model at 32²:
``cli.train`` an epoch on each dataset, ``cli.train_mutual --dataset
chexpert``, then ``cli.infer_chexpert`` on the checkpoint the CheXpert run
wrote and ``cli.infer_ddsm``, each against the JAX CLI on the same
checkpoint and data (per-class AUCs within 1e-6, the timing report's
lines), and the inference CLIs' flags against JAX's."""

import numpy as np
import pytest

from torch_datasets_tree import write_chexpert_tree, write_ddsm_tree, write_hip_tree
from xfmamba_tpu import cli as jax_cli
from xfmamba_tpu.cli import infer_chexpert as jax_infer_chexpert
from xfmamba_tpu.cli import infer_ddsm as jax_infer_ddsm
from xfmamba_tpu.utils import profiling as jax_profiling
from xfmamba_tpu_torch.checkpoint.convert import export_jax_variables
from xfmamba_tpu_torch.checkpoint.io import save_npz
from xfmamba_tpu_torch.cli import build_model_by_name, infer_chexpert, infer_ddsm, train
from xfmamba_tpu_torch.cli import train_mutual
from xfmamba_tpu_torch.data.chexpert import LABELS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMOKE = ["--model_name", "twoviewxfmamba_smoke", "--image_size", "32", "--device", "cpu"]
RUN = ["--batch_size", "4", "--num_workers", "2", "--epochs", "1"]
CLASSES = {"chexpert": "14", "hipxray": "3", "ddsmxray": "2"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    chex_csv, _ = write_chexpert_tree(str(root / "chexpert"), n_patients=40, size=(44, 36),
                                      seed=1)
    hip_images, hip_csv = write_hip_tree(str(root / "hip"), n=24, size=(40, 34), seed=2)
    base, meta, cases = write_ddsm_tree(str(root / "ddsm"), n_patients=40, size=(90, 60),
                                        npy=True, seed=3)
    return {
        "chexpert": ["--dataset", "chexpert", "--data_root", str(root / "chexpert"),
                     "--chexpert_csv", chex_csv],
        "hipxray": ["--dataset", "hipxray", "--hip_images_dir", hip_images, "--hip_csv", hip_csv],
        "ddsmxray": ["--dataset", "ddsmxray", "--data_root", base, "--ddsm_metadata_csv", meta,
                     "--ddsm_case_csvs", *cases],
        "chexpert_dir": str(root / "chexpert"), "chexpert_csv": chex_csv,
        "ddsm": (base, meta, cases)}


@pytest.mark.parametrize("dataset", ["chexpert", "hipxray", "ddsmxray"])
def test_train_each_dataset(trees, tmp_path, dataset):
    """One epoch of ``cli.train`` on each dataset: finite losses, the
    checkpoint files; CheXpert trains multilabel (14 sigmoid outputs, the
    mean AUC over its classes)."""
    run = tmp_path / "run"
    state, history = train.main(SMOKE + trees[dataset] + RUN + [
        "--num_classes", CLASSES[dataset], "--savemodel_path", str(run)])
    assert len(history) == 1
    assert np.isfinite(history[0]["train"]["loss"]) and np.isfinite(history[0]["val"]["loss"])
    for name in ("model_epoch_0.npz", "best.npz", "last.pt", "epoch_0/metrics.txt"):
        assert (run / name).is_file(), name


def test_train_mutual_on_chexpert(trees, tmp_path):
    """One epoch of ``cli.train_mutual --dataset chexpert``: multilabel, as
    ``fit`` trains CheXpert; finite CE and KL for both models."""
    _, history = train_mutual.main(
        ["--model_names", "twoviewxfmamba_smoke", "twoviewxfmamba_smoke", "--image_size", "32",
         "--device", "cpu", "--savemodel_path", str(tmp_path / "dml")]
        + trees["chexpert"] + RUN + ["--num_classes", "14"])
    assert len(history) == 1
    for avg in history[0]["models"]:
        assert np.isfinite(avg["ce_loss"]) and np.isfinite(avg["kl_loss"])


@pytest.mark.parametrize("drop_no_finding", [0, 1])
def test_infer_chexpert_matches_jax(trees, tmp_path, drop_no_finding):
    """``cli.infer_chexpert`` on a ``cli.train`` run's ``best.npz`` (14
    classes; 13: seeded weights) and the JAX CLI on the same file and data: the same per-class AUCs within 1e-6,
    column by column (the port names the columns in the label vector's
    order; JAX's names are one off at 14 classes), the same mean, and an
    ``inference_timing.txt`` of JAX's lines for the port's times."""
    if drop_no_finding:
        # cli.train has no 13-class protocol (as in JAX): seeded weights instead
        model, _ = build_model_by_name("twoviewxfmamba_smoke", 13, device="cpu", seed=4)
        ckpt = str(tmp_path / "w13.npz")
        save_npz(ckpt, export_jax_variables(model))
    else:
        train.main(SMOKE + trees["chexpert"] + RUN + ["--num_classes", "14", "--savemodel_path",
                                                      str(tmp_path / "run")])
        ckpt = str(tmp_path / "run" / "best.npz")
    args = ["--model_name", "twoviewxfmamba_smoke", "--image_size", "32",
            "--pretrained_model_path", ckpt, "--data_root", trees["chexpert_dir"],
            "--csv_file", trees["chexpert_csv"], "--batch_size", "4", "--num_workers", "2",
            "--drop_no_finding", str(drop_no_finding)]
    got = infer_chexpert.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want = jax_infer_chexpert.main(args + ["--out_dir", str(tmp_path / "jax")])
    assert len(got["per_class"]) == len(want["per_class"]) > 0
    np.testing.assert_allclose(list(got["per_class"].values()), list(want["per_class"].values()),
                               rtol=0, atol=1e-6)
    assert abs(got["mean_auc"] - want["mean_auc"]) <= 1e-6
    names = [l for l in LABELS if not (drop_no_finding and l == "No Finding")]
    jax_names = [l for l in jax_cli.CHEXPERT_LABELS if not (drop_no_finding and l == "No Finding")]
    kept = [jax_names.index(k) for k in want["per_class"]]
    assert list(got["per_class"]) == [names[i] for i in kept]
    report = jax_profiling.format_timing_report(got["timing"], header="CheXpert inference timing")
    assert (tmp_path / "port" / "inference_timing.txt").read_text() == report + "\n"
    assert got["timing"]["num_batches"] == want["timing"]["num_batches"]
    text = (tmp_path / "port" / "per_class_auc.txt").read_text()
    assert text.endswith(f"mean AUC ({len(got['per_class'])} classes): {got['mean_auc']:.6f}\n")


def test_infer_ddsm_matches_jax(trees, tmp_path):
    """``cli.infer_ddsm`` scores both passes; without the crop its AUCs equal
    the JAX CLI's on the same weights (npz) and pixels (the port reads the
    .dcm files, JAX the .npy beside them) within 1e-6; with the crop and a
    rescale factor both passes run (the overlay blends the cropped ROI)."""
    model, _ = build_model_by_name("twoviewxfmamba_smoke", 2, device="cpu", seed=5)
    ckpt = str(tmp_path / "w.npz")
    save_npz(ckpt, export_jax_variables(model))
    base, meta, cases = trees["ddsm"]
    args = ["--model_name", "twoviewxfmamba_smoke", "--image_size", "32",
            "--pretrained_model_path", ckpt, "--base_dir", base, "--metadata_csv", meta,
            "--case_csvs", *cases, "--batch_size", "4", "--num_workers", "2"]
    got = infer_ddsm.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want = jax_infer_ddsm.main(args + ["--out_dir", str(tmp_path / "jax")])
    assert set(got) == set(want) == {"plain", "overlay"}
    for tag in got:
        assert abs(got[tag] - want[tag]) <= 1e-6
        assert (tmp_path / "port" / f"auc_{tag}.txt").is_file()
    cropped = infer_ddsm.main(args + ["--crop", "1", "--rescale_factor", "0.8", "--out_dir",
                                      str(tmp_path / "crop"), "--device", "cpu"])
    assert set(cropped) == {"plain", "overlay"}
    assert all(0.0 <= v <= 1.0 for v in cropped.values())


@pytest.mark.parametrize("parse,jax_parse,required", [
    (infer_chexpert.parse_args, jax_infer_chexpert.parse_args,
     ["--data_root", "r", "--csv_file", "c"]),
    (infer_ddsm.parse_args, jax_infer_ddsm.parse_args,
     ["--base_dir", "b", "--metadata_csv", "m", "--case_csvs", "c"])])
def test_infer_flags_match_jax(parse, jax_parse, required):
    """Every flag of the JAX CLI, with its default; the port adds
    ``--device`` (default cuda)."""
    ours, ref = vars(parse(required)), vars(jax_parse(required))
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"] == "cuda" and set(ours) - set(ref) == {"device"}
