"""Data parallelism in the port (``xfmamba_tpu_torch/parallel``) on the CPU.

Two gloo ranks run in subprocesses (``tests/torch_parallel_worker.py``,
one torch thread each, free localhost ports) while this process computes
what they are held against:

- JAX's train step on the global batch (`test_torch_train.jax_train_step`
  at a batch of 4, drop path off), at `assert_step_matches_jax`'s
  tolerances: W ranks compute what JAX's GSPMD step computes;
- the port's one-rank runs: each BatchNorm site (ShallowFusion's shared
  BN, EarlyFusion's ``fusion_bn``), two steps with drop path and the device
  stage with a padded eval pass whose second rank holds only padding,
  ``cli.train`` and ``cli.train_mutual``.

The one-process helpers (`process_batch_slice`, `is_primary`,
`ensure_initialized`) and the loader's ``process_slice`` against JAX's run
in this process.  Under ``slow``: the two ranks against
``xfmamba_tpu.parallel.mesh``'s train and eval steps on a mesh of two of
this process's eight CPU devices.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train as ttrain
import torch_parallel_worker as worker
from test_torch_parity import assert_close, jax_variables
from test_torch_train import assert_step_matches_jax, jax_train_step
from torch_mura_tree import ArrayPairs, write_mura_tree
from xfmamba_tpu.data import loader as jax_loader
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu_torch.cli import train
from xfmamba_tpu_torch.data import TwoViewLoader, TwoViewSamples
from xfmamba_tpu_torch.data import transforms as tf
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.parallel import distributed, mesh as pmesh
from xfmamba_tpu_torch.train import metrics as M
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 2
LABEL = np.array([0, 1, 1, 0], np.int32)
TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")
SMOKE = ["--image_size", "32", "--device", "cpu", "--batch_size", "4", "--num_workers", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two ranks, computes JAX's step and the one-rank runs
    meanwhile, then reads what each rank saved."""
    out = tmp_path_factory.mktemp("ranks")
    root = tmp_path_factory.mktemp("mura")
    # 28 train pairs (7 steps of 4), 2 val pairs, one of each class: the val
    # batch's second rank holds only padding
    csvs, _ = write_mura_tree(str(root), n_studies=18, n_valid=4, sizes=((40, 64), (40, 64)),
                              seed=5)
    data = ["--data_root", str(root), "--train_image_csv", csvs[0], "--train_label_csv", csvs[1],
            "--valid_image_csv", csvs[2], "--valid_label_csv", csvs[3]]
    cli_args = ["--model_name", "twoviewxfmamba_smoke", "--epochs", "1", "--lr", "1e-3"] + \
        SMOKE + data
    mutual_args = ["--model_names", "twoviewxfmamba_smoke", "twoviewxfmamba_smoke",
                   "--epochs", "2", "--lr", "1e-3"] + SMOKE + data
    # jax_train_step's variables and batch at the global batch
    zeros = jnp.zeros((worker.GLOBAL, worker.IMAGE, worker.IMAGE, 1))
    variables = jax_variables(JaxTwoView(**worker.TINY), 0, zeros, zeros)
    rng = np.random.default_rng(1)
    batch = {k: rng.standard_normal((worker.GLOBAL, worker.IMAGE, worker.IMAGE, 1))
             .astype(np.float32) for k in ("image1", "image2")}
    batch["label"] = LABEL.astype(np.int64)
    torch.save({"variables": jax.tree_util.tree_map(np.asarray, variables), "batch": batch,
                "cli": cli_args, "mutual": mutual_args}, out / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN}
    env["OMP_NUM_THREADS"] = "1"
    ports = [distributed.free_port() for _ in range(3)]
    # ranks 0 and 1, and the one-rank runs (world 0: no process group)
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(r), str(world),
                               *map(str, ports), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, world in ((0, WORLD), (1, WORLD), (0, 0))]
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ttrain, "BATCH", worker.GLOBAL)
            jax_step = jax_train_step(label=LABEL)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {name: [torch.load(out / f"{name}_rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]
             for name in ("bn", "jax_step", "drop_path", "cli", "mutual")}
    one = {name: torch.load(out / f"{name}_one.pt", weights_only=False)
           for name in ("bn", "drop_path", "cli", "mutual")}
    return {"dir": out, "jax_step": jax_step, "variables": variables, "batch": batch,
            "one": one, "ranks": ranks}


def _close(got, want, tol, what=""):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_one_process_helpers(monkeypatch):
    """Without a process group or torchrun's environment
    `ensure_initialized` starts nothing, the process is primary and loads
    the whole batch, and the mesh is a world of one whose collectives are
    the identity; with two processes the slices are JAX's halves and an odd
    batch raises JAX's error."""
    for key in TORCHRUN:
        monkeypatch.delenv(key, raising=False)
    distributed.ensure_initialized()
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() and distributed.process_batch_slice(8) == slice(0, 8)
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank) == (1, 0)
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.gather_rows(t, 2), t[:2]) and torch.equal(mesh.mean(t), t)
    assert pmesh.shard_batch({"x": t.numpy(), "n_valid": 2}, mesh)["n_valid"] == 2
    with pytest.raises(ValueError, match="a coordinator address"):
        distributed.ensure_initialized(num_processes=2, process_id=0)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert distributed.process_batch_slice(8) == slice(4, 8)
    assert not distributed.is_primary()
    with pytest.raises(ValueError, match="global batch 7 not divisible by 2 processes"):
        distributed.process_batch_slice(7)
    two = pmesh.Mesh(2, 1, torch.device("cpu"))
    local = pmesh.shard_batch({"x": np.arange(8), "n_valid": 3}, two)
    assert local["x"].tolist() == [4, 5, 6, 7] and local["n_valid"] == 0


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_process_slice_matches_jax(shuffle, drop_last):
    """Each process's slice of every global batch, bitwise JAX's
    ``process_slice`` batches over two epochs (the train transform draws
    from per-sample generators keyed by the global index), and the slices
    together are the one-process batches.  A short padded batch gives the
    rank past its real rows a batch of padding (``n_valid`` 0) shaped as
    the others, where JAX's loader fails."""
    rng = np.random.default_rng(8)
    images = [rng.integers(0, 256, (40, 36), dtype=np.uint8) for _ in range(7)]
    samples = [(i % 7, (i * 3) % 7, i % 2) for i in range(10)]
    load, transform = ArrayPairs(images), tf.mura_train_transform((32, 32))
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=5)
    whole = list(TwoViewLoader(TwoViewSamples(samples, load, transform), **kw))
    parts = []
    for r in range(WORLD):
        ours = TwoViewLoader(TwoViewSamples(samples, load, transform), **kw)
        ref = jax_loader.TwoViewLoader(jax_loader.TwoViewSamples(samples, load, transform),
                                       **kw)
        ours.process_slice = ref.process_slice = slice(2 * r, 2 * r + 2)
        assert len(ours) == len(ref) == len(whole)
        for epoch in range(2):
            got = list(ours)
            if epoch == 0:
                parts.append(got)
            want = list(ref) if drop_last or r == 0 else None
            for i, a in enumerate(got):
                assert a["image1"].shape[0] == 2
                if want is not None:
                    assert a["n_valid"] == want[i]["n_valid"]
                    for k in ("image1", "image2", "label"):
                        np.testing.assert_array_equal(a[k], want[i][k])
    for i, b in enumerate(whole):
        for k in ("image1", "image2", "label"):
            np.testing.assert_array_equal(np.concatenate([p[i][k] for p in parts]), b[k])
        assert sum(p[i]["n_valid"] for p in parts) == b["n_valid"]
    if not drop_last:
        assert parts[1][-1]["n_valid"] == 0 and not parts[1][-1]["image1"].any()


def test_cli_train_starts_a_rank_per_card(monkeypatch):
    """Started plainly with ``--data_parallel 1`` on CUDA and two visible
    cards, ``cli.train`` starts two ranks, each in torchrun's environment;
    under torchrun, on the CPU, with ``--data_parallel 0`` or one card it
    starts none.  Its flags stay the JAX CLI's (`test_torch_cli`)."""
    for key in TORCHRUN:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = lambda *extra: train.parse_args(["--device", "cuda", *extra])  # noqa: E731
    assert train.local_ranks(args()) == 2
    assert train.local_ranks(args("--data_parallel", "0")) == 0
    assert train.local_ranks(args("--device", "cpu")) == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert train.local_ranks(args()) == 0
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert train.local_ranks(args()) == 0
    seen = []
    monkeypatch.setattr(train, "main", lambda argv: seen.append(
        (argv, {k: os.environ[k] for k in TORCHRUN})))
    train._rank_main(1, ["--epochs", "1"], 2, 1234)
    assert seen == [(["--epochs", "1"], dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                                              LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                                              MASTER_PORT="1234"))]
    for key in TORCHRUN:
        monkeypatch.delenv(key, raising=False)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["shallow_fusion", "early_fusion"])
def test_batchnorm_over_two_ranks_is_one_bn_over_the_global_batch(runs, site):
    """Each rank's rows of the outputs and input gradients (1e-5 of the
    largest), the parameter gradients summed over the ranks (1e-5 of the
    largest of the module: a gradient that is zero in exact arithmetic, as
    a bias ahead of a BatchNorm's, is rounding noise at that scale) and the
    running statistics (1e-5, float32 sums over 4096 rows in another order)
    against one rank on the whole batch: the
    statistics are the global batch's, and so is the backward's reduction."""
    one, ranks = runs["one"]["bn"][site], [r[site] for r in runs["ranks"]["bn"]]
    for key in ("y", "dx"):
        for i, want in enumerate(one[key]):
            _close(torch.cat([r[key][i] for r in ranks]), want, 1e-5, f"{site} {key}")
    assert set(ranks[0]["grads"]) == set(one["grads"])
    scale = max(float(g.abs().max()) for g in one["grads"].values())
    for k, want in one["grads"].items():
        np.testing.assert_allclose(sum(r["grads"][k] for r in ranks), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    for k, want in one["buffers"].items():
        for r in ranks:
            _close(r["buffers"][k], want, 1e-5, k)
    bn = "norm" if site == "shallow_fusion" else "model.fusion_bn"
    assert int(ranks[1]["buffers"][f"{bn}.num_batches_tracked"]) == \
        (2 if site == "shallow_fusion" else 1)


def test_two_ranks_match_jax_step_on_the_global_batch(runs):
    """One parallel step of the tiny XFMamba, ranks 0 and 1, against JAX's
    step on the global batch of 4 (`assert_step_matches_jax`: loss, the
    ranks' logits in rank order, every gradient, the parameters after Adam,
    the BN statistics); both ranks hold the same parameters bit for bit.
    The eval pass before it, gathered, is the one-rank eval step's."""
    r0, r1 = runs["ranks"]["jax_step"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert torch.equal(r0["out"]["loss"], r1["out"]["loss"])
    model = TwoViewXFMamba(**worker.TINY)
    model.load_state_dict(r0["state"])
    for k, p in model.named_parameters():
        p.grad = r0["grads"][k]
    out = {"loss": r0["out"]["loss"],
           "logits": torch.cat([r0["out"]["logits"], r1["out"]["logits"]])}
    assert_step_matches_jax(runs["jax_step"], model, out)

    from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables
    from xfmamba_tpu_torch.train import loop
    from xfmamba_tpu_torch.train.config import TrainConfig
    fresh = TwoViewXFMamba(**worker.TINY)
    load_jax_variables(fresh, runs["variables"])
    _, eval_step = loop.make_train_step(fresh, loop.make_optimizer(TrainConfig(),
                                                                   fresh.parameters()), False)
    want = eval_step({k: torch.as_tensor(v) for k, v in runs["batch"].items()})
    for r in (r0, r1):
        _close(r["eval"]["logits"], want["logits"], 1e-5, "eval logits")
        assert abs(float(r["eval"]["loss"]) - float(want["loss"])) <= 1e-5
        assert r["eval"]["label"].tolist() == LABEL.tolist() and r["eval"]["count"] == 4


def test_two_ranks_match_one_rank_with_drop_path(runs):
    """Two steps with drop path (backbone rate 0.4) and the device stage's
    augmentation, then a padded eval batch (2 valid rows of 4: the second
    rank holds only padding), against one rank on the global batches: the
    same drop-path masks and augmentation rows (the generators end in the
    same state), losses and logits (1e-5), the BN running statistics
    (1e-5), the parameters after two Adam steps (4 * lr everywhere: a sum
    of another order can flip the sign of a near-zero Adam input; 1e-6 on
    95% of each tensor, 1e-6 in the mean), the eval loss, logits and AUC."""
    one, ranks = runs["one"]["drop_path"], runs["ranks"]["drop_path"]
    for r in ranks:
        for got, want in zip(r["generators"], one["generators"]):
            assert torch.equal(got, want)
    for s, want in enumerate(one["outs"]):
        for r in ranks:
            assert abs(float(r["outs"][s]["loss"]) - float(want["loss"])) <= 1e-5
        _close(torch.cat([r["outs"][s]["logits"] for r in ranks]), want["logits"], 1e-5,
               f"step {s} logits")
    for k, want in one["state"].items():
        got = ranks[0]["state"][k]
        assert torch.equal(got, ranks[1]["state"][k]), k
        if "running" in k or "tracked" in k:
            _close(got, want, 1e-5, k)
            continue
        diff = (got - want).abs().numpy()
        assert diff.max() <= 4 * 1e-3, k
        assert (diff > 1e-6).mean() <= 0.05 and diff.mean() <= 1e-6, k
    for r in ranks:
        stats, logits, labels = r["eval"]
        want_stats, want_logits, want_labels = one["eval"]
        assert labels.tolist() == want_labels.tolist() == [0, 1]
        _close(logits, want_logits, 1e-5, "eval logits")
        assert stats["loss"] == pytest.approx(want_stats["loss"], abs=1e-5)
        assert stats["auc"] == want_stats["auc"]


def test_cli_train_two_ranks_under_torchrun(runs):
    """``cli.train`` for one epoch in two ranks started with torchrun's
    environment (gloo, ``--device cpu``): rank 0 writes every file ``fit``
    owes, rank 1 none; both end with the same weights bit for bit, and those
    are one rank's on the same global batches after its 7 Adam steps (4 *
    lr everywhere, where a near-zero Adam input flips; 1e-6 in the mean);
    the epoch's train and val loss and AUC are one rank's, the val pass
    padding the batch's second rank entirely (2 valid pairs in a batch of
    4)."""
    d = runs["dir"]
    for name in ("model_epoch_0.npz", "best.npz", "epoch_0/metrics.txt", "last.pt"):
        assert (d / "cli_rank0" / name).is_file(), name
    assert not (d / "cli_rank1").exists()
    (s0, h0), (s1, h1) = [(r["model"], r["history"]) for r in runs["ranks"]["cli"]]
    state_one, hist_one = runs["one"]["cli"]["model"], runs["one"]["cli"]["history"]
    for k, want in state_one.items():
        assert torch.equal(s0[k], s1[k]), k
        diff = (s0[k].double() - want.double()).abs()
        assert float(diff.max()) <= 4e-3 and float(diff.mean()) <= 1e-6, k
    for h in (h0, h1):
        for part in ("train", "val"):
            assert h[0][part]["loss"] == pytest.approx(hist_one[0][part]["loss"], abs=1e-5)
            assert h[0][part]["auc"] == pytest.approx(hist_one[0][part]["auc"], abs=1e-6)


def test_cli_train_mutual_over_two_processes_scores_the_gathered_logits(runs):
    """``cli.train_mutual --coordinator_address ... --num_processes 2
    --process_id r`` for two epochs: every epoch's AUC, accuracy, CE and KL
    are one process's on the same global batches, because the AUC is that
    of the logits gathered from both ranks (JAX's CLI scores the primary
    process's own shard, so two processes pick another best-ROC checkpoint
    than one); rank 0 alone writes the checkpoints, the same epochs as one
    process; both ranks' weights after 14 Adam steps are one process's (4 *
    lr everywhere, 1e-5 in the mean)."""
    one_models, one_hist = runs["one"]["mutual"]["models"], runs["one"]["mutual"]["history"]
    ranks = runs["ranks"]["mutual"]
    for r in ranks:
        for e, h in enumerate(r["history"]):
            for got, want in zip(h["models"], one_hist[e]["models"]):
                assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)
                assert got["acc"] == want["acc"]
                for key in ("ce_loss", "kl_loss", "loss"):
                    assert got[key] == pytest.approx(want[key], abs=1e-5), key
    d = runs["dir"]
    assert not (d / "mutual_rank1").exists()
    written = [os.path.relpath(p, d / "mutual_rank0") for h in ranks[0]["history"]
               for p in h["checkpoints"]]
    want = [os.path.relpath(p, d / "mutual_one") for h in one_hist for p in h["checkpoints"]]
    assert written == want and written
    assert not any(h["checkpoints"] for h in ranks[1]["history"])
    for r in ranks:
        for i, m in enumerate(r["models"]):
            for k, v in one_models[i].items():
                diff = (m[k].double() - v.double()).abs()
                assert float(diff.max()) <= 4e-3 and float(diff.mean()) <= 1e-5, k


# ---------------------------------------------------------------------------
# against JAX's parallel steps
# ---------------------------------------------------------------------------

def _jax_parallel(runs):
    """JAX's ``make_parallel_train_step`` and ``make_parallel_eval_step`` on
    ``make_mesh(2)`` from the same variables and global batch as
    `jax_train_step` (the gradients kept as it keeps them)."""
    from xfmamba_tpu.parallel.mesh import (
        make_mesh, make_parallel_eval_step, make_parallel_train_step, shard_batch)
    from xfmamba_tpu.train.config import TrainConfig as JaxTrainConfig
    from xfmamba_tpu.train.loop import TrainState
    from xfmamba_tpu.train.loop import make_optimizer as jax_make_optimizer
    from xfmamba_tpu.train.loop import make_train_step as jax_make_train_step
    assert len(jax.devices()) >= 2
    variables = runs["variables"]
    keep_grads = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    opt = optax.chain(keep_grads, jax_make_optimizer(JaxTrainConfig(lr=ttrain.LR)))
    raw_train, raw_eval = jax_make_train_step(JaxTwoView(**worker.TINY), opt,
                                              multilabel=False, jit_compile=False)
    mesh = make_mesh(2)
    state = TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]))
    jbatch = shard_batch({k: jnp.asarray(v) for k, v in runs["batch"].items()}, mesh)
    jbatch["label"] = jbatch["label"].astype(jnp.int32)
    evaluated = make_parallel_eval_step(raw_eval, mesh)(state, jbatch)
    new_state, metrics = make_parallel_train_step(raw_train, mesh)(
        state, jbatch, jax.random.PRNGKey(0), ttrain.LR)
    step = (variables, runs["batch"], new_state, float(metrics["loss"]),
            new_state.opt_state[0], np.asarray(metrics["logits"]))
    return step, evaluated


@pytest.mark.slow
def test_two_ranks_match_jax_parallel_steps_on_a_mesh_of_two(runs):
    """The two ranks' step against JAX's ``make_parallel_train_step`` on a
    mesh of two CPU devices (`assert_step_matches_jax`), and their eval
    pass against ``make_parallel_eval_step``'s logits and loss (1e-5)."""
    jstep, jeval = _jax_parallel(runs)
    r0, r1 = runs["ranks"]["jax_step"]
    model = TwoViewXFMamba(**worker.TINY)
    model.load_state_dict(r0["state"])
    for k, p in model.named_parameters():
        p.grad = r0["grads"][k]
    assert_step_matches_jax(jstep, model, {
        "loss": r0["out"]["loss"],
        "logits": torch.cat([r0["out"]["logits"], r1["out"]["logits"]])})
    _close(r0["eval"]["logits"], np.asarray(jeval["logits"]), 1e-5, "eval logits")
    assert abs(float(r0["eval"]["loss"]) - float(jeval["loss"])) <= 1e-5
    assert_close(M.roc_auc(LABEL, r0["eval"]["logits"][:, 1].numpy()),
                 M.roc_auc(LABEL, np.asarray(jeval["logits"])[:, 1]), 1e-12)
