"""One rank of the port's data-parallel runs for ``tests/test_torch_parallel.py``,
and the one-rank runs they are held against (pytest does not collect this
module).

    python tests/torch_parallel_worker.py RANK WORLD PORT PORT_CLI PORT_MUTUAL DIR

``WORLD`` 0 runs the same scenarios in one process without a process group,
the one-rank runs (``DIR/{scenario}_one.pt``).  Each rank runs with one torch thread and takes its rows of the same global
batches.  In a gloo group on 127.0.0.1:PORT it runs, in turn: the two
BatchNorm sites (`bn_site`), one step of the tiny XFMamba from JAX's
variables in ``DIR/inputs.pt`` with an eval pass before it (`jax_step`),
two steps with drop path and the device stage and a padded eval pass
(`drop_path_run`); then, the group closed, ``cli.train`` under torchrun's
environment (``MASTER_PORT`` PORT_CLI, ``--savemodel_path
DIR/cli_rank{RANK}``) and ``cli.train_mutual --coordinator_address
127.0.0.1:PORT_MUTUAL`` (``DIR/mutual_rank{RANK}``), with the arguments in
``inputs.pt``.  What each computed goes to ``DIR/{scenario}_rank{RANK}.pt``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables  # noqa: E402
from xfmamba_tpu_torch.data import device_pipeline as dp  # noqa: E402
from xfmamba_tpu_torch.models import tops  # noqa: E402
from xfmamba_tpu_torch.models.fusion import ShallowFusionBlock  # noqa: E402
from xfmamba_tpu_torch.models.layers import BatchShard, batch_shard  # noqa: E402
from xfmamba_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from xfmamba_tpu_torch.train import driver, loop  # noqa: E402
from xfmamba_tpu_torch.train.config import TrainConfig  # noqa: E402

GLOBAL = 4          # rows of every global batch
IMAGE = 32
TINY = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
            backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16, drop_path_rate=0.0))
DROPPING = dict(TINY, backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16,
                                              drop_path_rate=0.4))


class EarlyFusionTrainBN(nn.Module):
    """A tiny TwoViewEarlyFusionMamba (backbone dims 16, depths 1/1/1/1,
    drop path 0.3) called with ``train_bn=True``: its ``fusion_bn`` takes
    the batch's statistics."""

    def __init__(self):
        super().__init__()
        cfg = tops._BACKBONE_CFG["small"]
        tops._BACKBONE_CFG["small"] = dict(depths=(1, 1, 1, 1), dims=16, drop_path_rate=0.3,
                                           ssm_ratio=2.0)
        try:
            self.model = tops.TwoViewEarlyFusionMamba(
                generator=torch.Generator().manual_seed(6),
                dropout_generator=torch.Generator().manual_seed(7)).train()
        finally:
            tops._BACKBONE_CFG["small"] = cfg

    def forward(self, x_a, x_b):
        return self.model(x_a, x_b, train_bn=True)


def bn_site(name):
    """(module in training mode, global inputs, global upstream gradients)
    of a BatchNorm site: ShallowFusion's shared BN (called once a view)
    inside its block, EarlyFusion's ``fusion_bn``."""
    rng = np.random.default_rng(11)
    if name == "shallow_fusion":
        module = ShallowFusionBlock(16, d_state=4, generator=torch.Generator().manual_seed(2),
                                    dropout_generator=torch.Generator().manual_seed(3)).train()
        shape = (GLOBAL, 3, 3, 16)
        xs = [torch.from_numpy(2 + 3 * rng.standard_normal(shape).astype(np.float32))
              for _ in range(2)]
        gys = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(2)]
    else:
        module = EarlyFusionTrainBN()
        xs = [torch.from_numpy(rng.standard_normal((GLOBAL, IMAGE, IMAGE, 1)).astype(np.float32))
              for _ in range(2)]
        gys = [torch.from_numpy(rng.standard_normal((GLOBAL, 2)).astype(np.float32))]
    return module, xs, gys


def run_bn_site(name, mesh=None):
    """Forward and backward of ``sum(y * gy)`` on this rank's rows (all rows
    without a mesh): a sum, so every rank's input and parameter gradients
    are its part of the one-rank gradients."""
    module, xs, gys = bn_site(name)
    if mesh is not None:
        xs = [pmesh.shard_batch({"x": x}, mesh)["x"] for x in xs]
        gys = [pmesh.shard_batch({"g": g}, mesh)["g"] for g in gys]
    xs = [x.requires_grad_() for x in xs]
    shard = None if mesh is None else BatchShard(mesh.rank, mesh.world, xs[0].shape[0])
    with batch_shard(shard):
        ys = module(*xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        sum((y * g).sum() for y, g in zip(ys, gys)).backward()
    return {"y": [y.detach() for y in ys], "dx": [x.grad for x in xs],
            "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.grad is not None},
            "buffers": {k: b.clone() for k, b in module.named_buffers()}}


def jax_step(mesh, inputs):
    """The tiny XFMamba from JAX's variables: the parallel eval pass on the
    global batch, then one parallel train step (Adam, lr 1e-3)."""
    model = tops.TwoViewXFMamba(**TINY)
    load_jax_variables(model, inputs["variables"])
    opt = loop.make_optimizer(TrainConfig(lr=1e-3), model.parameters())
    train_step, eval_step = loop.make_train_step(model, opt, multilabel=False)
    local = pmesh.shard_batch(inputs["batch"], mesh)
    evaluated = pmesh.make_parallel_eval_step(eval_step, mesh)(local)
    out = pmesh.make_parallel_train_step(train_step, mesh)(local)
    return {"eval": evaluated, "out": out, "state": model.state_dict(),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def drop_path_batches():
    """Two staged uint8 global batches (48 x 48, labels 0/1) and a padded
    eval batch of two valid rows in ``GLOBAL``: on two ranks the second
    holds only padding."""
    rng = np.random.default_rng(12)

    def batch(n_valid=None):
        b = {k: rng.integers(0, 256, (GLOBAL, 48, 48, 1), dtype=np.uint8)
             for k in ("image1", "image2")}
        b["label"] = np.array([0, 1, 1, 0], np.int64)
        if n_valid is not None:
            for k in b:
                b[k][n_valid:] = 0
            b["n_valid"] = n_valid
        return b
    return [batch(), batch()], batch(2)


def drop_path_run(mesh=None):
    """Two steps of the tiny XFMamba with drop path (backbone rate 0.4) and
    the device stage (crop, flip, rotation), then the padded eval pass
    through ``driver.run_eval_epoch``; on this rank's rows with a mesh,
    else on the global batches."""
    model = tops.TwoViewXFMamba(**DROPPING, generator=torch.Generator().manual_seed(3),
                                dropout_generator=torch.Generator().manual_seed(4))
    stage = dp.mura_device_preprocess((IMAGE, IMAGE), seed=5)
    opt = loop.make_optimizer(TrainConfig(lr=1e-3), model.parameters())
    train_step, eval_step = loop.make_train_step(model, opt, multilabel=False,
                                                 preprocess=stage)
    staged, padded = drop_path_batches()

    def rows(b):
        b = {k: torch.as_tensor(v) for k, v in b.items() if k != "n_valid"} | (
            {"n_valid": b["n_valid"]} if "n_valid" in b else {})
        return b if mesh is None else pmesh.shard_batch(b, mesh)

    if mesh is not None:
        train_step = pmesh.make_parallel_train_step(train_step, mesh)
    outs = [train_step(rows(b)) for b in staged]
    eval_batch = {k: v.numpy() if torch.is_tensor(v) else v for k, v in rows(padded).items()}
    evaluated = driver.run_eval_epoch(eval_step, [eval_batch], False, "cpu", torch.uint8,
                                      mesh=mesh)
    return {"outs": outs, "state": model.state_dict(), "eval": evaluated,
            "generators": (model.dropout_generator.get_state(), stage.generator.get_state())}


def one_rank(inputs, out_dir):
    """The scenarios without a process group: the plain one-device code."""
    from xfmamba_tpu_torch.cli import train, train_mutual
    results = {"bn": {name: run_bn_site(name) for name in ("shallow_fusion", "early_fusion")},
               "drop_path": drop_path_run(),
               "cli": train.main(inputs["cli"] + [
                   "--savemodel_path", os.path.join(out_dir, "cli_one")]),
               "mutual": train_mutual.main(inputs["mutual"] + [
                   "--savemodel_path", os.path.join(out_dir, "mutual_one")])}
    results["mutual"] = {"models": [m.state_dict() for m in results["mutual"][0]],
                         "history": results["mutual"][1]}
    results["cli"] = {"model": results["cli"][0]["model"], "history": results["cli"][1]}
    for name, result in results.items():
        torch.save(result, os.path.join(out_dir, f"{name}_one.pt"))


def main(rank, world, port, port_cli, port_mutual, out_dir):
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    if world == 0:
        return one_rank(inputs, out_dir)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    mesh = pmesh.make_mesh(device="cpu")
    results = {"bn": {name: run_bn_site(name, mesh)
                      for name in ("shallow_fusion", "early_fusion")},
               "jax_step": jax_step(mesh, inputs), "drop_path": drop_path_run(mesh)}
    for name, result in results.items():
        torch.save(result, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    dist.destroy_process_group()

    from xfmamba_tpu_torch.cli import train, train_mutual
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port_cli))
    state, history = train.main(inputs["cli"] + [
        "--savemodel_path", os.path.join(out_dir, f"cli_rank{rank}")])
    assert not dist.is_initialized()
    torch.save({"model": state["model"], "history": history},
               os.path.join(out_dir, f"cli_rank{rank}.pt"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        del os.environ[key]
    models, history = train_mutual.main(inputs["mutual"] + [
        "--coordinator_address", f"127.0.0.1:{port_mutual}", "--num_processes", str(world),
        "--process_id", str(rank), "--savemodel_path",
        os.path.join(out_dir, f"mutual_rank{rank}")])
    torch.save({"models": [m.state_dict() for m in models], "history": history},
               os.path.join(out_dir, f"mutual_rank{rank}.pt"))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:6]), sys.argv[6])
