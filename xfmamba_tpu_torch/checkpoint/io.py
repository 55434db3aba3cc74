"""Checkpoint files (port of ``xfmamba_tpu/checkpoint/io.py``).

- `save_npz` / `load_npz` keep the JAX package's flat layout: one array per
  leaf of the flax variables, under its ``/``-joined path
  (``params/mamba_feature_extrac/patch_embed/conv1/conv/kernel``, ...).
  A port model's variables go in through
  `checkpoint.convert.export_jax_variables`, so its ``best.npz`` loads
  through JAX's ``cli.load_variables``; `load_model_npz` reads a JAX-written
  one into a port model through `load_jax_variables`.  BatchNorm's
  ``num_batches_tracked`` counters have no flax counterpart and are not
  written.
- `optax_adam_state`: a torch ``Adam``'s state as the JAX package's
  ``flax.serialization.to_state_dict`` of the optax state that its
  ``train/loop.py::make_optimizer`` builds, for the best-ROC files of
  mutual learning.
- `training_state` / `save_state` / `load_state`: the whole training state
  in one ``torch.save`` file (``last.pt``): the model's and the optimizer's
  state dicts, the epoch and the history, `EarlyStopping`'s counters, the
  plateau scheduler's state, the states of the model's generators (weights,
  drop-path) and the train loader's epoch counter.  ``fit(...,
  init_state=load_state(path))`` resumes from it exactly.  It stands in for
  the JAX package's orbax ``CheckpointManager``, which no JAX caller uses.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from xfmamba_tpu_torch.checkpoint.convert import jax_paths, load_jax_variables


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_npz(path: str, tree: Any) -> None:
    """Nested dicts of arrays -> one ``.npz`` with ``/``-joined keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def load_model_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``.npz`` in the JAX layout (written by either package) into
    ``model``; a file without a ``params`` level is taken as the params
    tree, as JAX's ``cli.load_variables`` takes it."""
    tree = load_npz(path)
    variables = {"params": tree.get("params", tree)}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    load_jax_variables(model, variables)
    return model


def optax_adam_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The state of a torch ``Adam`` over ``model``'s parameters under the
    keys of the optax state that JAX's ``make_optimizer`` builds for
    "adam" (``inject_hyperparams`` around the chain of
    ``add_decayed_weights``, when there is weight decay, ``scale_by_adam``
    and ``scale_by_learning_rate``): ``count`` (int32, the updates done),
    ``hyperparams/learning_rate`` (float32), and the Adam part of the
    chain, ``inner_state/{1 with weight decay, else 0}/`` ``count``,
    ``mu`` and ``nu`` (torch's ``exp_avg`` and ``exp_avg_sq``, the same
    moments) in the JAX parameter layout; a parameter not yet stepped has
    zero moments."""
    if type(optimizer) is not torch.optim.Adam:
        raise ValueError(f"optax_adam_state takes torch.optim.Adam, got {type(optimizer).__name__}")
    group = optimizer.param_groups[0]
    params = dict(model.named_parameters())
    mu, nu, steps = {}, {}, [0]
    for key, (jpath, _, to_jax) in jax_paths(model).items():
        if jpath[0] != "params":
            continue
        st = optimizer.state.get(params[key], {})
        if "step" in st:
            steps.append(int(st["step"]))
        for tree, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            value = st.get(name, torch.zeros_like(params[key]))
            node = tree
            for part in jpath[1:-1]:
                node = node.setdefault(part, {})
            node[jpath[-1]] = np.ascontiguousarray(to_jax(value.detach().cpu().float().numpy()))
    count = np.int32(max(steps))
    adam = str(1 if group["weight_decay"] else 0)
    return {"count": count, "hyperparams": {"learning_rate": np.float32(group["lr"])},
            "inner_state": {adam: {"count": count, "mu": mu, "nu": nu}}}


def model_generators(model: torch.nn.Module) -> Dict[str, torch.Generator]:
    """Every ``torch.Generator`` held by the model or a submodule, once
    each, under the first attribute path that holds it (the drop-path
    generator: nothing draws from the weights' one after the model is
    built)."""
    out, seen = {}, set()
    for path, module in model.named_modules():
        for name, value in vars(module).items():
            if isinstance(value, torch.Generator) and id(value) not in seen:
                seen.add(id(value))
                out[f"{path}.{name}" if path else name] = value
    return out


def _plain(value):
    """Python numbers and containers, for ``torch.load(weights_only=True)``."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


def training_state(model, optimizer, epoch: int, history, stopper=None, plateau=None,
                   train_loader=None, preprocess=None) -> dict:
    """Everything a resumed `fit` needs, after ``epoch`` has ended (with a
    device stage, its generator of augmentation parameters)."""
    return {
        "epoch": int(epoch),
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "history": _plain(history),
        "early_stopping": None if stopper is None else _plain(stopper.state_dict()),
        "plateau": None if plateau is None else _plain(plateau.state_dict()),
        "generators": {name: g.get_state() for name, g in model_generators(model).items()},
        "train_loader_epoch": None if train_loader is None else int(train_loader._epoch),
        "preprocess_generator": None if preprocess is None else preprocess.generator.get_state(),
    }


def save_state(path: str, state: dict) -> None:
    """``torch.save`` to a temporary name, then renamed over ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_state(path: str) -> dict:
    """A `training_state` saved by `save_state`, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_generators(model: torch.nn.Module, states: Dict[str, torch.Tensor]) -> None:
    gens = model_generators(model)
    if set(gens) != set(states):
        raise ValueError(f"the checkpoint's generators {sorted(states)} are not the model's "
                         f"{sorted(gens)}")
    for name, g in gens.items():
        g.set_state(states[name].cpu())
