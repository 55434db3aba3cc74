"""Move variables between the port and the JAX package's flax trees (the
inverse of ``xfmamba_tpu/checkpoint/convert.py``), both ways.

`load_jax_variables` takes the flax variables of a JAX module as nested
dicts of numpy arrays (``{"params": ..., "batch_stats": ...,
"ssm_state": ...}``; a ``"perturbations"`` collection is ignored) and fills
the state dict of its port counterpart.  It works for the whole
`TwoViewXFMamba` and for any submodule whose JAX twin has the matching
tree (a VSSBlock, a fusion op).

Names: a port key is renamed to the JAX path in two steps.  First each
module on the path may rename its children through a ``JAX_NAMES`` dict
(PatchEmbedV1's ``0`` / ``2`` are ``proj`` / ``norm``, PatchEmbedV2's ``0``
/ ``2`` / ``5`` / ``7`` are ``conv1`` / ``norm1`` / ``conv2`` / ``norm2``,
the downsamples' ``1`` / ``3`` are ``conv`` / ``norm``, an SS2D's
LayerNorm ``out_norm`` is ``out_norm.norm``, an OutNorm's convs
``dwconv``): the same index means another JAX name in another module, so
the rule follows the module.  Then the rules of ``_RENAMES`` move whole
levels (a stage's blocks and downsample up to the backbone).  The leaf
follows the port module's type: a Dense ``weight`` (out, in) is the
flax ``kernel`` (in, out); a conv ``weight`` (out, in/g, kh, kw) is the
flax ``conv/kernel`` (kh, kw, in/g, out); norm ``weight`` is ``scale``; a
BatchNorm's ``running_mean``/``running_var`` are ``batch_stats``
``mean``/``var``; an m0 SS2D's carried ``initial_state`` buffer is the
``ssm_state`` collection's ``initial_state``, in the same layout.  Any
missing, extra or misshapen entry raises.

`jax_paths` gives, for each port state-dict entry, its JAX path and both
layout maps, so a test can hold port gradients against JAX ones leaf by
leaf; `export_jax_variables` writes the port's parameters and batch
statistics as the nested flax dicts (a trained port model goes back to the
JAX package).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from xfmamba_tpu_torch.models.layers import BatchNorm, Conv2dSame, Dense, LayerNorm
from xfmamba_tpu_torch.models.ss2d import SS2D

# the flax collections the port holds
_COLLECTIONS = ("params", "batch_stats", "ssm_state")

# port module path -> JAX module path, applied in order on the dotted path
# after each module's JAX_NAMES
_RENAMES = [
    # SingleViewMamba's classifier: the reference's attribute, a clone into
    # the top's own scope in JAX (no level of its own)
    (r"^singleviewmamba(\.|$)", ""),
    (r"(^|\.)layers\.(\d+)\.blocks\.(\d+)(?=\.|$)", r"\1stage\2_block\3"),
    (r"(^|\.)layers\.(\d+)\.downsample(?=\.|$)", r"\1downsample\2"),
    (r"(^|\.)fc1\.0(?=\.|$)", r"\1fc1_reduce"),
    (r"(^|\.)fc1\.2(?=\.|$)", r"\1fc1_expand"),
    (r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1block\2"),
    (r"(^|\.)classifier\.norm(?=\.|$)", r"\1classifier_norm"),
    (r"(^|\.)classifier\.head(?=\.|$)", r"\1classifier_head"),
]


def _jax_module_path(model: nn.Module, path: str) -> tuple:
    names = []
    module = model
    for name in (path.split(".") if path else []):
        names.append(getattr(module, "JAX_NAMES", {}).get(name, name))
        module = module._modules[name]
    path = ".".join(names)
    for pattern, repl in _RENAMES:
        path = re.sub(pattern, repl, path)
    return tuple(p for p in path.split(".") if p)


def _same(a):
    return a


def _leaf_rule(module: nn.Module, leaf: str):
    """(collection, JAX leaf path, JAX -> port layout, port -> JAX layout)
    of a port leaf."""
    if isinstance(module, Conv2dSame):
        if leaf == "weight":
            return ("params", ("conv", "kernel"), lambda a: a.transpose(3, 2, 0, 1),
                    lambda a: a.transpose(2, 3, 1, 0))
        return "params", ("conv", "bias"), _same, _same
    if isinstance(module, Dense):
        if leaf == "weight":
            return "params", ("kernel",), lambda a: a.T, lambda a: a.T
        return "params", ("bias",), _same, _same
    if isinstance(module, (LayerNorm, BatchNorm)):
        names = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                 "running_mean": ("batch_stats", "mean"),
                 "running_var": ("batch_stats", "var")}
        coll, name = names[leaf]
        return coll, (name,), _same, _same
    if isinstance(module, SS2D) and leaf == "initial_state":
        return "ssm_state", (leaf,), _same, _same
    return "params", (leaf,), _same, _same


def jax_paths(model: nn.Module) -> dict:
    """Port state-dict key -> (JAX path as a tuple starting with the
    collection, JAX -> port layout, port -> JAX layout), for every entry
    but BatchNorm's ``num_batches_tracked``.  The layouts act on numpy
    arrays (a gradient maps as its parameter does)."""
    out = {}
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            continue
        parent, _, leaf = key.rpartition(".")
        coll, jleaf, to_port, to_jax = _leaf_rule(model.get_submodule(parent), leaf)
        out[key] = ((coll,) + _jax_module_path(model, parent) + jleaf, to_port, to_jax)
    return out


def export_jax_variables(model: nn.Module) -> dict:
    """The port's ``params``, ``batch_stats`` and ``ssm_state`` as nested
    dicts of float32 numpy arrays in the JAX package's layout."""
    variables = {}
    state = model.state_dict()
    for key, (jpath, _, to_jax) in jax_paths(model).items():
        node = variables
        for name in jpath[:-1]:
            node = node.setdefault(name, {})
        node[jpath[-1]] = np.ascontiguousarray(to_jax(state[key].detach().cpu().float().numpy()))
    return variables


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def load_jax_variables(model: nn.Module, variables) -> None:
    """Copy flax ``variables`` (nested dicts of arrays) into ``model``."""
    flat = {}
    for coll in _COLLECTIONS:
        flat.update({(coll,) + k: v for k, v in _flatten(variables.get(coll, {})).items()})
    unknown = set(variables) - {*_COLLECTIONS, "perturbations"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    used = set()
    state = {}
    missing, misshapen = [], []
    current = model.state_dict()
    for key, (jpath, to_port, _) in jax_paths(model).items():
        tensor = current[key]
        if jpath not in flat:
            missing.append(f"{key} <- {'/'.join(jpath)}")
            continue
        arr = to_port(flat[jpath])
        if tuple(arr.shape) != tuple(tensor.shape):
            misshapen.append(f"{key}: {tuple(tensor.shape)} vs {'/'.join(jpath)} {arr.shape}")
            continue
        used.add(jpath)
        state[key] = torch.as_tensor(np.ascontiguousarray(arr), dtype=tensor.dtype)
    extra = sorted("/".join(k) for k in set(flat) - used)
    if missing or extra or misshapen:
        raise ValueError(f"JAX variables do not match the model: missing={missing[:10]} "
                         f"extra={extra[:10]} misshapen={misshapen[:10]}")
    model.load_state_dict(state, strict=False)
