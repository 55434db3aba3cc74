"""Load JAX variables into the port (the inverse of
``xfmamba_tpu/checkpoint/convert.py``).

`load_jax_variables` takes the flax variables of a JAX module as nested
dicts of numpy arrays (``{"params": ..., "batch_stats": ...}``; a
``"perturbations"`` collection is ignored) and fills the state dict of its
port counterpart.  It works for the whole `TwoViewXFMamba` and for any
submodule whose JAX twin has the matching tree (a VSSBlock, a fusion op).

Names: a port key is renamed to the JAX path with the rules below, and the
leaf follows the port module's type: a Dense ``weight`` (out, in) is the
flax ``kernel`` (in, out); a conv ``weight`` (out, in/g, kh, kw) is the
flax ``conv/kernel`` (kh, kw, in/g, out); norm ``weight`` is ``scale``; a
BatchNorm's ``running_mean``/``running_var`` are ``batch_stats``
``mean``/``var``.  Any missing, extra or misshapen entry raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from xfmamba_tpu_torch.models.layers import BatchNorm, Conv2dSame, Dense, LayerNorm

# port module path -> JAX module path, applied in order on the dotted path
_RENAMES = [
    (r"(^|\.)layers\.(\d+)\.blocks\.(\d+)(?=\.|$)", r"\1stage\2_block\3"),
    (r"(^|\.)layers\.(\d+)\.downsample\.1(?=\.|$)", r"\1downsample\2.conv"),
    (r"(^|\.)layers\.(\d+)\.downsample\.3(?=\.|$)", r"\1downsample\2.norm"),
    (r"(^|\.)patch_embed\.0(?=\.|$)", r"\1patch_embed.conv1"),
    (r"(^|\.)patch_embed\.2(?=\.|$)", r"\1patch_embed.norm1"),
    (r"(^|\.)patch_embed\.5(?=\.|$)", r"\1patch_embed.conv2"),
    (r"(^|\.)patch_embed\.7(?=\.|$)", r"\1patch_embed.norm2"),
    (r"(^|\.)op\.out_norm(?=\.|$)", r"\1op.out_norm.norm"),
    (r"(^|\.)fc1\.0(?=\.|$)", r"\1fc1_reduce"),
    (r"(^|\.)fc1\.2(?=\.|$)", r"\1fc1_expand"),
    (r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1block\2"),
    (r"(^|\.)classifier\.head(?=\.|$)", r"\1classifier_head"),
]
# VSSBlock's SS2D out-norm sits one level deeper in JAX; a bare VSSBlock
# has the path "op.out_norm", matched by the rule above.


def _jax_module_path(path: str) -> tuple:
    for pattern, repl in _RENAMES:
        path = re.sub(pattern, repl, path)
    return tuple(p for p in path.split(".") if p)


def _leaf_rule(module: nn.Module, leaf: str):
    """(collection, JAX leaf path, numpy -> torch layout) of a port leaf."""
    if isinstance(module, Conv2dSame):
        if leaf == "weight":
            return "params", ("conv", "kernel"), lambda a: a.transpose(3, 2, 0, 1)
        return "params", ("conv", "bias"), None
    if isinstance(module, Dense):
        if leaf == "weight":
            return "params", ("kernel",), lambda a: a.T
        return "params", ("bias",), None
    if isinstance(module, (LayerNorm, BatchNorm)):
        names = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                 "running_mean": ("batch_stats", "mean"),
                 "running_var": ("batch_stats", "var")}
        coll, name = names[leaf]
        return coll, (name,), None
    return "params", (leaf,), None


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
    for coll in ("params", "batch_stats"):
        flat.update({(coll,) + k: v for k, v in _flatten(variables.get(coll, {})).items()})
    unknown = set(variables) - {"params", "batch_stats", "perturbations"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    used = set()
    state = {}
    missing, misshapen = [], []
    for key, tensor in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        parent, _, leaf = key.rpartition(".")
        coll, jleaf, layout = _leaf_rule(model.get_submodule(parent), leaf)
        jpath = (coll,) + _jax_module_path(parent) + jleaf
        if jpath not in flat:
            missing.append(f"{key} <- {'/'.join(jpath)}")
            continue
        arr = flat[jpath]
        if layout is not None:
            arr = layout(arr)
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
