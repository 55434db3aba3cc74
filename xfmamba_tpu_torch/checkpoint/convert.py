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

Reference checkpoints (``.pth`` files of the PyTorch reference):
`load_pth_state_dict`, `convert_xfmamba_state_dict` and
`convert_vssm_state_dict` apply the JAX package's rules of the same names
and give a port state dict.  The port keeps the reference's names and
torch's layouts, so the rules are all that is left: the drop list (the
fusion blocks' dead ``self_attention.in_proj``, ``num_batches_tracked``,
thop's ``total_ops`` / ``total_params``), VMamba's legacy renames on the
backbone's keys (``patch_embed.proj`` / ``.norm``, ``ln_1``,
``self_attention``, a top-level ``norm.`` / ``head.``), ``Linear2d``
weights stored as (out, in, 1, 1) reshaped to (out, in), the position
embedding moved to the port's channel-last layout, and a ``KeyError``
naming any key the JAX converter refuses (a ``ValueError`` for two keys
that land on one entry).  `load_reference_state_dict` loads the result
strictly, except that a model keeps its own ``num_batches_tracked`` where
the checkpoint has none (JAX never reads the count).
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


# ---- reference checkpoints: the rules of xfmamba_tpu/checkpoint/convert.py

# tensors of reference checkpoints that no forward pass reads
_DROP_PATTERNS = [
    r".*fusemamba\.blocks\.\d+\.self_attention\.in_proj\.weight$",  # built, never called
    r".*fusemamba\.blocks\.\d+\.self_attention\.in_proj\.bias$",
    r".*num_batches_tracked$",
    r".*total_ops$", r".*total_params$",                              # thop's counters
]
_OP_TENSORS = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds")


def load_pth_state_dict(path: str, key: str = "model") -> dict:
    """The state dict of a torch checkpoint file, its tensors on the CPU:
    the object under ``key``, then under ``"state_dict"``, where there is
    one.  As in the JAX package the file is read with ``torch.load(...,
    weights_only=False)``, because reference checkpoints pickle the run's
    ``argparse.Namespace`` beside the weights: the path is the user's own,
    and unpickling runs whatever the file holds, so load only files you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().cpu() for k, v in ckpt.items()}


def _dropped(k: str) -> bool:
    return any(re.match(p, k) for p in _DROP_PATTERNS)


def _apply_legacy_rewrites(sd: dict) -> dict:
    """VMamba's legacy names (``VSSM._load_from_state_dict``)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("patch_embed.proj.", "patch_embed.0.")
        k = k.replace("patch_embed.norm.", "patch_embed.2.")
        k = re.sub(r"(layers\.\d+\.blocks\.\d+\.)ln_1\.", r"\1norm.", k)
        k = re.sub(r"(layers\.\d+\.blocks\.\d+\.)self_attention\.", r"\1op.", k)
        if k.startswith("norm."):
            k = "classifier.norm." + k[len("norm."):]
        if k.startswith("head."):
            k = "classifier.head." + k[len("head."):]
        out[k] = v
    return out


def _linear(k: str, v: torch.Tensor) -> torch.Tensor:
    """A Linear / Linear2d weight as (out, in)."""
    return v.reshape(v.shape[0], v.shape[1]) if k.endswith("weight") and v.ndim == 4 else v


def _set(out: dict, k: str, v: torch.Tensor) -> None:
    if k in out:
        raise ValueError(f"duplicate destination {k}")
    out[k] = v


def _block_key(k: str, rest: str, v):
    """A key inside one VSSBlock (``layers.i.blocks.j.`` + ``rest``)."""
    m = re.match(r"(norm2?|mlp\.fc[12])\.(weight|bias)$", rest)
    if m:
        return _linear(k, v) if m.group(1).startswith("mlp.") else v
    m = re.match(r"op\.(.*)$", rest)
    if not m:
        raise KeyError(f"unhandled block key {k}")
    oprest = m.group(1)
    if oprest in _OP_TENSORS:
        return v
    m = re.match(r"(in_proj|out_proj)\.(weight|bias)$", oprest)
    if m:
        return _linear(k, v)
    if re.match(r"(conv2d|out_norm|out_norm\.\d+)\.(weight|bias)$", oprest):
        return v
    raise KeyError(f"unhandled op key {k}")


def _vssm_tensor(k: str, v, patchembed_v2: bool, downsample_v1: bool):
    """The port tensor of one (renamed) VSSM key, or a ``KeyError`` where
    the JAX converter has no rule for the key."""
    m = re.match(r"patch_embed\.(\d+)\.(weight|bias)$", k)
    if m:
        if int(m.group(1)) not in ((0, 2, 5, 7) if patchembed_v2 else (0, 2)):
            raise KeyError(f"unhandled patch_embed key {k}")
        return v
    if k == "pos_embed":
        return v.permute(0, 2, 3, 1).contiguous()          # (1, C, H, W) -> (1, H, W, C)
    m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.(.*)$", k)
    if m:
        return _block_key(k, m.group(3), v)
    m = re.match(r"layers\.(\d+)\.downsample\.(.*)$", k)
    if m:
        rest = m.group(2)
        if downsample_v1:
            m2 = re.match(r"(norm|reduction)\.(weight|bias)$", rest)
            if m2:
                return _linear(k, v) if m2.group(1) == "reduction" else v
        m2 = re.match(r"(\d+)\.(weight|bias)$", rest)
        if m2 and int(m2.group(1)) in (1, 3):
            return v
        raise KeyError(f"unhandled downsample key {k}")
    if re.match(r"(outnorm\d+|classifier\.norm)\.(weight|bias)$", k):
        return v
    if re.match(r"classifier\.head\.(weight|bias)$", k):
        return _linear(k, v)
    raise KeyError(f"unhandled VSSM key {k}")


def convert_vssm_state_dict(sd: dict) -> dict:
    """A reference VSSM / Backbone_VSSM state dict (names relative to the
    backbone) as the port VSSM's state dict."""
    sd = _apply_legacy_rewrites(sd)
    patchembed_v2 = any(k.startswith("patch_embed.5.") for k in sd)
    downsample_v1 = any(".downsample.reduction." in k for k in sd)
    out = {}
    for k, v in sd.items():
        if not _dropped(k):
            _set(out, k, _vssm_tensor(k, v, patchembed_v2, downsample_v1))
    return out


def _fusion_op_tensor(k: str, rest: str, v):
    """A key inside ShallowFuse_SS2Dv4 / Cross_SS2Dv5."""
    if rest in _OP_TENSORS:
        return v
    if re.match(r"(in_proj|in_proj_sec|out_proj)\.(weight|bias)$", rest):
        return _linear(k, v)
    if re.match(r"(conv2d|out_norm)\.(weight|bias)$", rest):
        return v
    if re.match(r"fc1\.(\d+)\.weight$", rest):                  # the SE bottleneck
        return _linear(k, v)
    raise KeyError(f"unhandled fusion op key {k}")


def convert_xfmamba_state_dict(sd: dict) -> dict:
    """A reference TwoViewXFMambaTop state dict as the port
    `TwoViewXFMamba`'s: the backbone's keys (``mamba_feature_extrac.``)
    through `convert_vssm_state_dict`, the fusion and head keys kept where
    the JAX converter has a rule for them."""
    out, backbone = {}, {}
    prefix = "mamba_feature_extrac."
    for k, v in sd.items():
        if _dropped(k):
            continue
        if k.startswith(prefix):
            backbone[k[len(prefix):]] = v
            continue
        if re.match(r"shallow_mamba_fusion\.norm\.(weight|bias|running_mean|running_var)$", k):
            _set(out, k, v)
            continue
        m = (re.match(r"shallow_mamba_fusion\.shallowfuseSS2D\.(.*)$", k)
             or re.match(r"fusemamba\.blocks\.\d+\.self_attention\.(.*)$", k))
        if m:
            _set(out, k, _fusion_op_tensor(k, m.group(1), v))
            continue
        if re.match(r"(fusemamba\.blocks\.\d+\.norm|final_conv)\.(weight|bias)$", k):
            _set(out, k, v)
            continue
        if re.match(r"classifier\.head\.(weight|bias)$", k):
            _set(out, k, _linear(k, v))
            continue
        raise KeyError(f"unhandled XFMamba top key {k}")
    for k, v in convert_vssm_state_dict(backbone).items():
        _set(out, prefix + k, v)
    return out


def load_reference_state_dict(model: nn.Module, state: dict) -> None:
    """Load a converted reference state dict into ``model``: every entry
    but ``num_batches_tracked`` present with the model's shape, nothing
    extra, or a ``ValueError``; the counts the model already has stay."""
    current = model.state_dict()
    missing = [k for k in current if k not in state and not k.endswith("num_batches_tracked")]
    extra = [k for k in state if k not in current]
    misshapen = [f"{k}: {tuple(current[k].shape)} vs {tuple(v.shape)}" for k, v in state.items()
                 if k in current and tuple(v.shape) != tuple(current[k].shape)]
    if missing or extra or misshapen:
        raise ValueError(f"the checkpoint does not match the model: missing={missing[:10]} "
                         f"extra={extra[:10]} misshapen={misshapen[:10]}")
    model.load_state_dict(state, strict=False)
