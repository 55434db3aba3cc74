"""Layer primitives, channels-last (port of ``xfmamba_tpu/models/layers.py``).

Parameters are float32 and named as in the reference PyTorch model
(``weight``/``bias``, convs (out, in/groups, kh, kw), linears (out, in)).
Like the JAX layers with ``dtype=bfloat16``, each layer computes in its
input's dtype: matmul and conv weights are cast to it at the call, and the
norms take float32 statistics and return the input's dtype.  Initialisers
mirror the JAX ones and draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# torch LayerNorm epsilon
LN_EPS = 1e-5


def gelu(x):
    """Exact (erf) GELU, torch's ``nn.GELU`` default."""
    return F.gelu(x)


# the SS2D activations by name (``vssm.py:26``)
_ACTS = dict(silu=F.silu, gelu=gelu)


def activation(name: str):
    if name not in _ACTS:
        raise ValueError(f"activation {name!r}: the port has {sorted(_ACTS)}")
    return _ACTS[name]


def trunc_normal_init(t: torch.Tensor, std: float = 0.02, generator=None):
    """timm-style truncated normal (+-2 std), the VSSM linear init."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def uniform_init(t: torch.Tensor, bound: float, generator=None):
    with torch.no_grad():
        return nn.init.uniform_(t, -bound, bound, generator=generator)


class Dense(nn.Module):
    """Linear layer on the last axis.  ``init="torch"`` is nn.Linear's
    default (uniform +-1/sqrt(in)), ``init="trunc_normal"`` the VSSM one;
    biases start at zero, as flax's Dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "torch", generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        if init == "trunc_normal":
            trunc_normal_init(self.weight, generator=generator)
        elif init == "torch":
            uniform_init(self.weight, math.sqrt(1.0 / in_features), generator)
        else:
            raise ValueError(f"unknown init {init!r}")

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2dSame(nn.Module):
    """Conv2d on NHWC maps with PyTorch's default init (kaiming-uniform
    a=sqrt(5) weight, uniform +-1/sqrt(fan_in) bias).  ``padding`` is
    per-side, (ph, pw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 generator=None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        bound = 1.0 / math.sqrt(in_ch // groups * kh * kw)
        uniform_init(self.weight, bound, generator)
        if self.bias is not None:
            uniform_init(self.bias, bound, generator)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis with float32 statistics."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on NHWC maps, in float32.  In eval mode it normalises
    with the running statistics; in training mode with the batch's, and
    updates the running ones with momentum 0.1 on every call, the running
    variance being the *unbiased* batch variance as in torch (flax keeps
    the biased one).  State-dict names are BatchNorm2d's."""

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float().permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight.float(), self.bias.float(),
                         self.training, self.momentum, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


def to_device(t: torch.Tensor, device=None) -> torch.Tensor:
    """A small CPU tensor on ``device``; to a GPU it goes from pinned memory
    without blocking the host, so that it does not wait for queued work."""
    if device is None or torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch; identity at
    inference.  The keep masks are drawn from ``generator`` (a CPU
    ``torch.Generator``).  Called with several tensors, it applies one mask
    to all of them, as the JAX DropPath does on a tuple."""

    def __init__(self, rate: float = 0.0, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def scales(self, batch: int, device=None) -> torch.Tensor:
        """(batch,) float32: keep / (1 - rate) or 0 per sample; ones when the
        branch is not dropped."""
        if self.rate == 0.0 or not self.training:
            return torch.ones(batch, device=device)
        if self.generator is None:
            raise RuntimeError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.rate
        mask = torch.rand(batch, generator=self.generator) < keep
        return to_device(mask.float() / keep, device)

    def forward(self, *xs):
        if self.rate == 0.0 or not self.training:
            return xs[0] if len(xs) == 1 else xs
        s = self.scales(xs[0].shape[0], xs[0].device)
        out = tuple(x * s.to(x.dtype).view(-1, *([1] * (x.dim() - 1))) for x in xs)
        return out[0] if len(out) == 1 else out


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (``vmamba.py:110-128``)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, generator=None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, init="trunc_normal",
                         generator=generator)
        self.fc2 = Dense(hidden_features, out_features, init="trunc_normal",
                         generator=generator)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))
