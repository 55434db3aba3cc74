"""Layer primitives, channels-last (port of ``xfmamba_tpu/models/layers.py``).

Parameters are float32 and named as in the reference PyTorch model
(``weight``/``bias``, convs (out, in/groups, kh, kw), linears (out, in)).
Like the JAX layers with ``dtype=bfloat16``, each layer computes in its
input's dtype: matmul and conv weights are cast to it at the call, and the
norms take float32 statistics and return the input's dtype.  Initialisers
mirror the JAX ones and draw from an explicit ``torch.Generator``.

Inside a data-parallel training step (`batch_shard`, which
``parallel.mesh.make_parallel_train_step`` enters) each rank holds its rows
of a global batch, and the two layers whose result depends on the whole
batch compute what one rank computes on the global batch, as JAX's GSPMD
step does: `BatchNorm` takes the global batch's statistics (all-reduced,
`GlobalBatchNorm`) and `DropPath` draws the global batch's masks from its
generator and keeps this rank's (`global_rows`).  Outside such a step, or
in a world of one rank, both run the one-device code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
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
    per-side, (ph, pw), or ``"same"``: flax's ``"SAME"``, which pads
    (k - 1) // 2 before and k // 2 after at stride 1 (more after than
    before for an even kernel, where torch's symmetric ``k // 2`` would
    change the output's size)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 generator=None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        if padding == "same":
            self.same = True
            self.padding = (0, 0)
        else:
            self.same = False
            self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        bound = 1.0 / math.sqrt(in_ch // groups * kh * kw)
        uniform_init(self.weight, bound, generator)
        if self.bias is not None:
            uniform_init(self.bias, bound, generator)

    def _same_pads(self, H, W):
        """(left, right, top, bottom) of flax's "SAME" for an H x W map."""
        pads = []
        for n, k, s in ((W, self.weight.shape[3], self.stride[1]),
                        (H, self.weight.shape[2], self.stride[0])):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return pads

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        xc = x.permute(0, 3, 1, 2)
        padding = self.padding
        if self.same:
            left, right, top, bottom = self._same_pads(x.shape[1], x.shape[2])
            if left == right and top == bottom:
                padding = (top, left)
            else:
                xc = F.pad(xc, (left, right, top, bottom))
        y = F.conv2d(xc, self.weight.to(x.dtype), b, self.stride, padding, groups=self.groups)
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


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's place in a data-parallel step: ``rank`` of ``world``
    ranks, each holding ``rows`` rows of every view of the global batch;
    ``group`` is the process group (None: the default group)."""
    rank: int
    world: int
    rows: int
    group: Any = None


_SHARD: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Run the block as ``shard``'s rows of a global batch (see the module
    docstring); None runs it as the whole batch."""
    global _SHARD
    outer, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = outer


def _sharded() -> Optional[BatchShard]:
    return _SHARD if _SHARD is not None and _SHARD.world > 1 else None


def global_rows(draw: Callable, batch: int):
    """``draw(n)`` (a tensor, or a dict of tensors, of n leading rows) for
    ``batch`` local rows: outside a data-parallel step ``draw(batch)``;
    inside one, the draw for the global batch, of which this rank keeps its
    rows, so that the generator stays in step across ranks and W ranks get
    the rows one rank would.  ``batch`` is k times the shard's rows: the
    models stack their views on the batch axis, so the global batch is k
    blocks of ``world * rows`` and this rank's rows are its part of each."""
    s = _sharded()
    if s is None:
        return draw(batch)
    if batch % s.rows:
        raise ValueError(f"{batch} rows are not whole views of this rank's {s.rows}")
    k = batch // s.rows

    def local(t):
        return t.reshape(k, s.world, s.rows, *t.shape[1:])[:, s.rank].reshape(batch,
                                                                           *t.shape[1:])

    out = draw(batch * s.world)
    return {key: local(v) for key, v in out.items()} if isinstance(out, dict) else local(out)


class GlobalBatchNorm(torch.autograd.Function):
    """Batch normalisation of this rank's rows x (n, C) float32 with the
    statistics of every rank's rows: the count and sum are all-reduced for
    the mean, then the sum of squared deviations from it for the (biased)
    variance, two passes as one device computes them.  Backward all-reduces
    the per-channel sums of dy and dy * x̂; the weight and bias gradients
    stay this rank's sums, for the step's gradient reduction.  Returns (y,
    mean, unbiased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        first = torch.cat([x.sum(0), x.new_tensor([x.shape[0]])])
        dist.all_reduce(first, group=group)
        count = first[C]
        mean = first[:C] / count
        centred = x - mean
        sq = (centred * centred).sum(0)
        dist.all_reduce(sq, group=group)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        xhat = centred * invstd
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.group = group
        unbiased = var * count / (count - 1)
        ctx.mark_non_differentiable(mean, unbiased)
        return xhat * weight + bias, mean, unbiased

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, count = ctx.saved_tensors
        C = xhat.shape[1]
        dbias = dy.sum(0)
        dweight = (dy * xhat).sum(0)
        sums = torch.cat([dbias, dweight])
        dist.all_reduce(sums, group=ctx.group)
        dx = (weight * invstd) * (dy - sums[:C] / count - xhat * (sums[C:] / count))
        return dx, dweight, dbias, None, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on NHWC maps, in float32.  In eval mode it normalises
    with the running statistics; in training mode with the batch's, and
    updates the running ones with momentum 0.1 on every call, the running
    variance being the *unbiased* batch variance as in torch (flax keeps
    the biased one).  ``batch_stats`` overrides the mode: True takes the
    batch's statistics (and updates the running ones), False the running
    ones, as flax's ``use_running_average`` does.  State-dict names are
    BatchNorm2d's.  Inside a data-parallel step the batch statistics are the
    global batch's (`GlobalBatchNorm`), and the running ones move by the
    global mean and unbiased variance."""

    def forward(self, x, batch_stats=None):
        batch_stats = self.training if batch_stats is None else batch_stats
        if batch_stats:
            self.num_batches_tracked.add_(1)
            shard = _sharded()
            if shard is not None:
                return self._global_batch_stats(x, shard)
        y = F.batch_norm(x.float().permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight.float(), self.bias.float(),
                         batch_stats, self.momentum, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    def _global_batch_stats(self, x, shard: BatchShard):
        y, mean, var = GlobalBatchNorm.apply(x.float().reshape(-1, x.shape[-1]),
                                             self.weight.float(), self.bias.float(), self.eps,
                                             shard.group)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y.reshape(x.shape).to(x.dtype)


def to_device(t: torch.Tensor, device=None) -> torch.Tensor:
    """A small CPU tensor on ``device``; to a GPU it goes from pinned memory
    without blocking the host, so that it does not wait for queued work."""
    if device is None or torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch; identity at
    inference.  The keep masks are drawn from ``generator`` (a CPU
    ``torch.Generator``), the global batch's inside a data-parallel step
    (`global_rows`).  Called with several tensors, it applies one mask to
    all of them, as the JAX DropPath does on a tuple."""

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
        mask = global_rows(lambda n: torch.rand(n, generator=self.generator), batch) < keep
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


class PatchMerging2D(nn.Module):
    """The 2 x 2 neighbourhoods concatenated (x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]), LayerNorm, a linear reduction without
    bias (``vmamba.py:60-98``; JAX ``layers.py:138``): downsample "v1",
    which the vanilla VMamba configurations use.  An odd map is padded with
    zeros at its bottom and right.  Names ``norm`` and ``reduction``, as
    the reference's."""

    def __init__(self, dim: int, out_dim: int = -1, generator=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, out_dim if out_dim > 0 else 2 * dim, bias=False,
                               init="trunc_normal", generator=generator)

    def forward(self, x):
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


def softmax_spatial(x):
    """Softmax of (B, H, W, C) over its H * W positions, per channel
    (``SoftmaxSpatial``, ``vmamba.py:152-161``; the ``_onsoftmax``
    out-norm)."""
    B, H, W, C = x.shape
    return torch.softmax(x.reshape(B, H * W, C), dim=1).reshape(B, H, W, C)
