"""Tensor functions and kernel wrappers (port of ``xfmamba_tpu.ops``)."""
from xfmamba_tpu_torch.ops.layer_norm import (
    layer_norm_fn,
    layer_norm_linear_fn,
    rms_norm_fn,
)
