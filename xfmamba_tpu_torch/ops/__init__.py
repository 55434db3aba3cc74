"""Tensor functions and kernel wrappers (port of ``xfmamba_tpu.ops``)."""
