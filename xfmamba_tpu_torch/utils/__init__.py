"""Utilities (port of ``xfmamba_tpu.utils``)."""
