"""Weight loading (port of ``xfmamba_tpu.checkpoint``)."""
