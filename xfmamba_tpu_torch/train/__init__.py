"""Training step, optimizers and losses (port of ``xfmamba_tpu.train``)."""
