"""Runnable examples of the port: ``python -m esm_tpu_torch.examples.<name>``."""
