"""Runnable examples: ``python -m sprs_tpu_torch.examples.<name>``."""
