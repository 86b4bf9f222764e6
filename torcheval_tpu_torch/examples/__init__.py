"""Runnable examples of the port (``python -m
torcheval_tpu_torch.examples.<name>``)."""
