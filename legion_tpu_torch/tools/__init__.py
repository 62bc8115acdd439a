"""Offline tools of the port (``python -m legion_tpu_torch.tools.prepare``)."""
