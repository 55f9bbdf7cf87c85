"""Launchers: ``python -m repro_torch.launch.serve`` (the LM serving
CLI)."""
