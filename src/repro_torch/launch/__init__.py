"""Launchers: ``python -m repro_torch.launch.serve`` (the LM serving
CLI) and ``python -m repro_torch.launch.train`` (the training CLI), over
the step factories of ``steps``."""
