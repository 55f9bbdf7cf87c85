"""Fault-tolerant training: atomic, asynchronous checkpoints in the
reference's format (``checkpoint``), int8 gradient compression with error
feedback (``compression``) and the training loop (``trainer``)."""
