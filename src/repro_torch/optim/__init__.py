"""Optimizers (``src/repro/optim``)."""
