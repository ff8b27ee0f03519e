"""Optimizers (port of ``repro.optim``; ``compression`` is not ported
yet)."""
