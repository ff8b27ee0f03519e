"""Optimizers (port of ``repro.optim``: ``adamw``, and ``compression``'s
error-feedback numerics)."""
