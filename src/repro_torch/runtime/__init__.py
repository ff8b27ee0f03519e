"""Fault tolerance for training (port of ``repro.runtime``)."""
