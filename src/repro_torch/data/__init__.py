"""Data sources (port of ``repro.data``)."""
