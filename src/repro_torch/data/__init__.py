"""Data sources (port of ``repro.data``; the image half)."""
