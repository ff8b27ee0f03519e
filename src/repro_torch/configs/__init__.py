"""LM architecture configs (port of ``repro.configs``, LM part)."""
from .base import ArchConfig, get_config, register  # noqa: F401
