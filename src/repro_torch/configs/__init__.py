"""The LM architectures (port of ``repro/configs``: the ten config modules'
FULL and REDUCED numbers and the registry)."""
from .registry import ARCHS, get_arch

__all__ = ["ARCHS", "get_arch"]
