"""The LM training input pipeline of the port (``repro/data``)."""
from .tokens import TokenPipeline

__all__ = ["TokenPipeline"]
