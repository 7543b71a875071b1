"""Models: the ``dense``, ``moe`` and ``ssm`` families, ported from ``repro.models``."""

from .model_factory import Model, make_model

__all__ = ["Model", "make_model"]
