"""Models: every family of ``repro.models`` (dense, moe, ssm, hybrid, encdec, vlm), ported."""

from .model_factory import Model, greedy_tokens, make_model

__all__ = ["Model", "greedy_tokens", "make_model"]
