"""Model factory: one API over the ported architectures.

The port's copy of ``repro.models.model_factory`` for serving: ``init``,
``init_caches``, ``prefill``, ``prefill_from``, ``decode_step`` and
``logits``.  Training (``loss_fn``) comes with slice E (ROADMAP.md queue 1,
'Slice E: training').

``Model(cfg, device=...)`` builds its tensors on ``device`` ("cuda"
unless the caller asks for the CPU).  ``plain=True`` runs prefill through
the kernels' plain PyTorch versions on any device; it exists for
comparisons and is never the default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from . import transformer
from .layers import DTYPES, ParamBuilder

__all__ = ["Model", "make_model", "splice_slot"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: Union[str, torch.device] = "cuda"
    plain: bool = False

    def __post_init__(self):
        transformer.pattern_of(self.cfg)  # raises for families not ported yet

    # -- parameters ---------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters with the reference's init scales, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        b = ParamBuilder(seed, DTYPES[self.cfg.param_dtype], self.device)
        return transformer.build_decoder_params(b, self.cfg)

    # -- forward ------------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, mode: str = "train",
                positions: Optional[torch.Tensor] = None, caches=None,
                aux: Optional[Dict[str, torch.Tensor]] = None):
        """Returns (hidden (B, S, d), caches); ``aux``, when given, receives
        the MoE aux values (``transformer.AUX_KEYS``)."""
        return transformer.decoder_forward(params, tokens, self.cfg, mode=mode,
                                           positions=positions, caches=caches,
                                           plain=self.plain, aux=aux)

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return transformer.lm_logits(params, hidden, self.cfg)

    # -- serving ------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> List[Any]:
        return transformer.init_caches(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, List[Any]]:
        """Full-sequence prefill → (last-position logits (B, V), filled caches)."""
        return self.prefill_from(params, tokens, self.init_caches(tokens.shape[0], max_len))

    @torch.no_grad()
    def prefill_from(self, params, tokens: torch.Tensor,
                     caches) -> Tuple[torch.Tensor, List[Any]]:
        """Prefill into caches that already exist → (last-position logits
        (B, V), caches filled in place), as the reference's ``prefill_from``:
        a KV cache is rewritten from position 0, an SSM state is continued."""
        hidden, caches = self.forward(params, tokens, mode="prefill", caches=caches)
        return self.logits(params, hidden[:, -1:, :])[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, params, tokens: torch.Tensor, positions: torch.Tensor,
                    caches) -> Tuple[torch.Tensor, List[Any]]:
        """tokens, positions: (B, 1) → (logits (B, V), caches updated in place)."""
        hidden, caches = self.forward(params, tokens, mode="decode", positions=positions,
                                      caches=caches)
        return self.logits(params, hidden)[:, 0, :], caches


def make_model(cfg: ModelConfig, *, device: Union[str, torch.device] = "cuda",
               plain: bool = False) -> Model:
    """The model of ``cfg``; raises ``NotImplementedError`` for the families
    the port does not have yet (hybrid, encdec, vlm)."""
    return Model(cfg, device=device, plain=plain)


def splice_slot(batched: List[Any], single: List[Any], slot: int) -> None:
    """Copy a batch-1 cache list into slot ``slot`` of a batched one, in place."""
    for big, one in zip(batched, single):
        for field in dataclasses.fields(big):
            getattr(big, field.name)[slot].copy_(getattr(one, field.name)[0])
