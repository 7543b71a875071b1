"""Token sampling (greedy / temperature / top-k).

Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so
its tokens equal the reference's.  Stochastic sampling draws each row from
its own ``torch.Generator``: the serving engine seeds one per token as a
pure function of (engine seed, request id, token index) with
:func:`token_seed`, so a request's tokens do not depend on its
batch-mates.  ``torch.Generator`` and ``jax.random`` give different draws
from the same seed, so only greedy output can equal the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["sample", "token_seed", "token_generator"]


def token_seed(seed: int, rid: int, index: int) -> int:
    """A 63-bit seed that depends on (seed, rid, index) alone."""
    state = np.random.SeedSequence([int(seed), int(rid), int(index)]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def token_generator(seed: int, rid: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(token_seed(seed, rid, index))
    return g


def sample(
    logits: torch.Tensor,                         # (B, V)
    generators: Optional[Sequence[torch.Generator]] = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or stochastic sampling; returns (B,) int64.

    Stochastic sampling needs one generator per row, so a row's draw
    cannot depend on the other rows.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lf = logits.float() / temperature
    if top_k:
        thresh = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = lf.masked_fill(lf < thresh, float("-inf"))
    if generators is None or len(generators) != lf.shape[0]:
        raise ValueError(f"stochastic sampling needs one generator per row "
                         f"({lf.shape[0]} rows)")
    probs = torch.softmax(lf, dim=-1)
    return torch.cat([torch.multinomial(probs[i], 1, generator=g)
                      for i, g in enumerate(generators)])
