"""What the benchmark hands to the program and to the reference alike:
the weights and the token batches, both made on the device from the seed.

Weights: one ``torch.Generator`` on the device draws every normal leaf
into one flat buffer, in chunks of at most 2**28 values, and every
uniform leaf in one more call; each leaf is a view of its buffer, scaled
in place, in the dtype it is served in.  The same seed, spec, device and
dtype give the same values.

Batches: step ``k``'s tokens are drawn uniformly from the vocabulary,
``rows`` × (``seq`` + 1) of them, by a generator seeded from (seed, k);
the labels are the tokens shifted by one.  Every seed draws the same
sizes; only the values change.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["mix", "make_weights", "tree_of", "make_batch"]

CHUNK = 1 << 28
WEIGHTS = 0x5EED


def mix(seed: int, salt: int) -> int:
    """A 63-bit generator seed from a run's seed (any whole number) and a salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_weights(spec, seed: int, device, dtype: torch.dtype) -> List[Tuple[tuple, torch.Tensor]]:
    """[(path, leaf)] of ``spec`` (``reference.model.param_spec``), drawn from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, WEIGHTS))
    normal = [e for e in spec if e[2] == "normal"]
    uniform = [e for e in spec if e[2] == "uniform"]
    total = sum(math.prod(e[1]) for e in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(lo + CHUNK, total)
        flat[lo:hi] = torch.randn(hi - lo, generator=g, device=device, dtype=torch.float32)
    draws = torch.rand(sum(math.prod(e[1]) for e in uniform), generator=g, device=device,
                       dtype=torch.float32)
    leaves, at_n, at_u = {}, 0, 0
    for path, shape, init, scale in spec:
        n = math.prod(shape)
        if init == "normal":
            leaves[path] = flat[at_n:at_n + n].view(shape).mul_(scale)
            at_n += n
        elif init == "uniform":
            lo, hi = scale
            leaves[path] = (lo + (hi - lo) * draws[at_u:at_u + n]).view(shape).to(dtype)
            at_u += n
        elif init == "zeros":
            leaves[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            leaves[path] = torch.ones(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
    return [(path, leaves[path]) for path, *_ in spec]


def tree_of(leaves: List[Tuple[tuple, torch.Tensor]]) -> Dict:
    """The nested dict (lists for integer keys) of [(path, leaf)]."""
    root: Dict = {}
    for path, leaf in leaves:
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({} if not isinstance(nxt, int) else [])
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = leaf
    return root


def make_batch(seed: int, step: int, rows: int, seq: int, vocab: int,
               device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: ``tokens``, ``labels`` (rows, seq) int64 and
    ``mask`` (rows, seq) float32 ones."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, step + 1))
    toks = torch.randint(0, vocab, (rows, seq + 1), generator=g, device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((rows, seq), dtype=torch.float32, device=device)}
