"""The plain float32 reference: what every model family shares.

Plain PyTorch, written from the configurations' ``model`` groups alone; it
imports nothing of the program.  ``mm`` is the product every projection
and attention product goes through: ``torch.matmul`` for the reference,
a lower-precision product for the control (``precision.py``).

The parameter tree's layout (keys, shapes, init scales) is what the
program's training step takes; :func:`param_spec` states it, and the
harness checks it against the program's own tree before a run.  What
differs by family (its layers' entries, their forward, a microbatch's
loss, its FLOPs) is in ``families/<family>.py``, found by the ``model``
group's ``family``; the embedding, the final norm, the head and the loss
over the vocabulary are here.

Where the configurations depart from the published models, these
functions and the families' follow the configurations (each departure is
listed in the configuration's ``assumed``):

* every norm is an RMSNorm with the scale stored as ``w`` and applied as
  ``1 + w`` (published StableLM 2: LayerNorm);
* rotary embeddings rotate every column of a head, split-half
  (published StableLM 2: a quarter of them), with no qk-norm (published:
  a LayerNorm per head on q and k);
* the attention and the MLP are applied one after the other, each with
  its own residual (published StableLM 2: in parallel);
* the head and the softmax of the loss span the vocabulary padded to a
  multiple of ``vocab_pad``;
* the SSD block is Mamba-2's with the residual stream in the model's
  dtype (``families/ssm.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import families

__all__ = ["param_spec", "padded_vocab", "rms_norm", "rope", "causal_attention", "row_loss",
           "blocked_loss"]

Spec = List[Tuple[tuple, Tuple[int, ...], str, object]]
MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# a family's layer: (its parameters, rows x (b, S, d), m, mm) -> rows (b, S, d)
Layer = Callable[[Dict, torch.Tensor, Dict, MM], torch.Tensor]


def padded_vocab(m: Dict) -> int:
    pad = m.get("vocab_pad", 1)
    return -(-m["vocab_size"] // pad) * pad


def param_spec(m: Dict) -> Spec:
    """[(path, shape, init, scale)] in the tree's order.  ``init`` is
    ``normal`` (std ``scale``), ``zeros``, ``ones`` or ``uniform``
    (``scale`` = (low, high)); the layers' entries are the family's
    (``families/<family>.py``)."""
    d, v = m["d_model"], padded_vocab(m)

    def normal(shape, std=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return "normal", std if std is not None else 1.0 / math.sqrt(fan_in)

    spec: Spec = [(("embed",), (v, d), *normal((v, d), 0.02))]
    for entry in families.load(m["family"]).param_spec(m):
        path, shape = entry[0], entry[1]
        init, scale = (entry[2], entry[3]) if len(entry) > 2 else normal(shape)
        spec.append((path, shape, init, scale))
    spec.append((("final_norm",), (d,), "zeros", None))
    if not m["tie_embeddings"]:
        spec.append((("lm_head",), (d, v), *normal((d, v), 0.02)))
    return spec


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions 0 … S − 1, split-half rotation."""
    s, _, dim = x.shape
    half = dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, mm: MM) -> torch.Tensor:
    """q (S, H, D), k and v (S, KVH, D) -> (S, H·D); query head h reads kv
    head h // (H / KVH); scale D^-1/2."""
    s, h, dim = q.shape
    kvh = k.shape[1]
    qg = q.reshape(s, kvh, h // kvh, dim).permute(1, 2, 0, 3)          # (KVH, G, S, D)
    kt = k.permute(1, 2, 0)[:, None]                                     # (KVH, 1, D, S)
    scores = mm(qg, kt) * dim ** -0.5
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    out = mm(p, v.permute(1, 0, 2)[:, None])                             # (KVH, G, S, D)
    return out.permute(2, 0, 1, 3).reshape(s, h * dim)


def row_loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor, m: Dict, layer: Layer,
             mm: MM = torch.matmul, remat: bool = True) -> torch.Tensor:
    """The summed token NLL of rows ``tokens`` (b, S) against ``labels``
    through the family's ``layer``; each layer recomputed in the backward
    when ``remat`` (memory only: the values are the same)."""
    x = params["embed"][tokens.long()]
    for p in params["layers"]:
        def one(x, p=p):
            return layer(p, x, m, mm)
        x = checkpoint(one, x, use_reentrant=False) if remat else one(x)
    h = rms_norm(x, params["final_norm"], m["norm_eps"])
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for row, lab in zip(h, labels):
        logits = mm(row, head)
        picked = logits.gather(-1, lab.long()[:, None])[:, 0]
        total = total + (torch.logsumexp(logits, dim=-1) - picked).sum()
    return total


def blocked_loss(tree: Dict, tokens: torch.Tensor, labels: torch.Tensor, m: Dict,
                 t: Dict, mm: MM, rows_per_block: int, count: int, *, layer: Layer) -> float:
    """A microbatch's loss for a family whose loss is a sum over rows, through
    its ``layer``: the rows in blocks of ``rows_per_block``, each block's
    :func:`row_loss` over ``count`` taken backward on its own -> the float
    sum."""
    total = 0.0
    for lo in range(0, tokens.shape[0], rows_per_block):
        loss = row_loss(tree, tokens[lo:lo + rows_per_block], labels[lo:lo + rows_per_block],
                        m, layer, mm) / count
        loss.backward()
        total += loss.item()
    return total
