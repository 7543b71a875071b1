"""The ``dense`` family: decoder layers of grouped-query causal attention and
a SwiGLU MLP, each behind an RMSNorm with its own residual (see
``reference/model.py`` for where this departs from published models)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench.flops import k4_calls, k4_forward
from bench.reference.model import MM, causal_attention, rms_norm, rope

TINY = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64)


def param_spec(m: Dict):
    d, hd = m["d_model"], m["head_dim"]
    q, kv, ff = m["num_heads"] * hd, m["num_kv_heads"] * hd, m["d_ff"]
    layer = [(("ln_attn",), (d,), "zeros", None),
             (("attn", "wq"), (d, q)), (("attn", "wk"), (d, kv)),
             (("attn", "wv"), (d, kv)), (("attn", "wo"), (q, d)),
             (("ln_mlp",), (d,), "zeros", None),
             (("mlp", "w1"), (d, ff)), (("mlp", "w3"), (d, ff)), (("mlp", "w2"), (ff, d))]
    return [(("layers", i) + e[0],) + e[1:] for i in range(m["num_layers"]) for e in layer]


def dense_layer(p: Dict, x: torch.Tensor, m: Dict, mm: MM) -> torch.Tensor:
    """One decoder layer on one row x (S, d)."""
    hd, eps = m["head_dim"], m["norm_eps"]
    h = rms_norm(x, p["ln_attn"], eps)
    q = rope(mm(h, p["attn"]["wq"]).unflatten(-1, (-1, hd)), m["rope_theta"])
    k = rope(mm(h, p["attn"]["wk"]).unflatten(-1, (-1, hd)), m["rope_theta"])
    v = mm(h, p["attn"]["wv"]).unflatten(-1, (-1, hd))
    x = x + mm(causal_attention(q, k, v, mm), p["attn"]["wo"])
    h = rms_norm(x, p["ln_mlp"], eps)
    return x + mm(F.silu(mm(h, p["mlp"]["w1"])) * mm(h, p["mlp"]["w3"]), p["mlp"]["w2"])


def layer(p: Dict, x: torch.Tensor, m: Dict, mm: MM) -> torch.Tensor:
    """One decoder layer on rows x (b, S, d), a row at a time."""
    return torch.stack([dense_layer(p, row, m, mm) for row in x])


def matmul_weights(m: Dict) -> int:
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    return m["num_layers"] * (d * q + 2 * d * kv + q * d + 3 * d * m["d_ff"])


def mixer_flops(m: Dict, rows: int, seq: int) -> float:
    return m["num_layers"] * k4_forward(*k4_calls(m, rows, seq))[0]
