"""The plain float32 reference of the two configurations' models.

Plain PyTorch, written from the configurations' ``model`` groups alone; it
imports nothing of the program.  ``mm`` is the product every projection
and attention product goes through: ``torch.matmul`` for the reference,
a lower-precision product for the control (``precision.py``).

The parameter tree's layout (keys, shapes, init scales) is what the
program's training step takes; :func:`param_spec` states it, and the
harness checks it against the program's own tree before a run.

Where the configurations depart from the published models, these
functions follow the configurations (each departure is listed in the
configuration's ``assumed``):

* every norm is an RMSNorm with the scale stored as ``w`` and applied as
  ``1 + w`` (published StableLM 2: LayerNorm);
* rotary embeddings rotate every column of a head, split-half
  (published StableLM 2: a quarter of them), with no qk-norm (published:
  a LayerNorm per head on q and k);
* the attention and the MLP are applied one after the other, each with
  its own residual (published StableLM 2: in parallel);
* the head and the softmax of the loss span the vocabulary padded to a
  multiple of ``vocab_pad``;
* the SSD block is Mamba-2's (in_proj to z, x, B, C, dt; a depthwise
  causal conv and SiLU on x, B, C; dt = softplus(dt + dt_bias); the
  scan; D·x; y·SiLU(z) through a gated RMSNorm; out_proj), one group of B
  and C, with the residual stream in the model's dtype (published:
  float32).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["param_spec", "padded_vocab", "row_loss"]

Spec = List[Tuple[tuple, Tuple[int, ...], str, object]]
MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def padded_vocab(m: Dict) -> int:
    pad = m.get("vocab_pad", 1)
    return -(-m["vocab_size"] // pad) * pad


def param_spec(m: Dict) -> Spec:
    """[(path, shape, init, scale)] in the tree's order.  ``init`` is
    ``normal`` (std ``scale``), ``zeros``, ``ones`` or ``uniform``
    (``scale`` = (low, high))."""
    d, v = m["d_model"], padded_vocab(m)

    def normal(shape, std=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return "normal", std if std is not None else 1.0 / math.sqrt(fan_in)

    spec: Spec = [(("embed",), (v, d), *normal((v, d), 0.02))]
    for i in range(m["num_layers"]):
        if m["family"] == "dense":
            hd = m["head_dim"]
            q, kv, ff = m["num_heads"] * hd, m["num_kv_heads"] * hd, m["d_ff"]
            layer = [("ln_attn",), (d,), "zeros", None], \
                [("attn", "wq"), (d, q)], [("attn", "wk"), (d, kv)], \
                [("attn", "wv"), (d, kv)], [("attn", "wo"), (q, d)], \
                [("ln_mlp",), (d,), "zeros", None], \
                [("mlp", "w1"), (d, ff)], [("mlp", "w3"), (d, ff)], [("mlp", "w2"), (ff, d)]
        elif m["family"] == "ssm":
            di = m["ssm_expand"] * d
            n, nh, w = m["ssm_state"], di // m["ssm_head_dim"], m["conv_width"]
            layer = [("ln",), (d,), "zeros", None], \
                [("ssd", "in_proj"), (d, 2 * di + 2 * n + nh)], \
                [("ssd", "conv_w"), (w, di + 2 * n), "normal", 0.1], \
                [("ssd", "conv_b"), (di + 2 * n,), "zeros", None], \
                [("ssd", "A_log"), (nh,), "uniform", (0.0, 1.5)], \
                [("ssd", "D"), (nh,), "ones", None], \
                [("ssd", "dt_bias"), (nh,), "uniform", (-4.6, -2.3)], \
                [("ssd", "norm"), (di,), "zeros", None], \
                [("ssd", "out_proj"), (di, d)]
        else:
            raise ValueError(f"no reference for the {m['family']!r} family")
        for entry in layer:
            path, shape = entry[0], entry[1]
            init, scale = (entry[2], entry[3]) if len(entry) > 2 else normal(shape)
            spec.append((("layers", i) + path, shape, init, scale))
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


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(…, T) -> (…, T, T): out[i, j] = a[j+1] + … + a[i] for i ≥ j, −inf above."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd_scan(x, a, B, C, chunk: int, mm: MM) -> torch.Tensor:
    """y of h_t = exp(a_t) h_{t-1} + x_t ⊗ B_t, y_t = h_t · C_t from h_0 = 0:
    x (b, s, H, P), a (b, s, H), B and C (b, s, N); the chunked form."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    c = s // chunk
    x = x.reshape(b, c, chunk, nh, p)
    a = a.reshape(b, c, chunk, nh).permute(0, 3, 1, 2)                    # (b, H, c, l)
    B = B.reshape(b, c, chunk, n)
    C = C.reshape(b, c, chunk, n)
    a_cs = torch.cumsum(a, dim=-1)
    L = torch.exp(segsum(a))                                              # (b, H, c, l, l)
    CB = mm(C, B.transpose(-1, -2))                                       # (b, c, l, l)
    W = CB[:, None] * L                                                   # (b, H, c, l, l)
    y = mm(W, x.permute(0, 3, 1, 2, 4)).permute(0, 2, 3, 1, 4)            # (b, c, l, H, P)
    decay = torch.exp(a_cs[..., -1:] - a_cs)                              # (b, H, c, l)
    xw = x * decay.permute(0, 2, 3, 1)[..., None]                         # (b, c, l, H, P)
    states = mm(xw.reshape(b, c, chunk, nh * p).transpose(-1, -2), B)      # (b, c, H·P, N)
    states = states.reshape(b, c, nh, p, n)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))              # (b, H, c+1, c+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]  # (b, c, H, P, N)
    y_in = mm(C, entering.reshape(b, c, nh * p, n).transpose(-1, -2))      # (b, c, l, H·P)
    y_in = y_in.reshape(b, c, chunk, nh, p)
    y = y + y_in * torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, s, nh, p)


def ssd_layer(p: Dict, x: torch.Tensor, m: Dict, mm: MM) -> torch.Tensor:
    """One Mamba-2 layer on rows x (b, S, d)."""
    q = p["ssd"]
    d, eps = m["d_model"], m["norm_eps"]
    di = m["ssm_expand"] * d
    n, hd = m["ssm_state"], m["ssm_head_dim"]
    nh = di // hd
    b, s, _ = x.shape
    zxbcdt = mm(rms_norm(x, p["ln"], eps), q["in_proj"])
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]
    w = q["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(padded[:, i:i + s] * q["conv_w"][i] for i in range(w)) + q["conv_b"]
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    Bm, Cm = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + q["dt_bias"])
    A = -torch.exp(q["A_log"])
    y = ssd_scan(xs * dt[..., None], dt * A, Bm, Cm, m["ssm_chunk"], mm)
    y = (y + q["D"][:, None] * xs).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), q["norm"], eps)
    return x + mm(y, q["out_proj"])


def row_loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor, m: Dict,
             mm: MM = torch.matmul, remat: bool = True) -> torch.Tensor:
    """The summed token NLL of rows ``tokens`` (b, S) against ``labels``;
    each layer recomputed in the backward when ``remat`` (memory only: the
    values are the same)."""
    x = params["embed"][tokens.long()]
    for p in params["layers"]:
        if m["family"] == "dense":
            def layer(x, p=p):
                return torch.stack([dense_layer(p, row, m, mm) for row in x])
        else:
            def layer(x, p=p):
                return ssd_layer(p, x, m, mm)
        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    h = rms_norm(x, params["final_norm"], m["norm_eps"])
    head = params["embed"].T if m["tie_embeddings"] else params["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for row, lab in zip(h, labels):
        logits = mm(row, head)
        picked = logits.gather(-1, lab.long()[:, None])[:, 0]
        total = total + (torch.logsumexp(logits, dim=-1) - picked).sum()
    return total
