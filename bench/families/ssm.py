"""The ``ssm`` family: Mamba-2's SSD layers (in_proj to z, x, B, C, dt; a
depthwise causal conv and SiLU on x, B, C; dt = softplus(dt + dt_bias);
the scan; D·x; y·SiLU(z) through a gated RMSNorm; out_proj), one group of
B and C, with the residual stream in the model's dtype (published:
float32)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from bench.flops import k5_calls, k5_forward
from bench.reference.model import MM, rms_norm

TINY = dict(num_layers=2, d_model=32, ssm_state=16, ssm_head_dim=8, ssm_chunk=8)


def param_spec(m: Dict):
    d = m["d_model"]
    di = m["ssm_expand"] * d
    n, nh, w = m["ssm_state"], di // m["ssm_head_dim"], m["conv_width"]
    layer = [(("ln",), (d,), "zeros", None),
             (("ssd", "in_proj"), (d, 2 * di + 2 * n + nh)),
             (("ssd", "conv_w"), (w, di + 2 * n), "normal", 0.1),
             (("ssd", "conv_b"), (di + 2 * n,), "zeros", None),
             (("ssd", "A_log"), (nh,), "uniform", (0.0, 1.5)),
             (("ssd", "D"), (nh,), "ones", None),
             (("ssd", "dt_bias"), (nh,), "uniform", (-4.6, -2.3)),
             (("ssd", "norm"), (di,), "zeros", None),
             (("ssd", "out_proj"), (di, d))]
    return [(("layers", i) + e[0],) + e[1:] for i in range(m["num_layers"]) for e in layer]


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


def layer(p: Dict, x: torch.Tensor, m: Dict, mm: MM) -> torch.Tensor:
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


def matmul_weights(m: Dict) -> int:
    """The projections and the depthwise conv."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    n, nh = m["ssm_state"], di // m["ssm_head_dim"]
    return m["num_layers"] * (d * (2 * di + 2 * n + nh) + m["conv_width"] * (di + 2 * n) + di * d)


def mixer_flops(m: Dict, rows: int, seq: int) -> float:
    return m["num_layers"] * k5_forward(*k5_calls(m, rows, seq))[0]


def conv_calls(m: Dict, rows: int, seq: int) -> Tuple[int, int, int, int]:
    """(b, s, channels, width) of each SSD block's conv call of a microbatch
    (``flops.conv_forward``, ``conv_backward``)."""
    return rows, seq, m["ssm_expand"] * m["d_model"] + 2 * m["ssm_state"], m["conv_width"]
