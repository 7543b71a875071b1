"""The depthwise causal conv with its bias and SiLU (``kernels/causal_conv``).

On the CPU: which route each device takes (the plain chain itself on the
CPU and on ``meta``, the kernel for CUDA tensors, checked by replacing the
launches), which route and epilogue the SSD and RG-LRU blocks take, the
argument checks, and the plain chain's roundings, which the card's forward
reproduces.

On the card (marker ``cuda``, skipped without one; the file imports no jax):
the forward kernel against the plain chain, bit for bit, at mamba2-130m's
and recurrentgemma-9b's shapes and around the kernel's tiles; the backward
against float64 autograd of the plain chain (dx at least as close as the
eager chain's own bf16 gradient), with the same bits on two calls; the
launch counts; and the SSD block through the kernels against ``plain=True``:

    PYTHONPATH=src python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_causal_conv.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.causal_conv import causal_conv as cc  # noqa: E402

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def operands(b, s, c, w, *, width=None, offset=0, dtype=torch.float32, device="cpu", seed=0):
    """x (B, S, C) as columns ``offset:offset + C`` of (B, S, width) rows,
    w (W, C) and bias (C,), from numpy."""
    rng = np.random.default_rng(seed)
    width = c if width is None else width
    rows = torch.from_numpy(rng.standard_normal((b, s, width), dtype=np.float32))
    x = rows.to(device=device, dtype=dtype)[..., offset:offset + c]
    wt = torch.from_numpy(0.3 * rng.standard_normal((w, c), dtype=np.float32))
    bias = torch.from_numpy(0.3 * rng.standard_normal((c,), dtype=np.float32))
    return x, wt.to(device=device, dtype=dtype), bias.to(device=device, dtype=dtype)


def gradients(fn, x, w, b, g):
    """(out, dx, dw, db) of ``fn(x, w, b)`` for the output's gradient g."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, g))


# ---------------------------------------------------------------------------
# CPU: routes, callers, checks, the plain chain's roundings
# ---------------------------------------------------------------------------
def refuse(*args, **kwargs):
    raise AssertionError("the CUDA kernel was launched off the card")


@pytest.mark.parametrize("silu", [True, False])
def test_cpu_runs_the_plain_chain_and_launches_nothing(monkeypatch, silu):
    """CPU tensors go to the plain chain itself, outside the Function, and
    autograd differentiates it: the same bits and gradients in both dtypes,
    no launch counted."""
    monkeypatch.setattr(cc, "_launch", refuse)
    monkeypatch.setattr(cc, "causal_conv_backward", refuse)
    monkeypatch.setattr(cc._CausalConv, "apply", refuse)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 6), dtype=np.float32))
    n = (cc.causal_conv.launches, cc.causal_conv.backward_launches)
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = operands(2, 9, 6, 4, width=11, offset=3, dtype=dtype)
        got = gradients(lambda *t: cc.causal_conv(*t, silu=silu), x, w, b, g.to(dtype))
        want = gradients(lambda *t: cc.causal_conv_plain(*t, silu=silu), x, w, b, g.to(dtype))
        assert all(a.dtype == dtype and torch.equal(a, e) for a, e in zip(got, want))
    assert (cc.causal_conv.launches, cc.causal_conv.backward_launches) == n


def test_meta_runs_the_plain_chain_outside_the_function(monkeypatch):
    monkeypatch.setattr(cc, "_launch", refuse)
    monkeypatch.setattr(cc._CausalConv, "apply", refuse)
    x = torch.empty((2, 16, 3352), dtype=torch.bfloat16, device="meta")[..., 1536:1536 + 1792]
    w = torch.empty((4, 1792), dtype=torch.bfloat16, device="meta")
    out = cc.causal_conv(x, w, w[0], silu=True)
    assert out.device.type == "meta" and out.shape == (2, 16, 1792)
    assert out.dtype == torch.bfloat16


def test_cuda_tensors_go_to_the_kernels(monkeypatch):
    """The Function's forward and backward hand CUDA tensors to the launches
    (replaced here: this machine need not have a card)."""
    calls = []
    monkeypatch.setattr(cc, "_launch", lambda *a: calls.append(("forward", a)) or "out")
    monkeypatch.setattr(cc, "causal_conv_backward",
                        lambda *a, silu: calls.append(("backward", a, silu)) or ("dx", "dw", "db"))
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    ctx = types.SimpleNamespace(needs_input_grad=(True, False, True, False))
    ctx.save_for_backward = lambda *t: setattr(ctx, "saved_tensors", t)
    assert cc._CausalConv.forward(ctx, on_card, "w", "b", True) == "out"
    assert cc._CausalConv.backward(ctx, "g") == ("dx", None, "db", None)
    assert calls == [("forward", (on_card, "w", "b", True)),
                     ("backward", (on_card, "w", "b", "g"), True)]


@pytest.mark.parametrize("arch,plain", [("mamba2-130m", False), ("mamba2-130m", True),
                                        ("recurrentgemma-9b", False),
                                        ("recurrentgemma-9b", True)])
def test_blocks_call_the_conv_with_their_epilogue(monkeypatch, arch, plain):
    """The SSD block's prefill takes the conv with SiLU, RG-LRU's without;
    ``plain=True`` takes the plain chain, else the kernel's entry point."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model, rglru, ssm
    from repro_torch.models.transformer import layer_kinds

    calls = []

    def recorder(route, fn):
        def record(x, w, b, *, silu):
            calls.append((route, silu, tuple(x.shape)))
            return fn(x, w, b, silu=silu)
        return record

    module, kind, key, silu = ((ssm, "ssd", "ssd", True) if arch.startswith("mamba2") else
                               (rglru, "rglru", "rec", False))
    monkeypatch.setattr(module, "causal_conv", recorder("kernel", cc.causal_conv))
    monkeypatch.setattr(module, "causal_conv_plain", recorder("plain", cc.causal_conv_plain))
    cfg = get_config(arch).smoke()
    params = make_model(cfg, device="cpu").init(0)
    p = params["layers"][layer_kinds(cfg).index(kind)][key]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 7, cfg.d_model),
                                                                  dtype=np.float32))
    block = ssm.ssd_block if kind == "ssd" else rglru.rglru_block
    y, _ = block(p, x.to(p["conv_w"].dtype), cfg, plain=plain)
    assert y.shape == x.shape
    assert [c[:2] for c in calls] == [("plain" if plain else "kernel", silu)]
    assert calls[0][2][:2] == (2, 7) and calls[0][2][2] == p["conv_w"].shape[1]


@pytest.mark.parametrize("case", ["w_channels", "b_channels", "w_rank", "no_taps", "empty",
                                  "dtype", "card_dtype", "card_width", "card_narrow_width",
                                  "channel_stride"])
def test_argument_checks(case):
    x, w, b = operands(2, 8, 6, 4)
    meta = dict(dtype=torch.float16, device="meta")
    bad = {
        "w_channels": (ValueError, (x, w[:, :5], b)),
        "b_channels": (ValueError, (x, w, b[:5])),
        "w_rank": (ValueError, (x, w[0], b)),
        "no_taps": (ValueError, (x, w[:0], b)),
        "empty": (ValueError, (x[:, :0], w, b)),
        "dtype": (TypeError, (x, w.bfloat16(), b)),
        "card_dtype": (TypeError, tuple(torch.empty(t.shape, **meta) for t in (x, w, b))),
        "card_width": (ValueError, (x.to("meta"), torch.empty((5, 6), device="meta"),
                                    b.to("meta"))),
        "card_narrow_width": (ValueError, (x.to("meta"), torch.empty((3, 6), device="meta"),
                                           b.to("meta"))),
        "channel_stride": (ValueError, (x.transpose(1, 2).contiguous().transpose(1, 2), w, b)),
    }
    error, args = bad[case]
    with pytest.raises(error):
        cc.causal_conv(*args, silu=True)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
def test_sequences_shorter_than_the_conv_read_zeros_before_the_start(s):
    """S < W is taken: the rows before the sequence count as 0, as F.pad
    makes them in the plain chain."""
    x, w, b = operands(2, s, 5, 4, seed=s)
    got = cc.causal_conv(x, w, b, silu=False)
    want = torch.stack([sum(w[i] * (x[:, t - 3 + i] if t - 3 + i >= 0 else 0) for i in range(4))
                        for t in range(s)], dim=1) + b
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, cc.causal_conv_plain(x, w, b, silu=False))


def to_bf16(a):
    """float32 numpy values rounded to bfloat16 (to nearest, ties to even)
    and widened again."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("strided", [True, False])
def test_plain_chain_rounds_as_the_kernel_does(dtype, silu, strided):
    """The plain chain's roundings, which the card's forward reproduces bit
    for bit: from 0.0 in f32, each tap's product and the running sum
    rounded on their own in tap order, the bias added, rounded to x's
    dtype; with SiLU, x / (1 + exp(-x)) in f32 and rounded again (the
    exponential's last bit is the library's, so SiLU is held to one
    rounding of the dtype)."""
    x, w, b = operands(3, 40, 12, 4, width=30 if strided else None, offset=9 if strided else 0,
                       dtype=dtype, seed=11)
    got = cc.causal_conv(x, w, b, silu=silu)
    xs, ws, bs = (t.float().numpy() for t in (x, w, b))
    xp = np.concatenate([np.zeros((3, 3, 12), np.float32), xs], axis=1)
    acc = np.zeros((3, 40, 12), np.float32)
    for i in range(4):
        acc = (acc + (xp[:, i:i + 40] * ws[i]).astype(np.float32)).astype(np.float32)
    rnd = to_bf16 if dtype == torch.bfloat16 else (lambda a: a.astype(np.float32))
    pre = rnd((acc + bs).astype(np.float32))
    if not silu:
        assert np.array_equal(got.float().numpy(), pre)
        return
    want = rnd((pre / (np.float32(1) + np.exp(-pre))).astype(np.float32))
    tol = 2**-8 if dtype == torch.bfloat16 else 2e-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
# (B, S, C, W, row width, column offset, dtype, silu)
FORWARD_CASES = [
    (2, 2048, 1792, 4, 3352, 1536, torch.bfloat16, True),    # mamba2-130m's xBC, training
    (2, 2048, 4096, 4, 4096, 0, torch.bfloat16, False),      # recurrentgemma-9b's RG-LRU prefill
    (2, 1, 1792, 4, 3352, 1536, torch.bfloat16, True),
    (2, 3, 1792, 4, 3352, 1536, torch.bfloat16, True),
    (2, 65, 1792, 4, 3352, 1536, torch.bfloat16, True),
    (2, 2049, 1792, 4, 3352, 1536, torch.bfloat16, True),
    (2, 300, 1792, 4, 3352, 1536, torch.float32, True),      # the f32 configurations
    (3, 70, 37, 4, 41, 1, torch.bfloat16, True),             # one channel a lane: C odd
    (1, 5, 6, 4, 9, 3, torch.float32, False),
    (1, 600, 96, 4, 96, 0, torch.bfloat16, True),
]


def case_id(case):
    b, s, c, w, width, offset, dtype, silu = case
    return f"{b}x{s}x{c}-W{w}-{str(dtype)[6:]}{'-silu' if silu else ''}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_forward_has_the_plain_chains_bits(cuda, case):
    b, s, c, w, width, offset, dtype, silu = case
    x, wt, bias = operands(b, s, c, w, width=width, offset=offset, dtype=dtype, device=cuda)
    n = cc.causal_conv.launches
    got = cc.causal_conv(x, wt, bias, silu=silu)
    assert cc.causal_conv.launches == n + 1
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, cc.causal_conv_plain(x, wt, bias, silu=silu))


BACKWARD_CASES = [FORWARD_CASES[i] for i in (0, 1, 3, 6, 7, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BACKWARD_CASES, ids=case_id)
def test_backward_against_float64(cuda, case):
    """dx, dw and db against float64 autograd of the plain chain.  Stated
    tolerance: the kernel rounds each to x's dtype once, so in bf16 each
    lies within 2^-7 of the largest reference value of its tensor (a bf16
    rounding is at most 2^-8 of the value) and dx at least as close as the
    eager chain's bf16 gradient; in f32 within 1e-5 of it."""
    b, s, c, w, width, offset, dtype, silu = case
    x, wt, bias = operands(b, s, c, w, width=width, offset=offset, dtype=dtype, device=cuda)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((b, s, c), dtype=np.float32))
    g = g.to(device=cuda, dtype=dtype)

    def exact(xx, ww, bb):
        out = sum(torch.nn.functional.pad(xx, (0, 0, w - 1, 0))[:, i:i + s] * ww[i]
                  for i in range(w)) + bb
        return torch.nn.functional.silu(out) if silu else out

    want = gradients(exact, x.double(), wt.double(), bias.double(), g.double())[1:]
    n = cc.causal_conv.backward_launches
    got = cc.causal_conv_backward(x, wt, bias, g, silu=silu)
    assert cc.causal_conv.backward_launches == n + 1
    assert [t.dtype for t in got] == [dtype] * 3
    eager = gradients(lambda *t: cc.causal_conv_plain(*t, silu=silu), x, wt, bias, g)[1:]
    scale = 2**-7 if dtype == torch.bfloat16 else 1e-5
    for name, k, e, ref in zip(("dx", "dw", "db"), got, eager, want):
        err = (k.double() - ref).abs().max()
        assert err <= scale * ref.abs().max(), (name, float(err))
        if name == "dx" and dtype == torch.bfloat16:
            assert err <= (e.double() - ref).abs().max(), (name, float(err))
    again = cc.causal_conv_backward(x, wt, bias, g, silu=silu)
    assert all(torch.equal(a, k) for a, k in zip(again, got))


@pytest.mark.cuda
def test_function_counts_and_carries_gradients_on_the_card(cuda):
    x, w, b = operands(2, 300, 1792, 4, width=3352, offset=1536, dtype=torch.bfloat16,
                       device=cuda)
    g = torch.ones((2, 300, 1792), dtype=torch.bfloat16, device=cuda)
    n = (cc.causal_conv.launches, cc.causal_conv.backward_launches)
    out, *grads = gradients(lambda *t: cc.causal_conv(*t, silu=True), x, w, b, g)
    assert (cc.causal_conv.launches - n[0], cc.causal_conv.backward_launches - n[1]) == (1, 1)
    assert torch.equal(out, cc.causal_conv_plain(x, w, b, silu=True))
    direct = cc.causal_conv_backward(x, w, b, g, silu=True)
    assert all(torch.equal(a, d) for a, d in zip(grads, direct))
    with torch.no_grad():
        cc.causal_conv(x, w, b, silu=True)
    assert cc.causal_conv.launches - n[0] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,tol", [("mamba2-130m", 2e-2), ("mamba2-smoke", 2e-4)])
def test_ssd_block_through_the_kernels_matches_plain(cuda, arch, tol):
    """The SSD block with the conv kernel and K5 against ``plain=True`` (the
    eager chain and K5's plain version): the output at K5's tolerance for
    the block's dtype (bf16 2e-2 at mamba2-130m's width, f32 2e-4 at its
    smoke() width), the gradients within 1e-4 of the largest (the smoke
    train step's rule) in f32; each call launches the conv once forward and
    once backward, as K5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as ssk
    from repro_torch.models import make_model
    from repro_torch.models.ssm import ssd_block

    cfg = get_config("mamba2-130m")
    cfg = cfg.smoke() if arch.endswith("smoke") else cfg
    params = make_model(cfg, device=cuda).init(0)
    p = params["layers"][0]["ssd"]
    dtype = p["in_proj"].dtype
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 200, cfg.d_model), dtype=np.float32))
    x = x.to(device=cuda, dtype=dtype)
    g = torch.from_numpy(rng.standard_normal((2, 200, cfg.d_model), dtype=np.float32))
    g = g.to(device=cuda, dtype=dtype)
    out = {}
    for plain in (False, True):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xx = x.detach().requires_grad_(True)
        n = (cc.causal_conv.launches, cc.causal_conv.backward_launches, ssk.ssd_scan.launches)
        y, _ = ssd_block(leaves, xx, cfg, plain=plain)
        grads = torch.autograd.grad(y, [xx, *leaves.values()], g)
        counts = (cc.causal_conv.launches - n[0], cc.causal_conv.backward_launches - n[1],
                  ssk.ssd_scan.launches - n[2])
        out[plain] = (y, grads, counts)
    assert out[False][2] == (1, 1, 1) and out[True][2] == (0, 0, 0)
    torch.testing.assert_close(out[False][0], out[True][0], rtol=tol, atol=tol)
    if dtype == torch.float32:
        gmax = max(float(t.abs().max()) for t in out[True][1])
        for a, e in zip(out[False][1], out[True][1]):
            torch.testing.assert_close(a, e, rtol=0, atol=1e-4 * gmax)
