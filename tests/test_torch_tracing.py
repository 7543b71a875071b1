"""The port's spans (``repro_torch.tracing``) on the CPU.

With spans off ``span`` is one shared no-op and the models register no
gradient hook; with spans on, the training step's losses and gradients
are bitwise those with spans off, and a CPU ``torch.profiler`` trace holds
the step's spans nested as the benchmark's readers take them: each
block's backward inside the step's backward, remat's re-run of a block
inside that block's backward, one gradient sum a microbatch, one update a
step, every span closed, also when the backward raises.  The models are a
stablelm-like dense model in 2 microbatches and a mamba2-like SSM model
in one, at the benchmark's tiny test sizes, in bf16 with remat on.
"""

import contextlib
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import make_model, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules, MeshShape  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# arch: (sizes, microbatches, block kind)
MODELS = {
    "stablelm-12b": (dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                          d_ff=64), 2, "attn"),
    "mamba2-130m": (dict(num_layers=2, d_model=32, ssm_state=16, ssm_head_dim=8, ssm_chunk=8),
                    1, "ssd"),
}
BATCH, SEQ, VOCAB, LAYERS = 4, 32, 200, 2


@pytest.fixture(autouse=True)
def spans_off_after():
    yield
    tracing.enable(False)
    tracing.close_backward()


def tiny(arch):
    sizes, mb, _ = MODELS[arch]
    base = get_config(arch)
    cfg = base.replace(**sizes, vocab_size=VOCAB, dtype="bfloat16", param_dtype="bfloat16",
                       parallel=dataclasses.replace(base.parallel, remat="block"))
    model = make_model(cfg, device="cpu")
    opt = AdamW(cfg=cfg, state_dtype=torch.float32)
    rules = MeshRules(MeshShape((1, 1), ("data", "model")), cfg.parallel)
    step = make_train_step(model, opt, rules, InputShape("train", SEQ, BATCH, "train"),
                           lr=3e-4, loss_chunk=16, microbatches=mb)
    assert step.microbatches == mb
    return model, opt, step


def batch(k):
    g = torch.Generator().manual_seed(1000 + k)
    return {"tokens": torch.randint(0, VOCAB, (BATCH, SEQ), generator=g),
            "labels": torch.randint(0, VOCAB, (BATCH, SEQ), generator=g)}


def spans_of(prof, tmp_path):
    """[(name, start, end)] of the trace's ``repro.*`` ranges, in order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(tracing.PREFIX))


def inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def test_spans_off_are_one_shared_no_op():
    tracing.enable(False)
    assert not tracing.enabled()
    assert tracing.span("loss") is tracing.span("update")
    assert isinstance(tracing.span("loss"), contextlib.nullcontext)
    tracing.enable(True)
    on = tracing.span("loss")
    assert tracing.enabled() and isinstance(on, record_function) and on.name == "repro.loss"


@pytest.mark.parametrize("arch", MODELS)
def test_no_hook_while_spans_are_off_or_without_gradients(arch, monkeypatch):
    model, _, step = tiny(arch)
    params = model.init(0)
    calls = []
    real = torch.Tensor.register_hook

    def counted(self, hook):
        calls.append(hook)
        return real(self, hook)

    monkeypatch.setattr(torch.Tensor, "register_hook", counted)
    tracing.enable(False)
    step.grads(params, batch(0))
    assert calls == []
    tracing.enable(True)
    step.grads(params, batch(0))
    # a microbatch: the loss's two, and one on each boundary of the blocks' chain
    assert len(calls) == step.microbatches * (2 + LAYERS + 1)
    with torch.no_grad():           # no gradient, no hook, spans on or off
        model.loss_fn(params, batch(0), loss_chunk=16)
    assert len(calls) == step.microbatches * (2 + LAYERS + 1)


@pytest.mark.parametrize("arch", MODELS)
def test_spans_leave_losses_and_gradients_bitwise_equal(arch):
    model, _, step = tiny(arch)
    params = model.init(0)
    tracing.enable(False)
    grads_off, metrics_off = step.grads(params, batch(0))
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        grads_on, metrics_on = step.grads(params, batch(0))
    assert all(torch.equal(metrics_on[k], metrics_off[k]) for k in metrics_off)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads_on), tree_leaves(grads_off)))


@pytest.mark.parametrize("arch", MODELS)
def test_spans_nest_in_a_cpu_trace(arch, tmp_path):
    model, opt, step = tiny(arch)
    kind = MODELS[arch][2]
    mb, steps = step.microbatches, 2
    params = model.init(0)
    state = opt.init(params)
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(steps):
            params, state, _ = step(params, state, batch(k))
    tracing.enable(False)
    assert tracing._open == {}
    spans = spans_of(prof, tmp_path)
    named = {}
    for s in spans:
        named.setdefault(s[0], []).append(s)
    backwards = named["repro.backward"]
    assert len(backwards) == steps * mb
    assert len(named.get("repro.accumulate", [])) == (steps * mb if mb > 1 else 0)
    assert len(named["repro.update"]) == steps
    for part in ("clip", "adamw", "apply"):
        parts = named[f"repro.update.{part}"]
        assert len(parts) == steps
        assert all(any(inside(p, u) for u in named["repro.update"]) for p in parts)
    assert len(named["repro.loss"]) == len(named["repro.loss.backward"]) == steps * mb
    assert all(any(inside(s, b) for b in backwards) for s in named["repro.loss.backward"])
    block_backwards = named[f"repro.block.{kind}.backward"]
    assert len(block_backwards) == steps * mb * LAYERS
    assert all(any(inside(s, b) for b in backwards) for s in block_backwards)
    blocks = named[f"repro.block.{kind}"]
    reruns = [s for s in blocks if any(inside(s, b) for b in backwards)]
    assert len(blocks) == 2 * len(reruns) == 2 * steps * mb * LAYERS
    assert all(any(inside(s, b) for b in block_backwards) for s in reruns)
    assert {n for n in named if n.startswith("repro.block.")} == {
        f"repro.block.{kind}", f"repro.block.{kind}.backward"}


class _Fails(torch.autograd.Function):
    """The identity, whose backward raises."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("planted in the first block's backward")


@pytest.mark.parametrize("arch", MODELS)
def test_every_span_closes_when_the_backward_raises(arch, monkeypatch, tmp_path):
    model, _, step = tiny(arch)
    kind = MODELS[arch][2]
    params = model.init(0)
    real, calls = transformer._apply_block, []

    def failing(*args, **kwargs):
        x, aux = real(*args, **kwargs)
        calls.append(1)
        return (_Fails.apply(x) if len(calls) == 1 else x), aux

    monkeypatch.setattr(transformer, "_apply_block", failing)
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="planted"):
            step.grads(params, batch(0))
    assert tracing._open == {}
    spans = spans_of(prof, tmp_path)
    # the second block's backward closed by its hook, the first's, open
    # when the backward raised, by the step
    (backward,) = [s for s in spans if s[0] == "repro.backward"]
    opened = [s for s in spans if s[0] == f"repro.block.{kind}.backward"]
    assert len(opened) == 2 and all(inside(s, backward) for s in opened)
    monkeypatch.setattr(transformer, "_apply_block", real)
    grads, _ = step.grads(params, batch(0))
    assert tracing._open == {}
    assert all(torch.isfinite(g.float()).all() for g in tree_leaves(grads))
