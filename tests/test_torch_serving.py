"""The port's ServingEngine against the JAX one, on the CPU.

Both smoke models (tinyllama-1.1b, mamba2-130m), the JAX parameters carried
across: at temperature 0 the port's token streams equal the JAX engine's,
with the inline and the threads backend.  Also: the admission policies'
ordering through the port's engine, that sampling at temperature > 0
does not depend on batch composition (the port against itself), that
remote prefill in a worker process gives the inline engine's tokens and
fails a request whose prefill fails, and that the open-loop load
generator makes the reference's traces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import loadgen as jax_loadgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.core import RemoteUnit, spawn_worker  # noqa: E402
from repro_torch.serving import Request, ServingEngine, loadgen  # noqa: E402
from repro_torch.serving.sampling import sample, token_seed  # noqa: E402

ARCHS = ["tinyllama-1.1b", "mamba2-130m"]


def specs(cfg, n=5, seed=0, mx=(2, 9)):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(*mx))) for i in range(n)]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(cfg, port model, port params, JAX engine's greedy token streams)."""
    jcfg = jax_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jeng = JaxServingEngine(jm, jparams, slots=2, max_len=48)
    for rid, prompt, mx in specs(cfg):
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=mx))
    want = {rid: r.tokens for rid, r in jeng.run().items()}
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, make_model(cfg, device="cpu"), params, want


@pytest.mark.parametrize("backend", ["inline", "threads"])
def test_greedy_streams_equal_jax_engine(served, backend):
    cfg, model, params, want = served
    eng = ServingEngine(model, params, slots=2, max_len=48, backend=backend)
    for rid, prompt, mx in specs(cfg):
        assert eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
    got = {rid: r.tokens for rid, r in eng.run().items()}
    assert got == want
    rep = eng.last_run_report
    assert rep.items == len(want)
    spans = rep.coverage
    assert spans[0][0] == 0 and spans[-1][1] == len(want)
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))


def test_static_mode_same_streams(served):
    cfg, model, params, want = served
    eng = ServingEngine(model, params, slots=2, max_len=48, mode="static")
    for rid, prompt, mx in specs(cfg):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
    assert {rid: r.tokens for rid, r in eng.run().items()} == want


def test_policies_order_completions(served):
    cfg, model, params, _ = served
    eng = ServingEngine(model, params, slots=1, max_len=48, policy="priority")
    for pr, (rid, prompt, _) in zip((0, 5, 0, 9), specs(cfg, n=4)):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=3, priority=pr))
    finished = sorted(eng.run().values(), key=lambda r: r.finish_time)
    assert [r.rid for r in finished] == [3, 1, 0, 2]

    eng = ServingEngine(model, params, slots=1, max_len=48, policy="deadline")
    for dl, (rid, prompt, _) in zip((9.0, 100.0, 1.0), specs(cfg, n=3)):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=3, deadline=dl))
    finished = sorted(eng.run().values(), key=lambda r: r.finish_time)
    assert [r.rid for r in finished] == [2, 0, 1]

    eng = ServingEngine(model, params, slots=2, max_len=48, max_queue=2)
    verdicts = [eng.submit(Request(rid=rid, prompt=p, max_new_tokens=2))
                for rid, p, _ in specs(cfg, n=4)]
    assert [bool(v) for v in verdicts] == [True, True, False, False]
    assert set(eng.run()) == {0, 1} and eng.throughput_report()["shed"] == 2


def test_sampling_independent_of_batch_composition(served):
    cfg, model, params, _ = served
    reqs = specs(cfg, n=4, seed=3, mx=(4, 8))

    def run(subset, slots):
        eng = ServingEngine(model, params, slots=slots, max_len=48, temperature=1.0, seed=11)
        for rid, prompt, mx in subset:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
        return {rid: r.tokens for rid, r in eng.run().items()}

    together = run(reqs, slots=3)
    alone = run(reqs[2:3], slots=1)
    reordered = run(list(reversed(reqs)), slots=2)
    assert together[2] == alone[2]
    assert together == reordered
    assert run(reqs, slots=3) == together  # reproducible for a fixed seed


def test_sample_greedy_and_seeds():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 0.0, 0.0, 0.0]])
    assert sample(logits).tolist() == [1, 0]       # first maximum, as jnp.argmax
    assert token_seed(0, 1, 2) == token_seed(0, 1, 2) != token_seed(0, 2, 1)
    with pytest.raises(ValueError):
        sample(logits, temperature=1.0)


def test_remote_backend_not_ported(served):
    _, model, params, _ = served
    with pytest.raises(ValueError, match="model_spec"):
        ServingEngine(model, params, backend="remote:localhost:1")
    eng = ServingEngine(model, params, slots=3, backend="remote:localhost:1,localhost:2",
                        model_spec={"config": "tinyllama-1.1b", "smoke": True, "seed": 0})
    assert eng.model_spec["device"] == "cpu"
    units = eng._prefill_units
    assert all(isinstance(u, RemoteUnit) and u.remote_backend == "thread" for u in units.values())
    assert [u.address for u in units.values()] == ["localhost:1", "localhost:2", "localhost:1"]


@pytest.fixture(scope="module")
def worker():
    handle = spawn_worker(startup_timeout=60.0)
    try:
        yield handle
    finally:
        handle.kill()


@pytest.mark.parametrize("arch", ARCHS)
def test_remote_prefill_tokens_equal_inline(worker, arch):
    cfg = get_config(arch).smoke()
    model = make_model(cfg, device="cpu")
    params = model.init(5)

    def serve(**kw):
        eng = ServingEngine(model, params, slots=2, max_len=48, **kw)
        for rid, prompt, mx in specs(cfg, n=6, seed=2):
            assert eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
        return {rid: r.tokens for rid, r in eng.run().items()}, eng

    inline, _ = serve()
    remote, eng = serve(backend=f"remote:{worker.address},{worker.address}",
                        model_spec={"config": arch, "smoke": True, "seed": 5})
    assert remote == inline
    rep = eng.last_run_report
    assert set(rep.wire_latency) == set(rep.dispatch_latency) == {"slot0", "slot1"}
    assert rep.items == 6
    sampled, _ = serve(temperature=1.0, seed=4)
    remote_sampled, _ = serve(temperature=1.0, seed=4, backend=f"remote:{worker.address}",
                              model_spec={"config": arch, "smoke": True, "seed": 5})
    assert remote_sampled == sampled


def test_failed_remote_prefill_fails_its_request(worker, served):
    cfg, model, params, _ = served
    eng = ServingEngine(model, params, slots=2, max_len=48, backend=f"remote:{worker.address}",
                        model_spec={"config": "no-such-model", "smoke": True, "seed": 0})
    for rid, prompt, mx in specs(cfg, n=3):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
    results = eng.run()
    assert sorted(results) == [0, 1, 2]
    assert all(not r.ok and r.tokens == [] and "no-such-model" in r.error
               for r in results.values())
    assert eng.steps == 0 and eng.throughput_report()["failed"] == 3


@pytest.mark.parametrize("overrides", [
    dict(seed=0, n=40),
    dict(seed=3, n=64, arrival="bursty", priorities=(0, 2, 1)),
    dict(seed=5, n=16, arrival="uniform", deadline_base=0.5, deadline_per_token=0.01),
])
def test_loadgen_trace_equals_reference(overrides):
    got, want = loadgen.make_trace(**overrides), jax_loadgen.make_trace(**overrides)
    assert len(got) == len(want) == overrides["n"]
    for g, w in zip(got, want):
        assert g.at == w.at
        assert np.array_equal(g.request.prompt, w.request.prompt)
        for field in ("rid", "max_new_tokens", "priority", "deadline"):
            assert getattr(g.request, field) == getattr(w.request, field), field
    assert loadgen.METRIC_KEYS == jax_loadgen.METRIC_KEYS


def test_loadgen_drives_the_engine(served):
    cfg, model, params, _ = served
    eng = ServingEngine(model, params, slots=2, max_len=64)
    trace = loadgen.make_trace(seed=1, n=8, rate=400.0, vocab_size=cfg.vocab_size,
                               prompt_lens=(3, 12), gen_lens=(2, 6))  # SSD prefill: >= 3
    metrics = loadgen.run_trace(eng, trace, time_scale=0.5)
    assert set(metrics) == set(loadgen.METRIC_KEYS)
    assert metrics["completed"] == 8 and metrics["failed"] == metrics["shed"] == 0
