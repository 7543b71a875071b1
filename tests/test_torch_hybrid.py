"""The port's ``hybrid`` family (RG-LRU + local attention) against the JAX
package on the CPU.

``rglru_block`` prefill (with and without a carried state, at S 300 so
that the log-depth scan has depth) and decode, the short-prompt conv state
(a deliberate difference from the reference, ROADMAP.md queue 3), and
recurrentgemma-9b's ``smoke()`` model: prefill over a prompt longer than
its window of 8 (the attention cache rolls) and decode, the training
forward, ``prefill_from``, and the serving engine's greedy streams with
the inline and threads backends.  The JAX parameters are carried across
with ``model_params_from_jax``; inputs come from numpy seeds; tolerance
2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import make_model, rglru, transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "recurrentgemma-9b"


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port model, port params) for the smoke config."""
    jcfg, cfg = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jm, jparams, make_model(cfg, device="cpu"), params


def block_params(pair):
    """The first RG-LRU layer's parameters on both sides."""
    cfg, _, jparams, _, params = pair
    assert transformer.layer_kinds(cfg)[0] == "rglru"
    return jax.tree.map(lambda a: a[0], jparams["blocks"][0]["rec"]), params["layers"][0]["rec"]


def test_hybrid_pattern_and_caches(pair):
    cfg = get_config(ARCH)
    kinds = transformer.layer_kinds(cfg)
    assert kinds == ["rglru", "rglru", "attn"] * 12 + ["rglru", "rglru"]
    caches = transformer.init_caches(cfg.replace(num_layers=3), 2, 4096, device="meta")
    assert isinstance(caches[0], rglru.RGLRUState) and caches[0].conv.shape == (2, 3, 4096)
    assert caches[2].k.shape == (2, 2048, 256)  # window-sized: cfg.window, not max_len


@jax.jit
def _jax_scan(a, b):
    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]
    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 300])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.05, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    close(rglru._linear_scan(torch.from_numpy(a), torch.from_numpy(b)), _jax_scan(a, b))


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_prefill_and_decode(pair, carried):
    cfg, jcfg = pair[0], jax_get_config(ARCH).smoke()
    jp, p = block_params(pair)
    x = rnd(2, 300, cfg.d_model, seed=1)
    jstate, state = None, None
    if carried:
        conv = rnd(2, cfg.conv_width - 1, cfg.d_model, seed=2)
        h = rnd(2, cfg.d_model, seed=3, scale=0.5)
        jstate = jrglru.RGLRUState(conv=jnp.asarray(conv), h=jnp.asarray(h))
        state = rglru.RGLRUState(conv=torch.from_numpy(conv.copy()), h=torch.from_numpy(h.copy()))
    jblock = jax.jit(lambda p_, x_, s_, decode: jrglru.rglru_block(p_, x_, jcfg, state=s_,
                                                                  decode=decode),
                     static_argnums=3)
    jy, jstate = jblock(jp, jnp.asarray(x), jstate, False)
    y, state = rglru.rglru_block(p, torch.from_numpy(x), cfg, state=state)
    close(y, jy)
    if not carried:
        assert state is None and jstate is None
        return
    close(state.h, jstate.h)
    close(state.conv, jstate.conv)
    for step in range(3):
        x1 = rnd(2, 1, cfg.d_model, seed=10 + step)
        jy, jstate = jblock(jp, jnp.asarray(x1), jstate, True)
        y, again = rglru.rglru_block(p, torch.from_numpy(x1), cfg, state=state, decode=True)
        assert again is state  # updated in place
        close(y, jy)
        close(state.h, jstate.h)
        close(state.conv, jstate.conv)


def test_rglru_short_prompt_conv_state(pair):
    # A 2-token prompt is shorter than conv_width - 1 = 3.  The reference's
    # conv state then has 2 rows and its next decode fails; the port keeps
    # the last 3 rows of cat(state.conv, xb), so prefill(2) + decode(1)
    # equals the reference's prefill of all 3 tokens (the zero conv state
    # is the conv's zero padding).
    cfg = pair[0]
    jcfg = jax_get_config(ARCH).smoke()
    jp, p = block_params(pair)
    x = rnd(2, 3, cfg.d_model, seed=4)
    _, jshort = jrglru.rglru_block(jp, jnp.asarray(x[:, :2]), jcfg,
                                   state=jrglru.init_rglru_state(jcfg, 2))
    assert jshort.conv.shape[1] == 2  # the reference's fault
    jy, jfull = jrglru.rglru_block(jp, jnp.asarray(x), jcfg,
                                   state=jrglru.init_rglru_state(jcfg, 2))
    state = rglru.init_rglru_state(cfg, 2, device="cpu")
    y2, state = rglru.rglru_block(p, torch.from_numpy(x[:, :2]), cfg, state=state)
    assert state.conv.shape == (2, cfg.conv_width - 1, cfg.d_model)
    close(y2, np.asarray(jy)[:, :2])
    y3, state = rglru.rglru_block(p, torch.from_numpy(x[:, 2:]), cfg, state=state, decode=True)
    close(y3, np.asarray(jy)[:, 2:])
    close(state.h, jfull.h)
    close(state.conv, jfull.conv)


def test_model_prefill_over_the_window_and_decode(pair):
    cfg, jm, jparams, model, params = pair
    assert cfg.window == 8
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 32)
    logits, caches = model.prefill(params, torch.from_numpy(tokens), 32)
    close(logits, jlogits)
    assert caches[2].k.shape[1] == 8
    close(caches[2].k, jcaches["blocks"][2].k[0])  # the rolled window
    tok = tokens[:, -1:]
    for step in range(4):
        pos = np.array([[13 + step]], np.int32)
        jlogits, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        logits, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                           caches)
        close(logits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]
    close(caches[0].h, jcaches["blocks"][0].h[0])


def test_training_forward_matches(pair):
    cfg, jm, jparams, model, params = pair
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jhidden, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    hidden, _ = model.forward(params, torch.from_numpy(tokens))
    close(model.logits(params, hidden), jm.logits(jparams, jhidden))


def test_prefill_from_existing_caches(pair):
    # a second prompt into caches that hold a first prompt and a decode
    # step: the KV cache is rewritten, the RG-LRU state continued
    cfg, jm, jparams, model, params = pair
    rng = np.random.default_rng(17)
    first = rng.integers(0, cfg.vocab_size, (1, 11)).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    _, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(first)}, 32)
    _, caches = model.prefill(params, torch.from_numpy(first), 32)
    tok, pos = np.array([[5]], np.int32), np.array([[11]], np.int32)
    _, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
    _, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos), caches)
    jlogits, jcaches = jm.prefill_from(jparams, {"tokens": jnp.asarray(second)}, jcaches)
    logits, again = model.prefill_from(params, torch.from_numpy(second), caches)
    assert again is caches
    close(logits, jlogits)
    pos = np.array([[7]], np.int32)
    jlogits, _ = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
    logits, _ = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos), caches)
    close(logits, jlogits)


def specs(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 14))).astype(np.int32),
             int(rng.integers(2, 9))) for i in range(n)]


@pytest.fixture(scope="module")
def jax_streams(pair):
    cfg, jm, jparams, _, _ = pair
    jeng = JaxServingEngine(jm, jparams, slots=2, max_len=48)
    for rid, prompt, mx in specs(cfg):
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=mx))
    return {rid: r.tokens for rid, r in jeng.run().items()}


@pytest.mark.parametrize("backend", ["inline", "threads"])
def test_greedy_streams_equal_jax_engine(pair, jax_streams, backend):
    cfg, _, _, model, params = pair
    eng = ServingEngine(model, params, slots=2, max_len=48, backend=backend)
    for rid, prompt, mx in specs(cfg):
        assert eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
    assert {rid: r.tokens for rid, r in eng.run().items()} == jax_streams
    assert eng.last_run_report.items == len(jax_streams)
