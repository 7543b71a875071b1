"""The port's model slice against the JAX package on the CPU.

``rms_norm``, ``apply_rope``, attention prefill and decode, ``ssd_block``
prefill and decode, and whole-model ``prefill`` / ``decode_step`` /
``prefill_from`` logits, for the ``smoke()`` configs of tinyllama-1.1b and
stablelm-12b (dense) and mamba2-130m (ssm); ``prefill_from`` also for
qwen3-moe-30b-a3b (moe, whose other cases are in ``test_torch_moe.py``).
The hybrid, encdec and vlm families are held in ``test_torch_hybrid.py``
and ``test_torch_encdec.py``.  The JAX model's parameters are carried across with
``model_params_from_jax``; inputs come from numpy seeds; tolerance 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, layers, make_model, ssm  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["tinyllama-1.1b", "mamba2-130m", "stablelm-12b"]


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX model, JAX params, port model, port params) for one smoke config."""
    jcfg = jax_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jm, jparams, make_model(cfg, device="cpu"), params


def test_configs_are_copies():
    # the hybrid, encdec and vlm families' configs too (tests/test_torch_hybrid.py and
    # tests/test_torch_encdec.py hold their models to the reference)
    for name in ARCHS + ["recurrentgemma-9b", "whisper-large-v3", "llama-3.2-vision-90b"]:
        for smoke in (False, True):
            jc, c = jax_get_config(name), get_config(name)
            if smoke:
                jc, c = jc.smoke(), c.smoke()
            for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                      "d_ff", "vocab_size", "ssm_state", "ssm_head_dim", "ssm_chunk", "dtype",
                      "rope_theta", "tie_embeddings", "conv_width", "block_pattern", "window",
                      "lru_width", "encoder_layers", "encoder_seq", "cross_attn_every",
                      "num_image_tokens"):
                assert getattr(c, f) == getattr(jc, f), (name, f)
            assert (c.padded_vocab, c.q_dim, c.kv_dim) == (jc.padded_vocab, jc.q_dim, jc.kv_dim)


def test_rms_norm():
    x, w = rnd(2, 5, 32, seed=1), rnd(32, seed=2, scale=0.1)
    close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_apply_rope():
    x = rnd(2, 7, 3, 16, seed=3)
    pos = np.array([np.arange(7), np.arange(7) + 40])
    close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_param_builder_scales():
    b = layers.ParamBuilder(0, torch.float32, "cpu")
    w = b.param((256, 512), ("embed", "mlp"))
    assert abs(float(w.std()) - 256**-0.5) < 0.01 * 256**-0.5 * 10
    u = b.param((1000,), ("ssm_heads",), init="uniform", scale=(-4.6, -2.3))
    assert float(u.min()) >= -4.6 and float(u.max()) <= -2.3
    again = layers.ParamBuilder(0, torch.float32, "cpu").param((256, 512), ("embed", "mlp"))
    assert torch.equal(w, again)
    with pytest.raises(ValueError, match="logical axes"):
        b.param((4, 4), ("embed",))


@pytest.mark.parametrize("window", [0, 8])
def test_attention_prefill_and_decode(window):
    # window 8 < the 11-token prompt: the rolling cache layout and its wrap
    jcfg = jax_get_config("tinyllama-1.1b").smoke()
    cfg = get_config("tinyllama-1.1b").smoke()
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(1))
    p = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    pa = p["layers"][0]["attn"]
    jpa = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"])
    x = rnd(2, 11, cfg.d_model, seed=4)
    jcache = jattn.init_kv_cache(jcfg, 2, 24, window)
    cache = attention.init_kv_cache(cfg, 2, 24, window, device="cpu")
    jattention = jax.jit(lambda p_, x_, c_: jattn.attention(p_, x_, jcfg, cache=c_, window=window))
    jy, jcache = jattention(jpa, jnp.asarray(x), jcache)
    y, cache = attention.attention(pa, torch.from_numpy(x), cfg, cache=cache, window=window)
    close(y, jy)
    close(cache.k, jcache.k)
    close(cache.v, jcache.v)
    assert cache.length.tolist() == [11, 11]
    for step in range(3):
        x1 = rnd(2, 1, cfg.d_model, seed=10 + step)
        jy, jcache = jattention(jpa, jnp.asarray(x1), jcache)
        y, cache = attention.attention(pa, torch.from_numpy(x1), cfg, cache=cache, window=window)
        close(y, jy)
        close(cache.k, jcache.k)
    assert cache.length.tolist() == [14, 14]


def test_ssd_block_prefill_and_decode():
    jcfg = jax_get_config("mamba2-130m").smoke()
    cfg = get_config("mamba2-130m").smoke()
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(2))
    p = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    ps = p["layers"][0]["ssd"]
    jps = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["ssd"])
    x = rnd(2, 13, cfg.d_model, seed=5)            # 13: a partial last chunk of 8
    jstate = jssm.init_ssm_state(jcfg, 2)
    state = ssm.init_ssm_state(cfg, 2, device="cpu")
    jblock = jax.jit(lambda p_, x_, s_, decode: jssm.ssd_block(p_, x_, jcfg, state=s_,
                                                              decode=decode),
                     static_argnums=3)
    jy, jstate = jblock(jps, jnp.asarray(x), jstate, False)
    y, state = ssm.ssd_block(ps, torch.from_numpy(x), cfg, state=state)
    close(y, jy)
    close(state.h, jstate.h)
    close(state.conv, jstate.conv)
    for step in range(3):
        x1 = rnd(2, 1, cfg.d_model, seed=20 + step)
        jy, jstate = jblock(jps, jnp.asarray(x1), jstate, True)
        y, state = ssm.ssd_block(ps, torch.from_numpy(x1), cfg, state=state, decode=True)
        close(y, jy)
    close(state.h, jstate.h)


def test_model_prefill_and_decode_logits(pair):
    cfg, jm, jparams, model, params = pair
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 32)
    logits, caches = model.prefill(params, torch.from_numpy(tokens), 32)
    close(logits, jlogits)
    tok = tokens[:, -1:]
    for step in range(4):
        pos = np.array([[13 + step]], np.int32)
        jlogits, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        logits, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                           caches)
        close(logits, jlogits)
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]


def test_training_forward_matches(pair):
    cfg, jm, jparams, model, params = pair
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jhidden, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    hidden, _ = model.forward(params, torch.from_numpy(tokens))
    close(model.logits(params, hidden), jm.logits(jparams, jhidden))


def test_bf16_params_convert_exactly():
    cfg = get_config("mamba2-130m").smoke().replace(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jax_get_config("mamba2-130m").smoke().replace(dtype="bfloat16", param_dtype="bfloat16")
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(3))
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(jparams["embed"], np.float32))
    np.testing.assert_array_equal(params["layers"][1]["ssd"]["in_proj"].float().numpy(),
                                  np.asarray(jparams["blocks"][0]["ssd"]["in_proj"][1], np.float32))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m", "qwen3-moe-30b-a3b"])
def test_prefill_from_existing_caches(arch):
    # prefill a second prompt into caches that already hold a first prompt
    # and some decode steps: the KV cache is rewritten, the SSM state continued
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm, model = jax_make_model(jcfg), make_model(cfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(4))
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
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
    assert again is caches  # filled in place
    close(logits, jlogits)
    pos = np.array([[7]], np.int32)
    jlogits, _ = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
    logits, _ = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos), caches)
    close(logits, jlogits)
